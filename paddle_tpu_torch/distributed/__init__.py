"""Distributed pieces of paddle_tpu_torch: the collectives tensor-parallel
serving's int8-compressed reduce needs (`comm_compress`), the atomic
CRC-checked checkpoints (`checkpoint`), and what the process fleet stands
on: the rendezvous `store` (over `torch.distributed.TCPStore`), the RPC
wire framing (`rpc`) and `spawn`."""
