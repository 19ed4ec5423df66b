"""Distributed pieces of paddle_tpu_torch: the collectives tensor-parallel
serving's int8-compressed reduce needs (`comm_compress`) and the atomic
CRC-checked checkpoints (`checkpoint`)."""
