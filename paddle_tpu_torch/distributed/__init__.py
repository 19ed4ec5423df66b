"""Collectives of paddle_tpu_torch: so far only what tensor-parallel
serving's int8-compressed reduce needs (`comm_compress`)."""
