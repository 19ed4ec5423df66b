"""Hand-written CUDA kernels for Hopper, one module per Pallas TPU kernel of
`paddle_tpu/ops/pallas/` that the port has reached. Each module holds the
wrapper (plain PyTorch version for CPU tensors, the CUDA kernel for CUDA
tensors) and the plain version itself."""
