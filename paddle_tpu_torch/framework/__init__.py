"""Framework state of paddle_tpu_torch: the RNG (`random`)."""
