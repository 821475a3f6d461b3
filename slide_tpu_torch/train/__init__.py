"""Training (counterpart: `slide_tpu/train/`): the position-DDPM driver,
EMA shadows and checkpoints in the JAX package's layout."""
