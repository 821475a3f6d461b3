"""PyTorch / CUDA port of slide_tpu for NVIDIA Hopper.

The JAX package `slide_tpu` is the reference this package is held against;
this package imports nothing of it.  Layout mirrors it: `configs/`, `ops/`,
`nn/`, `models/`, `diffusion/`, plus `weights.py` (flax checkpoints into
torch modules), `pipeline.py` (generation) and `csrc/` (CUDA kernels, built
by `_build.py`).
"""
