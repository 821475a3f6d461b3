"""Part 7 of 7 of the tests in `torch_diffusion_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_diffusion_cases import (  # noqa: F401
    test_x0_chain_with_the_latent_network,
)
