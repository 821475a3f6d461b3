"""Part 6 of 7 of the tests in `torch_diffusion_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_diffusion_cases import (  # noqa: F401
    test_x0_chain_warm_start_partial, test_eps_chain_with_the_kp_network,
)
