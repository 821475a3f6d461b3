"""Part 1 of 7 of the tests in `torch_diffusion_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_diffusion_cases import (  # noqa: F401
    test_eps_schedule_equals_jax,
)
