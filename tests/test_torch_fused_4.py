"""Part 4 of 14 of the tests in `torch_fused_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_fused_cases import (  # noqa: F401
    one_thread, test_k1_plan_placements,
)
