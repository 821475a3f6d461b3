"""Part 7 of 14 of the tests in `torch_fused_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_fused_cases import (  # noqa: F401
    one_thread, test_3xtf32_products_keep_the_k1_gate,
)
