"""Part 4 of 8 of the tests in `torch_ops_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_ops_cases import (  # noqa: F401
    test_pool_features,
)
