"""Part 2 of 8 of the tests in `torch_nn_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_nn_cases import (  # noqa: F401
    test_group_norm_statistics_sum_in_float64, test_shared_mlp,
    test_injection_mlp_rejects_missing_embedding,
)
