"""Part 1 of 8 of the tests in `torch_ops_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_ops_cases import (  # noqa: F401
    test_pairwise_sqdist_matches_and_is_clamped, test_knn_points_random,
)
