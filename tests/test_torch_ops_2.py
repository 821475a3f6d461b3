"""Part 2 of 8 of the tests in `torch_ops_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_ops_cases import (  # noqa: F401
    test_knn_points_ties_go_to_lowest_index, test_knn_points_rejects_k_above_n,
)
