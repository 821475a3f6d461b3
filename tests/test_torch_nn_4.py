"""Part 4 of 8 of the tests in `torch_nn_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_nn_cases import (  # noqa: F401
    test_query_and_group, test_group_knn_features_and_group_all,
    test_sa_module_without_attention,
)
