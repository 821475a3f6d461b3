"""Part 4 of 6 of the tests in `torch_eval_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_eval_cases import (  # noqa: F401
    _one_torch_thread, metric_sets, tree, sap_setting, test_pairwise_matrices_match_jax,
)
