"""Part 1 of 6 of the tests in `torch_eval_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_eval_cases import (  # noqa: F401
    _one_torch_thread, metric_sets, tree, sap_setting, test_emd_matches_jax,
    test_paired_metrics_match_jax, test_two_sample_metrics_match_jax, test_jsd_matches_jax,
)
