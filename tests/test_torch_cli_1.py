"""Part 1 of 5 of the tests in `torch_cli_cases.py` (its docstring says
what they hold against the JAX package and at which tolerance): see
ROADMAP.md, "Keep it under its limit"."""

from torch_cli_cases import (  # noqa: F401
    _one_torch_thread, test_config_helpers_match_jax, test_normalize_point_cloud_matches_jax,
    test_read_eval_result_matches_jax,
)
