"""Part 2 of 5 of the tests in `torch_cli_cases.py` (its docstring says
what they hold against the JAX package and at which tolerance): see
ROADMAP.md, "Keep it under its limit"."""

from torch_cli_cases import (  # noqa: F401
    _one_torch_thread, test_parsers_match_jax, test_evaluate_report_matches_jax,
)
