"""Part 14 of 14 of the tests in `torch_fused_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_fused_cases import (  # noqa: F401
    test_plain_matches_jax_fused_past_64_points, test_knn_ties_past_index_63_match_jax,
)
