"""Part 13 of 14 of the tests in `torch_fused_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_fused_cases import (  # noqa: F401
    one_thread, test_knn_ties_past_index_31_match_jax,
    test_presets_are_in_the_fused_scope_up_to_64_points, test_16_point_plans_are_unchanged,
)
