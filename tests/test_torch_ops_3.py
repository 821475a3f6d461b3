"""Part 3 of 8 of the tests in `torch_ops_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_ops_cases import (  # noqa: F401
    test_ball_query, test_three_nn, test_gather_and_group_points, test_count_to_mask,
)
