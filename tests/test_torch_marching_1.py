"""Part 1 of 3 of the tests in `torch_marching_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_marching_cases import (  # noqa: F401
    test_uneven_grid_matches_the_oracle, test_the_mesh_gate_sees_winding,
    test_empty_grid_raises_and_samples_nan,
)
