"""Part 3 of 7 of the tests in `torch_sap_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_sap_cases import (  # noqa: F401
    test_point_rasterize_and_grid_interp_match_jax,
)
