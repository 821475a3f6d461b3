"""Part 3 of 3 of the tests in `torch_marching_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_marching_cases import (  # noqa: F401
    test_device_extraction_matches_the_numpy_oracle,
)
