"""Part 1 of 7 of the tests in `torch_sap_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_sap_cases import (  # noqa: F401
    test_fftfreqs_and_filter_are_the_jax_ones, test_mirror_matches_jax,
)
