"""Part 2 of 3 of the tests in `torch_pipeline_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_pipeline_cases import (  # noqa: F401
    narrow, test_slice_matches_the_jax_composition,
    test_generate_is_reproducible_from_its_seed, test_unfused_chains_match_the_fused_ones,
)
