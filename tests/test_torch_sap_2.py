"""Part 2 of 7 of the tests in `torch_sap_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_sap_cases import (  # noqa: F401
    test_mirror_and_concat_replays_the_jax_permutation,
    test_normalize_and_bounding_box_match_jax, test_upsampler_config_is_the_jax_preset,
)
