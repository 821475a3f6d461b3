"""Part 1 of 6 of the tests in `torch_models_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_models_cases import (  # noqa: F401
    small_decode, test_class_embeddings_are_drawn_at_the_jax_scale,
    test_denoiser_rejects_unported_options, test_point_upsample,
    test_decode_params_picks_the_decode_subtree,
)
