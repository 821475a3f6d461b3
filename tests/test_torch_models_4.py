"""Part 4 of 6 of the tests in `torch_models_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_models_cases import (  # noqa: F401
    small_decode, test_denoiser_without_head_as_decoder_backbone,
)
