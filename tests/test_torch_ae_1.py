"""Part 1 of 6 of the tests in `torch_ae_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_ae_cases import (  # noqa: F401
    _one_torch_thread, kl_level, round_trip, test_pnet2stage_matches_jax,
    test_encoder_rejects_unported_options, test_chamfer_values_and_gradients_match_jax,
    test_ae_checkpoints_both_ways,
)
