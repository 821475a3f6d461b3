"""Part 1 of 6 of the tests in `torch_train_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_train_cases import (  # noqa: F401
    _one_torch_thread, test_cuda_spec_struct_matches_the_table,
    test_64_keypoints_are_outside_the_fused_scope,
    test_build_stages_ema_idx_loads_the_raw_autoencoder,
    test_distance_gradient_at_the_tie_matches_jax, test_sample_keypoints_match_jax,
    test_sample_keypoints_random_modes,
)
