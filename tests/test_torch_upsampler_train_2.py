"""Part 2 of 2 of the tests in `torch_upsampler_train_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_upsampler_train_cases import (  # noqa: F401
    _one_torch_thread, upsampler_steps, test_synthetic_tree_with_dpsr_grids_matches_jax,
    test_upsampler_loss_and_gradient_match_jax, test_upsampler_train_step_matches_optax,
)
