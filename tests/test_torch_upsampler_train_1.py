"""Part 1 of 2 of the tests in `torch_upsampler_train_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_upsampler_train_cases import (  # noqa: F401
    _one_torch_thread, upsampler_steps, test_dpsr_grid_gradient_at_the_ties_matches_jax,
    test_upsampler_checkpoints_both_ways, test_train_upsampler_checkpoints_and_resumes,
)
