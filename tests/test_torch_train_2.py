"""Part 2 of 9 of the tests in `torch_train_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_train_cases import (  # noqa: F401
    _one_torch_thread, test_training_loss_matches_jax_with_replayed_draws,
    test_weight_gradient_jobs_equal_autograd,
    test_backward_reference_flips_copies_of_a_tie_together, test_torch_adam_matches_optax,
    test_ema_matches_jax, test_k2_tile_plan,
)
