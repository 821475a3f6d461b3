"""Part 3 of 9 of the tests in `torch_train_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_train_cases import (  # noqa: F401
    _one_torch_thread, test_unpickler_keeps_the_adam_state,
    test_port_checkpoint_is_read_by_the_jax_package, test_synthetic_tree_and_batches_equal_jax,
    test_train_position_ddpm_checkpoints_and_resumes,
)
