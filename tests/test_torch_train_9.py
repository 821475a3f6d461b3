"""Part 9 of 9 of the tests in `torch_train_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_train_cases import (  # noqa: F401
    _one_torch_thread, test_fused_train_grads_at_128_points_match_jax,
    test_k2_tiles_plain_route_equals_the_whole_batch,
)
