"""Part 7 of 8 of the tests in `torch_ops_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_ops_cases import (  # noqa: F401
    test_fps_batches_off_the_tpu_tile, test_fps_ties_on_a_grid,
    test_fps_distance_uses_all_channels, test_fps_decode_shape_with_forced_points,
)
