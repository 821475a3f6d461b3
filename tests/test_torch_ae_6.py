"""Part 6 of 6 of the tests in `torch_ae_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_ae_cases import (  # noqa: F401
    _one_torch_thread, kl_level, round_trip,
    test_full_width_encode_with_the_committed_checkpoint,
)
