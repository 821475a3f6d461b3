"""Part 8 of 9 of the tests in `torch_train_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_train_cases import (  # noqa: F401
    _one_torch_thread, test_build_stages_fuses_64_keypoints,
    test_scratch_past_the_card_raises_naming_its_size,
)
