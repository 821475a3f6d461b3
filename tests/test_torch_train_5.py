"""Part 5 of 6 of the tests in `torch_train_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_train_cases import (  # noqa: F401
    _one_torch_thread, test_backward_reference_resolves_only_relu_ties,
)
