"""Part 1 of 8 of the tests in `torch_nn_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_nn_cases import (  # noqa: F401
    test_calc_t_emb_and_swish, test_calc_t_emb_late_steps, test_tail_group_norm,
)
