"""Part 2 of 2 of the tests in `torch_parallel_cases.py` (its docstring
says what they hold and at which tolerance): see ROADMAP.md, "Keep it
under its limit"."""

from torch_parallel_cases import (  # noqa: F401
    _one_torch_thread, test_two_rank_steps_equal_one_process_step, test_two_rank_training_run,
)
