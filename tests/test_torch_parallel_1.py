"""Part 1 of 2 of the tests in `torch_parallel_cases.py` (its docstring
says what they hold and at which tolerance): see ROADMAP.md, "Keep it
under its limit"."""

from torch_parallel_cases import (  # noqa: F401
    _one_torch_thread, test_draws_are_the_global_batch_rows, test_single_process_world,
    test_generation_over_devices_matches_one_device,
)
