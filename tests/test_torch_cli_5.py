"""Part 5 of 5 of the tests in `torch_cli_cases.py` (its docstring says
what they hold against the JAX package and at which tolerance): see
ROADMAP.md, "Keep it under its limit"."""

from torch_cli_cases import (  # noqa: F401
    _one_torch_thread, test_visualize_pcd_writes_jax_files, test_plots_render_jax_figures,
    test_logging_timing_and_model_size_match_jax, test_finiteness_checks_name_jax_paths,
    test_trace_profile_writes_a_chrome_trace,
)
