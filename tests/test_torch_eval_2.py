"""Part 2 of 6 of the tests in `torch_eval_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_eval_cases import (  # noqa: F401
    _one_torch_thread, metric_sets, tree, sap_setting, test_datasets_match_jax,
    test_eps_chain_slices_and_warm_start_match_jax,
    test_latent_fastdpm_sampler_matches_fast_x0_denoise,
    test_generation_eval_options_match_jax, test_rank_files_gather_as_jax,
)
