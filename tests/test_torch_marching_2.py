"""Part 2 of 3 of the tests in `torch_marching_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_marching_cases import (  # noqa: F401
    test_count_cells_and_faces_matches_jax, test_host_marching_is_the_jax_one,
    test_host_mesh_sampling_is_the_jax_one,
    test_sampler_statistics_match_the_jax_device_sampler,
    test_extract_and_sample_scales_counts_and_keeps_the_mesh,
)
