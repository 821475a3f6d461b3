"""Part 4 of 7 of the tests in `torch_diffusion_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_diffusion_cases import (  # noqa: F401
    test_eps_chain_closed_form, test_latent_denoise_and_reconstruct_closed_form,
    test_unported_sampler_raises,
)
