"""Part 4 of 5 of the tests in `torch_cli_cases.py` (its docstring says
what they hold against the JAX package and at which tolerance): see
ROADMAP.md, "Keep it under its limit"."""

from torch_cli_cases import (  # noqa: F401
    _one_torch_thread, tree, test_reconstruct_meshes_options_match_jax,
)
