"""Part 3 of 5 of the tests in `torch_cli_cases.py` (its docstring says
what they hold against the JAX package and at which tolerance): see
ROADMAP.md, "Keep it under its limit"."""

from torch_cli_cases import (  # noqa: F401
    _one_torch_thread, tree, test_cli_train_and_generate_match_the_port,
    test_cli_encode_and_decode_match_the_autoencoder,
)
