"""Model-size reporting (counterpart: `slide_tpu/utils/model_utils.py`)."""

from __future__ import annotations

import numpy as np

from slide_tpu_torch.utils.tree import named_leaves


def param_count(params) -> int:
    """The number of parameters of an `nn.Module`, a state dict or a tree of
    arrays (a flax-layout tree counts as its module does)."""
    return sum(int(np.prod(np.shape(leaf))) for _, leaf in named_leaves(params))


def print_size(params, name: str = "network") -> int:
    n = param_count(params)
    print("{} Parameters: {:.6f}M".format(name, n / 1e6), flush=True)
    return n
