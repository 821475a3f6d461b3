"""Finiteness checks (counterpart: `slide_tpu/utils/checks.py`)."""

from __future__ import annotations

import numpy as np

from slide_tpu_torch.utils.tree import as_numpy, named_leaves


def tree_nonfinite_paths(tree) -> list[str]:
    """Paths of the floating-point leaves that hold a NaN or an Inf: the
    parameter names of a module or a state dict, JAX's `keystr` paths of a
    tree.  Copies each leaf to the host."""
    bad = []
    for path, leaf in named_leaves(tree):
        arr = as_numpy(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad.append(path)
    return bad


def assert_tree_finite(tree, context: str = ""):
    """`tree`, or FloatingPointError naming up to ten non-finite leaves."""
    bad = tree_nonfinite_paths(tree)
    if bad:
        raise FloatingPointError(
            f"non-finite values {('in ' + context) if context else ''}: " + ", ".join(bad[:10]))
    return tree
