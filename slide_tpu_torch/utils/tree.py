"""The leaves of a parameter container with their paths: an `nn.Module`
(its named parameters), a state dict (a flat mapping of names to
tensors), or a tree of dicts, lists and tuples
of tensors or arrays.  Paths of a tree are written as JAX's `keystr`
writes them (`['a']['b']`, `[0]`); a module's and a state dict's are the
parameter names."""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn


def named_leaves(tree: Any) -> Iterator[tuple[str, Any]]:
    """(path, leaf) of every leaf, in the container's order."""
    if isinstance(tree, nn.Module):
        yield from tree.named_parameters()
        return
    if isinstance(tree, Mapping) and tree \
            and all(isinstance(v, torch.Tensor) for v in tree.values()):
        yield from tree.items()               # a state dict
        return
    yield from _walk(tree, "")


def _walk(node: Any, path: str) -> Iterator[tuple[str, Any]]:
    if isinstance(node, Mapping):
        for k in sorted(node) if all(isinstance(k, str) for k in node) else node:
            yield from _walk(node[k], f"{path}[{k!r}]")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk(v, f"{path}[{i}]")
    elif node is not None:
        yield path, node


def as_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)
