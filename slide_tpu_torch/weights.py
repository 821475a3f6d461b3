"""The weight bridge: reads the repository's checkpoints (pickles of numpy
trees written by `slide_tpu/train/checkpoint.py`) and copies a flax parameter
tree into a port module.

Torch modules of the port carry the flax module names, so a flax path maps
onto a `state_dict` key by joining it with dots and renaming the leaf:

    Dense       kernel (in, out)  -> weight (out, in), transposed
    Conv (3-D)  kernel (kd, kh, kw, in, out) -> weight (out, in, kd, kh, kw)
                bias              -> bias
    GroupNorm   scale / bias      -> weight / bias
    Embed       embedding         -> weight

The mapping is strict: every torch parameter takes exactly one leaf and every
leaf is used, or `load_flax_params` raises and names the leftovers.
`module_to_flax` is the inverse: a module's parameters (or tensors keyed
like them: EMA shadows, Adam's moments) as a flax tree of numpy arrays.

The reader unpickles numpy arrays in plain containers and runs no other
code: any other class (optax's state tuples) becomes an inert stand-in that
keeps its constructor arguments as a plain tuple, so Adam's
`ScaleByAdamState(count, mu, nu)` reads back as `(count, mu, nu)` and
`EmptyState()` as `()`.
"""

from __future__ import annotations

import pickle
from typing import Any, Mapping

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias"}
_PICKLE_CLASSES = {"_reconstruct", "ndarray", "dtype", "scalar"}


class _Args(tuple):
    """A pickled object of any class other than numpy's, kept as the tuple of
    the arguments it was built from (NEWOBJ / REDUCE); a state set on it
    (BUILD) is kept in `state`.  No code of the original class runs."""

    def __setstate__(self, state):
        self.state = state


class _Inert:
    """Stands in for any other class of a checkpoint: calling or
    constructing it gives an `_Args` of its arguments."""

    def __new__(cls, *args, **kwargs):
        return _Args(args)


class _NumpyUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays inside plain containers; any other class
    becomes `_Inert`, so loading a checkpoint imports and runs nothing else."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "numpy" and name in _PICKLE_CLASSES:
            return super().find_class(module, name)
        return _Inert


def read_checkpoint(path: str) -> dict:
    """A checkpoint's dict (`train/checkpoint.py` layout), through the
    numpy-only unpickler."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def load_inference_params(path: str, ema_idx: int = -1) -> Mapping[str, Any]:
    """Model parameters of a checkpoint; ema_idx >= 0 selects an EMA shadow
    (counterpart: `slide_tpu/cli/main.py::load_inference_params`)."""
    ckpt = read_checkpoint(path)
    if ema_idx >= 0:
        return ckpt["ema_state_list"][ema_idx]
    return ckpt["model_state_dict"]


def kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    """A flax kernel in torch's layout: a Dense kernel (in, out) transposed;
    a convolution's (kd, kh, kw, in, out) as (out, in, kd, kh, kw).  (`.T`
    would give (out, in, kw, kh, kd): the same shape for a cubic kernel,
    the taps mirrored.)"""
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"no torch layout for a kernel of shape {arr.shape}")


def kernel_to_flax(arr: np.ndarray) -> np.ndarray:
    """The inverse of `kernel_to_torch`."""
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 5:
        return arr.transpose(2, 3, 4, 1, 0)
    raise ValueError(f"no flax layout for a kernel of shape {arr.shape}")


def flax_to_torch_state(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flatten a flax parameter tree into torch `state_dict` keys."""
    out: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        *mods, leaf = path
        if leaf not in _LEAF_NAMES:
            raise ValueError(f"no torch name for flax leaf {'/'.join(path)}")
        arr = np.asarray(node, dtype=np.float32)
        if leaf == "kernel":
            arr = kernel_to_torch(arr)
        out[".".join(mods + [_LEAF_NAMES[leaf]])] = np.ascontiguousarray(arr)

    walk(params, ())
    return out


def load_flax_params(module: torch.nn.Module,
                     params: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a flax parameter tree into `module`'s parameters, strictly."""
    state = flax_to_torch_state(params)
    own = dict(module.named_parameters())
    missing = sorted(own.keys() - state.keys())
    unused = sorted(state.keys() - own.keys())
    if missing or unused:
        raise ValueError(f"flax tree does not match {type(module).__name__}: "
                         f"parameters without a leaf {missing}, "
                         f"leaves without a parameter {unused}")
    bad = [(k, tuple(p.shape), state[k].shape) for k, p in own.items()
           if tuple(p.shape) != state[k].shape]
    if bad:
        raise ValueError(f"shape mismatch (name, torch, flax): {bad}")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(torch.from_numpy(state[k]))
    return module


def flax_path(module: torch.nn.Module, name: str) -> tuple[tuple, bool]:
    """The flax path of a parameter and whether its array changes layout
    (`kernel_to_flax`): Linear and Conv3d weight -> kernel, GroupNorm
    weight -> scale, Embedding weight -> embedding."""
    *path, leaf = name.split(".")
    owner = module.get_submodule(".".join(path))
    transpose = False
    if leaf == "weight":
        if isinstance(owner, (torch.nn.Linear, torch.nn.Conv3d)):
            leaf, transpose = "kernel", True
        elif isinstance(owner, torch.nn.Embedding):
            leaf = "embedding"
        else:
            leaf = "scale"
    return tuple(path) + (leaf,), transpose


def module_to_flax(module: torch.nn.Module,
                   tensors: Mapping[str, torch.Tensor] | None = None) -> dict:
    """A module's parameters as the flax tree `load_flax_params` reads, numpy
    fp32 (the inverse of `flax_to_torch_state`).  With `tensors` (keyed by
    parameter name, shaped like the parameters: EMA shadows, Adam's
    moments), those are converted in their place."""
    tree: dict = {}
    for name, p in module.named_parameters():
        path, transpose = flax_path(module, name)
        t = p if tensors is None else tensors[name]
        arr = t.detach().cpu().numpy().astype(np.float32)
        if transpose:
            arr = np.ascontiguousarray(kernel_to_flax(arr))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def flax_order(module: torch.nn.Module) -> list[str]:
    """The module's parameter names in the order of its flax tree's leaves
    (`jax.tree.leaves`: keys sorted at every level)."""
    return sorted((name for name, _ in module.named_parameters()),
                  key=lambda name: flax_path(module, name)[0])


def flax_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in `jax.tree.leaves`'
    order (dict keys sorted)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in flax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flax_leaves(v)]
    return [tree]
