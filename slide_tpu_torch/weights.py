"""The weight bridge: reads the repository's checkpoints (pickles of numpy
trees written by `slide_tpu/train/checkpoint.py`) and copies a flax parameter
tree into a port module.

Torch modules of the port carry the flax module names, so a flax path maps
onto a `state_dict` key by joining it with dots and renaming the leaf:

    Dense       kernel (in, out)  -> weight (out, in), transposed
                bias              -> bias
    GroupNorm   scale / bias      -> weight / bias
    Embed       embedding         -> weight

The mapping is strict: every torch parameter takes exactly one leaf and every
leaf is used, or `load_flax_params` raises and names the leftovers.
"""

from __future__ import annotations

import pickle
from typing import Any, Mapping

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias"}
_PICKLE_CLASSES = {"_reconstruct", "ndarray", "dtype", "scalar"}


class _Inert:
    """Stands in for any other class of a checkpoint (the optimizer state's
    optax tuples): it takes the pickled state and runs no code of its own."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _NumpyUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays inside plain containers; any other class
    becomes `_Inert`, so loading a checkpoint imports and runs nothing else."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "numpy" and name in _PICKLE_CLASSES:
            return super().find_class(module, name)
        return _Inert


def load_inference_params(path: str, ema_idx: int = -1) -> Mapping[str, Any]:
    """Model parameters of a checkpoint; ema_idx >= 0 selects an EMA shadow
    (counterpart: `slide_tpu/cli/main.py::load_inference_params`)."""
    with open(path, "rb") as f:
        ckpt = _NumpyUnpickler(f).load()
    if ema_idx >= 0:
        return ckpt["ema_state_list"][ema_idx]
    return ckpt["model_state_dict"]


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
            arr = arr.T
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
