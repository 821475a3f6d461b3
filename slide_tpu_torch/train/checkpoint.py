"""Checkpoints in the JAX package's layout (counterpart:
`slide_tpu/train/checkpoint.py`):

  <output_dir>/pointnet_ckpt_<iter>.pkl
  { iter, model_state_dict, optimizer_state_dict, training_time_seconds
    [, ema_state_list] }

Every tree is a flax tree of numpy arrays (`weights.module_to_flax`), so the
JAX package reads a checkpoint of the port and the port reads one of the JAX
package (through the numpy-only unpickler, `weights.read_checkpoint`).  The
optimizer state is Adam's as optax keeps it, written as plain tuples:
((count int32, mu tree, nu tree), ()).
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Optional

import numpy as np

from slide_tpu_torch.weights import read_checkpoint


def _list_iters(path: str, ckpt_name: str) -> list:
    if not os.path.isdir(path):
        return []
    iters = []
    for f in os.listdir(path):
        if f.startswith(ckpt_name + "_") and f.endswith(".pkl") and "best" not in f:
            try:
                iters.append(int(f[len(ckpt_name) + 1:-4]))
            except ValueError:
                pass
    return iters


def find_max_iter(path: str, ckpt_name: str = "pointnet_ckpt", mode: str = "max"):
    """'max': the newest iteration (-1 if none); 'all': every iteration,
    newest first; 'best': the iteration with the lowest avg_cd in
    ../../eval_result/gathered_eval_result.pkl."""
    iters = _list_iters(path, ckpt_name)
    if mode == "max":
        return max(iters) if iters else -1
    if mode == "all":
        return sorted(iters, reverse=True)
    if mode == "best":
        with open(os.path.join(path, "..", "..", "eval_result",
                               "gathered_eval_result.pkl"), "rb") as f:
            data = pickle.load(f)
        return data["iter"][int(np.argmin(np.asarray(data["avg_cd"])))]
    raise ValueError(f"{mode} mode is not supported")


def save_checkpoint(output_dir: str, n_iter: int, params, opt_state,
                    training_time_seconds: int, ema_state_list=None,
                    ckpt_name: str = "pointnet_ckpt") -> str:
    """Write the trees (already numpy) as `<ckpt_name>_<n_iter>.pkl`, written
    to a temporary name and renamed, so a cut save leaves no truncated file."""
    os.makedirs(output_dir, exist_ok=True)
    states = {"iter": n_iter, "model_state_dict": params,
              "optimizer_state_dict": opt_state,
              "training_time_seconds": int(training_time_seconds)}
    if ema_state_list is not None:
        states["ema_state_list"] = list(ema_state_list)
    path = os.path.join(output_dir, f"{ckpt_name}_{n_iter}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(states, f)
    os.replace(tmp, path)
    return path


def mirror_checkpoint(path: str, durable_dir: str, keep: int = 1) -> str:
    """Copy a saved checkpoint into `durable_dir` (write-then-rename) and
    prune older mirrored iterations to the newest `keep`."""
    os.makedirs(durable_dir, exist_ok=True)
    name = os.path.basename(path)
    dst = os.path.join(durable_dir, name)
    tmp = dst + ".tmp"
    shutil.copyfile(path, tmp)
    os.replace(tmp, dst)
    ckpt_name = name.rsplit("_", 1)[0]
    for it in sorted(_list_iters(durable_dir, ckpt_name))[:-max(1, keep)]:
        try:
            os.remove(os.path.join(durable_dir, f"{ckpt_name}_{it}.pkl"))
        except OSError:
            pass
    return dst


def restore_from_mirror(output_dir: str, durable_dir: str,
                        ckpt_name: str = "pointnet_ckpt") -> Optional[str]:
    """When `output_dir` has no checkpoint and the mirror has one, copy the
    newest back.  Returns the restored path or None."""
    if _list_iters(output_dir, ckpt_name):
        return None
    mirrored = _list_iters(durable_dir, ckpt_name)
    if not mirrored:
        return None
    name = f"{ckpt_name}_{max(mirrored)}.pkl"
    os.makedirs(output_dir, exist_ok=True)
    dst = os.path.join(output_dir, name)
    shutil.copyfile(os.path.join(durable_dir, name), dst)
    return dst


def load_checkpoint(output_dir: str, n_iter: Optional[int] = None,
                    ckpt_name: str = "pointnet_ckpt") -> Optional[dict]:
    """Iteration `n_iter` (default: the newest), or None when there is no
    checkpoint to load (a start from scratch)."""
    if n_iter is None:
        n_iter = find_max_iter(output_dir, ckpt_name)
    if n_iter < 0:
        return None
    path = os.path.join(output_dir, f"{ckpt_name}_{n_iter}.pkl")
    try:
        return read_checkpoint(path)
    except (OSError, pickle.UnpicklingError, EOFError) as e:
        print(f"checkpoint load failed ({e}); starting from scratch", flush=True)
        return None
