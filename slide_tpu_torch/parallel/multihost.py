"""Several processes on `torch.distributed` (counterpart:
`slide_tpu/parallel/multihost.py`).

One process per card: each joins the group with its rank, holds its rank's
shard of every batch and its own copy of the network, and the training
step all-reduces the gradients (`parallel/data_parallel.py`).  No global
array is formed, as JAX's `make_array_from_process_local_data` forms one:
a rank's batch is its rows only."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None, device=None) -> bool:
    """Join the process group at `tcp://<coordinator_address>` as rank
    `process_id` of `num_processes`; a no-op returning False without an
    address.  The backend is `backend` where given, else `nccl` for a CUDA
    `device` (the default: the card) and `gloo` for the CPU.  With a card
    the rank takes card `rank % device_count` as its current device.  A
    caller may pass `backend="gloo"` to put several ranks on one card
    (NCCL refuses two ranks on one device)."""
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="tcp://" + coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def process_group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_info():
    """(rank, world size, local device count, global device count): the
    devices are the cards this process sees (1 without a card), the
    global count that times the world size."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if process_group_active() \
        else (0, 1)
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank, world, local, local * world


def global_batch_from_local(batch: dict, device=None) -> dict:
    """This rank's batch on its device: every array as a tensor on `device`
    (the rank's card by default), string metadata kept on the host.  Each
    rank computes on its own rows and the step all-reduces the gradients,
    so no global array is assembled."""
    dev = torch.device("cuda" if device is None else device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], str):
            out[k] = v
            continue
        out[k] = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                 device=dev)
    return out


def process_allgather(tree):
    """Every rank's `tree` (dicts, lists and tuples of arrays), each leaf
    stacked over the ranks in rank order on a new leading axis; without a
    process group the axis has length 1."""
    if process_group_active():
        trees = [None] * dist.get_world_size()
        dist.all_gather_object(trees, tree)
    else:
        trees = [tree]
    return _stack(trees)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees])
