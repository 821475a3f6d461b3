"""Data-parallel training steps over a process group (the counterpart of
the JAX package's data-sharded `mesh=` step, whose gradients XLA's psum
reduces).

Inside `data_parallel()` each rank holds its rows of the global batch (rank
r: rows [r b, (r + 1) b) of a (W b, ...) batch) and:

  - every random draw with one row per cloud (timesteps, noise, FPS starts)
    is made for the whole global batch from the generator, which every rank
    seeds alike, and the rank keeps its own rows (`batch_randn`,
    `batch_randint`); draws shared by the batch (a permutation) are made
    as before.  The generators stay in step, and a W-rank step computes what
    a one-rank step computes on the concatenated rows;
  - the training step all-reduces its gradients and its loss to their mean
    over the ranks before the optimizer (`all_reduce_mean`): one flat
    bucket, one collective a step.

Outside it (no process group, or a world of one) the helpers draw exactly
what `torch.randn` / `torch.randint` draw, and nothing is reduced."""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Shard:
    """This process's place in the data-parallel group."""

    rank: int
    world: int


_SHARD: contextvars.ContextVar = contextvars.ContextVar("slide_data_parallel", default=None)


def current_shard() -> Optional[Shard]:
    """The active shard, or None outside `data_parallel()`."""
    return _SHARD.get()


@contextlib.contextmanager
def data_parallel():
    """Run the enclosed steps as this rank's part of a data-parallel step
    over the process group."""
    token = _SHARD.set(Shard(dist.get_rank(), dist.get_world_size()))
    try:
        yield _SHARD.get()
    finally:
        _SHARD.reset(token)


def _own_rows(draw, shape: Sequence[int]) -> torch.Tensor:
    shard = current_shard()
    shape = tuple(shape)
    if shard is None:
        return draw(shape)
    b = shape[0]
    full = draw((b * shard.world,) + shape[1:])
    return full[shard.rank * b:(shard.rank + 1) * b]


def batch_randn(shape: Sequence[int], generator: torch.Generator,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Standard normals of `shape` (one row per cloud), on the generator's
    device: this rank's rows of the global batch's draw."""
    return _own_rows(lambda s: torch.randn(s, generator=generator, device=generator.device,
                                           dtype=dtype), shape)


def batch_randint(high: int, shape: Sequence[int], generator: torch.Generator,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Integers in [0, high) of `shape` (one row per cloud), on the
    generator's device: this rank's rows of the global batch's draw."""
    kw = {} if dtype is None else {"dtype": dtype}
    return _own_rows(lambda s: torch.randint(0, high, s, generator=generator,
                                             device=generator.device, **kw), shape)


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks of the active shard,
    in place, through one all-reduce of a flat fp32 bucket.  A no-op outside
    `data_parallel()`."""
    shard = current_shard()
    if shard is None or not tensors:
        return
    flat = _bucket(tensors)
    dist.all_reduce(flat)
    flat /= shard.world
    _unbucket(flat, tensors)


def broadcast_from_rank0(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite each tensor with rank 0's, in place, through one broadcast
    of a flat bucket."""
    if not tensors:
        return
    flat = _bucket(tensors)
    dist.broadcast(flat, src=0)
    _unbucket(flat, tensors)


def _bucket(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _unbucket(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
