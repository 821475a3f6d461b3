"""Symmetry mirroring, the SAP refiner's symmetry prior (counterpart:
`slide_tpu/sap/mirror.py`): reflect the cloud about its centroid along one
axis, tag real and mirrored points with a +1 / -1 indicator channel, and
optionally FPS-downsample variants."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from slide_tpu_torch.ops import furthest_point_sample, gather_points


def mirror(partial: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Reflect xyz (and the matching normal axis) about the cloud's centroid.
    partial (B, N, F >= 3).  Every coordinate goes through (x - c) + c, as
    in the JAX package, so the unreflected ones round as they do there."""
    xyz = partial[..., :3]
    center = torch.mean(xyz, dim=1, keepdim=True)
    sign = torch.ones(3, dtype=partial.dtype, device=partial.device)
    sign[axis] = -1.0
    out = torch.cat([(xyz - center) * sign + center, partial[..., 3:]], dim=-1)
    if partial.shape[-1] >= 6:
        out[..., axis + 3] = -out[..., axis + 3]
    return out


def down_sample_points(x: torch.Tensor, npoints: int, start_idx=0) -> torch.Tensor:
    """FPS-downsample (on the first 3 channels) keeping every channel."""
    idx = furthest_point_sample(x[..., :3], npoints, start_idx=start_idx)
    return gather_points(x, idx)


def mirror_and_concat(partial: torch.Tensor, axis: int = 2,
                      num_points: Sequence[int] = (), attach_label: bool = False,
                      permute: bool = True,
                      generator: Optional[torch.Generator] = None,
                      perm: Optional[torch.Tensor] = None):
    """Concat the cloud with its mirror (with a +1 / -1 indicator channel if
    `attach_label`), shuffle the 2N points with one permutation shared by
    the batch (as `jax.random.permutation` is), and add FPS-downsampled
    variants.  The permutation is `perm` when given (a test replays JAX's),
    else drawn from `generator`.  Returns a tuple (concat, *downsampled)."""
    b, n, _ = partial.shape
    mirrored = mirror(partial, axis=axis)
    if attach_label:
        ones = torch.ones((b, n, 1), dtype=partial.dtype, device=partial.device)
        partial = torch.cat([partial, ones], dim=-1)
        mirrored = torch.cat([mirrored, -ones], dim=-1)
    concat = torch.cat([partial, mirrored], dim=1)             # (B, 2N, F[+1])
    if permute:
        if perm is None:
            if generator is None:
                raise ValueError("permute=True requires a generator or a permutation")
            perm = torch.randperm(2 * n, generator=generator, device=generator.device)
        concat = concat[:, torch.as_tensor(perm, device=concat.device).long()]
    out = [concat]
    for npts in num_points:
        out.append(down_sample_points(concat, npts))
    return tuple(out)
