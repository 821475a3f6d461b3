"""Voxelisation for the PVCNN backbone (counterpart: `slide_tpu/ops/voxel.py`).

avg_voxelize: scatter-mean of point features into an R^3 grid, each voxel
the mean of the points whose rounded coordinates land in it.
trilinear_devoxelize: trilinear gather of grid features at continuous point
coordinates, borders clamped.  Both are plain PyTorch (`index_add_` and
gathers) and differentiable by autograd: the JAX package computes them in
plain `jnp`, outside any Pallas kernel.  Grids are channels-last,
(B, R, R, R, C).
"""

from __future__ import annotations

import torch


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip`: half the gradient at a bound, as its maximum / minimum
    pass it (`torch.clamp` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _linear_index(idx: torch.Tensor, r: int) -> torch.Tensor:
    return idx[..., 0] * (r * r) + idx[..., 1] * r + idx[..., 2]


def avg_voxelize(features: torch.Tensor, coords: torch.Tensor, resolution: int) -> torch.Tensor:
    """features (B, N, C), coords (B, N, 3) voxel coordinates in [0, R) ->
    grid (B, R, R, R, C).  Coordinates round half to even, as `jnp.round`
    does, then clip to [0, R - 1]."""
    b, n, c = features.shape
    r = resolution
    idx = torch.clamp(torch.round(coords).long(), 0, r - 1)
    lin = _linear_index(idx, r) + (torch.arange(b, device=coords.device) * r ** 3)[:, None]
    lin = lin.reshape(-1)
    sums = features.new_zeros((b * r ** 3, c)).index_add(0, lin, features.reshape(b * n, c))
    cnt = features.new_zeros((b * r ** 3,)).index_add(
        0, lin, features.new_ones((b * n,)))
    grid = sums / torch.clamp(cnt, min=1.0)[:, None]
    return grid.reshape(b, r, r, r, c)


def trilinear_devoxelize(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid (B, R, R, R, C), coords (B, N, 3) in [0, R - 1] -> features
    (B, N, C) by trilinear interpolation of the 8 corners, borders clamped."""
    b, r, c = grid.shape[0], grid.shape[1], grid.shape[-1]
    pts = _clip(coords, 0.0, r - 1)
    i0 = torch.floor(pts).long()
    i1 = torch.clamp(i0 + 1, max=r - 1)
    f = pts - i0.to(pts.dtype)
    flat = grid.reshape(b, r ** 3, c)
    out = 0.0
    for corner in range(8):
        bits = [(corner >> d) & 1 for d in range(3)]
        ind = torch.stack([i1[..., d] if bits[d] else i0[..., d] for d in range(3)], dim=-1)
        w = torch.stack([f[..., d] if bits[d] else 1.0 - f[..., d] for d in range(3)],
                        dim=-1).prod(dim=-1)
        lin = _linear_index(ind, r)
        vals = torch.gather(flat, 1, lin[..., None].expand(-1, -1, c))
        out = out + vals * w[..., None]
    return out


def normalize_coords_for_voxelization(xyz: torch.Tensor, resolution: int,
                                      eps: float = 0.0) -> torch.Tensor:
    """PVCNN's normalisation: centre each cloud, scale by twice its largest
    norm, shift to [0, 1], scale by R and clip to [0, R - 1 - eps]."""
    centered = xyz - xyz.mean(dim=1, keepdim=True)
    norm = torch.linalg.vector_norm(centered, dim=-1, keepdim=True).amax(dim=1, keepdim=True)
    unit = centered / (norm * 2.0 + 1e-8) + 0.5
    return _clip(unit * resolution, 0.0, resolution - 1 - eps)
