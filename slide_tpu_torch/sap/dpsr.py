"""Differentiable Poisson surface reconstruction (DPSR), the spectral solver of
Shape-As-Points (counterpart: `slide_tpu/sap/dpsr.py`).

Trilinear scatter of the point normals onto a periodic grid -> rfftn ->
gaussian spectral filter -> divergence in frequency space -> divide by the
Laplacian's eigenvalues -> irfftn -> shift (zero mean at the input points)
and scale (the indicator at the grid origin maps to +-0.5).  fp32 and
complex64 throughout; the FFTs are `torch.fft` (cuFFT on the card), the
inverse written out so that it reads the spectrum as the CPU's FFT does
(`_irfftn`).

The scatter is `index_add_`, whose sums run in no fixed order on the card:
card and CPU agree to rounding, not bit for bit.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch
from torch import nn


def fftfreqs(res: Sequence[int]) -> np.ndarray:
    """Integer FFT frequencies on the half-spectrum grid:
    (res0, res1, res2//2+1, ndim)."""
    freqs = [np.fft.fftfreq(r, d=1.0 / r) for r in res[:-1]]
    freqs.append(np.fft.rfftfreq(res[-1], d=1.0 / res[-1]))
    omega = np.stack(np.meshgrid(*freqs, indexing="ij"), axis=-1)
    return omega.astype(np.float32)


def spec_gaussian_filter(res: Sequence[int], sig: float) -> np.ndarray:
    """exp(-0.5 * (sig*2*|w|/res0)^2) on the half-spectrum:
    (res0, res1, res2//2+1)."""
    omega = fftfreqs(res).astype(np.float64)
    dis = np.sqrt(np.sum(omega ** 2, axis=-1))
    return np.exp(-0.5 * ((sig * 2.0 * dis / res[0]) ** 2)).astype(np.float32)


_CORNERS = torch.tensor(list(itertools.product((0, 1), repeat=3)), dtype=torch.float32)


def _corner_data(pts: torch.Tensor, res: Sequence[int]):
    """Trilinear corner indices and weights with periodic wrap-around.
    pts (B, N, 3) in [0, 1) -> (idx (B, N, 8, 3) int64, weights (B, N, 8)).
    `pts / cube` with cube = 1/size, as the JAX package writes it: it
    decides the floor at cell boundaries."""
    size = torch.tensor(res, dtype=pts.dtype, device=pts.device)
    cube = 1.0 / size
    ind0 = torch.floor(pts / cube)
    ind1 = torch.remainder(torch.ceil(pts / cube), size)       # periodic
    c = _CORNERS.to(pts.device, pts.dtype)[None, None]          # (1, 1, 8, 3)
    idx = torch.where(c == 0, ind0[:, :, None, :], ind1[:, :, None, :])
    # weight = product over dims of |pt - the OPPOSITE corner| / cube
    xyz0 = ind0 * cube
    xyz1 = (ind0 + 1.0) * cube
    pos_opp = torch.where(c == 0, xyz1[:, :, None, :], xyz0[:, :, None, :])
    # |.| with jnp.abs's derivative, +1 at 0: a point on a grid plane moves
    # its weights as a point of the cell it was put in (torch.abs gives 0)
    diff = pts[:, :, None, :] - pos_opp
    d = torch.where(diff >= 0, diff, -diff) / cube
    weights = d[..., 0] * d[..., 1] * d[..., 2]
    return idx.long(), weights


def _linear(idx: torch.Tensor, res: Sequence[int]) -> torch.Tensor:
    return idx[..., 0] * (res[1] * res[2]) + idx[..., 1] * res[2] + idx[..., 2]


def point_rasterize(pts: torch.Tensor, vals: torch.Tensor,
                    res: Sequence[int]) -> torch.Tensor:
    """Trilinear scatter-add of per-point values onto the grid: pts (B, N, 3)
    in [0, 1), vals (B, N, F) -> (B, F, *res)."""
    b, n, _ = pts.shape
    nf = vals.shape[-1]
    cells = int(np.prod(res))
    idx, w = _corner_data(pts, res)
    lin = _linear(idx, res) + torch.arange(b, device=pts.device)[:, None, None] * cells
    contrib = w[..., None] * vals[:, :, None, :]                # (B, N, 8, F)
    grid = torch.zeros((b * cells, nf), dtype=vals.dtype, device=vals.device)
    grid.index_add_(0, lin.reshape(-1), contrib.reshape(-1, nf))
    return grid.reshape(b, *res, nf).movedim(-1, 1)


def grid_interp(grid: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation with periodic wrap-around: grid (B, *res, F),
    pts (B, N, 3) in [0, 1) -> (B, N, F)."""
    b = grid.shape[0]
    res = grid.shape[1:-1]
    idx, w = _corner_data(pts, res)
    flat = grid.reshape(b, -1, grid.shape[-1])
    lat = flat[torch.arange(b, device=grid.device)[:, None, None], _linear(idx, res)]
    return torch.sum(lat * w[..., None], dim=-2)


def _irfftn(spec: torch.Tensor, res: Sequence[int]) -> torch.Tensor:
    """`irfftn(spec, s=res)` over dims (1, 2, 3) as the CPU's FFT (and the JAX
    package's on the CPU) computes it: the inverse along dims 1 and 2, then
    the real inverse along the last dim, reading only the real parts of its
    zero and Nyquist bins.  DPSR's spectrum is not Hermitian in those bins
    (the divergence's odd factor omega at the Nyquist frequency), and cuFFT's
    multi-dimensional real inverse reads them otherwise: 3e-4 of the field
    apart at 128^3."""
    half = torch.fft.ifftn(spec, dim=(1, 2))
    half[..., 0].imag.zero_()
    if res[-1] % 2 == 0:
        half[..., -1].imag.zero_()
    return torch.fft.irfft(half, n=res[-1], dim=3)


class DPSR(nn.Module):
    """The spectral Poisson solver, with the gaussian filter `G` and the
    angular frequencies `omega` as buffers.  `forward(v, n)` is
    `shift_and_scale(solve(point_rasterize(v, n, res)), v)`."""

    def __init__(self, res: Sequence[int], sig: float = 10):
        super().__init__()
        self.res = tuple(res)
        self.sig = sig
        self.register_buffer("G", torch.from_numpy(spec_gaussian_filter(self.res, sig)))
        self.register_buffer("omega",
                             torch.from_numpy(fftfreqs(self.res) * (2.0 * np.pi)))

    def solve(self, ras: torch.Tensor) -> torch.Tensor:
        """The raster (B, 3, *res) -> the unshifted, unscaled field (B, *res)."""
        spec = torch.fft.rfftn(ras, dim=(2, 3, 4)).movedim(1, -1)   # (B, r, r, rc, 3)
        filtered = spec * self.G[None, ..., None]
        # divergence in frequency space: DivN = -i * sum_d N_d * omega_d
        div = -1j * torch.sum(filtered * self.omega[None], dim=-1)   # (B, r, r, rc)
        lap = -torch.sum(self.omega ** 2, dim=-1)                    # (r, r, rc)
        phi_s = div / (lap[None] + 1e-6)
        phi_s[:, 0, 0, 0] = 0.0                                      # zero DC
        return _irfftn(phi_s, self.res)

    def shift_and_scale(self, phi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Zero mean at the points `v`; the origin's value mapped to +-0.5
        (the field divided by -2 |phi[origin]|)."""
        fv = grid_interp(phi[..., None], v)[..., 0]                  # (B, nv)
        phi = phi - torch.mean(fv, dim=-1).reshape(-1, 1, 1, 1)
        fv0 = phi[:, 0, 0, 0]
        return -phi / torch.abs(fv0).reshape(-1, 1, 1, 1) * 0.5

    def forward(self, v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        """v: (B, nv, 3) points in [0, 1); n: (B, nv, 3) normals -> the
        indicator field phi (B, *res), in fp32 (float64 for float64 points
        and a solver cast with `.double()`, the reference of gradient
        checks)."""
        if v.shape != n.shape:
            raise ValueError("points and normals must have the same shape")
        dtype = torch.float64 if v.dtype == torch.float64 else torch.float32
        v = v.to(dtype)
        ras = point_rasterize(v, n.to(dtype), self.res)              # (B, 3, *res)
        return self.shift_and_scale(self.solve(ras), v)
