"""Approximate Earth Mover's Distance (counterpart: `slide_tpu/ops/emd.py`,
the reference's `approxmatch` kernel).

A soft matching refined over 10 annealing levels, -4^j for j = 7..-1 and
then 0: each round weighs every pair by exp(level * d), takes row ratios
from the left mass still unmatched, consumes right mass capped at what is
left of it and adds the transported mass to the match.  The cost is
sum(match * squared distance) / max(n, m).  The match is held constant in
the backward (as the JAX package's `stop_gradient`): gradients flow through
the distance term only.

Plain PyTorch (the JAX package's is plain `jnp` under `lax.scan`, not a
Pallas kernel): a few (n, m) products a round, in fp32 with TF32 off, on
the device of its inputs.  At level -4^7 = -16384 a rounding gap of delta
in a squared distance is a relative gap of 16384 delta in its weight, so
two fp32 implementations agree to ~1e-3 relative on a match, not to fp32
rounding (`tests/test_torch_eval.py` states the measured gap).
"""

from __future__ import annotations

import numpy as np
import torch

from slide_tpu_torch.ops.neighbors import pairwise_sqdist

# the annealing levels -4^j for j = 7..-1, then 0 (fp32, as the JAX scan's)
LEVELS = tuple(float(v) for v in np.float32(
    np.append(-np.power(4.0, np.arange(7, -2, -1, dtype=np.float64)), 0.0)))


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate transport plan between (B, n, 3) and (B, m, 3) clouds:
    match (B, n, m), row sums ~ the left multiplier and column sums ~ the
    right one (m // n or n // m, by integer division, on the smaller side's
    partner)."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    d = pairwise_sqdist(xyz1, xyz2)
    if n >= m:
        multi_l, multi_r = 1.0, float(n // m)
    else:
        multi_l, multi_r = float(m // n), 1.0
    match = torch.zeros((b, n, m), dtype=torch.float32, device=d.device)
    remain_l = torch.full((b, n), multi_l, dtype=torch.float32, device=d.device)
    remain_r = torch.full((b, m), multi_r, dtype=torch.float32, device=d.device)
    for level in LEVELS:
        w = torch.exp(level * d)
        suml = torch.bmm(w, remain_r[:, :, None])[..., 0] + 1e-9
        ratio_l = remain_l / suml
        sumr = torch.bmm(ratio_l[:, None, :], w)[:, 0] * remain_r
        consumption = torch.clamp(remain_r / (sumr + 1e-9), max=1.0)
        ratio_r = consumption * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        delta = w * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + delta
        remain_l = torch.clamp(remain_l - delta.sum(dim=2), min=0.0)
    return match


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Per-pair approximate EMD (B,): the squared-distance transport cost over
    max(n, m), differentiable in both clouds through the distance term."""
    with torch.no_grad():
        match = approx_match(xyz1, xyz2)
    cost = torch.sum(match * pairwise_sqdist(xyz1, xyz2), dim=(1, 2))
    return cost / max(xyz1.shape[1], xyz2.shape[1])
