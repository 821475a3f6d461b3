"""Chamfer distance, the feature ("normal") chamfer and the F-score
(counterpart: `slide_tpu/ops/chamfer.py`), differentiable: the autoencoder
trains through them.

Each point's nearest neighbour is chosen on the clamped matmul-form squared
distance (`pairwise_sqdist`, fp32, TF32 off; ties to the lowest index), and
the chosen distance is then recomputed in difference form, which is exact
for close pairs: the matmul form cancels to exact zeros there, and the
square root's infinite gradient at 0 turned AE training to NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

from slide_tpu_torch.ops.grouping import gather_points
from slide_tpu_torch.ops.neighbors import pairwise_sqdist


def chamfer_parts(x: torch.Tensor, y: torch.Tensor,
                  x_feat: Optional[torch.Tensor] = None,
                  y_feat: Optional[torch.Tensor] = None,
                  normal_loss_type: str = "cos") -> dict:
    """Per-point nearest-neighbour squared distances both ways: x (B, P1, 3),
    y (B, P2, 3) -> "dist_x" (B, P1), "dist_y" (B, P2), "idx_x", "idx_y";
    with per-point features (B, P, F) also "feat_x" / "feat_y", each point's
    feature loss against its nearest neighbour's: "cos" 1 - |cosine| (norms
    floored at 1e-6), "mse" the summed squared difference."""
    with torch.no_grad():
        d = pairwise_sqdist(x, y)
        idx_x = torch.argmin(d, dim=2)
        idx_y = torch.argmin(d, dim=1)
        del d
    dist_x = torch.sum((x - gather_points(y, idx_x)) ** 2, dim=-1)
    dist_y = torch.sum((y - gather_points(x, idx_y)) ** 2, dim=-1)
    out = {"dist_x": dist_x, "dist_y": dist_y, "idx_x": idx_x, "idx_y": idx_y}
    if x_feat is not None and y_feat is not None:
        y_near = gather_points(y_feat, idx_x)
        x_near = gather_points(x_feat, idx_y)
        if normal_loss_type == "cos":
            out["feat_x"] = 1.0 - torch.abs(_cosine(x_feat, y_near))
            out["feat_y"] = 1.0 - torch.abs(_cosine(y_feat, x_near))
        elif normal_loss_type == "mse":
            out["feat_x"] = torch.sum((x_feat - y_near) ** 2, dim=-1)
            out["feat_y"] = torch.sum((y_feat - x_near) ** 2, dim=-1)
        else:
            raise ValueError(f"normal loss type {normal_loss_type} not supported")
    return out


def _safe_sqrt(d: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sqrt with a bounded gradient at 0; torch.maximum, as jnp.maximum,
    passes half the gradient at a tie."""
    return torch.sqrt(torch.maximum(d, d.new_tensor(eps)))


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    na = torch.maximum(torch.linalg.vector_norm(a, dim=-1), a.new_tensor(eps))
    nb = torch.maximum(torch.linalg.vector_norm(b, dim=-1), b.new_tensor(eps))
    return torch.sum(a * b, dim=-1) / (na * nb)


def fscore(dist1: torch.Tensor, dist2: torch.Tensor, threshold: float = 0.0001):
    """F-score from SQUARED per-point distances: (fscore, precision1,
    precision2), each (B,); 0 where both precisions are 0."""
    p1 = (dist1 < threshold).float().mean(dim=1)
    p2 = (dist2 < threshold).float().mean(dim=1)
    denom = p1 + p2
    f = torch.where(denom > 0, 2.0 * p1 * p2 / torch.where(denom > 0, denom,
                                                            torch.ones_like(denom)),
                    torch.zeros_like(denom))
    return f, p1, p2


def calc_cd(output: torch.Tensor, gt: torch.Tensor, *, calc_f1: bool = False,
            f1_threshold: float = 0.0001, normal_loss_type: str = "cos") -> dict:
    """Chamfer metrics of (B, N, F) clouds, xyz first and point features
    after.  dist1 is gt -> output, dist2 output -> gt.  Returns (B,) values:
    "cd_p" (mean euclidean, averaged over the directions), "cd_t" (the sum of
    the mean squared), with features "cd_feature_p" / "cd_feature_t", with
    `calc_f1` "f1"."""
    parts = chamfer_parts(gt[..., :3], output[..., :3],
                          x_feat=gt[..., 3:] if gt.shape[-1] > 3 else None,
                          y_feat=output[..., 3:] if output.shape[-1] > 3 else None,
                          normal_loss_type=normal_loss_type)
    dist1, dist2 = parts["dist_x"], parts["dist_y"]
    result = {"cd_p": (_safe_sqrt(dist1).mean(1) + _safe_sqrt(dist2).mean(1)) / 2.0,
              "cd_t": dist1.mean(1) + dist2.mean(1)}
    if "feat_x" in parts:
        f1p, f2p = parts["feat_x"], parts["feat_y"]
        result["cd_feature_p"] = (_safe_sqrt(f1p).mean(1) + _safe_sqrt(f2p).mean(1)) / 2.0
        result["cd_feature_t"] = f1p.mean(1) + f2p.mean(1)
    if calc_f1:
        result["f1"], _, _ = fscore(dist1, dist2, threshold=f1_threshold)
    return result
