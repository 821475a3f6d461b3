"""Gather / group / masked pooling / 3-point interpolation (counterpart:
`slide_tpu/ops/grouping.py`).  Channels-last: features (B, N, C)."""

from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m] = points[b, idx[b, m]].  (B, N, C) x (B, M) -> (B, M, C)."""
    return torch.take_along_dim(points, idx.long()[..., None], dim=1)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m, k] = points[b, idx[b, m, k]].  (B, N, C) x (B, M, K) ->
    (B, M, K, C)."""
    b, m, k = idx.shape
    flat = gather_points(points, idx.reshape(b, m * k))
    return flat.reshape(b, m, k, points.shape[-1])


def count_to_mask(count: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M) neighbour counts -> (B, M, K) bool mask, slot j valid iff j < count."""
    return torch.arange(k, device=count.device) < count[..., None]


def masked_max_pool(feature: torch.Tensor, count=None) -> torch.Tensor:
    """Max over the neighbour axis of (B, M, K, C); empty slots repeat a real
    neighbour, so no mask is needed."""
    return torch.amax(feature, dim=-2)


def masked_avg_pool(feature: torch.Tensor, count) -> torch.Tensor:
    """Mean over the valid neighbour slots; `count` (B, M) or 'all'."""
    if isinstance(count, str):
        if count != "all":
            raise ValueError(count)
        return torch.mean(feature, dim=-2)
    count = torch.clamp(count, min=1)
    mask = count_to_mask(count, feature.shape[-2])[..., None].to(feature.dtype)
    return torch.sum(feature * mask, dim=-2) / count[..., None].to(feature.dtype)


def pool_features(feature: torch.Tensor, count=None, pooling: str = "max"):
    """'max', 'avg', or 'avg_max' / 'max_avg' (first half of the channels
    max-pooled, the rest averaged)."""
    if pooling == "max":
        return masked_max_pool(feature, count)
    if pooling == "avg":
        return masked_avg_pool(feature, count)
    if "avg" in pooling and "max" in pooling:
        half = feature.shape[-1] // 2
        return torch.cat([masked_max_pool(feature[..., :half], count),
                          masked_avg_pool(feature[..., half:], count)], dim=-1)
    raise ValueError(f"{pooling} pooling is not supported")


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features (B, M, C), idx and weight (B, n, 3) -> (B, n, C)."""
    grouped = group_points(features, idx)
    return torch.sum(grouped * weight[..., None].to(grouped.dtype), dim=-2)


def interp_weights_from_dists(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """w_i = (1/(d_i+eps)) / sum_j 1/(d_j+eps)."""
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)
