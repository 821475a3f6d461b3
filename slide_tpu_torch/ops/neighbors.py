"""Neighbour search: brute-force kNN, ball query, 3-NN (counterpart:
`slide_tpu/ops/neighbors.py`).

Every op returns fixed-K index tensors.  Distances are fp32 and clamped at 0;
neighbour order is ascending distance with ties to the lowest index (a stable
sort, as `lax.top_k` is stable).
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (B, M, D) x (B, N, D) -> (B, M, N), in fp32
    as ||x||^2 - 2<x, y> + ||y||^2, clamped at 0."""
    x = x.float()
    y = y.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    inner = torch.bmm(x, y.transpose(1, 2))
    d = x2 - 2.0 * inner + y2.transpose(1, 2)
    # torch.maximum: gradient 0.5 at a tie, as jnp.maximum's; + 0.0 turns a
    # -0.0 into +0.0 so equal distances compare equal in the sort
    return torch.maximum(d, d.new_zeros(())) + 0.0


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int):
    """k nearest `points` of each query: (sqdists (B, M, k), idx (B, M, k)
    int64), ascending, ties to the lowest index."""
    n = points.shape[1]
    if k > n:
        raise ValueError(f"k={k} > number of points {n}")
    d = pairwise_sqdist(query, points)
    sd, idx = torch.sort(d, dim=-1, stable=True)
    return sd[..., :k], idx[..., :k]


def ball_query(query: torch.Tensor, points: torch.Tensor, radius: float, k: int):
    """The first `k` points in index order with squared distance < radius^2;
    empty slots repeat the first found neighbour (index 0 if none).  Returns
    (idx (B, M, k) int64, counts (B, M) int64, capped at k)."""
    n = points.shape[1]
    d = pairwise_sqdist(query, points)
    mask = d < torch.tensor(radius, dtype=torch.float32) ** 2
    counts = torch.clamp(mask.sum(dim=-1), max=k)
    iota = torch.arange(n, device=query.device).expand_as(d)
    keys = torch.where(mask, iota, iota + n)
    order = torch.topk(keys, k, dim=-1, largest=False, sorted=True).indices
    slot = torch.arange(k, device=query.device)
    idx = torch.where(slot < counts[..., None], order, order[..., :1])
    return idx, counts


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """3 nearest `known` points of each `unknown` one: (euclidean dist
    (B, n, 3), idx (B, n, 3))."""
    sqd, idx = knn_points(unknown, known, 3)
    return torch.sqrt(sqd), idx
