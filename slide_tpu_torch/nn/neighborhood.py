"""Neighbourhood feature assembly (counterpart: `slide_tpu/nn/neighborhood.py`).

Channel order matters for the weights: query_and_group emits [features,
relative_xyz, absolute_xyz?, center_xyz?]; group_knn_features emits
[features, sqdist, weight, absolute_xyz, relative_xyz, center_xyz] (C+11).
"""

from __future__ import annotations

import torch

from slide_tpu_torch.ops import ball_query, group_points, knn_points


def query_and_group(xyz, new_xyz, features=None, *, nsample: int,
                    radius: float = 0.0, neighbor_def: str = "nn",
                    use_xyz: bool = True, include_abs_coordinate: bool = False,
                    include_center_coordinate: bool = False, subset: bool = True):
    """Group each query's neighbourhood: xyz (B, N, 3) sources, new_xyz
    (B, M, 3) queries, features (B, N, C) or None.  'nn' is kNN, 'radius' the
    ball query; with 'radius' and subset=False a query with no neighbour falls
    back to itself with zero features.

    Returns (new_features (B, M, K, C'), counts (B, M))."""
    b, m, _ = new_xyz.shape
    n = xyz.shape[1]
    if neighbor_def == "nn":
        k = min(nsample, n)
        _, idx = knn_points(new_xyz, xyz, k)
        counts = torch.full((b, m), k, dtype=torch.int64, device=xyz.device)
        have_neigh = None
    elif neighbor_def == "radius":
        idx, counts = ball_query(new_xyz, xyz, radius, nsample)
        have_neigh = None if subset else counts > 0
    else:
        raise ValueError(f"neighbor definition {neighbor_def} is not supported")

    abs_xyz = group_points(xyz, idx)
    center = new_xyz[:, :, None, :]
    if have_neigh is not None:
        hn = have_neigh[..., None, None].to(abs_xyz.dtype)
        abs_xyz = hn * abs_xyz + (1.0 - hn) * center
    rel_xyz = abs_xyz - center

    parts = []
    if features is not None:
        grouped = group_points(features, idx)
        if have_neigh is not None:
            grouped = grouped * have_neigh[..., None, None].to(grouped.dtype)
        parts.append(grouped)
    elif not use_xyz:
        raise ValueError("cannot have no features and use_xyz=False")
    if use_xyz:
        parts.append(rel_xyz)
        if include_abs_coordinate:
            parts.append(abs_xyz)
        if include_center_coordinate:
            parts.append(center.expand(b, m, abs_xyz.shape[2], 3))
    return torch.cat(parts, dim=-1), counts


def group_all(xyz, features=None, use_xyz: bool = True):
    """The whole cloud as one neighbourhood: (B, 1, N, C[+3]), channels
    [features, xyz]."""
    grouped_xyz = xyz[:, None, :, :]
    if features is None:
        return grouped_xyz
    grouped = features[:, None, :, :]
    if use_xyz:
        return torch.cat([grouped, grouped_xyz], dim=-1)
    return grouped


def group_knn_features(x, y, features_at_y, k: int):
    """For each point of x (B, N1, 3), its k nearest points of y (B, N2, 3):
    (B, N1, k, C+11) = [features, sqdist, inverse-distance weight, abs xyz,
    relative xyz, center xyz]."""
    sqd, idx = knn_points(x, y, k)
    feats = group_points(features_at_y, idx)
    nn_abs = group_points(y, idx)
    center = x[:, :, None, :]
    nn_rel = nn_abs - center
    d = sqd[..., None]
    recip = 1.0 / (d + 1e-8)
    weight = recip / torch.sum(recip, dim=2, keepdim=True)
    return torch.cat([feats, d, weight, nn_abs, nn_rel, center.expand_as(nn_abs)],
                     dim=-1)
