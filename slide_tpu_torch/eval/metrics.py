"""The generative-model metrics (counterpart: `slide_tpu/eval/metrics.py`):
paired CD / EMD / F-score, the all-pairs distance matrices, MMD and COV,
the 1-NNA two-sample classifier and the occupancy-grid JSD.

The distance matrices are computed on the device (`device`, the card
unless the caller passes "cpu"), a tile of sample rows against a tile of
references at a time; the bookkeeping (argsort, unique, entropy) is numpy
and scipy on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import entropy

from slide_tpu_torch.ops.chamfer import chamfer_parts, fscore
from slide_tpu_torch.ops.emd import earth_mover_distance
from slide_tpu_torch.pipeline import resolve_device

# the (S, R, N, N) tile of a pairwise sweep holds at most this many distances
# (fp32: 1 GB; the EMD keeps a few such arrays: weights, match, increment)
TILE_DISTANCES = 1 << 28


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32).to(device)


@torch.no_grad()
def emd_cd(sample_pcs, ref_pcs, f1_threshold: float = 0.001, device=None) -> dict:
    """Paired metrics between aligned sample and reference sets: {"CD",
    "EMD", "fscore"}, each (B,) on the device."""
    dev = resolve_device(device)
    sample_pcs, ref_pcs = _as_tensor(sample_pcs, dev), _as_tensor(ref_pcs, dev)
    if sample_pcs.shape[0] != ref_pcs.shape[0]:
        raise ValueError("paired metrics need equal set sizes")
    parts = chamfer_parts(sample_pcs, ref_pcs)
    cd = parts["dist_x"].mean(1) + parts["dist_y"].mean(1)
    fs, _, _ = fscore(parts["dist_x"], parts["dist_y"], threshold=f1_threshold)
    return {"CD": cd, "EMD": earth_mover_distance(sample_pcs, ref_pcs), "fscore": fs}


def _pair_block(samples: torch.Tensor, refs: torch.Tensor, with_emd: bool):
    """(S, N, 3) x (R, N, 3) -> (CD (S, R), EMD (S, R) or None)."""
    s, r = samples.shape[0], refs.shape[0]
    a = samples.repeat_interleave(r, dim=0)
    b = refs.repeat(s, 1, 1)
    parts = chamfer_parts(a, b)
    cd = (parts["dist_x"].mean(1) + parts["dist_y"].mean(1)).reshape(s, r)
    emd = earth_mover_distance(a, b).reshape(s, r) if with_emd else None
    return cd, emd


@torch.no_grad()
def pairwise_emd_cd(sample_pcs, ref_pcs, batch_size: int = 32, verbose: bool = False,
                    with_emd: bool = True, device=None):
    """All-pairs CD and EMD matrices (N_sample, N_ref), numpy fp32.
    with_emd=False skips the EMD and returns its matrix filled with NaN (a
    caller that forgets the flag fails loudly instead of reading 0 as a
    perfect score).  Tiles: `batch_size` references against as many
    sample rows as keep the tile's pairwise distances within
    TILE_DISTANCES."""
    dev = resolve_device(device)
    sample_pcs, ref_pcs = _as_tensor(sample_pcs, dev), _as_tensor(ref_pcs, dev)
    n_s, n_r = sample_pcs.shape[0], ref_pcs.shape[0]
    all_cd = np.zeros((n_s, n_r), np.float32)
    all_emd = np.zeros((n_s, n_r), np.float32) if with_emd \
        else np.full((n_s, n_r), np.nan, np.float32)
    s_blk = max(1, min(n_s, batch_size,
                       TILE_DISTANCES // max(1, batch_size * sample_pcs.shape[1]
                                             * ref_pcs.shape[1])))
    for i in range(0, n_s, s_blk):
        rows = sample_pcs[i:i + s_blk]
        for r0 in range(0, n_r, batch_size):
            block = ref_pcs[r0:r0 + batch_size]
            cd, emd = _pair_block(rows, block, with_emd)
            all_cd[i:i + rows.shape[0], r0:r0 + block.shape[0]] = cd.cpu().numpy()
            if with_emd:
                all_emd[i:i + rows.shape[0], r0:r0 + block.shape[0]] = emd.cpu().numpy()
        if verbose:
            print(f"pairwise metrics: {min(i + s_blk, n_s)}/{n_s}", flush=True)
    return all_cd, all_emd


def knn_classifier(m_xx, m_xy, m_yy, k: int = 1, sqrt: bool = False) -> dict:
    """Leave-one-out kNN two-sample test (1-NNA): counts, precision,
    recall, "acc_t", "acc_f" and "acc"."""
    m_xx, m_xy, m_yy = map(np.asarray, (m_xx, m_xy, m_yy))
    n0, n1 = m_xx.shape[0], m_yy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    mat = np.block([[m_xx, m_xy], [m_xy.T, m_yy]]).astype(np.float64)
    if sqrt:
        mat = np.sqrt(np.abs(mat))
    np.fill_diagonal(mat, np.inf)
    idx = np.argsort(mat, axis=0)[:k]
    count = label[idx].sum(axis=0)
    pred = (count >= (k / 2.0)).astype(np.float64)
    tp = (pred * label).sum()
    fp = (pred * (1 - label)).sum()
    fn = ((1 - pred) * label).sum()
    tn = ((1 - pred) * (1 - label)).sum()
    return {"tp": tp, "fp": fp, "fn": fn, "tn": tn,
            "precision": tp / (tp + fp + 1e-10), "recall": tp / (tp + fn + 1e-10),
            "acc_t": tp / (tp + fn + 1e-10), "acc_f": tn / (tn + fp + 1e-10),
            "acc": float((pred == label).mean())}


def lgan_mmd_cov(all_dist) -> dict:
    """MMD and COV of a (N_sample, N_ref) distance matrix."""
    all_dist = np.asarray(all_dist)
    n_ref = all_dist.shape[1]
    return {"lgan_mmd": float(all_dist.min(axis=0).mean()),
            "lgan_cov": float(len(np.unique(all_dist.argmin(axis=1))) / n_ref),
            "lgan_mmd_smp": float(all_dist.min(axis=1).mean())}


def compute_all_metrics(sample_pcs, ref_pcs, batch_size: int = 32, verbose: bool = False,
                        with_emd: bool = True, device=None) -> dict:
    """MMD / COV (CD and EMD) and 1-NNA (CD and EMD); with_emd=False keeps
    the CD family only."""
    def pairwise(a, b):
        return pairwise_emd_cd(a, b, batch_size, verbose=verbose, with_emd=with_emd,
                               device=device)

    results = {}
    m_rs_cd, m_rs_emd = pairwise(ref_pcs, sample_pcs)
    names = (("CD", m_rs_cd), ("EMD", m_rs_emd)) if with_emd else (("CD", m_rs_cd),)
    for name, mat in names:
        for k, v in lgan_mmd_cov(mat.T).items():
            results[f"{k}-{name}"] = v
    m_rr_cd, m_rr_emd = pairwise(ref_pcs, ref_pcs)
    m_ss_cd, m_ss_emd = pairwise(sample_pcs, sample_pcs)
    fams = (("CD", (m_rr_cd, m_rs_cd, m_ss_cd)),
            ("EMD", (m_rr_emd, m_rs_emd, m_ss_emd))) if with_emd \
        else (("CD", (m_rr_cd, m_rs_cd, m_ss_cd)),)
    for name, (rr, rs, ss) in fams:
        one_nn = knn_classifier(rr, rs, ss, k=1, sqrt=False)
        results.update({f"1-NN-{name}-{k}": v for k, v in one_nn.items() if "acc" in k})
    return results


# ---------------------------------------------------------------------------
# JSD of occupancy grids


def unit_cube_grid_point_cloud(resolution: int, clip_sphere: bool = False):
    """The centres of a resolution^3 grid over [-0.5, 0.5]^3 and its
    spacing; with clip_sphere, only the centres inside the unit sphere."""
    spacing = 1.0 / (resolution - 1)
    lin = np.arange(resolution, dtype=np.float32) * spacing - 0.5
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    if clip_sphere:
        grid = grid.reshape(-1, 3)
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


def entropy_of_occupancy_grid(pclouds, grid_resolution: int, in_sphere: bool = False):
    """(mean Bernoulli entropy per cell, per-cell point counts).  A point's
    cell is its nearest grid centre, found by rounding; with `in_sphere` the
    cells outside the unit sphere are dropped and points there go to the
    nearest cell inside."""
    pclouds = np.asarray(pclouds)
    res = grid_resolution
    spacing = 1.0 / (res - 1)
    centers = unit_cube_grid_point_cloud(res, clip_sphere=False)[0].reshape(-1, 3)
    if in_sphere:
        keep = np.linalg.norm(centers, axis=1) <= 0.5
        lut = -np.ones(len(centers), np.int64)
        lut[keep] = np.arange(int(keep.sum()))
        centers_in = centers[keep]
    else:
        lut = np.arange(len(centers))
        centers_in = centers
    n_cells = len(centers_in)
    grid_counters = np.zeros(n_cells)
    grid_bernoulli = np.zeros(n_cells)
    for pc in pclouds:
        idx3 = np.clip(np.round((pc + 0.5) / spacing).astype(np.int64), 0, res - 1)
        cell = lut[idx3[:, 0] * res * res + idx3[:, 1] * res + idx3[:, 2]]
        miss = cell < 0
        if miss.any():
            d = np.sum((pc[miss, None, :] - centers_in[None]) ** 2, axis=-1)
            cell[miss] = d.argmin(axis=1)
        np.add.at(grid_counters, cell, 1)
        grid_bernoulli[np.unique(cell)] += 1
    n = float(len(pclouds))
    occupied = grid_bernoulli[grid_bernoulli > 0] / n
    acc_entropy = sum(entropy([p, 1.0 - p]) for p in occupied)
    return acc_entropy / n_cells, grid_counters


def jensen_shannon_divergence(p, q) -> float:
    """JSD in bits of two unnormalised distributions."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    if (p < 0).any() or (q < 0).any():
        raise ValueError("negative values")
    if len(p) != len(q):
        raise ValueError("non-equal size")
    p = p / p.sum()
    q = q / q.sum()
    e1, e2 = entropy(p, base=2), entropy(q, base=2)
    return entropy((p + q) / 2.0, base=2) - (e1 + e2) / 2.0


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs, resolution: int = 28) -> float:
    """The JSD of the two sets' in-sphere occupancy counts."""
    s = entropy_of_occupancy_grid(sample_pcs, resolution, True)[1]
    r = entropy_of_occupancy_grid(ref_pcs, resolution, True)[1]
    return jensen_shannon_divergence(s, r)
