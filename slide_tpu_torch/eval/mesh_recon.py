"""SAP / mesh-reconstruction evaluation (counterpart:
`slide_tpu/eval/mesh_recon.py`):

  sap_grid_eval       the DPSR-grid L2 over a loader (the metric that picks
                      a SAP checkpoint), appended to the history pickle,
                      with the training-curve plot;
  reconstruct_meshes  the whole mesh path: the SAP net's split -> DPSR ->
                      marching tetrahedra -> optionally back to the input's
                      scale -> PLY meshes and clouds, optionally points
                      sampled from each mesh (npz).

The net, DPSR and the extraction run on `device` (the card unless the
caller passes "cpu"; the SAP net's SA levels run K3 there, the extraction
is `sap/marching_gpu.py`); the meshes then come to the host
(`mesh_to_host`), where one worker thread writes batch i's files while the
device runs batch i + 1.  The JAX package's float16 transfer of the grids
is not ported: it serves a TPU behind a remote link.  `reconstruct_meshes`
can put an autoencoder's round trip in front of the net (`ae_fns`, then
`noise_magnitude` gaussian noise).  The draws (the round trip's, the
noise, the mirror's permutation of n points, in that order) come from one
generator seeded with `seed` (+ rank), or from the caller's
`noise_fn(shape)` and `perm_fn(n)`.
"""

from __future__ import annotations

import os
import pickle
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from slide_tpu_torch.ops import sample_keypoints
from slide_tpu_torch.pipeline import resolve_device
from slide_tpu_torch.sap import (compute_center_and_max_length, marching_tetrahedra_device,
                                 mesh_to_host, mirror_and_concat,
                                 network_output_to_dpsr_grid)
from slide_tpu_torch.sap.mesh_sampling import (sample_points_from_mesh,
                                               uniform_sample_points_from_mesh)
from slide_tpu_torch.vis.ply import batch_save_pcd, save_mesh_ply


def _draws(dev, seed: int, perm_fn, noise_fn=None):
    """(perm_fn(n), noise_fn(shape)): the caller's, or drawn from one
    generator on `dev` seeded with `seed`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if perm_fn is None:
        def perm_fn(n):
            return torch.randperm(n, generator=gen, device=dev)
    if noise_fn is None:
        def noise_fn(shape):
            return torch.randn(tuple(shape), generator=gen, device=dev)
    return perm_fn, noise_fn


def _prepare_sap_input(data, trainset_config, dpsr_config, dev, perm_fn, *,
                       ae_fns: Optional[Callable] = None, noise_magnitude: float = 0.0,
                       noise_fn: Optional[Callable] = None):
    """The net's input: points | unit normals (or zeros), optionally the
    autoencoder's round trip `ae_fns(x, keypoint, label, noise_fn)` on the
    cloud's FPS keypoints (the centroid first) and `noise_magnitude` noise,
    then the mirror with its +1 / -1 tags."""
    x = torch.as_tensor(data["points"], dtype=torch.float32, device=dev)
    label = torch.as_tensor(np.asarray(data["label"]), dtype=torch.int64, device=dev)
    if trainset_config.get("include_normals", True):
        normals = torch.as_tensor(data["normals"], dtype=torch.float32, device=dev)
        normals = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
        x = torch.cat([x, normals], dim=-1)
    else:
        x = torch.cat([x, torch.zeros_like(x)], dim=-1)
    if ae_fns is not None:
        keypoint, _ = sample_keypoints(x[..., :3], trainset_config["num_keypoints"],
                                       add_centroid=True)
        x = ae_fns(x, keypoint, label, noise_fn)
        if noise_magnitude > 0:
            x = x + noise_magnitude * noise_fn(x.shape).to(x.device)
    if dpsr_config.get("mirror_before_upsampling", False):
        permute = not dpsr_config.get("only_original_points_split", False)
        x = mirror_and_concat(x, axis=2, attach_label=True, permute=permute,
                              perm=perm_fn(2 * x.shape[1]) if permute else None)[0]
    return x, label


@torch.no_grad()
def sap_grid_eval(net, dpsr, loader, pointnet_config: dict, dpsr_config: dict,
                  trainset_config: dict, save_dir: str, iteration: int, epoch: int, *,
                  scale: float = 1, seed: int = 0,
                  save_file_name: str = "shapenet_psr_dpsr_eval_result.pkl", device=None,
                  perm_fn: Optional[Callable] = None) -> float:
    """The mean over the loader's shapes of each batch's mean squared gap
    between the DPSR grid of the net's split cloud and the batch's `psr`;
    appended to the history pickle, whose training curve is then plotted
    (skipped, with a message, where matplotlib is missing).  Returns it."""
    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    save_file = os.path.join(save_dir, save_file_name)
    perm_fn, _ = _draws(dev, seed, perm_fn)
    total, count = 0.0, 0
    for data in loader:
        x, label = _prepare_sap_input(data, trainset_config, dpsr_config, dev, perm_fn)
        psr_gt = torch.as_tensor(data["psr"], dtype=torch.float32, device=dev)
        disp = net(x, ts=None, label=label)
        grid, _, _ = network_output_to_dpsr_grid(
            x, disp, dpsr, scale, pointnet_config,
            last_dim_as_indicator=dpsr_config.get("mirror_before_upsampling", False),
            only_original_points_split=dpsr_config.get("only_original_points_split", False))
        b = psr_gt.shape[0]
        total += float(torch.mean((grid - psr_gt) ** 2)) * b
        count += b
    loss = total / max(count, 1)
    merge_current_with_previous_eval_results(
        {"iter": iteration, "dpsr_grid_L2_loss": loss, "epoch": epoch}, save_file)
    try:
        plot_result(save_file, "dpsr_grid_L2_loss")
    except Exception as e:  # noqa: BLE001  the plot is a by-product: report and go on
        print(f"plotting skipped: {e}")
    return loss


def _write_batch(grid_mesh, x, refined_p, refined_n, label, cat, center, max_len,
                 start_idx: int, rng_seed: int, dirs: dict, mirror_first: bool,
                 return_original_scale: bool, do_sample_points_from_mesh: bool) -> dict:
    """The host side of one batch: its noisy and refined clouds and meshes
    as PLY files, and (optionally) points sampled from each mesh."""
    x = x.cpu().numpy()
    refined_p, refined_n = refined_p.cpu().numpy(), refined_n.cpu().numpy()
    label, center, max_len = label.cpu().numpy(), center.cpu().numpy(), max_len.cpu().numpy()
    rng = np.random.default_rng(rng_seed)
    batch_save_pcd(dirs["noisy"], "noisy_pcd", x[..., :3], batch_info=cat,
                   normals=x[..., 3:6], indicator=x[..., -1] if mirror_first else None,
                   start_idx=start_idx)
    batch_save_pcd(dirs["refined"], "refined_pcd", refined_p, batch_info=cat,
                   normals=refined_n, start_idx=start_idx)
    out = {k: [] for k in ("points", "normals", "uniform_points", "uniform_normals",
                           "label")}
    for i in range(x.shape[0]):
        try:
            v, f, n = mesh_to_host(grid_mesh, i)
        except ValueError:
            print(f"mesh {start_idx + i}: empty surface (no level crossing)", flush=True)
            continue
        if return_original_scale:
            c = (v.max(0) + v.min(0)) / 2
            ml = (v.max(0) - v.min(0)).max()
            v = (v - c) / ml * max_len[i, 0, 0] + center[i, 0]
        tag = cat[i] if cat is not None else "reconstructed_mesh"
        save_mesh_ply(os.path.join(dirs["mesh"], f"{tag}_{str(start_idx + i).zfill(5)}.ply"),
                      v, f, n)
        if do_sample_points_from_mesh:
            p2k, n2k = sample_points_from_mesh(v, f, 2048, rng)
            pu, nu = uniform_sample_points_from_mesh(v, f, 2048, rng=rng)
            out["points"].append(p2k[None])
            out["normals"].append(n2k[None])
            out["uniform_points"].append(pu[None])
            out["uniform_normals"].append(nu[None])
            out["label"].append(label[i:i + 1])
    return out


@torch.no_grad()
def reconstruct_meshes(net, dpsr, loader, pointnet_config: dict, dpsr_config: dict,
                       trainset_config: dict, save_dir: str, *, iteration: int = 0,
                       epoch: int = 0, scale: float = 1, seed: int = 0, rank: int = 0,
                       do_sample_points_from_mesh: bool = False,
                       explicit_normalize: bool = False,
                       return_original_scale: bool = False,
                       label_number: Optional[int] = None,
                       ae_fns: Optional[Callable] = None, noise_magnitude: float = 0.0,
                       device=None, perm_fn: Optional[Callable] = None,
                       noise_fn: Optional[Callable] = None) -> str:
    """The whole reconstruction path.  Writes under
    <save_dir>/visualization_results_at_iteration_<it>_epoch_<ep>/ the
    noisy and refined clouds (noisy_pcd/, refined_pcd/), the meshes
    (reconstructed_mesh/) and, with `do_sample_points_from_mesh`,
    points_sampled_from_mesh.npz and uniform_points_sampled_from_mesh.npz
    (points, normals, label).  Returns that directory.

    label_number: the class of every shape of a loader whose batches carry
    no label.  explicit_normalize: the split cloud's normals normalised
    before DPSR (`network_output_to_dpsr_grid`).  ae_fns(x, keypoint,
    label, noise_fn) -> x: an autoencoder's round trip on each cloud first
    (its keypoints FPS of the cloud with the centroid first), then
    `noise_magnitude` noise."""
    dev = resolve_device(device)
    vis_dir = os.path.join(save_dir, "visualization_results_at_iteration_%s_epoch_%s"
                           % (str(iteration).zfill(8), str(epoch).zfill(4)))
    dirs = {"noisy": os.path.join(vis_dir, "noisy_pcd"),
            "refined": os.path.join(vis_dir, "refined_pcd"),
            "mesh": os.path.join(vis_dir, "reconstructed_mesh")}
    if do_sample_points_from_mesh:
        dirs["points"] = os.path.join(vis_dir, "points_sampled_from_mesh")
        dirs["uniform"] = os.path.join(vis_dir, "uniform_points_sampled_from_mesh")
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    result = {k: [] for k in ("points", "normals", "uniform_points", "uniform_normals",
                              "label")}
    mirror_first = dpsr_config.get("mirror_before_upsampling", False)
    perm_fn, noise_fn = _draws(dev, seed + rank, perm_fn, noise_fn)
    per_rank = getattr(loader.dataset, "num_samples_per_rank", len(loader.dataset))

    def drain(futures):
        batch_out = futures.popleft().result()
        for k in result:
            result[k] += batch_out[k]

    with ThreadPoolExecutor(max_workers=1) as executor:
        futures: deque = deque()
        for batch_idx, data in enumerate(loader):
            if "label" not in data:
                data = dict(data, label=np.full(np.asarray(data["points"]).shape[0],
                                                label_number, np.int64))
            orig = torch.as_tensor(data["points"], dtype=torch.float32, device=dev)
            center, max_len = compute_center_and_max_length(orig)
            x, label = _prepare_sap_input(data, trainset_config, dpsr_config, dev, perm_fn,
                                          ae_fns=ae_fns, noise_magnitude=noise_magnitude,
                                          noise_fn=noise_fn)
            disp = net(x, ts=None, label=label)
            grid, refined_p, refined_n = network_output_to_dpsr_grid(
                x, disp, dpsr, scale, pointnet_config, last_dim_as_indicator=mirror_first,
                only_original_points_split=dpsr_config.get("only_original_points_split",
                                                           False),
                explicit_normalize=explicit_normalize)
            grid_mesh = marching_tetrahedra_device(grid)
            grid_mesh["corner_pos"] = grid_mesh["corner_pos"] / float(grid.shape[-1])
            start_idx = per_rank * rank + loader.batch_size * batch_idx
            futures.append(executor.submit(
                _write_batch, grid_mesh, x, refined_p, refined_n, label,
                data.get("category_name"), center, max_len, start_idx,
                seed + rank + 1000 * batch_idx, dirs, mirror_first, return_original_scale,
                do_sample_points_from_mesh))
            # at most one batch's host side behind the device
            while len(futures) >= 2:
                drain(futures)
        while futures:
            drain(futures)

    if do_sample_points_from_mesh and result["points"]:
        pts = np.concatenate(result["points"], axis=0)
        nrm = np.concatenate(result["normals"], axis=0)
        lab = np.concatenate(result["label"], axis=0)
        np.savez(os.path.join(vis_dir, "points_sampled_from_mesh.npz"),
                 points=pts, normals=nrm, label=lab)
        np.savez(os.path.join(vis_dir, "uniform_points_sampled_from_mesh.npz"),
                 points=np.concatenate(result["uniform_points"], axis=0),
                 normals=np.concatenate(result["uniform_normals"], axis=0), label=lab)
        batch_save_pcd(dirs["points"], "pcd_from_mesh", pts, normals=nrm)
    return vis_dir


def merge_current_with_previous_eval_results(current: dict, save_file: str) -> dict:
    """Append this checkpoint's metrics to the history pickle."""
    if os.path.isfile(save_file):
        with open(save_file, "rb") as f:
            history = pickle.load(f)
        for k, v in current.items():
            history.setdefault(k, []).append(v)
    else:
        history = {k: [v] for k, v in current.items()}
    with open(save_file, "wb") as f:
        pickle.dump(history, f)
    return history


def plot_result(save_file: str, metric: str, out_png: Optional[str] = None) -> str:
    """The training curve of `metric` from the history pickle, its lowest
    value marked; matplotlib is imported here, where it is used."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(save_file, "rb") as f:
        history = pickle.load(f)
    iters = np.asarray(history["iter"])
    vals = np.asarray(history[metric])
    order = np.argsort(iters)
    iters, vals = iters[order], vals[order]
    best = int(np.argmin(vals))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(iters, vals, marker="o", ms=3)
    ax.scatter([iters[best]], [vals[best]], color="red", zorder=3)
    ax.set_xlabel("iteration")
    ax.set_ylabel(metric)
    ax.set_title(f"lowest {metric}: {vals[best]:.6g} @ iter {iters[best]}")
    out_png = out_png or (os.path.splitext(save_file)[0] + f"_{metric}.png")
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    print(f"lowest {metric} is {vals[best]:.8f} at iteration {iters[best]}", flush=True)
    return out_png
