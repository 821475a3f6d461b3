"""Autoencoder evaluation (counterpart: `slide_tpu/eval/ae_eval.py`):

  ae_visual_eval            the round trip's clouds at every level, pickled
                            (and optionally `reconstructed_pcd.npz`), per rank;
  gather_ae_visual_results  merges the rank pickles and deletes them;
  ae_quantitative_eval      the last level's losses averaged over a loader,
                            appended to the history pickle.

The round trip runs on `device` (the card unless the caller passes "cpu"):
the keypoints' FPS and the encoder's and decoder's FPS are K3 there.  Draws
come from one generator seeded with `seed` (+ rank), or from the caller's
`noise_fn(shape)` (per batch: the keypoint noise, then the posterior's) and
`start_fn(b, n)` (the FPS starts, in the round trip's order).
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Optional

import numpy as np
import torch

from slide_tpu_torch.eval.mesh_recon import merge_current_with_previous_eval_results
from slide_tpu_torch.ops import sample_keypoints
from slide_tpu_torch.pipeline import resolve_device, seeded_draws


def _prepare_ae_batch(data, trainset_config, keypoint_source, dev, gen, noise_fn):
    """(x = points | unit normals, keypoints, label, points) on the device."""
    points = torch.as_tensor(data["points"], dtype=torch.float32, device=dev)
    normals = torch.as_tensor(data["normals"], dtype=torch.float32, device=dev)
    normals = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    label = torch.as_tensor(np.asarray(data["label"]), dtype=torch.int64, device=dev)
    if keypoint_source == "farthest_points_sampling":
        keypoints, _ = sample_keypoints(
            points, trainset_config["num_keypoints"],
            add_centroid=trainset_config.get("add_centroid_to_keypoints", True),
            random_subsample=trainset_config.get("random_subsample", False), generator=gen)
    else:
        keypoints = torch.as_tensor(data["keypoint"], dtype=torch.float32, device=dev)
    nm = trainset_config.get("keypoint_noise_magnitude", 0)
    if nm > 0:
        keypoints = keypoints + nm * noise_fn(keypoints.shape).to(dev)
    return torch.cat([points, normals], dim=-1), keypoints, label, points


def _stem(iteration: int, epoch: int) -> str:
    return ("shapenet_psr_autoencoder_visualization_result_iteration_%s_epoch_%s"
            % (str(iteration).zfill(8), str(epoch).zfill(4)))


@torch.no_grad()
def ae_visual_eval(ae, loader, save_dir: str, iteration: int, epoch: int,
                   trainset_config: dict, *, rank: int = 0, world_size: int = 1,
                   save_reconstructed_pcd: bool = False,
                   keypoint_source: str = "farthest_points_sampling",
                   save_keypoint_feature: bool = False, seed: int = 0, device=None,
                   noise_fn: Optional[Callable] = None,
                   start_fn: Optional[Callable] = None) -> str:
    """Pickle {"hierarchical_pointcloud": [per level (S, N_l, F)], "label",
    "category", "category_name", "gt_points", "model"} for the loader's
    shapes; returns the pickle's path."""
    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    save_file = os.path.join(save_dir, _stem(iteration, epoch)
                             + (f"_rank_{rank}.pkl" if world_size > 1 else ".pkl"))
    gen, noise_fn, start_fn = seeded_draws(dev, seed + rank, noise_fn, start_fn)
    total_xyz = None
    acc = {"label": [], "category": [], "category_name": [], "model": [], "gt_points": [],
           "keypoint": [], "keypoint_feature": []}
    for data in loader:
        x, keypoints, label, points = _prepare_ae_batch(data, trainset_config,
                                                        keypoint_source, dev, gen, noise_fn)
        l_xyz, _, feat = ae(x, keypoints, label=label, loss_type="cd_p", noise_fn=noise_fn,
                            start_fn=start_fn, return_keypoint_feature=True)
        levels = [v.cpu().numpy() for v in l_xyz]
        total_xyz = [[v] for v in levels] if total_xyz is None else \
            [t + [v] for t, v in zip(total_xyz, levels)]
        acc["keypoint"].append(keypoints.cpu().numpy())
        if save_keypoint_feature:
            acc["keypoint_feature"].append(feat.cpu().numpy())
        acc["gt_points"].append(points.cpu().numpy())
        acc["label"].append(label.cpu().numpy())
        for k in ("category", "category_name", "model"):
            acc[k] += list(data.get(k, []))

    total_xyz = [np.concatenate(v, axis=0) for v in total_xyz]
    label = np.concatenate(acc["label"], axis=0)
    payload = {"hierarchical_pointcloud": total_xyz, "label": label,
               "category": acc["category"], "category_name": acc["category_name"],
               "gt_points": np.concatenate(acc["gt_points"], axis=0), "model": acc["model"]}
    with open(save_file, "wb") as f:
        pickle.dump(payload, f)
    if save_reconstructed_pcd:
        last = total_xyz[-1]
        result = {"points": last[..., :3], "label": label, "category": acc["category"],
                  "category_name": acc["category_name"], "model": acc["model"],
                  "keypoint": np.concatenate(acc["keypoint"], axis=0)}
        if last.shape[2] == 6:
            result["normals"] = last[..., 3:6]
        if save_keypoint_feature:
            result["keypoint_feature"] = np.concatenate(acc["keypoint_feature"], axis=0)
        np.savez(os.path.join(save_dir, "reconstructed_pcd.npz"), **result)
    return save_file


def gather_ae_visual_results(save_dir: str, iteration: int, epoch: int,
                             world_size: int) -> str:
    """Merge the rank pickles into one and delete them."""
    stem = _stem(iteration, epoch)
    result = {}
    gathered = []
    for rank in range(world_size):
        rank_file = os.path.join(save_dir, stem + f"_rank_{rank}.pkl")
        with open(rank_file, "rb") as f:
            data = pickle.load(f)
        for k, v in data.items():
            if k not in result:
                result[k] = v
            elif isinstance(v, np.ndarray):
                result[k] = np.concatenate([result[k], v], axis=0)
            elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
                result[k] = [np.concatenate([a, b], axis=0) for a, b in zip(result[k], v)]
            else:
                result[k] = result[k] + v
        gathered.append(rank_file)
    save_file = os.path.join(save_dir, stem + ".pkl")
    with open(save_file, "wb") as f:
        pickle.dump(result, f)
    for fpath in gathered:
        os.remove(fpath)
    return save_file


@torch.no_grad()
def ae_quantitative_eval(ae, loader, save_dir: str, iteration: int, epoch: int,
                         trainset_config: dict, *, seed: int = 0,
                         save_file_name: str =
                         "shapenet_psr_autoencoder_quantitative_eval_result.pkl",
                         device=None, noise_fn: Optional[Callable] = None,
                         start_fn: Optional[Callable] = None) -> dict:
    """The last level's losses averaged over the loader's shapes, appended
    to the history pickle; returns this checkpoint's results."""
    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    save_file = os.path.join(save_dir, save_file_name)
    gen, noise_fn, start_fn = seeded_draws(dev, seed, noise_fn, start_fn)
    sums, count = {}, 0
    for data in loader:
        x, keypoints, label, points = _prepare_ae_batch(
            data, trainset_config, "farthest_points_sampling", dev, gen, noise_fn)
        _, loss_list = ae(x, keypoints, label=label, loss_type="cd_p", noise_fn=noise_fn,
                          start_fn=start_fn)
        b = points.shape[0]
        for k, v in loss_list[-1].items():
            sums[k] = sums.get(k, 0.0) + float(torch.mean(v)) * b
        count += b
    current = {"iter": iteration, "epoch": epoch}
    current.update({k: v / max(count, 1) for k, v in sums.items()})
    merge_current_with_previous_eval_results(current, save_file)
    return current
