"""Generation evaluation (counterpart: `slide_tpu/eval/generation.py`).

Per rank: sample a test set's worth of shapes, time each batch, and write
`shapenet_psr_generated_data_<N>_pts[_rank_<r>]<info>.npz` with the JAX
package's keys: points (B, N, 3 + F), label, category, category_name,
timing [, keypoint, keypoint_feature, gt_points, normals].
`gather_generated_results` merges the rank files into one and deletes them.

The chain runs on the device of `device` (the card unless the caller passes
"cpu"); with `fused=True` (the default) an unconditional chain whose net is
in the fused scope runs the fused denoiser (`make_fused_net_fn`: K1 on the
card, its plain version on the CPU).  Every draw comes from one generator
seeded with `seed + rank`, or from the caller's `noise_fn(shape)` (normal
draws, in the JAX package's order: a batch's keypoint noise, then its
chain) and `start_fn(b, n)` (the decode's FPS starts).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from slide_tpu_torch.data import (BatchLoader, DummyShapesDataset, GeneralNpzDataset,
                                  get_dataloader)
from slide_tpu_torch.diffusion import (diffusion_config_of, diffusion_sampling,
                                       fast_sampling)
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.models.fused_denoiser import make_fused_net_fn
from slide_tpu_torch.ops import sample_keypoints
from slide_tpu_torch.pipeline import resolve_device, seeded_draws

TASKS = ("generation", "keypoint_generation", "keypoint_conditional_generation",
         "latent_generation", "latent_keypoint_conditional_generation")


def generated_file(save_dir: str, num_points: int, rank: int, world_size: int,
                   ckpt_info: str = "") -> str:
    """The npz a rank writes (the merged file's name with world_size 1)."""
    rank_tag = f"_rank_{rank}" if world_size > 1 else ""
    return os.path.join(
        save_dir, f"shapenet_psr_generated_data_{num_points}_pts{rank_tag}{ckpt_info}.npz")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _loader(trainset_config: dict, conditional: bool, rank: int, world_size: int, seed: int,
            use_dummy_dataset: Optional[bool], test_external_keypoint: bool,
            external_keypoint_file: Optional[str]) -> BatchLoader:
    eval_bs = int(trainset_config["eval_batch_size"] / world_size)
    if test_external_keypoint:
        return BatchLoader(GeneralNpzDataset(external_keypoint_file, scale=1,
                                             noise_magnitude=0, rank=rank,
                                             world_size=world_size),
                           eval_bs, shuffle=False)
    if use_dummy_dataset or (use_dummy_dataset is None and not conditional):
        # unconditional tasks need only labels: no data on disk
        n = int(np.ceil(trainset_config["num_samples_tested"] / world_size))
        return BatchLoader(DummyShapesDataset(trainset_config["data_dir"], n,
                                              categories=trainset_config.get("categories"),
                                              seed=seed),
                           eval_bs, shuffle=False)
    cfg = dict(trainset_config, batch_size=trainset_config["eval_batch_size"])
    return get_dataloader(cfg, phase="train", rank=rank, world_size=world_size,
                          append_samples_to_last_rank=False,
                          shuffle_before_rank_split=False, random_subsample=True,
                          num_samples=cfg["num_samples_tested"], seed=seed)


def evaluate_per_rank(net, trainset_config: dict, sched, save_dir: str, task: str, *,
                      point_feature_dim: int = 3,
                      latent_sampler: Optional[Callable] = None, rank: int = 0,
                      world_size: int = 1, ckpt_info: str = "",
                      test_external_keypoint: bool = False,
                      external_keypoint_file: Optional[str] = None,
                      split_points_and_normals: bool = False,
                      save_keypoint_feature: bool = False, seed: int = 0,
                      use_dummy_dataset: Optional[bool] = None, mesh=None,
                      custom_sampler: Optional[Callable] = None,
                      local_resampling: bool = False, complete_x0=None, keypoint_mask=None,
                      sampler: str = "ddpm", fastdpm_kw: Optional[dict] = None,
                      fused: bool = True, device=None,
                      noise_fn: Optional[Callable] = None,
                      start_fn: Optional[Callable] = None) -> str:
    """Sample and write this rank's npz; returns its path.

    `net` is the denoiser module (its weights loaded), `sched` its
    `DiffusionSchedule` (None with a `latent_sampler`).
    sampler="fastdpm" replaces the T-step chain with the S-step FastDPM one
    (fastdpm_kw: length / sampling_method / schedule / kappa).
    latent_sampler(noise_fn, start_fn, label=, keypoint=[, local_resampling=,
    complete_x0=, keypoint_mask=]) -> (points, keypoint, keypoint_feature)
    replaces the chain for the latent tasks; custom_sampler(noise_fn, label,
    condition) -> points for the others.
    local_resampling: with complete_x0 (B, K, 3 + F) and keypoint_mask (B,
    K), only the masked keypoints' latents are sampled anew; rows are taken
    in loader order from this rank's first global row.  Requires a latent
    sampler."""
    if task not in TASKS:
        raise ValueError(task)
    if mesh is not None:
        raise NotImplementedError("generation over several devices: not ported yet "
                                  "(ROADMAP Queue A, item 19)")
    if local_resampling:
        if latent_sampler is None:
            raise ValueError("local_resampling requires a latent task/sampler")
        if complete_x0 is None or keypoint_mask is None:
            raise ValueError("local_resampling requires complete_x0 and keypoint_mask")
    if trainset_config["dataset"] != "shapenet_psr_dataset":
        raise ValueError("only shapenet_psr_dataset is supported")
    conditional = task in ("keypoint_conditional_generation",
                           "latent_keypoint_conditional_generation")
    if conditional and latent_sampler is None and custom_sampler is None:
        raise NotImplementedError("the denoiser's condition-cloud branch: not ported yet "
                                  "(ROADMAP Queue A, item 18)")
    dev = resolve_device(device)
    num_points = trainset_config["num_keypoints"] if task == "keypoint_generation" \
        else trainset_config["npoints"]
    os.makedirs(save_dir, exist_ok=True)
    save_file = generated_file(save_dir, num_points, rank, world_size, ckpt_info)
    loader = _loader(trainset_config, conditional, rank, world_size, seed,
                     use_dummy_dataset, test_external_keypoint, external_keypoint_file)

    _, noise_fn, start_fn = seeded_draws(dev, seed + rank, noise_fn, start_fn)

    fused_fn = None
    if fused and latent_sampler is None and custom_sampler is None \
            and isinstance(net, ConditionalPointNet2):
        fused_fn = make_fused_net_fn(net.config, net, num_points)

    def sample(label):
        def net_fn(x, ts):
            if fused_fn is not None:
                return fused_fn(x, ts, label)
            return net(x, ts=ts, label=label)

        shape = (label.shape[0], num_points, point_feature_dim)
        if sampler == "fastdpm":
            return fast_sampling(net_fn, shape, sched, diffusion_config_of(sched), noise_fn,
                                 **(fastdpm_kw or {}))
        if sampler != "ddpm":
            raise ValueError(f"unknown sampler {sampler}")
        return diffusion_sampling(net_fn, shape, sched, noise_fn)

    out = {k: [] for k in ("points", "keypoint", "keypoint_feature", "label", "category",
                           "category_name", "gt_points", "timing")}
    # local-resampling rows: this rank's shard starts at its global row (the
    # same split as GeneralNpzDataset's)
    resample_offset = 0
    if local_resampling and world_size > 1:
        resample_offset = rank * int(np.ceil(len(complete_x0) / world_size))
    with torch.no_grad():
        for data in loader:
            label = torch.as_tensor(np.asarray(data["label"]), dtype=torch.int64, device=dev)
            b = int(label.shape[0])
            condition = keypoint = None
            if conditional:
                if test_external_keypoint:
                    keypoint = torch.as_tensor(data["points"], dtype=torch.float32, device=dev)
                else:
                    gt = torch.as_tensor(data["points"], dtype=torch.float32, device=dev)
                    keypoint, _ = sample_keypoints(
                        gt, trainset_config["num_keypoints"],
                        add_centroid=trainset_config.get("add_centroid_to_keypoints", True))
                    out["gt_points"].append(
                        np.concatenate([data["points"], data["normals"]], axis=2))
                nm = trainset_config.get("keypoint_noise_magnitude", 0)
                if nm > 0:
                    keypoint = keypoint + nm * noise_fn(keypoint.shape).to(dev)
                condition = keypoint
                out["keypoint"].append(keypoint.cpu().numpy())

            _sync(dev)
            t_start = time.time()
            if latent_sampler is not None:
                kw = {}
                if local_resampling:
                    rows = slice(resample_offset, resample_offset + b)
                    kw = {"local_resampling": True,
                          "complete_x0": torch.as_tensor(np.asarray(complete_x0[rows]),
                                                         dtype=torch.float32, device=dev),
                          "keypoint_mask": torch.as_tensor(np.asarray(keypoint_mask[rows]),
                                                           dtype=torch.float32, device=dev)}
                    resample_offset += b
                pts, kp, kpf = latent_sampler(noise_fn, start_fn, label=label,
                                              keypoint=keypoint, **kw)
                if task == "latent_generation":
                    out["keypoint"].append(kp.cpu().numpy())
                if save_keypoint_feature:
                    out["keypoint_feature"].append(kpf.cpu().numpy())
            elif custom_sampler is not None:
                pts = custom_sampler(noise_fn, label, condition)
            else:
                pts = sample(label)
            _sync(dev)
            out["timing"].extend([(time.time() - t_start) / b] * b)
            out["points"].append(pts.cpu().numpy())
            out["label"].append(label.cpu().numpy())
            out["category"] += list(data["category"])
            out["category_name"] += list(data["category_name"])

    result = {"points": np.concatenate(out["points"], axis=0),
              "label": np.concatenate(out["label"], axis=0),
              "category": out["category"], "category_name": out["category_name"],
              "timing": np.asarray(out["timing"])}
    for k in ("keypoint", "keypoint_feature", "gt_points"):
        if out[k]:
            result[k] = np.concatenate(out[k], axis=0)
    if split_points_and_normals and result["points"].shape[2] == 6:
        result["normals"] = result["points"][:, :, 3:]
        result["points"] = result["points"][:, :, 0:3]
    np.savez(save_file, **result)
    avg = result["timing"].sum() / result["points"].shape[0]
    print(f"Generated samples saved to {save_file}; avg per-sample time {avg:.4f}s",
          flush=True)
    return save_file


def gather_generated_results(save_dir: str, world_size: int, num_points: int = 2048,
                             ckpt_info: str = "") -> str:
    """Merge the rank files into one npz and delete them."""
    result = {}
    gathered = []
    for rank in range(world_size):
        rank_file = generated_file(save_dir, num_points, rank, max(world_size, 2), ckpt_info)
        with np.load(rank_file) as data:
            for name in data.files:
                result.setdefault(name, []).append(data[name])
        gathered.append(rank_file)
    save_file = generated_file(save_dir, num_points, 0, 1, ckpt_info)
    np.savez(save_file, **{k: np.concatenate(v, axis=0) for k, v in result.items()})
    for f in gathered:
        os.remove(f)
    return save_file
