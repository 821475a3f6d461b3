"""One rank of a data-parallel check on `torch.distributed` (no JAX: the
CPU tests and the card test run it, one process a rank):

    python tests/ddp_worker.py <check> <rank> <world> <host:port> <device> <backend> <dir>

Checks, each writing <dir>/rank<r>.json:

  steps  the keypoint DDPM's and the autoencoder's train step (narrow
         widths, seed-made clouds): this rank's step on its rows inside
         `data_parallel()` against one process's step on all the rows with
         the same generator's draws (rank 0 runs it); the largest gradient
         gap and the largest gradient, the two losses, and a digest of the
         parameters after Adam (equal on every rank);
  run    `train_position_ddpm` of 3 steps at batch 4 on the synthetic tree
         in <dir>/data, then resumed to 5 steps: the iterations each rank
         logged and saved, a digest of its parameters after each run; and
         the error of a batch of 5, which two ranks cannot split;
  card   the keypoint DDPM's step at the preset's full width on the card
         (K1, K2 and K3), a global batch of 32 clouds of 2048 points: the
         gradient elements beyond GRAD_RTOL / GRAD_ATOL of the one-process
         step's, the largest gap, the parameters' digest.

`position_config` / `ae_config` are the nets; `step_gap` the comparison
(the card test runs it at the keypoint preset's full width)."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slide_tpu_torch.configs import autoencoder_config, keypoint_ddpm_config  # noqa: E402
from slide_tpu_torch.parallel import (data_parallel, maybe_initialize_distributed,  # noqa: E402
                                      process_allgather, world_info)
from slide_tpu_torch.train import driver as tdriver  # noqa: E402


def position_config(batch: int, narrow: bool = True) -> dict:
    cfg = keypoint_ddpm_config("airplane", batch_size=batch)
    if narrow:
        pc = cfg["pointnet_config"]
        pc.update(t_dim=16, class_condition_dim=16)
        pc["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                                  mlp_depth=2, decoder_mlp_depth=2)
    return cfg


def ae_config(batch: int) -> dict:
    """The airplane autoencoder cut to two encoder SA levels (to 32 and 8
    centers) and two decoder levels (64 -> 200 points), 32-128 channels."""
    cfg = autoencoder_config("airplane", batch_size=batch)
    pc = cfg["pointnet_config"]
    pc["encoder_config"]["architecture"].update(npoint=[32, 8], nsample=[8, 4], radius=[0, 0],
                                                feature_dim=[16, 64, 128], mlp_depth=2)
    l1, l2, _ = pc["decoder_config_list"]
    pc["decoder_config_list"] = [l1, l2]
    pc["feature_weight"] = [0, 0.1]
    l1["architecture"]["feature_dim"] = [8, 8, 8]
    l1["feature_mapper_setting"]["out_dim"] = 8
    l1["upsampling_setting"].update(point_upsample_factor=8, num_output_points=64,
                                    output_scale_factor=0.5)
    l2["architecture"].update(npoint=[16, 8], nsample=[8, 4], radius=[0, 0], K=4,
                              feature_dim=[64, 64, 128], decoder_feature_dim=[128] * 3,
                              mlp_depth=2)
    l2["feature_mapper_setting"].update(out_dim=64, nsample=4)
    l2["upsampling_setting"].update(point_upsample_factor=4, num_output_points=200,
                                    output_scale_factor=0.5)
    return cfg


def clouds(b: int, n: int, seed: int, dev) -> dict:
    """A batch of b noisy spheres of n points with unit normals."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    normals = v / np.linalg.norm(v, axis=-1, keepdims=True)
    points = 0.4 * normals + 0.01 * rng.standard_normal((b, n, 3)).astype(np.float32)
    return {"points": torch.as_tensor(points, device=dev),
            "normals": torch.as_tensor(normals, device=dev),
            "label": torch.zeros(b, dtype=torch.int64, device=dev)}


def digest(net) -> str:
    h = hashlib.sha256()
    for p in net.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def step_gap(build, batch: dict, rank: int, world: int, seed: int = 1) -> dict:
    """`build()` -> (state, step) twice; this rank's rows through the step
    inside `data_parallel()`, and on rank 0 all the rows in one process,
    each with a generator seeded `seed` on the batch's device.  Returns the
    data-parallel gradients (after the all-reduce), rank 0's one-process
    gradients (None elsewhere), both losses and the parameters' digest."""
    dev = batch["points"].device
    b = batch["points"].shape[0] // world
    local = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
    state, step = build()
    with data_parallel():
        loss = step(state, local, torch.Generator(device=dev).manual_seed(seed))
    grads = [p.grad.detach().clone() for p in state.net.parameters()]
    out = {"grads": grads, "loss": float(loss), "digest": digest(state.net),
           "names": [n for n, _ in state.net.named_parameters()]}
    if rank == 0:
        ref, ref_step = build()
        out["ref_loss"] = float(ref_step(ref, batch,
                                         torch.Generator(device=dev).manual_seed(seed)))
        out["ref_grads"] = [p.grad.detach().clone() for p in ref.net.parameters()]
    return out


def _gap(res: dict) -> dict:
    largest = max(float(g.abs().max()) for g in res["ref_grads"])
    gap = max(float((a - b).abs().max()) for a, b in zip(res["grads"], res["ref_grads"]))
    return {"gap": gap, "largest": largest, "loss": res["loss"], "ref_loss": res["ref_loss"]}


def check_steps(rank: int, world: int, dev) -> dict:
    out = {"world_info": list(world_info()),
           "gathered": process_allgather({"rank": np.array([rank])})["rank"].ravel().tolist()}
    cases = {"kp": (lambda: tdriver.build_position_ddpm(position_config(4 * world), seed=0,
                                                        device=dev), clouds(4 * world, 256, 0, dev)),
             "ae": (lambda: tdriver.build_ae_training(ae_config(2 * world), seed=0, device=dev),
                    clouds(2 * world, 256, 1, dev))}
    for name, (build, batch) in cases.items():
        res = step_gap(build, batch, rank, world)
        out[name] = {"digest": res["digest"], "loss": res["loss"]}
        if rank == 0:
            out[name].update(_gap(res))
    return out


# per element, as chip_smoke.py holds a card step against the CPU's
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4


def check_card(rank: int, world: int, dev) -> dict:
    res = step_gap(lambda: tdriver.build_position_ddpm(position_config(32, narrow=False),
                                                       seed=0, device=dev),
                   clouds(32, 2048, 2, dev), rank, world)
    out = {"digest": res["digest"], "loss": res["loss"]}
    if rank == 0:
        out["beyond"] = sum(int(((a - b).abs() > GRAD_ATOL + GRAD_RTOL * b.abs()).sum())
                            for a, b in zip(res["grads"], res["ref_grads"]))
        out.update(_gap(res))
    return out


def check_run(rank: int, world: int, dev, root: str) -> dict:
    cfg = position_config(4)
    cfg["shapenet_psr_dataset_config"].update(repeat_dataset=1, npoints=256)
    cfg["train_config"].update(root_directory=os.path.join(root, "exp"), iters_per_logging=1,
                               epochs_per_ckpt=1)
    saved = []
    real_save = tdriver.save_checkpoint

    def save(directory, n_iter, *args, **kw):
        saved.append(n_iter)
        return real_save(directory, n_iter, *args, **kw)

    tdriver.save_checkpoint = save
    out = {}
    try:
        tdriver.train_position_ddpm(dict(cfg, shapenet_psr_dataset_config=dict(
            cfg["shapenet_psr_dataset_config"], batch_size=5)), data_dir=os.path.join(root, "data"),
            max_iters=1, device=dev, verbose=False)
    except ValueError as e:
        out["indivisible"] = str(e)
    for name, iters in (("first", 3), ("resumed", 5)):
        state, losses = tdriver.train_position_ddpm(copy.deepcopy(cfg),
                                                    data_dir=os.path.join(root, "data"),
                                                    max_iters=iters, device=dev, verbose=False)
        out[name] = {"logged": [i for i, _ in losses], "losses": [l for _, l in losses],
                     "digest": digest(state.net), "step": state.step, "saved": list(saved)}
        saved.clear()
    return out


def main(check: str, rank: str, world: str, coord: str, device: str, backend: str,
         out_dir: str) -> None:
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    assert maybe_initialize_distributed(coord, world, rank, backend=backend, device=device)
    dev = torch.device(device)
    if check == "steps":
        res = check_steps(rank, world, dev)
    elif check == "card":
        res = check_card(rank, world, dev)
    else:
        res = check_run(rank, world, dev, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
