"""Position-DDPM training (counterpart: `slide_tpu/train/driver.py`,
`train_position_ddpm` and the scaffold it shares with the other tasks).

    state, losses = train_position_ddpm(keypoint_ddpm_config("airplane"),
                                        data_dir=root, max_iters=200)

One step: keypoints by FPS over the centroid-prepended cloud (K3), the eps
loss at one random timestep per cloud, its gradient, Adam (optax's `adam`:
eps outside the square root, bias correction), the EMA shadows.  With
`fused=True` (the default) the denoiser is the fused one: K1 forward and K2
backward on the card, their plain versions on the CPU.  Entry points run on
the card unless the caller passes `device="cpu"`.

Resume is by default (`ckpt_iter: "max"`), checkpoints are the JAX
package's (`train/checkpoint.py`), written every `loader_len *
epochs_per_ckpt` iterations, at the end of a run that stops off that
cadence, and mirrored to `durable_ckpt_dir` when set.  Randomness comes from
explicit generators: the network's init from `seed`, the per-step draws from
`seed + 1`, the data from numpy with `seed`.

Left out (ROADMAP): the other tasks' targets (16b), the x0-engine step
(13b), the device-resident corpus (15a's `device_data`) and the
checkpoint-time eval hooks (16b); a config asking for one raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from slide_tpu_torch.data import get_dataloader
from slide_tpu_torch.diffusion import calc_diffusion_hyperparams, diffusion_training_loss
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.models.fused_denoiser import make_fused_train_fn
from slide_tpu_torch.ops import sample_keypoints
from slide_tpu_torch.pipeline import resolve_device
from slide_tpu_torch.train.checkpoint import (load_checkpoint, mirror_checkpoint,
                                              restore_from_mirror, save_checkpoint)
from slide_tpu_torch.train.ema import ema_init, ema_update
from slide_tpu_torch.nn.layers import GroupNorm
from slide_tpu_torch.weights import (flax_leaves, flax_order, flax_path, flax_to_torch_state,
                                     load_flax_params, module_to_flax)


@dataclasses.dataclass
class TrainState:
    """The network, its optimizer, the EMA shadows (lists of tensors parallel
    to `net.parameters()`, one per rate) and the number of updates done."""

    net: nn.Module
    optimizer: torch.optim.Optimizer
    ema: list
    ema_rates: tuple
    step: int = 0


def init_params(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw `net`'s parameters from `generator` with the JAX package's
    initialisers: dense kernels U(-1/sqrt(fan_in), 1/sqrt(fan_in)) and zero
    biases, GroupNorm scale 1 and bias 0, embeddings N(0, 1/features)."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                w = torch.rand(mod.weight.shape, generator=generator,
                               device=generator.device)
                mod.weight.copy_(w * (2 * bound) - bound)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                w = torch.randn(mod.weight.shape, generator=generator,
                                device=generator.device)
                mod.weight.copy_(w / math.sqrt(mod.embedding_dim))
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return net


def experiment_dirs(config: dict) -> tuple[str, str]:
    """(experiment root, checkpoint dir) of an eps-DDPM config:
    root/T{T}_betaT{beta_T}_{model_name}/<output_directory>."""
    tc = config["train_config"]
    dc = config["diffusion_config"]
    local = "T{}_betaT{}_{}".format(dc["T"], dc["beta_T"], config["pointnet_config"]["model_name"])
    exp_root = os.path.join(tc["root_directory"], local)
    return exp_root, os.path.join(exp_root, tc["output_directory"])


def sample_train_keypoints(points: torch.Tensor, trainset_config: dict,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """FPS keypoints of each cloud, with optional gaussian noise, per the
    dataset config (random start or random subset when it asks)."""
    if trainset_config.get("keypoints_source", "farthest_points_sampling") \
            != "farthest_points_sampling":
        raise ValueError("only farthest_points_sampling keypoints are supported")
    keypoint, _ = sample_keypoints(
        points, trainset_config["num_keypoints"],
        add_centroid=trainset_config.get("add_centroid_to_keypoints", True),
        random_subsample=trainset_config.get("random_sample_keypoints", False),
        generator=generator)
    nm = trainset_config.get("keypoint_noise_magnitude", 0)
    if nm > 0:
        if generator is None:
            raise ValueError("keypoint noise requires a generator")
        noise = torch.randn(keypoint.shape, generator=generator, device=generator.device)
        keypoint = keypoint + nm * noise.to(keypoint.device)
    return keypoint


def _prepare_x(task: str, trainset_config: dict, points: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The diffusion target of a task; only `keypoint_generation` is ported."""
    if task == "keypoint_generation":
        return sample_train_keypoints(points, trainset_config, generator)
    raise NotImplementedError(f"task {task}: not ported yet (ROADMAP Queue A, item 16b)")


def maybe_fused_train_apply(pointnet_config: dict, n_points: int, net: nn.Module,
                            fused: bool = True) -> Optional[Callable]:
    """The differentiable fused denoiser `(x, ts, label) -> eps` for the
    train step (`make_fused_train_fn`: K1 + K2 on the card), or None when
    `fused` is off or the config is outside the fused scope."""
    if not fused:
        return None
    return make_fused_train_fn(pointnet_config, net, n_points)


def make_train_step(net: nn.Module, sched, task: str, trainset_config: dict,
                    fused_apply: Optional[Callable] = None) -> Callable:
    """`step(state, batch, generator, draws=None) -> loss` (a 0-d tensor on
    the device, not synchronised).  `batch` holds `points` and `label` on
    the device; `draws` = (ts, z) replaces the loss's random draws."""

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   draws=None) -> torch.Tensor:
        x = _prepare_x(task, trainset_config, batch["points"], generator)
        label = batch["label"]

        def net_fn(xt, ts):
            if fused_apply is not None:
                return fused_apply(xt, ts, label)
            return net(xt, ts=ts, label=label)

        ts, z = draws if draws is not None else (None, None)
        loss = diffusion_training_loss(net_fn, x, sched, generator, ts=ts, z=z)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        ema_update(state.ema, list(net.parameters()), state.ema_rates)
        state.step += 1
        return loss.detach()

    return train_step


# ---------------------------------------------------------------------------
# Adam's state as optax keeps it: ((count, mu tree, nu tree), ())


def adam_state_tree(state: TrainState):
    """The optimizer state as optax's `adam` state of the flax tree, numpy:
    count int32, then the first and second moments."""
    net, opt = state.net, state.optimizer
    params = dict(net.named_parameters())
    count, mu, nu = 0, {}, {}
    for name, p in params.items():
        st = opt.state.get(p, {})
        if st:
            count = int(st["step"])
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    return ((np.asarray(count, np.int32), module_to_flax(net, mu), module_to_flax(net, nu)),
            ())


def load_adam_state(state: TrainState, saved) -> None:
    """Seat optax `adam` leaves (count, mu leaves, nu leaves in flax order)
    into the torch optimizer, after checking their count and shapes."""
    net, opt = state.net, state.optimizer
    names = flax_order(net)
    params = dict(net.named_parameters())
    shapes = [np.shape(leaf) for leaf in flax_leaves(module_to_flax(net))]
    expected = [()] + shapes + shapes
    leaves = flax_leaves(saved)
    if len(leaves) != len(expected):
        raise ValueError(f"optimizer state in checkpoint has {len(leaves)} leaves, "
                         f"the configured optimizer expects {len(expected)}")
    for i, (s, shape) in enumerate(zip(leaves, expected)):
        if np.shape(s) != shape:
            raise ValueError(f"optimizer-state leaf {i} shape {np.shape(s)} != "
                             f"expected {shape}")
    count = int(np.asarray(leaves[0]))
    n = len(names)
    mu = {name: leaves[1 + i] for i, name in enumerate(names)}
    nu = {name: leaves[1 + n + i] for i, name in enumerate(names)}
    for name in names:
        p = params[name]
        as_torch = {}
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            arr = np.asarray(tree[name], np.float32)
            if flax_path(net, name)[1]:
                arr = arr.T
            as_torch[key] = torch.as_tensor(np.ascontiguousarray(arr), device=p.device)
        opt.state[p] = {"step": torch.tensor(float(count)), **as_torch}


def _ema_trees(state: TrainState) -> list:
    names = [n for n, _ in state.net.named_parameters()]
    return [module_to_flax(state.net, dict(zip(names, shadow))) for shadow in state.ema]


def _load_ema(state: TrainState, trees) -> None:
    names = [n for n, _ in state.net.named_parameters()]
    for shadow, tree in zip(state.ema, trees):
        flat = flax_to_torch_state(tree)
        with torch.no_grad():
            for name, t in zip(names, shadow):
                t.copy_(torch.from_numpy(flat[name]))


def _save(state: TrainState, output_directory: str, n_iter: int, seconds: int,
          durable_dir: Optional[str]) -> str:
    path = save_checkpoint(output_directory, n_iter, module_to_flax(state.net),
                           adam_state_tree(state), seconds,
                           ema_state_list=_ema_trees(state) if state.ema_rates else None)
    if durable_dir:
        mirror_checkpoint(path, durable_dir)
    return path


def run_training(config: dict, state: TrainState, train_step: Callable, *,
                 data_dir: Optional[str] = None, max_iters: Optional[int] = None,
                 seed: int = 0, verbose: bool = True):
    """The training loop: resume, one step per batch, logging, checkpoints.
    Returns (state, [(iter, loss), ...]) with a loss every
    `iters_per_logging` iterations; a non-finite logged loss raises
    FloatingPointError."""
    train_config = config["train_config"]
    trainset_config = dict(config["shapenet_psr_dataset_config"])
    if data_dir is not None:
        trainset_config["data_dir"] = data_dir
    if train_config.get("device_data", False):
        raise NotImplementedError("device_data: not ported yet (ROADMAP Queue A, item 15a)")
    dev = next(state.net.parameters()).device
    _, output_directory = experiment_dirs(config)

    time_offset, ckpt_iter = 0, -1
    ckpt_sel = train_config.get("ckpt_iter")
    durable_dir = train_config.get("durable_ckpt_dir")
    if durable_dir and ckpt_sel == "max":
        restored = restore_from_mirror(output_directory, durable_dir)
        if restored and verbose:
            print(f"restored checkpoint from durable mirror: {restored}", flush=True)
    if ckpt_sel == "max" or isinstance(ckpt_sel, int):
        ckpt = load_checkpoint(output_directory, None if ckpt_sel == "max" else ckpt_sel)
        if ckpt is not None:
            load_adam_state(state, ckpt["optimizer_state_dict"])
            load_flax_params(state.net, ckpt["model_state_dict"])
            if state.ema_rates:
                _load_ema(state, ckpt["ema_state_list"])
            state.step = ckpt["iter"] + 1
            ckpt_iter = ckpt["iter"]
            time_offset = ckpt.get("training_time_seconds", 0)
            if verbose:
                print(f"resumed from iteration {ckpt_iter}", flush=True)

    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    loader = get_dataloader(trainset_config, phase="train", seed=seed)
    loader_len = len(loader)
    n_iters = int(loader_len * train_config["n_epochs"])
    if max_iters is not None:
        n_iters = min(n_iters, max_iters)
    iters_per_ckpt = max(1, int(loader_len * train_config["epochs_per_ckpt"]))
    iters_per_logging = train_config["iters_per_logging"]
    batch_size = trainset_config["batch_size"]

    losses = []
    n_iter = ckpt_iter + 1
    t0 = log_t = time.time()
    warned_partial = False
    while n_iter < n_iters:
        start_iter = n_iter
        for batch in loader:
            if n_iter >= n_iters:
                break
            if batch["label"].shape[0] != batch_size:
                if not warned_partial:
                    print(f"warning: skipping partial batch of {batch['label'].shape[0]} "
                          f"(batch_size {batch_size})", flush=True)
                    warned_partial = True
                continue
            dbatch = {"points": torch.as_tensor(batch["points"], dtype=torch.float32,
                                                device=dev),
                      "label": torch.as_tensor(batch["label"], dtype=torch.int64,
                                               device=dev)}
            loss = train_step(state, dbatch, generator)
            if n_iter % iters_per_logging == 0:
                loss_v = float(loss)
                if not np.isfinite(loss_v):
                    raise FloatingPointError(f"non-finite training loss at iteration {n_iter}")
                losses.append((n_iter, loss_v))
                if verbose:
                    print(f"iteration: {n_iter} \tloss: {loss_v:.6f} "
                          f"\ttime: {time.time() - log_t:.2f}s", flush=True)
                log_t = time.time()
            n_iter += 1
            if n_iter % iters_per_ckpt == 0:
                _save(state, output_directory, n_iter - 1,
                      int(time.time() - t0) + time_offset, durable_dir)
        if n_iter == start_iter:
            raise ValueError(f"no full batches of {batch_size} in the dataset: "
                             f"batch_size exceeds the usable dataset size")
    if n_iter > ckpt_iter + 1 and n_iter % iters_per_ckpt != 0:
        # a run that ends off the cadence keeps its last iterations
        _save(state, output_directory, n_iter - 1, int(time.time() - t0) + time_offset,
              durable_dir)
    return state, losses


def build_position_ddpm(config: dict, *, seed: int = 0, device=None, fused: bool = True):
    """The network (its parameters drawn from `seed`), Adam, the EMA
    shadows and the train step of the position DDPM: (TrainState, step)."""
    train_config = config["train_config"]
    trainset_config = config["shapenet_psr_dataset_config"]
    task = train_config["task"]
    if "standard_diffusion_config" in config:
        raise NotImplementedError("the x0-engine train step: not ported yet "
                                  "(ROADMAP Queue A, item 13b)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(device)
    dc = config["diffusion_config"]
    sched = calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"], dev)
    pointnet_config = config["pointnet_config"]
    net = ConditionalPointNet2(pointnet_config)
    init_params(net, torch.Generator().manual_seed(seed))
    net = net.to(dev).train()
    optimizer = torch.optim.Adam(net.parameters(), lr=train_config["learning_rate"],
                                 betas=(0.9, 0.999), eps=1e-8)
    ema_rates = tuple(train_config.get("ema_rate") or ())
    state = TrainState(net=net, optimizer=optimizer,
                       ema=ema_init(list(net.parameters()), ema_rates), ema_rates=ema_rates)
    n_points = trainset_config["num_keypoints"] if task == "keypoint_generation" \
        else trainset_config["npoints"]
    fused_apply = None
    if task == "keypoint_generation":
        fused_apply = maybe_fused_train_apply(pointnet_config, n_points, net, fused)
    return state, make_train_step(net, sched, task, trainset_config, fused_apply=fused_apply)


def train_position_ddpm(config: dict, *, data_dir: Optional[str] = None,
                        max_iters: Optional[int] = None, seed: int = 0, device=None,
                        fused: bool = True, verbose: bool = True):
    """Train the position (keypoint) DDPM per `config["train_config"]`
    (counterpart: the JAX package's `train_position_ddpm`).  Returns
    (TrainState, [(iter, loss), ...])."""
    state, step = build_position_ddpm(config, seed=seed, device=device, fused=fused)
    return run_training(config, state, step, data_dir=data_dir, max_iters=max_iters,
                        seed=seed, verbose=verbose)
