"""Training (counterpart: `slide_tpu/train/driver.py`): the position DDPM,
the point autoencoder, the feature (latent) DDPM and the SAP
refine+upsample net, on the scaffold they share.

    state, losses = train_position_ddpm(keypoint_ddpm_config("airplane"),
                                        data_dir=root, max_iters=200)
    state, losses = train_autoencoder(autoencoder_config("airplane"),
                                      data_dir=root, max_iters=200)
    state, losses = train_latent_ddpm(latent_ddpm_config("airplane"), ae_params,
                                      data_dir=root, max_iters=200)
    state, losses = train_upsampler(upsampler_config(), data_dir=root,
                                    max_iters=200)

One position step: the task's target (`keypoint_generation`: keypoints by
FPS over the centroid-prepended cloud, K3; `generation`: the cloud with its
normals; `keypoint_conditional_generation`: the cloud with its normals,
conditioned on its keypoints), the eps loss at one random timestep per
cloud, or, where the config carries `standard_diffusion_config`, the x0
engine's chamfer / MSE losses (`x0_training_loss`), its gradient, Adam
(optax's `adam`: eps outside the square root, bias correction), the EMA
shadows.
One autoencoder step: noisy keypoints (K3), the round trip (the SA levels
and the decoder's trims on K3) and its per-level chamfer losses.  One latent
step: keypoints (K3), the frozen autoencoder's encode (K3 in its SA
levels), the latent eps loss.  One upsampler step: the mirrored cloud
(optionally first corrupted by a frozen autoencoder's round trip), the SAP
net (K3 in its SA levels), the split cloud's DPSR grid under autograd and
the (tanh-)MSE against the dataset's grid.  With `fused=True` (the
default) the DDPM denoisers of the unconditional keypoint and latent tasks
are the fused one: K1 forward and K2 backward on the card, their plain
versions on the CPU; the conditional tasks run the module.  Entry points
run on the card unless the caller passes `device="cpu"`.
`train_config["activation_dtype"]` ("bfloat16") runs the networks' layers
in that dtype for the run (`nn/precision.py`).

Resume is by default (`ckpt_iter: "max"`), checkpoints are the JAX
package's (`train/checkpoint.py`), written every `loader_len *
epochs_per_ckpt` iterations, at the end of a run that stops off that
cadence, and mirrored to `durable_ckpt_dir` when set.  Randomness comes from
explicit generators: the network's init from `seed`, the per-step draws from
`seed + 1`, the data from numpy with `seed`.  Each step also takes its draws
as an argument (a test replays the JAX package's).

Each entry point takes `eval_hook="auto"`: after every checkpoint of the
cadence (every `eval_per_ckpt`-th) it evaluates the raw weights and every
EMA shadow as the JAX package's hooks do (`make_generation_eval_hook`,
`make_ae_eval_hook`, `make_latent_eval_hook`, `make_sap_eval_hook`), into
<experiment root>/eval_result[/model_ema_<rate>] with `_iter_<n>` tags.

With `train_config["device_data"]` the corpus lives on the device and
each step's batch is assembled there (`run_training`).  The denoiser is
the one `pointnet_config["network_type"]` names (`build_network`):
`ConditionalPointNet2` (fused where in scope), `PVCNN2` or `PointwiseNet`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from slide_tpu_torch.data import DeviceCorpus, get_dataloader, make_assemble_fn
from slide_tpu_torch.diffusion import (X0Schedule, calc_diffusion_hyperparams,
                                       diffusion_training_loss, latent_config_weights,
                                       latent_denoise_and_reconstruct, latent_train_loss,
                                       x0_denoise, x0_training_loss)
from slide_tpu_torch.eval import (ae_quantitative_eval, ae_visual_eval, evaluate_per_rank,
                                  sap_grid_eval)
from slide_tpu_torch.eval.generation import conditioned_net_fn
from slide_tpu_torch.models import (PVCNN2, ConditionalPointNet2, build_autoencoder,
                                    decode_params, get_pointwise_net)
from slide_tpu_torch.models.fused_denoiser import make_fused_net_fn, make_fused_train_fn
from slide_tpu_torch.ops import sample_keypoints
from slide_tpu_torch.parallel import (all_reduce_mean, batch_randint, batch_randn,
                                      broadcast_from_rank0, current_shard, data_parallel,
                                      process_group_active)
from slide_tpu_torch.pipeline import resolve_device
from slide_tpu_torch.sap import DPSR, mirror_and_concat, network_output_to_dpsr_grid
from slide_tpu_torch.train.checkpoint import (load_checkpoint, mirror_checkpoint,
                                              restore_from_mirror, save_checkpoint)
from slide_tpu_torch.train.ema import ema_init, ema_update
from slide_tpu_torch.nn.layers import GroupNorm
from slide_tpu_torch.nn.precision import activation_dtype_scope
from slide_tpu_torch.weights import (flax_leaves, flax_order, flax_path, flax_to_torch_state,
                                     kernel_to_torch, load_flax_params, module_to_flax)


@dataclasses.dataclass
class TrainState:
    """The trained module (a denoiser or the autoencoder), its optimizer, the
    EMA shadows (lists of tensors parallel to `net.parameters()`, one per
    rate) and the number of updates done."""

    net: nn.Module
    optimizer: torch.optim.Optimizer
    ema: list
    ema_rates: tuple
    step: int = 0


def init_params(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw `net`'s parameters from `generator` with the JAX package's
    initialisers: dense and convolution kernels U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) and zero biases, GroupNorm scale 1 and bias 0, class
    embeddings N(0, 1)."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (nn.Linear, nn.Conv3d)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                w = torch.rand(mod.weight.shape, generator=generator,
                               device=generator.device)
                mod.weight.copy_(w * (2 * bound) - bound)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator,
                                             device=generator.device))
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return net


def build_network(pointnet_config: dict) -> nn.Module:
    """The denoiser that `pointnet_config["network_type"]` names:
    "pointnet++" (the default) `ConditionalPointNet2`, "pointwise_net"
    `PointwiseNet(**network_args)`, "pvd" `PVCNN2(**network_args)` over
    3 + `in_fea_dim` input channels.  Only the first has a fused route."""
    nt = pointnet_config.get("network_type", "pointnet++")
    if nt == "pointnet++":
        return ConditionalPointNet2(pointnet_config)
    if nt == "pointwise_net":
        return get_pointwise_net(pointnet_config["network_args"])
    if nt == "pvd":
        return PVCNN2(in_dim=3 + pointnet_config["in_fea_dim"],
                      **pointnet_config.get("network_args", {}))
    raise ValueError(f"network_type {nt} is not supported")


def _new_state(net: nn.Module, train_config: dict) -> TrainState:
    """`net` with Adam (optax's defaults) at the config's learning rate and
    its EMA shadows, one per `ema_rate` (none when the config has none)."""
    optimizer = torch.optim.Adam(net.parameters(), lr=train_config["learning_rate"],
                                 betas=(0.9, 0.999), eps=1e-8)
    ema_rates = tuple(train_config.get("ema_rate") or ())
    return TrainState(net=net, optimizer=optimizer,
                      ema=ema_init(list(net.parameters()), ema_rates), ema_rates=ema_rates)


def _step_update(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """Backward, Adam, the EMA shadows; the loss, detached.  Inside
    `data_parallel()` the gradients and the loss are first all-reduced to
    their mean over the ranks (one bucket): the global batch's."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    if current_shard() is not None:
        loss = loss.clone()
        all_reduce_mean([p.grad for p in state.net.parameters() if p.grad is not None]
                        + [loss])
    state.optimizer.step()
    ema_update(state.ema, list(state.net.parameters()), state.ema_rates)
    state.step += 1
    return loss


def _trainset_config(config: dict, data_dir: Optional[str]) -> dict:
    """The config's dataset settings, reading from `data_dir` when given."""
    trainset_config = dict(config["shapenet_psr_dataset_config"])
    if data_dir is not None:
        trainset_config["data_dir"] = data_dir
    return trainset_config


def experiment_dirs(config: dict) -> tuple[str, str]:
    """(experiment root, checkpoint dir): root/<local>/<output_directory>,
    <local> T{T}_betaT{beta_T}_{model_name} for a DDPM, the model name for
    the autoencoder."""
    tc = config["train_config"]
    name = config["pointnet_config"]["model_name"]
    if "diffusion_config" in config:
        dc = config["diffusion_config"]
        local = "T{}_betaT{}_{}".format(dc["T"], dc["beta_T"], name)
    elif "standard_diffusion_config" in config:
        dc = config["standard_diffusion_config"]
        local = "T{}_betaT{}_{}".format(dc["num_diffusion_timesteps"], dc["beta_end"], name)
    else:
        local = name
    exp_root = os.path.join(tc["root_directory"], local)
    return exp_root, os.path.join(exp_root, tc["output_directory"])


def sample_train_keypoints(points: torch.Tensor, trainset_config: dict,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FPS keypoints of each cloud, with optional gaussian noise, per the
    dataset config (random start or random subset when it asks).  The
    noise's standard-normal draw is `noise` when given, else `generator`'s."""
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
        if noise is None:
            if generator is None:
                raise ValueError("keypoint noise requires a generator")
            noise = batch_randn(keypoint.shape, generator)
        keypoint = keypoint + nm * noise.to(keypoint.device)
    return keypoint


POSITION_TASKS = ("keypoint_generation", "generation", "keypoint_conditional_generation")


def _prepare_x(task: str, trainset_config: dict, points: torch.Tensor,
               normals: Optional[torch.Tensor], generator: Optional[torch.Generator]):
    """(diffusion target, condition) of a position task: the keypoints and
    no condition (`keypoint_generation`); the cloud, with its normals when
    `include_normals` (the default), and no condition (`generation`); that
    cloud conditioned on its keypoints (`keypoint_conditional_generation`).
    The keypoints' draws come first, from `generator`."""
    if task not in POSITION_TASKS:
        raise ValueError(f"task {task} not handled by this driver")
    keypoint = None
    if task in ("keypoint_generation", "keypoint_conditional_generation"):
        keypoint = sample_train_keypoints(points, trainset_config, generator)
    if task == "keypoint_generation":
        return keypoint, None
    if trainset_config.get("include_normals", True):
        points = torch.cat([points, normals], dim=-1)
    return points, keypoint


def maybe_fused_train_apply(pointnet_config: dict, n_points: int, net: nn.Module,
                            fused: bool = True) -> Optional[Callable]:
    """The differentiable fused denoiser `(x, ts, label) -> eps` for the
    train step (`make_fused_train_fn`: K1 + K2 on the card), or None when
    `fused` is off or the config is outside the fused scope (another
    `network_type` is: `fused_denoiser.supports_config`)."""
    if not fused:
        return None
    return make_fused_train_fn(pointnet_config, net, n_points)


def make_train_step(net: nn.Module, sched, task: str, trainset_config: dict,
                    fused_apply: Optional[Callable] = None) -> Callable:
    """`step(state, batch, generator, draws=None) -> loss` (a 0-d tensor on
    the device, not synchronised).  `draws` = (ts, z) replaces the loss's
    random draws."""

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   draws=None) -> torch.Tensor:
        x, net_fn = _step_inputs(net, task, trainset_config, batch, generator, fused_apply)
        ts, z = draws if draws is not None else (None, None)
        return _step_update(state, diffusion_training_loss(net_fn, x, sched, generator,
                                                           ts=ts, z=z))

    return train_step


def _step_inputs(net: nn.Module, task: str, trainset_config: dict, batch: dict,
                 generator: torch.Generator, fused_apply: Optional[Callable]):
    """(target, net_fn) of a position step: the fused apply where there is
    one and no condition, else the module with the batch's condition."""
    x, condition = _prepare_x(task, trainset_config, batch["points"], batch.get("normals"),
                              generator)
    label = batch["label"]

    def net_fn(xt, ts):
        if fused_apply is not None and condition is None:
            return fused_apply(xt, ts, label)
        return net(xt, ts=ts, label=label, condition=condition)

    return x, net_fn


def make_x0_train_step(net: nn.Module, x0_sched: X0Schedule, standard_diffusion_config: dict,
                       task: str, trainset_config: dict,
                       fused_apply: Optional[Callable] = None) -> Callable:
    """The x0-engine (chamfer-loss) position step, taken where the config
    carries `standard_diffusion_config`: `step(state, batch, generator,
    draws=None) -> loss`, the batch mean of `x0_training_loss`'s
    `training_loss` at the config's `loss_type` and `normal_loss_type`.
    `draws` = (ts, z) replaces the loss's random draws."""
    loss_type = standard_diffusion_config["loss_type"]
    normal_loss_type = standard_diffusion_config.get("normal_loss_type", "cos")

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   draws=None) -> torch.Tensor:
        x, net_fn = _step_inputs(net, task, trainset_config, batch, generator, fused_apply)
        ts, z = draws if draws is not None else (None, None)
        out = x0_training_loss(net_fn, x, x0_sched, generator, loss_type=loss_type,
                               normal_loss_type=normal_loss_type, ts=ts, z=z)
        return _step_update(state, out["training_loss"])

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
                arr = kernel_to_torch(arr)
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
                 seed: int = 0, eval_hook: Optional[Callable] = None,
                 verbose: bool = True):
    """The training loop: resume, one step per batch (`points`, `normals`,
    `label` and, where the dataset loads it, `psr` on the device), logging,
    checkpoints, and `eval_hook(net, ema shadows, iteration)` after each
    checkpoint of the cadence.  Where the config sets `activation_dtype`, the
    steps and hooks run under it (`nn/precision.py`), and the dtype before
    the run is restored when it ends.  Returns (state,
    [(iter, loss), ...]) with a loss every `iters_per_logging` iterations;
    a non-finite logged loss raises FloatingPointError.

    With `train_config["device_data"]` the split's raw clouds (and grids)
    go to the device once (`data/device_corpus.py`; their bytes are logged
    first) and each step's batch is assembled there from a (B,) int32 index
    array, the only per-step transfer: epochs are permutations of the
    dataset's entries from `np.random.default_rng(seed)`, full batches
    only (the ragged tail is dropped), as the JAX package's; the
    assembly's draws come from a generator on the device seeded with seed
    + 101.  The checkpoint, hook and resume cadence is the loader's.
    `steps_per_dispatch` (the JAX package's steps per `lax.scan`) is
    accepted and has no effect: the port dispatches step by step until
    its steps are captured as CUDA graphs (ROADMAP item 7).

    Under an initialised process group of W ranks (the counterpart of the
    JAX package's `mesh=`; `parallel/multihost.py`) the run is data
    parallel: each rank reads its rank's split of the data at batch
    `batch_size // W` (which must divide), starts from rank 0's
    parameters and EMA shadows (broadcast once, after any resume: every
    rank resumes from the same checkpoint), and runs each step inside
    `parallel.data_parallel()`: the global batch's draws, its rows kept,
    and the gradients and the logged loss all-reduced to the global
    batch's mean.  The ranks take the number of iterations of the shortest
    rank's loader.  Only rank 0 writes checkpoints and the durable mirror
    and runs `eval_hook`; every rank returns once the last checkpoint is
    written.  `device_data` applies with W == 1 only."""
    train_config = config["train_config"]
    scope = activation_dtype_scope(train_config["activation_dtype"]) \
        if "activation_dtype" in train_config else contextlib.nullcontext()
    with scope:
        return _run_training(config, state, train_step, data_dir=data_dir,
                             max_iters=max_iters, seed=seed, eval_hook=eval_hook,
                             verbose=verbose)


def _run_training(config: dict, state: TrainState, train_step: Callable, *,
                  data_dir: Optional[str], max_iters: Optional[int], seed: int,
                  eval_hook: Optional[Callable], verbose: bool):
    train_config = config["train_config"]
    trainset_config = _trainset_config(config, data_dir)
    dev = next(state.net.parameters()).device
    _, output_directory = experiment_dirs(config)
    rank, world = (dist.get_rank(), dist.get_world_size()) if process_group_active() \
        else (0, 1)
    batch_size = trainset_config["batch_size"]
    if batch_size % world != 0:
        raise ValueError(
            f"batch size {batch_size} is not divisible by the {world} ranks — nothing "
            f"would ever train (pick batch_size as a multiple of {world})")
    batch_size //= world

    time_offset, ckpt_iter = 0, -1
    ckpt_sel = train_config.get("ckpt_iter")
    durable_dir = train_config.get("durable_ckpt_dir")
    if durable_dir and ckpt_sel == "max" and rank == 0:
        restored = restore_from_mirror(output_directory, durable_dir)
        if restored and verbose:
            print(f"restored checkpoint from durable mirror: {restored}", flush=True)
    if durable_dir and world > 1:
        dist.barrier()                   # the restored file is there for every rank
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
    if world > 1:
        broadcast_from_rank0(list(state.net.parameters())
                             + [t for shadow in state.ema for t in shadow])

    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    loader = get_dataloader(trainset_config, phase="train", seed=seed, rank=rank,
                            world_size=world)
    batches = _loader_batches(loader, dev)
    if train_config.get("device_data", False) and world == 1:
        batches = _device_batches(loader.dataset, trainset_config, dev, seed, verbose)
    loader_len = len(loader)
    if world > 1:
        loader_len = _min_over_ranks(loader_len, dev)
    n_iters = int(loader_len * train_config["n_epochs"])
    if max_iters is not None:
        n_iters = min(n_iters, max_iters)
    iters_per_ckpt = max(1, int(loader_len * train_config["epochs_per_ckpt"]))
    iters_per_logging = train_config["iters_per_logging"]
    step_scope = data_parallel if world > 1 else contextlib.nullcontext

    losses = []
    n_iter = ckpt_iter + 1
    t0 = log_t = time.time()
    warned_partial = False
    while n_iter < n_iters:
        start_iter = n_iter
        for dbatch in batches(batch_size):
            if n_iter >= n_iters:
                break
            if dbatch["label"].shape[0] != batch_size:
                if not warned_partial:
                    print(f"warning: skipping partial batch of {dbatch['label'].shape[0]} "
                          f"(batch_size {batch_size})", flush=True)
                    warned_partial = True
                continue
            with step_scope():
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
            if n_iter % iters_per_ckpt == 0 and rank == 0:
                _save(state, output_directory, n_iter - 1,
                      int(time.time() - t0) + time_offset, durable_dir)
                if eval_hook is not None:
                    eval_hook(state.net, state.ema, n_iter - 1)
            if n_iter >= n_iters:
                break                    # before the next batch is made
        if n_iter == start_iter:
            raise ValueError(f"no full batches of {batch_size} in the dataset: "
                             f"batch_size exceeds the usable dataset size")
    if n_iter > ckpt_iter + 1 and n_iter % iters_per_ckpt != 0 and rank == 0:
        # a run that ends off the cadence keeps its last iterations
        _save(state, output_directory, n_iter - 1, int(time.time() - t0) + time_offset,
              durable_dir)
    if world > 1:
        dist.barrier()                   # rank 0's last checkpoint is there for every rank
    return state, losses


def _min_over_ranks(value: int, dev) -> int:
    """The smallest of the ranks' `value`s (NCCL reduces on the card, gloo
    on the host)."""
    t = torch.tensor([value], device=dev if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def _loader_batches(loader, dev) -> Callable:
    """`batches(batch_size)`: one epoch of the loader's batches, on `dev`."""
    def batches(batch_size):
        for batch in loader:
            yield {key: torch.as_tensor(batch[key], dtype=dtype, device=dev)
                   for key, dtype in (("points", torch.float32), ("normals", torch.float32),
                                      ("psr", torch.float32), ("label", torch.int64))
                   if key in batch}
    return batches


def _device_batches(dataset, trainset_config: dict, dev, seed: int,
                    verbose: bool) -> Callable:
    """`batches(batch_size)`: one epoch of batches assembled on `dev` from
    the corpus, the full batches of a permutation of the dataset's entries
    (numpy, seeded with `seed`, as the JAX package's `ep_rng`)."""
    corpus = DeviceCorpus.from_dataset(dataset)
    if verbose:
        print(f"device corpus: {len(corpus)} entries, {corpus.nbytes} bytes", flush=True)
    corpus = corpus.to(dev)
    assemble = make_assemble_fn(trainset_config)
    data_gen = torch.Generator(device=dev).manual_seed(seed + 101)
    ep_rng = np.random.default_rng(seed)

    def batches(batch_size):
        n = len(corpus)
        perm = ep_rng.permutation(n)
        for i in range(n // batch_size):
            idx = torch.as_tensor(perm[i * batch_size:(i + 1) * batch_size].astype(np.int32))
            yield assemble(corpus, idx.to(dev), data_gen)
    return batches


# ---------------------------------------------------------------------------
# Checkpoint-time evaluation hooks (counterpart: the JAX package's
# `make_*_eval_hook`): `hook(net, ema shadows, iteration)`, called by
# `run_training` after each checkpoint of the cadence.  The DDPM hooks
# evaluate the raw weights and every EMA shadow, the latter under
# eval_result/model_ema_<rate>/.


def _eval_copy(net: nn.Module, shadow=None) -> nn.Module:
    """A copy of `net` in eval mode, with an EMA shadow's values if given."""
    out = copy.deepcopy(net).eval()
    if shadow is not None:
        with torch.no_grad():
            for p, s in zip(out.parameters(), shadow):
                p.copy_(s)
    return out


def _cadence(train_config: dict, run: Callable) -> Callable:
    """`run(net, ema shadows, iteration)` at every `eval_per_ckpt`-th
    checkpoint."""
    num_ckpts = [0]

    def hook(net, ema, n_iter):
        num_ckpts[0] += 1
        if num_ckpts[0] % train_config.get("eval_per_ckpt", 1) == 0:
            run(net, ema, n_iter)

    return hook


def _every_weight_set(config: dict, run_eval: Callable) -> Callable:
    """The DDPM hooks' cadence over the raw weights and each EMA shadow:
    run_eval(net, save_dir, ckpt_info)."""
    train_config = config["train_config"]
    ema_rates = tuple(train_config.get("ema_rate") or ())
    save_dir = os.path.join(experiment_dirs(config)[0], "eval_result")

    def run(net, ema, n_iter):
        ckpt_info = f"_iter_{n_iter}"
        run_eval(_eval_copy(net), save_dir, ckpt_info)
        for rate, shadow in zip(ema_rates, ema):
            run_eval(_eval_copy(net, shadow), os.path.join(save_dir, f"model_ema_{rate:.5f}"),
                     ckpt_info)

    return _cadence(train_config, run)


def make_generation_eval_hook(config: dict, *, data_dir: Optional[str] = None,
                              seed: int = 0, fused: bool = True) -> Callable:
    """The position DDPM's hook: a test set sampled per checkpoint
    (`evaluate_per_rank`) by the raw weights and by each EMA shadow.  The
    chain is the eps engine's, or the x0 engine's (`x0_denoise`) where the
    config carries `standard_diffusion_config`; an unconditional chain runs
    the fused denoiser where the config is in its scope (K1 on the card), a
    conditional one encodes its condition once."""
    trainset_config = _trainset_config(config, data_dir)
    task = config["train_config"]["task"]
    pfd = 3 + config["pointnet_config"]["in_fea_dim"]
    num_points = trainset_config["num_keypoints"] if task == "keypoint_generation" \
        else trainset_config["npoints"]
    dc = config.get("diffusion_config")
    sdc = config.get("standard_diffusion_config")

    def x0_sampler(net, x0_sched, fused_fn):
        def sampler(noise_fn, label, condition):
            net_fn = conditioned_net_fn(net, label, condition, fused_fn)
            return x0_denoise(net_fn, (label.shape[0], num_points, pfd), x0_sched, noise_fn)
        return sampler

    def run_eval(net, save_dir, ckpt_info):
        dev = next(net.parameters()).device
        sched = None if dc is None else \
            calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"], dev)
        custom = None
        if sdc is not None:
            fused_fn = make_fused_net_fn(config["pointnet_config"], net, num_points) \
                if fused else None
            custom = x0_sampler(net, X0Schedule.from_config(sdc, dev), fused_fn)
        evaluate_per_rank(net, trainset_config, sched, save_dir, task, point_feature_dim=pfd,
                          ckpt_info=ckpt_info, seed=seed, fused=fused, device=dev,
                          custom_sampler=custom)

    return _every_weight_set(config, run_eval)


def make_ae_eval_hook(config: dict, *, data_dir: Optional[str] = None,
                      seed: int = 0) -> Callable:
    """The autoencoder's hook: the visual evaluation on the val split and
    the quantitative history on the train and val splits (and, where the
    dataset config adds keypoint noise, on val without it)."""
    trainset_config = _trainset_config(config, data_dir)
    save_dir = os.path.join(experiment_dirs(config)[0], "eval_result")
    # the val split does not repeat (the dataset raises for it; the JAX
    # package's hook passes the training config's repeat_dataset and does)
    loaders = {"train": trainset_config, "val": dict(trainset_config, repeat_dataset=1)}

    def run(net, ema, n_iter):
        ae = _eval_copy(net)
        dev = next(ae.parameters()).device
        ae_visual_eval(ae, get_dataloader(loaders["val"], phase="val", seed=seed), save_dir,
                       n_iter, 0, trainset_config, seed=seed, device=dev)
        for phase, sub in (("train", "trainset_eval"), ("val", "valset_eval")):
            ae_quantitative_eval(ae, get_dataloader(loaders[phase], phase=phase, seed=seed),
                                 os.path.join(save_dir, sub), n_iter, 0, trainset_config,
                                 seed=seed, device=dev)
        if trainset_config.get("keypoint_noise_magnitude", 0) > 0:
            ae_quantitative_eval(ae, get_dataloader(loaders["val"], phase="val", seed=seed),
                                 os.path.join(save_dir, "valset_eval_keypoint_noise_0"),
                                 n_iter, 0, dict(trainset_config, keypoint_noise_magnitude=0),
                                 seed=seed, device=dev)

    return _cadence(config["train_config"], run)


def make_latent_eval_hook(config: dict, ae_params, *, data_dir: Optional[str] = None,
                          seed: int = 0, fused: bool = True) -> Callable:
    """The feature DDPM's hook: per checkpoint, latents sampled with the
    keypoints of train-split shapes pinned (the fused denoiser where the
    config is in its scope, K1 on the card), decoded by the frozen
    autoencoder (`ae_params`, a flax tree; its decode runs K3 on the card),
    by the raw weights and by each EMA shadow."""
    trainset_config = _trainset_config(config, data_dir)
    task = config["train_config"]["task"]
    k = trainset_config["num_keypoints"]
    pointnet_config = config["pointnet_config"]
    feat_dim = pointnet_config["in_fea_dim"]
    decoder = {}

    def run_eval(net, save_dir, ckpt_info):
        dev = next(net.parameters()).device
        if dev not in decoder:
            ae = build_autoencoder(config["autoencoder_config"]["pointnet_config"],
                                   decode_only=True)
            load_flax_params(ae, decode_params(ae_params))
            decoder[dev] = ae.to(dev).eval()
        ae = decoder[dev]
        sched = X0Schedule.from_config(config["standard_diffusion_config"], dev)
        fused_fn = make_fused_net_fn(pointnet_config, net, k) if fused else None

        def latent_sampler(noise_fn, start_fn, label, keypoint, **kw):
            def net_fn(x, ts):
                if fused_fn is not None:
                    return fused_fn(x, ts, label)
                return net(x, ts=ts, label=label)

            def decode_fn(kp, feat, lbl):
                return ae.decode(kp, feat, label=lbl, start_fn=start_fn)

            return latent_denoise_and_reconstruct(
                net_fn, decode_fn, label.shape[0], 3, (k, 3 + feat_dim), sched, noise_fn,
                label=label, keypoint=keypoint, **kw)

        evaluate_per_rank(net, trainset_config, None, save_dir, task,
                          point_feature_dim=feat_dim, ckpt_info=ckpt_info,
                          latent_sampler=latent_sampler, seed=seed, device=dev)

    return _every_weight_set(config, run_eval)


def make_sap_eval_hook(config: dict, *, data_dir: Optional[str] = None,
                       seed: int = 0) -> Callable:
    """The SAP net's hook: the DPSR-grid L2 on the val split (the metric
    that picks a SAP checkpoint), raw weights."""
    trainset_config = _trainset_config(config, data_dir)
    dpsr_config = config["dpsr_config"]
    save_dir = os.path.join(experiment_dirs(config)[0], "eval_result")

    def run(net, ema, n_iter):
        dev = next(net.parameters()).device
        dpsr = DPSR((dpsr_config["grid_res"],) * 3, sig=dpsr_config["psr_sigma"]).to(dev)
        sap_grid_eval(_eval_copy(net), dpsr,
                      get_dataloader(trainset_config, phase="val", seed=seed),
                      config["pointnet_config"], dpsr_config, trainset_config, save_dir,
                      n_iter, 0, scale=trainset_config["scale"], seed=seed, device=dev)

    return _cadence(config["train_config"], run)


def build_position_ddpm(config: dict, *, seed: int = 0, device=None, fused: bool = True):
    """The network (its parameters drawn from `seed`), Adam, the EMA
    shadows and the train step of the position DDPM: (TrainState, step).
    The step is the x0 engine's where the config carries
    `standard_diffusion_config`, else the eps engine's; only
    `keypoint_generation` (no condition, a fixed number of points) runs the
    fused denoiser."""
    train_config = config["train_config"]
    trainset_config = config["shapenet_psr_dataset_config"]
    task = train_config["task"]
    if task not in POSITION_TASKS:
        raise ValueError(f"task {task} not handled by this driver")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(device)
    pointnet_config = config["pointnet_config"]
    net = build_network(pointnet_config)
    init_params(net, torch.Generator().manual_seed(seed))
    state = _new_state(net.to(dev).train(), train_config)
    n_points = trainset_config["num_keypoints"] if task == "keypoint_generation" \
        else trainset_config["npoints"]
    fused_apply = None
    if task == "keypoint_generation":
        fused_apply = maybe_fused_train_apply(pointnet_config, n_points, net, fused)
    if "standard_diffusion_config" in config:
        sdc = config["standard_diffusion_config"]
        return state, make_x0_train_step(net, X0Schedule.from_config(sdc, dev), sdc, task,
                                         trainset_config, fused_apply=fused_apply)
    dc = config["diffusion_config"]
    sched = calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"], dev)
    return state, make_train_step(net, sched, task, trainset_config, fused_apply=fused_apply)


def train_position_ddpm(config: dict, *, data_dir: Optional[str] = None,
                        max_iters: Optional[int] = None, seed: int = 0, device=None,
                        fused: bool = True, eval_hook: Optional[Callable] = None,
                        verbose: bool = True):
    """Train the position (keypoint) DDPM per `config["train_config"]`
    (counterpart: the JAX package's `train_position_ddpm`).  Returns
    (TrainState, [(iter, loss), ...])."""
    state, step = build_position_ddpm(config, seed=seed, device=device, fused=fused)
    if eval_hook == "auto":
        eval_hook = make_generation_eval_hook(config, data_dir=data_dir, seed=seed,
                                              fused=fused)
    return run_training(config, state, step, data_dir=data_dir, max_iters=max_iters,
                        seed=seed, eval_hook=eval_hook, verbose=verbose)


def _draw_fns(generator: torch.Generator, device, draws: Optional[dict]):
    """(noise_fn, start_fn) of a step: the posterior noises and FPS starts in
    `draws` ("posterior", "fps_starts": lists in call order) when given,
    else drawn from `generator`."""
    draws = draws or {}
    if "posterior" in draws:
        noises = iter(draws["posterior"])

        def noise_fn(shape):
            return next(noises).to(device)
    else:
        def noise_fn(shape):
            return batch_randn(shape, generator).to(device)
    if "fps_starts" in draws:
        starts = iter(draws["fps_starts"])

        def start_fn(b, n):
            return torch.as_tensor(next(starts), device=device)
    else:
        def start_fn(b, n):
            return batch_randint(n, (b,), generator, dtype=torch.int32).to(device)
    return noise_fn, start_fn


# ---------------------------------------------------------------------------
# The point autoencoder


def make_ae_train_step(ae: nn.Module, trainset_config: dict) -> Callable:
    """`step(state, batch, generator, draws=None) -> loss`: unit normals,
    noisy FPS keypoints, the round trip and the sum over levels of the
    batch-mean `training_loss`.  `draws` replaces the step's random draws:
    "keypoint_noise" (B, K, 3), "posterior" (the keypoint level's two noises)
    and "fps_starts" (the three trims', then the targets')."""

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   draws: Optional[dict] = None) -> torch.Tensor:
        points, label = batch["points"], batch["label"]
        normals = batch["normals"]
        normals = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
        keypoint = sample_train_keypoints(points, trainset_config, generator,
                                          noise=(draws or {}).get("keypoint_noise"))
        noise_fn, start_fn = _draw_fns(generator, points.device, draws)
        _, loss_list = ae(torch.cat([points, normals], dim=-1), keypoint, label=label,
                          loss_type="cd_p", noise_fn=noise_fn, start_fn=start_fn)
        return _step_update(state, sum(ld["training_loss"].mean() for ld in loss_list))

    return train_step


def build_ae_training(config: dict, *, seed: int = 0, device=None):
    """The autoencoder (its parameters drawn from `seed`), Adam, the EMA
    shadows (none with the shipped preset) and the train step:
    (TrainState, step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(device)
    ae = build_autoencoder(config["pointnet_config"])
    init_params(ae, torch.Generator().manual_seed(seed))
    state = _new_state(ae.to(dev).train(), config["train_config"])
    return state, make_ae_train_step(ae, config["shapenet_psr_dataset_config"])


def train_autoencoder(config: dict, *, data_dir: Optional[str] = None,
                      max_iters: Optional[int] = None, seed: int = 0, device=None,
                      eval_hook: Optional[Callable] = None, verbose: bool = True):
    """Train the point autoencoder per `config["train_config"]` (counterpart:
    the JAX package's `train_autoencoder`).  Returns (TrainState,
    [(iter, loss), ...])."""
    state, step = build_ae_training(config, seed=seed, device=device)
    if eval_hook == "auto":
        eval_hook = make_ae_eval_hook(config, data_dir=data_dir, seed=seed)
    return run_training(config, state, step, data_dir=data_dir, max_iters=max_iters,
                        seed=seed, eval_hook=eval_hook, verbose=verbose)


# ---------------------------------------------------------------------------
# The feature (latent) DDPM


def make_latent_train_step(net: nn.Module, ae: nn.Module, sched: X0Schedule,
                           diffusion_config: dict, trainset_config: dict,
                           fused_apply: Optional[Callable] = None) -> Callable:
    """`step(state, batch, generator, draws=None) -> loss`: FPS keypoints,
    the frozen autoencoder's encode (its posterior sampled), the latent eps
    loss's batch mean.  `draws` replaces the step's random draws:
    "posterior" (encode's two noises), "ts" (B,) and "z" (the latent's
    shape)."""
    kp_cond = diffusion_config.get("keypoint_conditional", False)
    kp_w, feat_w = latent_config_weights(diffusion_config)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   draws: Optional[dict] = None) -> torch.Tensor:
        draws = draws or {}
        points, label = batch["points"], batch["label"]
        keypoint = sample_train_keypoints(points, trainset_config, generator)
        x = points
        if trainset_config.get("include_normals", True):
            x = torch.cat([x, batch["normals"]], dim=-1)
        noise_fn, _ = _draw_fns(generator, points.device, draws)

        def encode_fn(xx, kp, lbl):
            return ae.encode(xx, kp, label=lbl, noise_fn=noise_fn)

        def net_fn(xt, ts):
            if fused_apply is not None:
                return fused_apply(xt, ts, label)
            return net(xt, ts=ts, label=label)

        per_cloud = latent_train_loss(
            net_fn, encode_fn, x, keypoint, label, sched, keypoint_conditional=kp_cond,
            keypoint_position_loss_weight=kp_w, feature_loss_weight=feat_w,
            generator=generator, ts=draws.get("ts"), z=draws.get("z"))
        return _step_update(state, per_cloud.mean())

    return train_step


def build_latent_training(config: dict, ae_params, *, seed: int = 0, device=None,
                          fused: bool = True):
    """The feature DDPM's denoiser (its parameters drawn from `seed`), Adam,
    the EMA shadows, the frozen autoencoder (`ae_params`, a flax tree of the
    whole AE) and the train step: (TrainState, step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(device)
    trainset_config = config["shapenet_psr_dataset_config"]
    sched = X0Schedule.from_config(config["standard_diffusion_config"], dev)
    pointnet_config = config["pointnet_config"]
    net = build_network(pointnet_config)
    init_params(net, torch.Generator().manual_seed(seed))
    state = _new_state(net.to(dev).train(), config["train_config"])
    ae = build_autoencoder(config["autoencoder_config"]["pointnet_config"])
    load_flax_params(ae, ae_params)
    ae = ae.to(dev).eval().requires_grad_(False)
    fused_apply = maybe_fused_train_apply(pointnet_config, trainset_config["num_keypoints"],
                                          net, fused)
    return state, make_latent_train_step(net, ae, sched, config["standard_diffusion_config"],
                                         trainset_config, fused_apply=fused_apply)


def train_latent_ddpm(config: dict, ae_params, *, data_dir: Optional[str] = None,
                      max_iters: Optional[int] = None, seed: int = 0, device=None,
                      fused: bool = True, eval_hook: Optional[Callable] = None,
                      verbose: bool = True):
    """Train the feature (latent) DDPM against a frozen autoencoder
    (counterpart: the JAX package's `train_latent_ddpm`).  `ae_params` is
    the autoencoder's flax tree (e.g. a checkpoint's `model_state_dict`); its
    structure comes from `config["autoencoder_config"]["pointnet_config"]`.
    Returns (TrainState, [(iter, loss), ...])."""
    state, step = build_latent_training(config, ae_params, seed=seed, device=device,
                                        fused=fused)
    if eval_hook == "auto":
        eval_hook = make_latent_eval_hook(config, ae_params, data_dir=data_dir, seed=seed,
                                          fused=fused)
    return run_training(config, state, step, data_dir=data_dir, max_iters=max_iters,
                        seed=seed, eval_hook=eval_hook, verbose=verbose)


# ---------------------------------------------------------------------------
# The SAP refine+upsample net


def make_upsampler_train_step(net: nn.Module, dpsr: nn.Module, trainset_config: dict,
                              dpsr_config: dict, pointnet_config: dict,
                              ae: Optional[nn.Module] = None,
                              noise_magnitude: float = 0.0) -> Callable:
    """`step(state, batch, generator, draws=None) -> loss`: unit normals,
    optionally the cloud corrupted by a frozen autoencoder's round trip
    (noisy FPS keypoints, `encode` with its posterior sampled, `decode`,
    then `noise_magnitude` noise), the mirror and its +1 / -1 tags, the SAP
    net's displacements, the split cloud's DPSR grid and the (tanh-)MSE
    against the batch's `psr` grid.  `draws` replaces the step's random
    draws: "keypoint_noise" (B, K, 3), "posterior" (encode's two noises),
    "ae_noise" (the decoded cloud's noise, (B, N, split_factor, F) under
    `split_before_refine`, else its shape) and "perm" (the mirror's)."""
    mirror_first = dpsr_config.get("mirror_before_upsampling", False)
    only_orig = dpsr_config.get("only_original_points_split", False)
    split = dpsr_config.get("split_before_refine", False)
    include_normals = trainset_config.get("include_normals", True)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   draws: Optional[dict] = None) -> torch.Tensor:
        draws = draws or {}
        points, label = batch["points"], batch["label"]
        normals = batch["normals"]
        normals = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
        x = torch.cat([points, normals if include_normals else torch.zeros_like(points)],
                      dim=-1)
        if ae is not None:
            with torch.no_grad():
                keypoint = sample_train_keypoints(points, trainset_config, generator,
                                                  noise=draws.get("keypoint_noise"))
                noise_fn, _ = _draw_fns(generator, points.device, draws)
                feat = ae.encode(x, keypoint, label=label, noise_fn=noise_fn)
                x = ae.decode(keypoint, feat, label=label)
            if noise_magnitude > 0:
                b, n, f = x.shape
                shape = (b, n, dpsr_config["split_factor"], f) if split else (b, n, f)
                noise = draws.get("ae_noise")
                if noise is None:
                    noise = batch_randn(shape, generator)
                noise = noise_magnitude * noise.to(x.device)
                x = (x[:, :, None, :] + noise).reshape(b, -1, f) if split else x + noise
        if mirror_first:
            x = mirror_and_concat(x, axis=2, attach_label=True, permute=not only_orig,
                                  generator=generator, perm=draws.get("perm"))[0]
        return _step_update(state, upsampler_loss(net, dpsr, x, label, batch["psr"],
                                                  trainset_config, dpsr_config,
                                                  pointnet_config))

    return train_step


def upsampler_loss(net: nn.Module, dpsr: nn.Module, x: torch.Tensor, label: torch.Tensor,
                   target: torch.Tensor, trainset_config: dict, dpsr_config: dict,
                   pointnet_config: dict) -> torch.Tensor:
    """The SAP loss of a (mirrored and tagged, per the config) cloud `x`: the
    net's displacements, the split cloud's DPSR grid, its (tanh-)MSE
    against the `target` grid."""
    disp = net(x, ts=None, label=label)
    grid, _, _ = network_output_to_dpsr_grid(
        x, disp, dpsr, trainset_config["scale"], pointnet_config,
        last_dim_as_indicator=dpsr_config.get("mirror_before_upsampling", False),
        only_original_points_split=dpsr_config.get("only_original_points_split", False))
    if dpsr_config.get("psr_tanh", True):
        return torch.mean((torch.tanh(grid) - torch.tanh(target)) ** 2)
    return torch.mean((grid - target) ** 2)


def build_upsampler_training(config: dict, *, ae_params=None, seed: int = 0, device=None):
    """The SAP net (its parameters drawn from `seed`), Adam, the EMA shadows
    (none with the shipped preset), DPSR on the device, the frozen
    autoencoder when the config has an `autoencoder_config` and `ae_params`
    (a flax tree of the whole AE) is given, and the train step:
    (TrainState, step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(device)
    pointnet_config = config["pointnet_config"]
    dpsr_config = config["dpsr_config"]
    dpsr = DPSR((dpsr_config["grid_res"],) * 3, sig=dpsr_config["psr_sigma"]).to(dev)
    net = build_network(pointnet_config)
    init_params(net, torch.Generator().manual_seed(seed))
    state = _new_state(net.to(dev).train(), config["train_config"])
    ae, noise_magnitude = None, 0.0
    if config.get("autoencoder_config") and ae_params is not None:
        ae = build_autoencoder(config["autoencoder_config"]["pointnet_config"])
        load_flax_params(ae, ae_params)
        ae = ae.to(dev).eval().requires_grad_(False)
        noise_magnitude = config["autoencoder_config"].get("noise_magnitude", 0.0)
    return state, make_upsampler_train_step(net, dpsr, config["shapenet_psr_dataset_config"],
                                            dpsr_config, pointnet_config, ae=ae,
                                            noise_magnitude=noise_magnitude)


def train_upsampler(config: dict, *, ae_params=None, data_dir: Optional[str] = None,
                    max_iters: Optional[int] = None, seed: int = 0, device=None,
                    eval_hook: Optional[Callable] = None, verbose: bool = True):
    """Train the SAP refine+upsample net against the dataset's DPSR grids
    (counterpart: the JAX package's `train_upsampler`), optionally on clouds
    corrupted by a frozen autoencoder's round trip (`ae_params`, with the
    config's `autoencoder_config`).  Returns (TrainState, [(iter, loss), ...])."""
    state, step = build_upsampler_training(config, ae_params=ae_params, seed=seed,
                                           device=device)
    if eval_hook == "auto":
        eval_hook = make_sap_eval_hook(config, data_dir=data_dir, seed=seed)
    return run_training(config, state, step, data_dir=data_dir, max_iters=max_iters,
                        seed=seed, eval_hook=eval_hook, verbose=verbose)
