"""Mesh generation: position DDPM -> feature DDPM -> autoencoder decode ->
SAP refine+upsample -> DPSR -> marching tetrahedra and surface sampling
(counterpart: `benchmarks/e2e_pipeline.py::build_stages` / `device_chain`
and `main`'s mesh step, and the CLI's `latent-generate`, whose AE loading it
follows).

Both DDPM chains run the fused denoiser by default (`fused=True`, the JAX
package's default `SLIDE_TPU_FUSED=1`): on the card every denoiser step is
one launch of the CUDA kernel of `models/fused_denoiser.py`.  `fused=False`
runs the `ConditionalPointNet2` module instead.  The decode's FPS trims and
SA levels and the SAP net's SA levels run the CUDA kernel of `ops/fps.py`.
DPSR and the extraction run on the same device (`sap/`).  Everything is
fp32 with TF32 off.

    stages = build_stages(batch=16)          # the card, committed checkpoints
    out = generate(stages, seed=0)           # out["cloud"]: (16, 2048, 6)
    verts, faces, normals = sap.mesh_to_host(out["mesh"], 0)   # sample 0's mesh
    out = generate(with_fastdpm(stages, 50), seed=0)   # FastDPM, 50 + 50 steps

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
card they raise.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Optional

import torch

from slide_tpu_torch.config import restore_lists
from slide_tpu_torch.configs import (autoencoder_config, keypoint_ddpm_config,
                                     latent_ddpm_config, upsampler_config)
from slide_tpu_torch.diffusion import (DiffusionSchedule, X0Schedule,
                                       calc_diffusion_hyperparams, diffusion_config_of,
                                       diffusion_sampling, fast_sampling,
                                       fast_x0_denoise, x0_denoise)
from slide_tpu_torch.models import (ConditionalPointNet2, PointAutoencoder,
                                    build_autoencoder, decode_params)
from slide_tpu_torch.models.fused_denoiser import make_fused_net_fn, scope_error
from slide_tpu_torch.sap import (DPSR, extract_and_sample_device, mirror_and_concat,
                                 network_output_to_dpsr_grid)
from slide_tpu_torch.weights import load_flax_params, load_inference_params

_CKPT_DIR = Path(__file__).resolve().parent.parent / "benchmarks" / "results" / "ckpts"
# FastDPM's noise scale, as the JAX pipeline's `with_fastdpm` runs it
FASTDPM_KAPPA = 0.5
DEFAULT_CKPTS = {"kp": _CKPT_DIR / "kp" / "pointnet_ckpt_19999.pkl",
                 "lat": _CKPT_DIR / "lat" / "pointnet_ckpt_24999.pkl",
                 "ae": _CKPT_DIR / "ae" / "pointnet_ckpt_29999.pkl",
                 "sap": _CKPT_DIR / "sap" / "pointnet_ckpt_9999.pkl"}
# surface points sampled from each mesh, as the JAX pipeline samples them
NUM_SAMPLES = 2048


def resolve_device(device=None) -> torch.device:
    """`cuda` unless asked otherwise; raises when the card is missing."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def default_configs() -> dict:
    """The shipped airplane presets of the first three stages and the SAP
    refine+upsample preset (all 13 classes; its `dpsr_config` sets DPSR's
    grid, 128^3, and sigma, 2)."""
    return {"kp": keypoint_ddpm_config("airplane"),
            "lat": latent_ddpm_config("airplane"),
            "ae": autoencoder_config("airplane"),
            "sap": upsampler_config()}


@dataclasses.dataclass
class Stages:
    """The stages' networks, schedules and DPSR on one device.  `kp_fused` /
    `lat_fused` are the fused denoisers (`make_fused_net_fn`), None when the
    chains run the modules; `fastdpm` > 0 swaps both chains for S-step
    FastDPM samplers (STEP method, quadratic schedule, kappa 0.5)."""

    batch: int
    device: torch.device
    label: torch.Tensor
    kp_net: ConditionalPointNet2
    lat_net: ConditionalPointNet2
    ae: PointAutoencoder
    kp_sched: DiffusionSchedule
    lat_sched: X0Schedule
    sap_net: ConditionalPointNet2
    sap_config: Mapping[str, Any]
    dpsr: DPSR
    num_keypoints: int
    latent_dim: int
    kp_fused: Optional[Callable] = None
    lat_fused: Optional[Callable] = None
    fastdpm: int = 0

    def kp_eps(self, x, ts) -> torch.Tensor:
        if self.kp_fused is not None:
            return self.kp_fused(x, ts, self.label)
        return self.kp_net(x, ts=ts, label=self.label)

    def lat_eps(self, x, ts) -> torch.Tensor:
        if self.lat_fused is not None:
            return self.lat_fused(x, ts, self.label)
        return self.lat_net(x, ts=ts, label=self.label)

    def sample_kp(self, noise_fn) -> torch.Tensor:
        """Position DDPM: (B, K, 3) keypoints."""
        shape = (self.batch, self.num_keypoints, 3)
        if self.fastdpm > 0:
            return fast_sampling(self.kp_eps, shape, self.kp_sched,
                                 diffusion_config_of(self.kp_sched), noise_fn,
                                 length=self.fastdpm, sampling_method="step",
                                 schedule="quadratic", kappa=FASTDPM_KAPPA)
        return diffusion_sampling(self.kp_eps, shape, self.kp_sched, noise_fn)

    def sample_lat(self, noise_fn, keypoint: torch.Tensor) -> torch.Tensor:
        """Feature DDPM with the keypoints pinned: (B, K, 3 + latent_dim)."""
        shape = (self.batch, self.num_keypoints, 3 + self.latent_dim)
        if self.fastdpm > 0:
            return fast_x0_denoise(self.lat_eps, shape, self.lat_sched, noise_fn,
                                   length=self.fastdpm, schedule="quadratic",
                                   kappa=FASTDPM_KAPPA, keypoint=keypoint, keypoint_dim=3)
        return x0_denoise(self.lat_eps, shape, self.lat_sched, noise_fn,
                          keypoint=keypoint, keypoint_dim=3)

    @torch.no_grad()
    def decode(self, keypoint, feature, start_fn=None) -> torch.Tensor:
        """Autoencoder decode: (B, 2048, 6) points + normals."""
        return self.ae.decode(keypoint, feature, label=self.label, start_fn=start_fn)

    @torch.no_grad()
    def sap(self, cloud: torch.Tensor, generator: Optional[torch.Generator] = None,
            perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """SAP refine+upsample and DPSR: the cloud (B, N, 6) mirrored along z
        and tagged, its 2N points shuffled by one permutation (`perm`, else
        drawn from `generator`), the SAP net's displacements split each point
        into 5, and DPSR solves for the indicator grid (B, *res).  No tanh:
        the JAX package applies it only in the SAP training loss."""
        xm = mirror_and_concat(cloud, axis=2, attach_label=True, permute=True,
                               generator=generator, perm=perm)[0]
        disp = self.sap_net(xm, ts=None, label=self.label)
        grid, _, _ = network_output_to_dpsr_grid(
            xm, disp, self.dpsr, 1, self.sap_config, last_dim_as_indicator=True,
            explicit_normalize=True)
        return grid


def _params(src, ema_idx: int) -> Mapping[str, Any]:
    if isinstance(src, (str, os.PathLike)):
        return load_inference_params(str(src), ema_idx)
    return src


def build_stages(batch: int, t_steps: int = 1000, ckpts: Optional[Mapping] = None,
                 device=None, configs: Optional[Mapping] = None,
                 ema_idx: int = -1, fused: bool = True) -> Stages:
    """Build the stages.  `ckpts` maps kp / lat / ae / sap to a checkpoint
    path or a flax parameter tree (default: the committed checkpoints);
    `configs` maps them to full experiment configs (default, for each one
    it leaves out: `default_configs()`).
    `fused` runs both chains through the fused denoiser and raises, naming
    the reason, when a denoiser's config is outside its scope; `fused=False`
    runs the modules.

    `ema_idx` >= 0 picks that EMA shadow of the two DDPM checkpoints; the
    autoencoder always loads its raw parameters, as
    `slide_tpu/cli/main.py::cmd_latent_generate` loads it: the committed AE
    checkpoint holds no EMA shadows (no `ema_state_list`).  So does the SAP
    net, as `benchmarks/e2e_pipeline.py::_maybe_load` loads it at
    `ema_idx=-1`: its committed checkpoint has no shadows either."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(device)
    configs = restore_lists(copy.deepcopy({**default_configs(), **(configs or {})}))
    ckpts = {**DEFAULT_CKPTS, **(ckpts or {})}

    kp_cfg, lat_cfg, ae_cfg, sap_cfg = (configs[k] for k in ("kp", "lat", "ae", "sap"))
    dc = kp_cfg["diffusion_config"]
    kp_sched = calc_diffusion_hyperparams(t_steps, dc["beta_0"], dc["beta_T"], dev)
    sdc = dict(lat_cfg["standard_diffusion_config"], num_diffusion_timesteps=t_steps)
    lat_sched = X0Schedule.from_config(sdc, dev)

    kp_net = ConditionalPointNet2(kp_cfg["pointnet_config"])
    load_flax_params(kp_net, _params(ckpts["kp"], ema_idx))
    lat_net = ConditionalPointNet2(lat_cfg["pointnet_config"])
    load_flax_params(lat_net, _params(ckpts["lat"], ema_idx))
    ae = build_autoencoder(ae_cfg["pointnet_config"], decode_only=True)
    load_flax_params(ae, decode_params(_params(ckpts["ae"], -1)))
    sap_net = ConditionalPointNet2(sap_cfg["pointnet_config"])
    load_flax_params(sap_net, _params(ckpts["sap"], -1))
    dpsr_cfg = sap_cfg["dpsr_config"]
    dpsr = DPSR((dpsr_cfg["grid_res"],) * 3, sig=dpsr_cfg["psr_sigma"])

    kp_net, lat_net = kp_net.to(dev).eval(), lat_net.to(dev).eval()
    num_keypoints = lat_cfg["shapenet_psr_dataset_config"]["num_keypoints"]
    kp_fused = lat_fused = None
    if fused:
        for name, cfg in (("kp", kp_cfg), ("lat", lat_cfg)):
            reason = scope_error(cfg["pointnet_config"], num_keypoints)
            if reason is not None:
                raise ValueError(f"fused=True: the {name} denoiser's config is outside "
                                 f"the fused kernel's scope ({reason}); pass fused=False")
        kp_fused = make_fused_net_fn(kp_cfg["pointnet_config"], kp_net, num_keypoints)
        lat_fused = make_fused_net_fn(lat_cfg["pointnet_config"], lat_net, num_keypoints)

    return Stages(
        batch=batch, device=dev,
        label=torch.zeros((batch,), dtype=torch.int64, device=dev),
        kp_net=kp_net, lat_net=lat_net, ae=ae.to(dev).eval(), kp_sched=kp_sched,
        lat_sched=lat_sched, sap_net=sap_net.to(dev).eval(),
        sap_config=sap_cfg["pointnet_config"], dpsr=dpsr.to(dev), num_keypoints=num_keypoints,
        latent_dim=lat_cfg["pointnet_config"]["in_fea_dim"],
        kp_fused=kp_fused, lat_fused=lat_fused)


def with_fastdpm(stages: Stages, length: int) -> Stages:
    """The same stages with both DDPM chains swapped for `length`-step
    FastDPM samplers (STEP method, quadratic schedule, kappa 0.5), over the
    same nets (counterpart: `benchmarks/e2e_pipeline.py::with_fastdpm`)."""
    return dataclasses.replace(stages, fastdpm=length)


@torch.no_grad()
def generate(stages: Stages, seed: int = 0, *, noise_fn: Optional[Callable] = None,
             start_fn: Optional[Callable] = None,
             perm: Optional[torch.Tensor] = None) -> dict:
    """One pass of the stages with every random choice drawn from one
    generator seeded with `seed`: the chains' noise, the decode's FPS
    starts, the mirror's permutation, the surface samples.  `noise_fn`,
    `start_fn` and `perm` replace the first three (a test replays another
    implementation's draws).

    Returns the decoded cloud (B, N, 6), the keypoints (B, K, 3), their
    features (B, K, latent_dim), the DPSR grid (B, R, R, R), NUM_SAMPLES
    surface points and their unit normals (B, NUM_SAMPLES, 3) from each
    sample's mesh, the true face and active-cell counts (B,), the batch's
    mesh (`sap.mesh_to_host(out["mesh"], i)` gives sample i's verts, faces
    and normals) and the seconds of each stage."""
    dev = stages.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    if noise_fn is None:
        def noise_fn(shape):
            return torch.randn(tuple(shape), generator=gen, device=dev)

    if start_fn is None:
        def start_fn(b, n):
            return torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = sync()
    kp = stages.sample_kp(noise_fn)
    t1 = sync()
    latent = stages.sample_lat(noise_fn, kp)
    t2 = sync()
    cloud = stages.decode(latent[..., :3], latent[..., 3:], start_fn)
    t3 = sync()
    grid = stages.sap(cloud, gen, perm)
    t4 = sync()
    points, normals, n_faces, n_cells, mesh = extract_and_sample_device(grid, gen, NUM_SAMPLES)
    t5 = sync()
    return {"cloud": cloud, "keypoints": latent[..., :3], "features": latent[..., 3:],
            "grid": grid, "points": points, "normals": normals, "n_faces": n_faces,
            "n_cells": n_cells, "mesh": mesh,
            "seconds": {"position_ddpm": t1 - t0, "feature_ddpm": t2 - t1,
                        "ae_decode": t3 - t2, "sap_dpsr": t4 - t3, "marching": t5 - t4}}
