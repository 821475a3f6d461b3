"""x0-parameterized DDPM engine (counterpart: `slide_tpu/diffusion/x0.py`),
the engine of the feature DDPM and of the chamfer-loss position DDPM.  The
model predicts epsilon; a step turns it into a clipped x0 prediction and
samples the posterior; training (`x0_training_loss`) scores the predicted
x0 with chamfer, F-score and MSE terms.  Noise comes from `noise_fn(shape)`:
one draw for x_T (when no x is given) and one per step; the training loss
and the forward diffusions draw from a `torch.Generator` unless handed
their draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from slide_tpu_torch.diffusion.eps import NoiseFn
from slide_tpu_torch.ops.chamfer import calc_cd
from slide_tpu_torch.parallel.sharded import batch_randint, batch_randn


def _warmup_beta(beta_start, beta_end, t, frac):
    betas = beta_end * np.ones(t, dtype=np.float64)
    warmup = int(t * frac)
    betas[:warmup] = np.linspace(beta_start, beta_end, warmup, dtype=np.float64)
    return betas


def get_beta_schedule(beta_schedule: str, *, beta_start: float, beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    t = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, t, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, t, dtype=np.float64)
    elif beta_schedule == "warmup10":
        betas = _warmup_beta(beta_start, beta_end, t, 0.1)
    elif beta_schedule == "warmup50":
        betas = _warmup_beta(beta_start, beta_end, t, 0.5)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(t, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(t, 1, t, dtype=np.float64)
    else:
        raise NotImplementedError(beta_schedule)
    return betas


@dataclasses.dataclass(frozen=True)
class X0Schedule:
    """The engine's coefficients, computed in float64, stored fp32.
    `t_truncation`: the mixed losses' bound (timesteps below it take the
    chamfer term), from `t_trunction` (sic, the reference's key) or else
    from `xt_coefficient_trunction` (the timesteps whose sqrt(1 / abar)
    lies below it); 0 for the other loss types."""

    T: int
    data_clamp_range: float
    model_output_scale_factor: float
    scale_loss_terms: bool
    t_truncation: int
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    sqrt_alphas: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    logvar: torch.Tensor

    @staticmethod
    def from_config(config: dict, device="cpu") -> "X0Schedule":
        betas = get_beta_schedule(
            config["beta_schedule"], beta_start=config["beta_start"],
            beta_end=config["beta_end"],
            num_diffusion_timesteps=config["num_diffusion_timesteps"])
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
        model_var_type = config.get("model_var_type", "fixedsmall")
        if model_var_type == "fixedlarge":
            logvar = np.log(np.append(posterior_variance[1], betas[1:]))
        elif model_var_type == "fixedsmall":
            logvar = np.log(np.maximum(posterior_variance, 1e-20))
        else:
            raise ValueError(f"variance type {model_var_type} not supported")
        sqrt_recip = np.sqrt(1.0 / acp)
        t_trunc = 0
        if config.get("loss_type") in ("mixed_cd_p_epsilon_mse", "mixed_cd_t_epsilon_mse"):
            if "t_trunction" in config:
                t_trunc = int(config["t_trunction"])
            else:
                t_trunc = int((sqrt_recip < config["xt_coefficient_trunction"]).sum())

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return X0Schedule(
            T=betas.shape[0],
            data_clamp_range=config["data_clamp_range"],
            model_output_scale_factor=config["model_output_scale_factor"],
            scale_loss_terms=config.get("scale_loss_terms", False),
            t_truncation=t_trunc,
            alphas=f32(alphas), alphas_cumprod=f32(acp),
            sqrt_recip_alphas_cumprod=f32(sqrt_recip),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            sqrt_alphas=f32(np.sqrt(alphas)),
            sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
            logvar=f32(logvar))


def _bc(coeffs: torch.Tensor, ts: torch.Tensor, ndim: int) -> torch.Tensor:
    """Coefficients at ts, shaped to broadcast over a rank-ndim x."""
    return coeffs[ts.long()].reshape((ts.shape[0],) + (1,) * (ndim - 1))


def predict_xstart(sched: X0Schedule, x_t, ts, model_output):
    """Clipped x0 prediction from an epsilon prediction (already scaled)."""
    x0 = (_bc(sched.sqrt_recip_alphas_cumprod, ts, x_t.ndim) * x_t
          - _bc(sched.sqrt_recipm1_alphas_cumprod, ts, x_t.ndim) * model_output)
    if sched.data_clamp_range > 0:
        x0 = torch.clamp(x0, -sched.data_clamp_range, sched.data_clamp_range)
    return x0


def denoising_step(sched: X0Schedule, x, ts, model_output, noise, *,
                   complete_x0=None, keypoint_mask=None):
    """One reverse step p(x_{t-1} | x_t); with `keypoint_mask` (B, N) only the
    masked points take the new x0 (local resampling).  Returns (sample, x0)."""
    x0 = predict_xstart(sched, x, ts, model_output)
    if keypoint_mask is not None:
        m = keypoint_mask.reshape(keypoint_mask.shape
                                  + (1,) * (x.ndim - keypoint_mask.ndim)).to(x.dtype)
        x0 = x0 * m + complete_x0 * (1.0 - m)
    mean = (_bc(sched.posterior_mean_coef1, ts, x.ndim) * x0
            + _bc(sched.posterior_mean_coef2, ts, x.ndim) * x)
    logvar = _bc(sched.logvar, ts, x.ndim)
    nonzero = 1.0 - (ts == 0).to(x.dtype).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return mean + nonzero * torch.exp(0.5 * logvar) * noise, x0


@torch.no_grad()
def x0_denoise(net_fn: Callable, shape: Sequence[int], sched: X0Schedule,
               noise_fn: NoiseFn, *, x: Optional[torch.Tensor] = None,
               curr_step: Optional[int] = None, n_steps: Optional[int] = None,
               keypoint: Optional[torch.Tensor] = None, keypoint_dim: int = 0,
               complete_x0=None, keypoint_mask=None) -> torch.Tensor:
    """Reverse chain from x_curr_step (default: noise at T).  With `keypoint`,
    the first `keypoint_dim` channels are pinned to it before every network
    call and on the output."""
    shape = tuple(shape)
    b = shape[0]
    curr = sched.T if curr_step is None else curr_step
    steps = curr if (n_steps is None or curr - n_steps < 0) else n_steps
    if x is None:
        x = noise_fn(shape)

    def pin(x):
        if keypoint is None:
            return x
        return torch.cat([keypoint, x[..., keypoint_dim:]], dim=-1)

    for t in range(curr - 1, curr - steps - 1, -1):
        x = pin(x)
        ts = torch.full((b,), t, dtype=torch.int32, device=x.device)
        out = net_fn(x, ts) * sched.model_output_scale_factor
        x, _ = denoising_step(sched, x, ts, out, noise_fn(shape),
                              complete_x0=complete_x0, keypoint_mask=keypoint_mask)
    return pin(x)


LOSS_TYPES = ("cd_p", "cd_t", "x0_mse", "epsilon_mse", "mixed_cd_p_epsilon_mse",
              "mixed_cd_t_epsilon_mse")


def x0_training_loss(net_fn: Callable, x: torch.Tensor, sched: X0Schedule,
                     generator: Optional[torch.Generator] = None, *,
                     loss_type: str = "cd_p", normal_loss_type: str = "cos",
                     ts: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None) -> dict:
    """The x0 engine's training losses: x_t = sqrt(abar) x + sqrt(1 - abar) z
    at one uniformly drawn timestep per cloud, the network's epsilon (times
    the output scale), the unclipped x0 it implies (x_t held constant), and
    against x: `calc_cd`'s terms (with the F-score at 1e-4 and the feature
    terms where x has channels past xyz), "x0_mse", "epsilon_mse", and
    "training_loss" per `loss_type`.  With `scale_loss_terms` the x0 and the
    target are divided by sqrt(1 / abar - 1) first.  Returns each term's
    batch mean (0-d tensors).  `ts` (B,) and `z` (x's shape) are drawn from
    `generator` unless given (a test hands in the JAX draws)."""
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"loss type {loss_type} is not supported")
    b = x.shape[0]
    if ts is None:
        ts = batch_randint(sched.T, (b,), generator).to(x.device)
    if z is None:
        z = batch_randn(x.shape, generator, dtype=x.dtype).to(x.device)
    abar = _bc(sched.alphas_cumprod, ts, x.ndim)
    x_t = torch.sqrt(abar) * x + torch.sqrt(1.0 - abar) * z
    model_output = net_fn(x_t, ts) * sched.model_output_scale_factor
    x0 = (_bc(sched.sqrt_recip_alphas_cumprod, ts, x.ndim) * x_t.detach()
          - _bc(sched.sqrt_recipm1_alphas_cumprod, ts, x.ndim) * model_output)
    target = x
    if sched.scale_loss_terms:
        scale = _bc(sched.sqrt_recipm1_alphas_cumprod, ts, x.ndim)
        x0 = x0 / scale
        target = target / scale

    terms = calc_cd(x0, target.detach(), calc_f1=True, f1_threshold=0.0001,
                    normal_loss_type=normal_loss_type)
    terms["x0_mse"] = torch.sum((x0 - target) ** 2, dim=2).mean(dim=1)
    terms["epsilon_mse"] = torch.sum((model_output - z) ** 2, dim=2).mean(dim=1)
    zero = torch.zeros_like(terms["cd_p"])
    feat_p = terms.get("cd_feature_p", zero)
    feat_t = terms.get("cd_feature_t", zero)
    if loss_type == "cd_p":
        loss = terms["cd_p"] + feat_p
    elif loss_type == "cd_t":
        loss = terms["cd_t"] + feat_t
    elif loss_type in ("x0_mse", "epsilon_mse"):
        loss = terms[loss_type]
    else:
        small = (ts < sched.t_truncation).to(terms["cd_p"].dtype)
        cd = terms["cd_p"] + feat_p if loss_type == "mixed_cd_p_epsilon_mse" \
            else terms["cd_t"] + feat_t
        loss = small * cd + (1 - small) * terms["epsilon_mse"]
    terms["training_loss"] = loss
    return {k: torch.mean(v) for k, v in terms.items()}


def diffuse(x: torch.Tensor, sched: X0Schedule, noise_fn: NoiseFn, *, curr_step: int = 0,
            n_steps: Optional[int] = None) -> torch.Tensor:
    """Forward diffusion q(x_{t+1} | x_t) step by step: x is x_curr_step,
    the result x_{curr_step + n_steps} (n_steps up to T, and at most the
    steps left).  One `noise_fn(shape)` draw a step."""
    if curr_step >= sched.T:
        raise ValueError(f"curr_step {curr_step} must be < T={sched.T}")
    if n_steps is None or curr_step + n_steps > sched.T:
        n_steps = sched.T - curr_step
    for t in range(curr_step, curr_step + n_steps):
        x = (sched.sqrt_alphas[t].to(x.device) * x
             + sched.sqrt_one_minus_alphas[t].to(x.device) * noise_fn(tuple(x.shape)))
    return x


def diffuse_t_steps(x0: torch.Tensor, t: int, sched: X0Schedule,
                    noise: torch.Tensor) -> torch.Tensor:
    """The one-shot jump x_t ~ q(x_t | x_0) on the standard-normal `noise`,
    t in [0, T - 1]."""
    abar = sched.alphas_cumprod[t].to(x0.device)
    return torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * noise
