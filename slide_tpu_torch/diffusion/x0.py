"""x0-parameterized DDPM sampler (counterpart: `slide_tpu/diffusion/x0.py`),
the engine of the feature DDPM.  The model predicts epsilon; a step turns it
into a clipped x0 prediction and samples the posterior.  Noise comes from
`noise_fn(shape)`: one draw for x_T (when no x is given) and one per step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from slide_tpu_torch.diffusion.eps import NoiseFn


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
    """The sampler's coefficients, computed in float64, stored fp32."""

    T: int
    data_clamp_range: float
    model_output_scale_factor: float
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
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

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return X0Schedule(
            T=betas.shape[0],
            data_clamp_range=config["data_clamp_range"],
            model_output_scale_factor=config["model_output_scale_factor"],
            alphas=f32(alphas), alphas_cumprod=f32(acp),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
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
