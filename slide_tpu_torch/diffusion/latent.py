"""Latent diffusion over keypoint features (counterpart:
`slide_tpu/diffusion/latent.py`): the training loss and the DDPM sampling
half.  The latent is [keypoint positions | keypoint features]; with
keypoints given (keypoint-conditional, every preset) they are pinned at
every step and only features are denoised.  The FastDPM samplers are
`fastdpm.py`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from slide_tpu_torch.diffusion.eps import NoiseFn
from slide_tpu_torch.diffusion.x0 import X0Schedule, _bc, x0_denoise


def latent_config_weights(config: dict) -> tuple[float, float]:
    """(keypoint_position_loss_weight, feature_loss_weight); keypoint
    positions carry no loss when they are the condition."""
    kp_w = config.get("keypoint_position_loss_weight", 1.0)
    feat_w = config.get("feature_loss_weight", 1.0)
    if config.get("keypoint_conditional", False):
        kp_w = 0.0
    return kp_w, feat_w


def latent_encode(encode_fn: Callable, x: torch.Tensor, keypoint: torch.Tensor,
                  label) -> torch.Tensor:
    """[keypoint | encode_fn(x, keypoint, label)] (B, K, 3 + latent)."""
    return torch.cat([keypoint, encode_fn(x, keypoint, label)], dim=-1)


def latent_train_loss(net_fn: Callable, encode_fn: Callable, x: torch.Tensor,
                      keypoint: torch.Tensor, label, sched: X0Schedule, *,
                      keypoint_conditional: bool, keypoint_position_loss_weight: float,
                      feature_loss_weight: float,
                      generator: Optional[torch.Generator] = None,
                      ts: Optional[torch.Tensor] = None,
                      z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-cloud weighted eps-MSE on the latent, (B,).  The latent is encoded
    without gradient; one timestep per cloud; x_t's keypoint positions are
    the keypoints when conditional.  `ts` (B,) and `z` (the latent's shape)
    are drawn from `generator` unless given (a test hands in the JAX draws)."""
    with torch.no_grad():
        latent = latent_encode(encode_fn, x, keypoint, label)
    b, kp_dim = latent.shape[0], keypoint.shape[-1]
    if ts is None:
        ts = torch.randint(0, sched.T, (b,), generator=generator,
                           device=generator.device).to(latent.device)
    if z is None:
        z = torch.randn(latent.shape, generator=generator, device=generator.device,
                        dtype=latent.dtype).to(latent.device)
    abar = _bc(sched.alphas_cumprod.to(latent.device), ts, latent.ndim)
    x_t = torch.sqrt(abar) * latent + torch.sqrt(1.0 - abar) * z
    if keypoint_conditional:
        x_t = torch.cat([keypoint, x_t[..., kp_dim:]], dim=-1)
    out = net_fn(x_t, ts) * sched.model_output_scale_factor
    mse = (out - z) ** 2
    loss = (keypoint_position_loss_weight * mse[..., :kp_dim].sum(dim=-1)
            + feature_loss_weight * mse[..., kp_dim:].mean(dim=-1))
    return loss.mean(dim=1)


@torch.no_grad()
def latent_denoise_and_reconstruct(net_fn: Callable, decode_fn: Callable, n: int,
                                   keypoint_dim: int, shape: Sequence[int],
                                   sched: X0Schedule, noise_fn: NoiseFn, *,
                                   label=None, keypoint: Optional[torch.Tensor] = None,
                                   x: Optional[torch.Tensor] = None,
                                   curr_step: Optional[int] = None,
                                   n_steps: Optional[int] = None,
                                   local_resampling: bool = False,
                                   complete_x0=None, keypoint_mask=None,
                                   sampler: str = "ddpm"):
    """Reverse-diffuse the (n, *shape) latent, then decode it.
    decode_fn(keypoint, feature, label) -> (B, N, out) cloud.
    Returns (cloud, keypoint, keypoint_feature)."""
    if sampler != "ddpm":
        raise NotImplementedError(f"sampler {sampler!r} is not ported")
    if local_resampling and keypoint is None:
        raise ValueError("local resampling is keypoint-conditional")
    latent = x0_denoise(
        net_fn, (n,) + tuple(shape), sched, noise_fn, x=x, curr_step=curr_step,
        n_steps=n_steps, keypoint=keypoint, keypoint_dim=keypoint_dim,
        complete_x0=complete_x0 if local_resampling else None,
        keypoint_mask=keypoint_mask if local_resampling else None)
    kp = latent[..., :keypoint_dim]
    feat = latent[..., keypoint_dim:]
    return decode_fn(kp, feat, label), kp, feat
