"""Latent diffusion over keypoint features, sampling half (counterpart:
`slide_tpu/diffusion/latent.py::latent_denoise_and_reconstruct`, DDPM
sampler).  The latent is [keypoint positions | keypoint features]; with
keypoints given they are pinned at every step and only features are
denoised.  The FastDPM samplers are `fastdpm.py`; the training loss is a
later slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from slide_tpu_torch.diffusion.eps import NoiseFn
from slide_tpu_torch.diffusion.x0 import X0Schedule, x0_denoise


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
