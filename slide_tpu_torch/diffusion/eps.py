"""Epsilon-prediction DDPM sampler (counterpart: `slide_tpu/diffusion/eps.py`).

The T-step reverse chain is a Python loop (the JAX package's `lax.scan`).
Networks come in as closures `net_fn(x, ts) -> eps_hat`; noise comes from
`noise_fn(shape)`, one draw for x_T and one for each step (the last step's
draw is not used, as in the JAX chain, so a test can replay its draws).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

NoiseFn = Callable[[Sequence[int]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Linear-beta DDPM coefficients, fp32, on one device."""

    T: int
    beta: torch.Tensor
    alpha: torch.Tensor
    alpha_bar: torch.Tensor
    sigma: torch.Tensor


def calc_diffusion_hyperparams(T: int, beta_0: float, beta_T: float,
                               device="cpu") -> DiffusionSchedule:
    """Computed in float64 with numpy, stored as fp32."""
    beta = np.linspace(beta_0, beta_T, T, dtype=np.float64)
    alpha = 1.0 - beta
    alpha_bar = np.cumprod(alpha)
    beta_tilde = beta.copy()
    beta_tilde[1:] = beta[1:] * (1.0 - alpha_bar[:-1]) / (1.0 - alpha_bar[1:])

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return DiffusionSchedule(T=T, beta=f32(beta), alpha=f32(alpha),
                             alpha_bar=f32(alpha_bar), sigma=f32(np.sqrt(beta_tilde)))


@torch.no_grad()
def diffusion_sampling(net_fn: Callable, shape: Sequence[int],
                       sched: DiffusionSchedule, noise_fn: NoiseFn) -> torch.Tensor:
    """Ancestral sampling x_T -> x_0 over `shape` (B, N, D)."""
    shape = tuple(shape)
    b = shape[0]
    # the per-step scalars in fp32, each with the JAX chain's own operations
    eps_coef = (1.0 - sched.alpha) / torch.sqrt(1.0 - sched.alpha_bar)
    sqrt_alpha = torch.sqrt(sched.alpha)
    x = noise_fn(shape)
    for t in range(sched.T - 1, -1, -1):
        ts = torch.full((b,), t, dtype=torch.int32, device=x.device)
        eps = net_fn(x, ts)
        x = (x - eps_coef[t] * eps) / sqrt_alpha[t]
        noise = noise_fn(shape)
        if t > 0:
            x = x + sched.sigma[t] * noise
    return x
