"""Epsilon-prediction DDPM sampler (counterpart: `slide_tpu/diffusion/eps.py`).

The T-step reverse chain is a Python loop (the JAX package's `lax.scan`).
Networks come in as closures `net_fn(x, ts) -> eps_hat`; noise comes from
`noise_fn(shape)`, one draw for x_T and one for each step (the last step's
draw is not used, as in the JAX chain, so a test can replay its draws).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

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


def diffusion_training_loss(net_fn: Callable, x0: torch.Tensor, sched: DiffusionSchedule,
                            generator: Optional[torch.Generator] = None,
                            ts: Optional[torch.Tensor] = None,
                            z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE(eps_hat, z) at one uniformly drawn timestep per cloud: x_t =
    sqrt(abar_t) x0 + sqrt(1 - abar_t) z, eps_hat = net_fn(x_t, ts).  `ts`
    (B,) and `z` (x0's shape) are drawn from `generator` unless given (a
    test hands in the JAX draws)."""
    b = x0.shape[0]
    if ts is None:
        ts = torch.randint(0, sched.T, (b,), generator=generator,
                           device=generator.device).to(x0.device)
    if z is None:
        z = torch.randn(x0.shape, generator=generator, device=generator.device,
                        dtype=x0.dtype).to(x0.device)
    abar = sched.alpha_bar.to(x0.device)[ts.long()].reshape((b,) + (1,) * (x0.ndim - 1))
    x_t = torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * z
    eps_hat = net_fn(x_t, ts)
    return torch.mean((eps_hat - z) ** 2)


@torch.no_grad()
def diffusion_sampling(net_fn: Callable, shape: Sequence[int], sched: DiffusionSchedule,
                       noise_fn: NoiseFn, *, t_slices: Optional[Sequence[int]] = None,
                       xT: Optional[torch.Tensor] = None,
                       start_step: Optional[int] = None):
    """Ancestral sampling x_T -> x_0 over `shape` (B, N, D).

    t_slices: timesteps at which to record the state before that step's
    noise (zeros for a timestep the chain does not visit).  xT / start_step:
    a warm start from a precomputed x at `start_step`: x = xT +
    sigma[start_step] z, then the steps start_step - 1 down to 0.  Returns
    x_0, or (x_0, {t: state}) with t_slices."""
    shape = tuple(shape)
    b = shape[0]
    # the per-step scalars in fp32, each with the JAX chain's own operations
    eps_coef = (1.0 - sched.alpha) / torch.sqrt(1.0 - sched.alpha_bar)
    sqrt_alpha = torch.sqrt(sched.alpha)
    if xT is not None:
        if start_step is None:
            raise ValueError("start_step required with a precomputed xT")
        x = xT + sched.sigma[start_step] * noise_fn(shape)
        start = start_step - 1
    else:
        x = noise_fn(shape)
        start = sched.T - 1
    slices = {t: torch.zeros_like(x) for t in (t_slices or ())}
    for t in range(start, -1, -1):
        ts = torch.full((b,), t, dtype=torch.int32, device=x.device)
        eps = net_fn(x, ts)
        x = (x - eps_coef[t] * eps) / sqrt_alpha[t]
        if t in slices:
            slices[t] = x
        noise = noise_fn(shape)
        if t > 0:
            x = x + sched.sigma[t] * noise
    if t_slices:
        return x, slices
    return x
