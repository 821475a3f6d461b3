"""FastDPM accelerated sampling (counterpart: `slide_tpu/diffusion/fastdpm.py`):
VAR / STEP methods x linear / quadratic schedules x kappa.

The schedule search (bisection over noise levels, continuous timesteps from
the Stirling-approximated log-noise) runs on the host in numpy float64, as
in the JAX package; the S-step reverse chain is a Python loop over fp32
coefficients.  Noise comes from `noise_fn(shape)`: one draw for x_T, then one
per step (the last step's draw is multiplied by sigma = 0), so a test can
replay the JAX chain's draws.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from slide_tpu_torch.diffusion.eps import DiffusionSchedule, NoiseFn
from slide_tpu_torch.diffusion.x0 import X0Schedule


def bisearch(f, domain, target, eps: float = 1e-8) -> float:
    """Smallest x with f(x) > target, by bisection."""
    sign = -1 if target < 0 else 1
    left, right = domain
    x = (left + right) / 2
    for _ in range(1000):
        x = (left + right) / 2
        if f(x) < target:
            right = x
        elif f(x) > (1 + sign * eps) * target:
            left = x
        else:
            break
    return x


def get_var_noise(s: int, diffusion_config: dict, schedule: str = "linear") -> np.ndarray:
    """VAR noise levels whose product matches the full chain's terminal
    alpha_bar."""
    dc = diffusion_config
    target = np.prod(1 - np.linspace(dc["beta_0"], dc["beta_T"], dc["T"]))
    if schedule == "linear":
        g = lambda x: np.linspace(dc["beta_0"], x, s)
        domain = (dc["beta_0"], 0.99)
    elif schedule == "quadratic":
        g = lambda x: np.array([dc["beta_0"] * (1 + i * x) ** 2 for i in range(s)])
        domain = (0.0, 0.95 / np.sqrt(dc["beta_0"]) / s)
    else:
        raise NotImplementedError(schedule)
    largest = bisearch(lambda x: np.prod(1 - g(x)), domain, target, eps=1e-4)
    return g(largest)


def get_step_steps(s: int, diffusion_config: dict, schedule: str = "linear") -> list[int]:
    """STEP timestep subsets of the T-step chain."""
    t = diffusion_config["T"]
    if schedule == "linear":
        c = (t - 1.0) / (s - 1.0)
        taus = [np.floor(i * c) for i in range(s)]
    elif schedule == "quadratic":
        taus = np.linspace(0, np.sqrt(t * 0.8), s) ** 2
    else:
        raise NotImplementedError(schedule)
    return [int(x) for x in taus]


def _log_gamma(x):
    y = x - 1
    return np.log(2 * np.pi * y) / 2 + y * (np.log(y) - 1) + np.log(1 + 1 / (12 * y))


def _log_cont_noise(t, beta_0, beta_t, big_t):
    delta = (beta_t - beta_0) / (big_t - 1)
    c = (1.0 - beta_0) / delta
    t1 = t + 1
    return t1 * np.log(delta) + _log_gamma(c + 1) - _log_gamma(c - t1 + 1)


def precompute_var_steps(sched: DiffusionSchedule, user_defined_eta: np.ndarray,
                         beta_0: float, beta_t: float) -> list[float]:
    """Continuous timesteps matching each VAR noise level, decreasing."""
    alpha_bar = sched.alpha_bar.detach().cpu().numpy().astype(np.float64)
    t = sched.T
    # the cumulative product in fp32: gamma_bar[0] must compare equal to
    # alpha_bar[0] (an fp32 value) so that the first level brackets at i=0
    gamma_bar = np.cumprod((1 - np.asarray(user_defined_eta)).astype(np.float32))
    gamma_bar = gamma_bar.astype(np.float64)
    if gamma_bar[0] > alpha_bar[0] * (1 + 1e-5) or \
            gamma_bar[-1] < alpha_bar[-1] * (1 - 1e-3):
        raise ValueError("VAR noise levels out of the chain's alpha_bar range")
    steps = []
    for ti in range(len(gamma_bar) - 1, -1, -1):
        t_adapted = None
        for i in range(t - 1):
            if alpha_bar[i] >= gamma_bar[ti] > alpha_bar[i + 1]:
                t_adapted = bisearch(
                    lambda _t: _log_cont_noise(_t, beta_0, beta_t, t),
                    domain=(i - 0.01, i + 1.01),
                    target=np.log(gamma_bar[ti]))
                break
        if t_adapted is None:
            t_adapted = t - 1
        steps.append(t_adapted)
    return steps


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


@torch.no_grad()
def _generalized_chain(net_fn: Callable, shape, taus, abar_cur: np.ndarray,
                       abar_next: np.ndarray, kappa: float, noise_fn: NoiseFn,
                       device) -> torch.Tensor:
    """DDIM-style generalized reverse chain shared by VAR and STEP: for each
    step i,
      sigma_i = kappa * sqrt((1-a_next)/(1-a_cur) * (1 - a_cur/a_next)),
      x <- x * sqrt(a_next/a_cur) + c_i * eps + sigma_i * z,
      c_i = sqrt(1 - a_next - sigma_i^2) - sqrt(1-a_cur) * sqrt(a_next/a_cur);
    the last step has a_next = 1, sigma = 0."""
    sigma = kappa * np.sqrt((1 - abar_next) / (1 - abar_cur) * (1 - abar_cur / abar_next))
    sigma[-1] = 0.0
    mult = np.sqrt(abar_next / abar_cur)
    c = np.sqrt(np.maximum(1 - abar_next - sigma ** 2, 0.0)) - np.sqrt(1 - abar_cur) * mult
    taus, mult, c, sigma = (_f32(a, device) for a in (taus, mult, c, sigma))
    shape = tuple(shape)
    x = noise_fn(shape)
    for i in range(len(taus)):
        eps = net_fn(x, taus[i].expand(shape[0]))
        x = x * mult[i] + c[i] * eps + sigma[i] * noise_fn(shape)
    return x


def var_sampling(net_fn: Callable, shape: Sequence[int], user_defined_eta: np.ndarray,
                 continuous_steps, kappa: float, noise_fn: NoiseFn,
                 device="cpu") -> torch.Tensor:
    """VAR method: the chain over the given noise levels."""
    gamma_bar = np.cumprod(1 - np.asarray(user_defined_eta, np.float64))
    # step i uses gamma_bar[S-1-i] now and gamma_bar[S-2-i] next (1 at the end)
    abar_cur = gamma_bar[::-1].copy()
    abar_next = np.append(gamma_bar[::-1][1:], 1.0)
    return _generalized_chain(net_fn, shape, np.asarray(continuous_steps, np.float64),
                              abar_cur, abar_next, kappa, noise_fn, device)


def step_sampling(net_fn: Callable, shape: Sequence[int], sched: DiffusionSchedule,
                  user_defined_steps, kappa: float, noise_fn: NoiseFn) -> torch.Tensor:
    """STEP method: the chain over a subset of the T timesteps."""
    steps = sorted(list(user_defined_steps), reverse=True)
    alpha_bar = sched.alpha_bar.detach().cpu().numpy().astype(np.float64)
    abar_cur = alpha_bar[steps]
    abar_next = np.append(alpha_bar[steps[1:]], 1.0)
    return _generalized_chain(net_fn, shape, np.asarray(steps, np.float64), abar_cur,
                              abar_next, kappa, noise_fn, sched.alpha_bar.device)


def fast_sampling(net_fn: Callable, shape: Sequence[int], sched: DiffusionSchedule,
                  diffusion_config: dict, noise_fn: NoiseFn, *, length: int = 100,
                  sampling_method: str = "var", schedule: str = "quadratic",
                  kappa: float = 0.0) -> torch.Tensor:
    """S-step FastDPM chain of an epsilon-prediction DDPM."""
    if sampling_method not in ("var", "step"):
        raise ValueError(sampling_method)
    if schedule not in ("quadratic", "linear"):
        raise ValueError(schedule)
    if sampling_method == "var":
        eta = get_var_noise(length, diffusion_config, schedule)
        csteps = precompute_var_steps(sched, eta, diffusion_config["beta_0"],
                                      diffusion_config["beta_T"])
        return var_sampling(net_fn, shape, eta, csteps, kappa, noise_fn,
                            sched.alpha_bar.device)
    steps = get_step_steps(length, diffusion_config, schedule)
    return step_sampling(net_fn, shape, sched, steps, kappa, noise_fn)


def diffusion_config_of(sched: DiffusionSchedule) -> dict:
    """The {T, beta_0, beta_T} dict `fast_sampling` needs, from a linear-beta
    schedule (the only kind `calc_diffusion_hyperparams` builds)."""
    beta = sched.beta.detach().cpu().numpy().astype(np.float64)
    return {"T": sched.T, "beta_0": float(beta[0]), "beta_T": float(beta[-1])}


@torch.no_grad()
def fast_x0_denoise(net_fn: Callable, shape: Sequence[int], sched: X0Schedule,
                    noise_fn: NoiseFn, *, length: int = 50, schedule: str = "quadratic",
                    kappa: float = 0.0, keypoint=None,
                    keypoint_dim: int = 0) -> torch.Tensor:
    """STEP-method chain of the x0 engine: the net predicts epsilon (scaled
    by model_output_scale_factor); each of the S steps forms the clipped x0
    prediction and takes the generalized DDIM jump to the next selected
    timestep.  Keypoints are pinned before every net call and on the
    output, as in `x0_denoise`."""
    steps = sorted(get_step_steps(length, {"T": sched.T}, schedule), reverse=True)
    alpha_bar = sched.alphas_cumprod.detach().cpu().numpy().astype(np.float64)
    abar_cur = alpha_bar[steps]
    abar_next = np.append(alpha_bar[steps[1:]], 1.0)
    sigma = kappa * np.sqrt((1 - abar_next) / (1 - abar_cur) * (1 - abar_cur / abar_next))
    sigma[-1] = 0.0
    dev = sched.alphas_cumprod.device
    taus = torch.as_tensor(steps, dtype=torch.int32, device=dev)
    a_cur, a_next, sigma = (_f32(a, dev) for a in (abar_cur, abar_next, sigma))

    shape = tuple(shape)
    x = noise_fn(shape)

    def pin(x):
        if keypoint is None:
            return x
        return torch.cat([keypoint, x[..., keypoint_dim:]], dim=-1)

    for i in range(len(steps)):
        x = pin(x)
        eps = net_fn(x, taus[i].expand(shape[0])) * sched.model_output_scale_factor
        x0 = (x - torch.sqrt(1.0 - a_cur[i]) * eps) / torch.sqrt(a_cur[i])
        if sched.data_clamp_range > 0:
            x0 = torch.clamp(x0, -sched.data_clamp_range, sched.data_clamp_range)
        c = torch.sqrt(torch.clamp_min(1.0 - a_next[i] - sigma[i] ** 2, 0.0))
        x = torch.sqrt(a_next[i]) * x0 + c * eps + sigma[i] * noise_fn(shape)
    return pin(x)
