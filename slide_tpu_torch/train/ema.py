"""Exponential moving averages of parameters (counterpart:
`slide_tpu/train/ema.py`).  A shadow is a list of tensors parallel to
`module.parameters()`, updated in place."""

from __future__ import annotations

from typing import Sequence

import torch

EMA_DEFAULT_RATES = (0.999, 0.9999)


def ema_init(params: Sequence[torch.Tensor], rates) -> list:
    """One shadow per rate, each a real copy of the parameters."""
    return [[p.detach().clone() for p in params] for _ in rates]


@torch.no_grad()
def ema_update(shadows: list, params: Sequence[torch.Tensor], rates) -> list:
    """shadow <- mu * shadow + (1 - mu) * param, in place, with the JAX
    package's two products and one sum."""
    params = [p.detach() for p in params]
    for shadow, mu in zip(shadows, rates):
        if shadow:
            torch._foreach_mul_(shadow, mu)
            torch._foreach_add_(shadow, torch._foreach_mul(params, 1.0 - mu))
    return shadows


def ema_maturity(rate: float, n_updates: int) -> float:
    """Fraction of an EMA shadow that is trained signal: 1 - rate**n (the
    shadows start at the random-init parameters)."""
    if n_updates <= 0:
        return 0.0
    return 1.0 - rate ** n_updates


def select_eval_params(params, ema_list, rates, n_updates, min_maturity: float = 0.95):
    """The parameters to evaluate after `n_updates`: the largest-rate shadow
    whose maturity is at least `min_maturity`, else the raw parameters.
    Returns (params, "raw" or "ema_<rate>")."""
    ema_list = ema_list or ()
    rates = tuple(rates or ())
    best = None
    for i, rate in enumerate(rates[:len(ema_list)]):
        if ema_maturity(rate, n_updates) >= min_maturity:
            if best is None or rate > rates[best]:
                best = i
    if best is None:
        return params, "raw"
    return ema_list[best], f"ema_{rates[best]}"


def select_eval_params_from_ckpt(ckpt: dict, rates=EMA_DEFAULT_RATES,
                                 min_maturity: float = 0.95):
    """`select_eval_params` over a loaded checkpoint (`train/checkpoint.py`'s
    dict: iter, model_state_dict and, where written, ema_state_list)."""
    return select_eval_params(ckpt["model_state_dict"], ckpt.get("ema_state_list"), rates,
                              int(ckpt.get("iter", -1)) + 1, min_maturity=min_maturity)
