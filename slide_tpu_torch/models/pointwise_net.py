"""The pointwise (ConcatSquash) denoiser (counterpart:
`slide_tpu/models/pointwise_net.py`), the backbone of `network_type:
"pointwise_net"`: six ConcatSquashLinear layers conditioned on [beta_t,
sin(beta_t), cos(beta_t), the global PNet feature of the condition cloud],
with an optional residual output.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slide_tpu_torch.nn.layers import Linear
from slide_tpu_torch.nn.pnet import PNet2Stage

LAYER_DIMS = (128, 256, 512, 256, 128, 3)


def variance_schedule(num_steps: int, beta_1: float, beta_t: float) -> dict:
    """The net's own schedule, 1-indexed with a zero t=0 slot: (T + 1,)
    fp32 tensors betas, alphas, alpha_bars, sigmas_flex, sigmas_inflex."""
    betas = np.concatenate([[0.0], np.linspace(beta_1, beta_t, num_steps)])
    alphas = 1.0 - betas
    alpha_bars = np.exp(np.cumsum(np.log(alphas)))
    sigmas_flex = np.sqrt(betas)
    sigmas_inflex = np.zeros_like(betas)
    sigmas_inflex[1:] = np.sqrt((1 - alpha_bars[:-1]) / (1 - alpha_bars[1:]) * betas[1:])
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in (
        ("betas", betas), ("alphas", alphas), ("alpha_bars", alpha_bars),
        ("sigmas_flex", sigmas_flex), ("sigmas_inflex", sigmas_inflex))}


class ConcatSquashLinear(nn.Module):
    """out = layer(x) * sigmoid(hyper_gate(ctx)) + hyper_bias(ctx)."""

    def __init__(self, dim_in: int, dim_out: int, dim_ctx: int):
        super().__init__()
        self.layer = Linear(dim_in, dim_out)
        self.hyper_gate = Linear(dim_ctx, dim_out)
        self.hyper_bias = Linear(dim_ctx, dim_out, bias=False)

    def forward(self, ctx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x) * torch.sigmoid(self.hyper_gate(ctx)) + self.hyper_bias(ctx)


class PointwiseNet(nn.Module):
    """x (B, N, 3) the noisy cloud, condition (B, M, pnet mlp1[0]) the
    condition cloud, ts (B,) steps into the net's padded schedule -> (B, N,
    3).  The layers are `layers_<i>`, as flax names a tuple of submodules."""

    def __init__(self, residual: bool = True, num_steps: int = 1000, beta_1: float = 1e-4,
                 beta_T: float = 0.05, mode: str = "linear",
                 pnet_global_feature_architecture: Sequence[Sequence[int]] = (
                     (3, 128, 256), (512, 1024)),
                 global_feature_remove_last_activation: bool = False):
        super().__init__()
        if mode != "linear":
            raise ValueError("only the linear schedule is supported")
        self.residual = residual
        self.register_buffer("betas",
                             variance_schedule(num_steps, beta_1, beta_T)["betas"],
                             persistent=False)
        arch = [tuple(a) for a in pnet_global_feature_architecture]
        self.global_pnet = PNet2Stage(arch[0], arch[1], bn=False,
                                      remove_last_activation=global_feature_remove_last_activation)
        dim_ctx = arch[1][-1] + 3
        dim_in = 3
        self.n_layers = len(LAYER_DIMS)
        for i, d in enumerate(LAYER_DIMS):
            self.add_module(f"layers_{i}", ConcatSquashLinear(dim_in, d, dim_ctx))
            dim_in = d

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None,
                ts: Optional[torch.Tensor] = None, label: Optional[torch.Tensor] = None):
        del label                              # the JAX module ignores it too
        b = x.shape[0]
        if ts is None:
            ts = torch.zeros((b,), dtype=torch.int64, device=x.device)
        beta = self.betas[ts.long()].reshape(b, 1, 1).to(x.dtype)
        context = self.global_pnet(condition).reshape(b, 1, -1)
        ctx = torch.cat([beta, torch.sin(beta), torch.cos(beta), context], dim=-1)
        out = x
        for i in range(self.n_layers):
            out = getattr(self, f"layers_{i}")(ctx, out)
            if i < self.n_layers - 1:
                out = F.leaky_relu(out, negative_slope=0.01)
        return x + out if self.residual else out


def get_pointwise_net(args: dict) -> PointwiseNet:
    """A `PointwiseNet` from the config's `network_args`."""
    args = dict(args)
    if "pnet_global_feature_architecture" in args:
        args["pnet_global_feature_architecture"] = tuple(
            tuple(a) for a in args["pnet_global_feature_architecture"])
    return PointwiseNet(**args)
