"""Core layers: GroupNorm with flax's statistics, tail-passthrough GroupNorm,
shared MLPs and the injection MLP (counterpart: `slide_tpu/nn/layers.py`).

Channels-last: a 1x1 convolution over (B, M, K, C) is a `Linear` over the last
axis, a plain fp32 matmul (no cuDNN, so no TF32).  Submodules carry the flax
names so that `weights.load_flax_params` maps a flax tree onto them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


_ACTIVATIONS = {"relu": torch.relu, "swish": swish}


def get_activation(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"activation must be one of {list(_ACTIVATIONS)}, got {name}")
    return _ACTIVATIONS[name]


def calc_t_emb(ts: torch.Tensor, t_dim: int) -> torch.Tensor:
    """Sinusoidal step embedding: (B,) -> (B, t_dim) = [sin(t f), cos(t f)],
    f_i = exp(-i ln(10000) / (h - 1)), h = t_dim // 2."""
    if t_dim % 2 != 0:
        raise ValueError("t_dim must be even")
    half = t_dim // 2
    exponent = np.arange(half) * -(math.log(10000.0) / (half - 1))
    freqs = torch.exp(torch.as_tensor(exponent, dtype=torch.float32,
                                      device=ts.device))
    ang = ts.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


class GroupNorm(nn.Module):
    """flax `GroupNorm`: statistics per sample and group over every other
    axis, in fp32 (float64 for float64 input: a float64 run is a reference),
    with var = E[x^2] - E[x]^2 clipped at 0."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups != 0:
            raise ValueError(f"{num_channels} channels in {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xg = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
        xg = xg.reshape(b, -1, g, c // g)
        # E[x^2] - E[x]^2 cancels: the sums accumulate in float64, over each
        # group's elements laid out contiguously (the CPU's fp32 reduction
        # over the strided (rows, channels) axes left var up to 7e-5 off in
        # a group, the output ~1e-5, and ran slower)
        flat = xg.transpose(1, 2).reshape(b, g, -1)
        mean = flat.mean(dim=-1, dtype=torch.float64)[:, None, :, None]
        mean2 = (flat * flat).mean(dim=-1, dtype=torch.float64)[:, None, :, None]
        # torch.maximum: gradient 0.5 at a tie, as flax's jnp.maximum
        var = torch.maximum(mean2 - mean * mean, mean.new_zeros(()))
        mul = torch.rsqrt(var + self.eps).to(xg.dtype) * self.weight.reshape(g, c // g)
        y = (xg - mean.to(xg.dtype)) * mul + self.bias.reshape(g, c // g)
        return y.reshape(x.shape)


class TailGroupNorm(nn.Module):
    """GroupNorm over the first `channels - channels % num_groups` channels;
    the tail (raw coordinates) passes through untouched."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__()
        self.channels = channels
        self.c_norm = channels - channels % num_groups
        self.group_norm = GroupNorm(num_groups, self.c_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.channels:
            raise ValueError(f"TailGroupNorm built for {self.channels} channels, "
                             f"got {x.shape[-1]}")
        if self.c_norm == self.channels:
            return self.group_norm(x)
        return torch.cat([self.group_norm(x[..., :self.c_norm]),
                          x[..., self.c_norm:]], dim=-1)


class SharedMLP(nn.Module):
    """1x1 convolutions with GroupNorm + activation; dims = (Cin, h, ..., Cout).
    bn_first puts [norm, act, conv] per layer, else [conv, norm, act];
    truncate_last leaves the last layer a bare conv."""

    def __init__(self, dims: Sequence[int], bn: bool = True, bn_first: bool = False,
                 bias: bool = False, activation: str = "relu",
                 truncate_last: bool = False):
        super().__init__()
        self.dims = list(dims)
        self.bn = bn
        self.bn_first = bn_first
        self.truncate_last = truncate_last
        self.act = get_activation(activation)
        n = len(self.dims) - 1
        for i in range(1, n + 1):
            self.add_module(f"conv_{i}", nn.Linear(self.dims[i - 1], self.dims[i],
                                                   bias=bias))
            if not bn:
                continue
            if bn_first:
                c = self.dims[i - 1]
            elif i == n and truncate_last:
                continue
            else:
                c = self.dims[i]
            self.add_module(f"norm_{i}", TailGroupNorm(min(32, c), c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.dims) - 1
        for i in range(1, n + 1):
            conv = getattr(self, f"conv_{i}")
            if self.bn_first:
                if self.bn:
                    x = getattr(self, f"norm_{i}")(x)
                x = conv(self.act(x))
            else:
                x = conv(x)
                if i == n and self.truncate_last:
                    continue
                if self.bn:
                    x = getattr(self, f"norm_{i}")(x)
                x = self.act(x)
        return x


def _broadcast_emb(emb: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """(B, C) -> (B, 1, ..., 1, C) to add onto a rank-`target_ndim` tensor."""
    return emb.reshape(emb.shape[0], *([1] * (target_ndim - 2)), emb.shape[-1])


class InjectionMLP(nn.Module):
    """Shared MLP with timestep / condition / second-condition injection and a
    residual connection, on spec (s0, s1, ..., sn):

      [first_conv: Linear(first_conv_in -> s0)]
      h = SharedMLP(s0 -> s1);       h += Linear(t_emb -> s1)    if include_t
      h = SharedMLP(s1 -> s2);       h += Linear(cond -> s2)     if include_condition
      h = SharedMLP(s2 -> ... -> sn) if len > 3
      h += Linear(cond2 -> sn)                                   if include_second_condition
      h += feature if s0 == sn else Linear(feature -> sn)        if res_connect

    t_emb_dim / condition_dim / second_condition_dim are the widths of the
    injected embeddings (flax infers them at the first call).
    """

    def __init__(self, mlp_spec: Sequence[int], bn: bool = True,
                 include_t: bool = False, bn_first: bool = False, bias: bool = False,
                 first_conv: bool = False, first_conv_in_channel: int = 0,
                 res_connect: bool = False, include_condition: bool = False,
                 include_second_condition: bool = False, activation: str = "relu",
                 t_emb_dim: Optional[int] = None, condition_dim: Optional[int] = None,
                 second_condition_dim: Optional[int] = None):
        super().__init__()
        spec = list(mlp_spec)
        if len(spec) < 3:
            raise ValueError("mlp_spec must have at least 3 entries")
        if include_second_condition and len(spec) < 4:
            raise ValueError("second condition requires mlp_spec of length >= 4")
        self.spec = spec
        self.include_t = include_t
        self.include_condition = include_condition
        self.include_second_condition = include_second_condition
        self.res_connect = res_connect
        if first_conv:
            self.first_conv = nn.Linear(first_conv_in_channel, spec[0], bias=bias)
        else:
            self.first_conv = None
        kw = dict(bn=bn, bn_first=bn_first, bias=bias, activation=activation)
        self.first_mlp = SharedMLP(spec[0:2], **kw)
        if include_t:
            self.fc_t = nn.Linear(t_emb_dim, spec[1])
        self.second_mlp = SharedMLP(spec[1:3], **kw)
        if include_condition:
            self.fc_condition = nn.Linear(condition_dim, spec[2])
        self.rest_mlp = SharedMLP(spec[2:], **kw) if len(spec) > 3 else None
        if include_second_condition:
            self.fc_second_condition = nn.Linear(second_condition_dim, spec[-1])
        if res_connect and spec[0] != spec[-1]:
            self.res_conv = nn.Linear(spec[0], spec[-1], bias=bias)

    def forward(self, feature, t_emb=None, condition_emb=None,
                second_condition_emb=None):
        if self.first_conv is not None:
            feature = self.first_conv(feature)
        h = self.first_mlp(feature)
        if self.include_t:
            if t_emb is None:
                raise ValueError("include_t module requires t_emb")
            h = h + _broadcast_emb(self.fc_t(t_emb), h.ndim)
        elif t_emb is not None:
            raise ValueError("t_emb given to a module without include_t")
        h = self.second_mlp(h)
        if self.include_condition:
            if condition_emb is None:
                raise ValueError("include_condition module requires condition_emb")
            h = h + _broadcast_emb(self.fc_condition(condition_emb), h.ndim)
        elif condition_emb is not None:
            raise ValueError("condition_emb given to a module without include_condition")
        if self.rest_mlp is not None:
            h = self.rest_mlp(h)
        if self.include_second_condition:
            if second_condition_emb is None:
                raise ValueError("include_second_condition module requires "
                                 "second_condition_emb")
            h = h + _broadcast_emb(self.fc_second_condition(second_condition_emb),
                                   h.ndim)
        elif second_condition_emb is not None:
            raise ValueError("second_condition_emb given without "
                             "include_second_condition")
        if self.res_connect:
            h = h + (feature if self.spec[0] == self.spec[-1]
                     else self.res_conv(feature))
        return h


class TimestepEmbedder(nn.Module):
    """sinusoidal -> fc -> swish -> fc -> swish, output width 4 * t_dim."""

    def __init__(self, t_dim: int):
        super().__init__()
        self.t_dim = t_dim
        self.fc_t1 = nn.Linear(t_dim, 4 * t_dim)
        self.fc_t2 = nn.Linear(4 * t_dim, 4 * t_dim)

    def forward(self, ts: torch.Tensor) -> torch.Tensor:
        # the sinusoid in the layers' dtype (float64 in a reference run)
        t = swish(self.fc_t1(calc_t_emb(ts, self.t_dim).to(self.fc_t1.weight.dtype)))
        return swish(self.fc_t2(t))
