"""Neighbourhood attention pooling and the global attention (counterpart:
`slide_tpu/nn/attention.py`: `AttentionPool`, `GlobalAttention`)."""

from __future__ import annotations

import torch
from torch import nn

from slide_tpu_torch.nn.layers import Linear, TailGroupNorm
from slide_tpu_torch.ops import count_to_mask


class AttentionPool(nn.Module):
    """Learned per-channel softmax pooling over the K neighbour slots.

    feat (B, M, c_in1) -> Linear to c1 = max(c_in1, 32); grouped_feat
    (B, M, K, c_in2) -> Linear to c2 = max(c_in2, 32); concatenated, a
    [relu, GN, conv, relu, GN, conv] stack gives scores (B, M, K, c_out); masked
    softmax over K weighs the (optionally transformed) value
    grouped_feat_out (B, M, K, c_out); output (B, M, c_out).

    c_in1 / c_in2 are the true input widths (flax infers them).
    """

    def __init__(self, c_in1: int, c_in2: int, c_out: int,
                 attention_bn: bool = True, transform_grouped_feat_out: bool = True,
                 last_activation: bool = True):
        super().__init__()
        c1, c2 = max(c_in1, 32), max(c_in2, 32)
        inter = min(c1 + c2, c_out)
        self.attention_bn = attention_bn
        self.transform_grouped_feat_out = transform_grouped_feat_out
        self.last_activation = last_activation
        self.feat_conv = Linear(c_in1, c1)
        self.grouped_feat_conv = Linear(c_in2, c2)
        if attention_bn:
            self.w_norm_1 = TailGroupNorm(min(32, c1 + c2), c1 + c2)
            self.w_norm_2 = TailGroupNorm(min(32, inter), inter)
        self.w_conv_1 = Linear(c1 + c2, inter)
        self.w_conv_2 = Linear(inter, c_out)
        if transform_grouped_feat_out:
            self.feat_out_conv = Linear(c_out, c_out)
            if last_activation and attention_bn:
                self.feat_out_norm = TailGroupNorm(min(32, c_out), c_out)

    def forward(self, feat, grouped_feat, grouped_feat_out, count):
        k = grouped_feat.shape[-2]
        f1 = self.feat_conv(feat)
        f1 = f1[:, :, None, :].expand(*f1.shape[:2], k, f1.shape[-1])
        g1 = self.grouped_feat_conv(grouped_feat)
        h = torch.relu(torch.cat([f1, g1], dim=-1))
        if self.attention_bn:
            h = self.w_norm_1(h)
        h = torch.relu(self.w_conv_1(h))
        if self.attention_bn:
            h = self.w_norm_2(h)
        scores = self.w_conv_2(h)
        if not (isinstance(count, str) and count == "all"):
            mask = count_to_mask(torch.clamp(count, min=1), k)[..., None]
            scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
        weight = torch.softmax(scores, dim=-2)
        value = grouped_feat_out
        if self.transform_grouped_feat_out:
            value = self.feat_out_conv(value)
            if self.last_activation:
                if self.attention_bn:
                    value = self.feat_out_norm(value)
                value = torch.relu(value)
        return torch.sum(value * weight, dim=-2)


class GlobalAttention(nn.Module):
    """The reference's global attention module over a level's points.

    Its output is its value path: key, query and value convs, then (with
    `last_activation`) [GN,] relu on the value.  The reference broadcasts
    the value over the softmax axis, so the weighted sum of softmax weights
    that add up to 1 returns the value itself; the key, query and weight
    stack parameters exist so that the parameter tree matches the JAX
    package's.  `use_intended_attention=True` computes the softmax-weighted
    form instead: scores (B, N, N, c) from the weight stack over [query_i,
    key_j], softmax over j, summed against the value.

    in_dim is the input width, c + additional_dim (flax infers it).
    """

    def __init__(self, c: int, additional_dim: int = 0, attention_bn: bool = True,
                 last_activation: bool = True, use_intended_attention: bool = False):
        super().__init__()
        in_dim = c + additional_dim
        self.attention_bn = attention_bn
        self.last_activation = last_activation
        self.use_intended_attention = use_intended_attention
        self.key_conv = Linear(in_dim, c)
        self.query_conv = Linear(in_dim, c)
        self.value_conv = Linear(in_dim, c)
        if last_activation and attention_bn:
            self.value_norm = TailGroupNorm(min(32, c), c)
        if attention_bn:
            self.w_norm_1 = TailGroupNorm(min(32, 2 * c), 2 * c)
            self.w_norm_2 = TailGroupNorm(min(32, c), c)
        self.w_conv_1 = Linear(2 * c, c)
        self.w_conv_2 = Linear(c, c)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, N, c + additional_dim) -> (B, N, c)."""
        value = self.value_conv(feat)
        if self.last_activation:
            if self.attention_bn:
                value = self.value_norm(value)
            value = torch.relu(value)
        if not self.use_intended_attention:
            return value
        key = self.key_conv(feat)
        query = self.query_conv(feat)
        n = feat.shape[1]
        q = query[:, :, None, :].expand(-1, -1, n, -1)
        k = key[:, None, :, :].expand(-1, n, -1, -1)
        h = torch.relu(torch.cat([q, k], dim=-1))
        if self.attention_bn:
            h = self.w_norm_1(h)
        h = torch.relu(self.w_conv_1(h))
        if self.attention_bn:
            h = self.w_norm_2(h)
        w = torch.softmax(self.w_conv_2(h), dim=2)
        return torch.einsum("bijc,bjc->bic", w, value)
