"""Neighbourhood attention pooling (counterpart: `slide_tpu/nn/attention.py`
`AttentionPool`).  The presets of the generation path build no global
attention, so `GlobalAttention` is not ported."""

from __future__ import annotations

import torch
from torch import nn

from slide_tpu_torch.nn.layers import TailGroupNorm
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
        self.feat_conv = nn.Linear(c_in1, c1)
        self.grouped_feat_conv = nn.Linear(c_in2, c2)
        if attention_bn:
            self.w_norm_1 = TailGroupNorm(min(32, c1 + c2), c1 + c2)
            self.w_norm_2 = TailGroupNorm(min(32, inter), inter)
        self.w_conv_1 = nn.Linear(c1 + c2, inter)
        self.w_conv_2 = nn.Linear(inter, c_out)
        if transform_grouped_feat_out:
            self.feat_out_conv = nn.Linear(c_out, c_out)
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
