"""Two-stage global PointNet (counterpart: `slide_tpu/nn/pnet.py`): a
per-point MLP, a global max over the points, that maximum concatenated onto
every point, a second per-point MLP and a second global max."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from slide_tpu_torch.nn.layers import SharedMLP


class PNet2Stage(nn.Module):
    """mlp1 = (in, h, out) and mlp2 = (h, out) are channel specs; the second
    stage runs on (2 * mlp1[-1],) + mlp2.  remove_last_activation leaves the
    last layer of each stage a bare conv.  Every conv has a bias."""

    def __init__(self, mlp1: Sequence[int], mlp2: Sequence[int], bn: bool = True,
                 remove_last_activation: bool = True):
        super().__init__()
        if len(mlp1) != 3:
            raise ValueError("PNet2Stage expects a 3-entry mlp1 spec (in, h, out)")
        spec2 = (2 * mlp1[-1],) + tuple(mlp2)
        if len(spec2) != 3:
            raise ValueError("PNet2Stage expects a 2-entry mlp2 spec (h, out)")
        self.mlp1 = SharedMLP(mlp1, bn=bn, bias=True, truncate_last=remove_last_activation)
        self.mlp2 = SharedMLP(spec2, bn=bn, bias=True, truncate_last=remove_last_activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, mlp1[0]) -> (B, mlp2[-1])."""
        h = self.mlp1(x)
        g = torch.amax(h, dim=1, keepdim=True)
        h = self.mlp2(torch.cat([h, g.expand_as(h)], dim=-1))
        return torch.amax(h, dim=1)
