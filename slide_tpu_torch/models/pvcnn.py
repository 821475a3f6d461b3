"""The PVCNN2 point-voxel denoiser (counterpart: `slide_tpu/models/pvcnn.py`),
the backbone of `network_type: "pvd"`.

SA stages of [PVConv blocks -> SA (FPS, ball query, shared MLP, max over
the neighbours)], a voxel attention at the bottleneck, FP stages of [3-NN
interpolation, shared MLP -> PVConv blocks] and a classifier head.  A
PVConv adds a voxel branch (avg-voxelise, two 3x3x3 convolutions with
GroupNorm(8) and swish, a voxel attention or squeeze-excitation, trilinear
devoxelise) to a per-point MLP.  The timestep embedding is constant over a
cloud's points, so it is broadcast again at each stage, as the JAX package
does.  Channel widths are worked out here from the input width, as flax
infers them.

Grids are channels-last, (B, R, R, R, C); a 3x3x3 convolution runs
`nn.Conv3d(padding=1)` on the channels-first view (the JAX package's
`nn.Conv`, outside any Pallas kernel).  FPS goes through
`ops.furthest_point_sample` (K3 on the card).  Dropout never acts: the
JAX driver never passes `deterministic=False`, so neither module trains
with it; the port builds none.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slide_tpu_torch.nn.layers import GroupNorm, Linear, swish
from slide_tpu_torch.nn.neighborhood import query_and_group
from slide_tpu_torch.ops import (avg_voxelize, furthest_point_sample, gather_points,
                                 interp_weights_from_dists, normalize_coords_for_voxelization,
                                 three_interpolate, three_nn, trilinear_devoxelize)

DEFAULT_SA_BLOCKS = (
    ((32, 2, 32), (1024, 0.1, 32, (32, 64))),
    ((64, 3, 16), (256, 0.2, 32, (64, 128))),
    ((128, 3, 8), (64, 0.4, 32, (128, 256))),
    (None, (16, 0.8, 32, (256, 256, 512))),
)
DEFAULT_FP_BLOCKS = (
    ((256, 256), (256, 3, 8)),
    ((256, 256), (256, 3, 8)),
    ((256, 128), (128, 2, 16)),
    ((128, 128, 64), (64, 2, 32)),
)


class Conv3d(nn.Conv3d):
    """A 3x3x3 'SAME' convolution over a channels-last grid (B, R, R, R,
    Cin) -> (B, R, R, R, Cout), in the weight's dtype (flax's `nn.Conv`
    promotes its input to the fp32 kernel's)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(c_in, c_out, kernel_size=3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(self.weight.dtype), self.weight, self.bias,
                     padding=1)
        return y.permute(0, 2, 3, 4, 1)


class PVSharedMLP(nn.Module):
    """[Dense, GroupNorm(8), swish] per width of `out_channels`."""

    def __init__(self, c_in: int, out_channels: Sequence[int]):
        super().__init__()
        self.n = len(out_channels)
        for i, oc in enumerate(out_channels):
            self.add_module(f"conv_{i}", Linear(c_in, oc))
            self.add_module(f"norm_{i}", GroupNorm(8, oc))
            c_in = oc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = swish(getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(x)))
        return x


class VoxelAttention(nn.Module):
    """Softmax self-attention over flattened positions (B, M, C), a residual,
    GroupNorm(8) and swish."""

    def __init__(self, channels: int):
        super().__init__()
        self.q = Linear(channels, channels)
        self.k = Linear(channels, channels)
        self.v = Linear(channels, channels)
        self.out = Linear(channels, channels)
        self.norm = GroupNorm(8, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(torch.einsum("bmc,bnc->bmn", self.q(x), self.k(x)), dim=-1)
        h = self.out(torch.einsum("bmn,bnc->bmc", w, self.v(x)))
        return swish(self.norm(h + x))


class SE3d(nn.Module):
    """Squeeze-excitation over a channels-last grid: the grid's mean per
    channel, Dense to C/4, relu (or swish), Dense to C, sigmoid, scaling.
    The two Dense layers carry flax's automatic names."""

    def __init__(self, channels: int, use_relu: bool = True):
        super().__init__()
        self.use_relu = use_relu
        self.Dense_0 = Linear(channels, channels // 4)
        self.Dense_1 = Linear(channels // 4, channels)

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        s = self.Dense_0(grid.mean(dim=(1, 2, 3)))
        s = torch.relu(s) if self.use_relu else swish(s)
        s = torch.sigmoid(self.Dense_1(s))
        return grid * s[:, None, None, None, :]


class PVConv(nn.Module):
    """Point-voxel convolution: (features (B, N, c_in), coords (B, N, 3)) ->
    (B, N, out_channels)."""

    def __init__(self, c_in: int, out_channels: int, resolution: int,
                 attention: bool = False, with_se: bool = False):
        super().__init__()
        self.resolution = resolution
        self.vconv_1 = Conv3d(c_in, out_channels)
        self.vnorm_1 = GroupNorm(8, out_channels)
        self.vconv_2 = Conv3d(out_channels, out_channels)
        self.vnorm_2 = GroupNorm(8, out_channels)
        self.attention = VoxelAttention(out_channels) if attention else None
        self.se = SE3d(out_channels) if with_se else None
        self.point_features = PVSharedMLP(c_in, (out_channels,))

    def forward(self, features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        vox = normalize_coords_for_voxelization(coords, self.resolution)
        grid = avg_voxelize(features, vox, self.resolution)
        grid = swish(self.vnorm_1(self.vconv_1(grid)))
        grid = self.vnorm_2(self.vconv_2(grid))
        if self.attention is not None:
            b, r, c = grid.shape[0], grid.shape[1], grid.shape[-1]
            grid = self.attention(grid.reshape(b, r ** 3, c)).reshape(b, r, r, r, c)
        else:
            grid = swish(grid)
        if self.se is not None:
            grid = self.se(grid)
        return trilinear_devoxelize(grid, vox) + self.point_features(features)


def _widths(t: Optional[Tuple]) -> Optional[Tuple]:
    return None if t is None else tuple(t)


class PVCNN2(nn.Module):
    """The PVD completion-style denoiser: the noisy cloud (concatenated with
    the condition cloud, when there is one) through the PVCNN2 base, the
    output cropped back to the noisy cloud's points.

    in_dim: the input's channels (xyz + extra features), and the condition
    cloud's; out_dim: the output's channels.  The other arguments are the
    JAX package's `PVCNN2` fields (`dropout` is accepted and never acts).
    """

    def __init__(self, in_dim: int = 3, out_dim: int = 3, embed_dim: int = 64,
                 use_att: bool = True, dropout: float = 0.1,
                 extra_feature_channels: int = 0,
                 sa_blocks: Sequence = DEFAULT_SA_BLOCKS,
                 fp_blocks: Sequence = DEFAULT_FP_BLOCKS):
        super().__init__()
        del dropout, extra_feature_channels   # as in the JAX module: unused
        self.embed_dim = embed_dim
        self.use_att = use_att
        self.sa_blocks = [(_widths(c), (s[0], s[1], s[2], tuple(s[3]))) for c, s in sa_blocks]
        self.fp_blocks = [(tuple(f), _widths(c)) for f, c in fp_blocks]
        self.embedf_1 = Linear(embed_dim, embed_dim)
        self.embedf_2 = Linear(embed_dim, embed_dim)

        width = in_dim                         # the features' width at level 0
        skip_widths = [in_dim - 3]             # the FP's skip features, per level
        sa_c = 0
        for i, (conv_cfg, sa_cfg) in enumerate(self.sa_blocks):
            if i > 0:
                skip_widths.append(width)
            h = width if i == 0 else width + embed_dim
            if conv_cfg is not None:
                out_c, num_blocks, vres = conv_cfg
                # stages after the first keep only their first conv block
                for p in range(num_blocks if i == 0 else 1):
                    attention = (sa_c + 1) % 2 == 0 and sa_c > 0 and use_att and p == 0
                    self.add_module(f"sa{i}_pv{p}", PVConv(h, out_c, vres, attention=attention,
                                                           with_se=not attention))
                    h = out_c
            num_centers, _, _, mlp_out = sa_cfg
            name = f"sa{i}_amod" if num_centers is None else f"sa{i}_samod"
            self.add_module(name, PVSharedMLP(h + 3, mlp_out))
            width = mlp_out[-1]
            sa_c += 1
        if use_att:
            self.global_att = VoxelAttention(width)
        for j, (fp_cfg, conv_cfg) in enumerate(self.fp_blocks):
            c_in = width + embed_dim + skip_widths[-1 - j]
            self.add_module(f"fp{j}_mlp", PVSharedMLP(c_in, fp_cfg))
            width = fp_cfg[-1]
            if conv_cfg is not None:
                out_c, num_blocks, vres = conv_cfg
                for p in range(num_blocks):
                    self.add_module(f"fp{j}_pv{p}", PVConv(width, out_c, vres, with_se=True))
                    width = out_c
        self.cls_mlp = PVSharedMLP(width, (128,))
        self.cls_out = Linear(128, out_dim)

    def _t_embed(self, ts: torch.Tensor) -> torch.Tensor:
        half = self.embed_dim // 2
        exponent = np.arange(half) * -(math.log(10000.0) / (half - 1))
        freqs = torch.exp(torch.as_tensor(exponent, dtype=torch.float32, device=ts.device))
        ang = ts.float()[:, None] * freqs[None]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).to(self.embedf_1.weight.dtype)
        emb = F.leaky_relu(self.embedf_1(emb), negative_slope=0.1)
        return self.embedf_2(emb)

    def forward(self, pointcloud: torch.Tensor, condition: Optional[torch.Tensor] = None,
                ts: Optional[torch.Tensor] = None, label: Optional[torch.Tensor] = None):
        """(B, N, in_dim) [, condition (B, M, in_dim)] -> (B, N, out_dim)."""
        del label                              # the JAX module ignores it too
        b, n1, _ = pointcloud.shape
        x = pointcloud if condition is None else torch.cat([pointcloud, condition], dim=1)
        coords, features = x[..., :3], x
        if ts is None:
            ts = torch.zeros((b,), dtype=torch.int64, device=x.device)
        temb = self._t_embed(ts)

        def temb_at(n):
            return temb[:, None, :].expand(b, n, self.embed_dim)

        coords_list, feats_list = [], []
        for i, (conv_cfg, sa_cfg) in enumerate(self.sa_blocks):
            feats_list.append(features)
            coords_list.append(coords)
            h = features if i == 0 else torch.cat([features, temb_at(coords.shape[1])], dim=-1)
            if conv_cfg is not None:
                for p in range(conv_cfg[1] if i == 0 else 1):
                    h = getattr(self, f"sa{i}_pv{p}")(h, coords)
            num_centers, radius, num_neighbors, _ = sa_cfg
            if num_centers is None:
                g = getattr(self, f"sa{i}_amod")(torch.cat([h, coords], dim=-1))
                features = torch.amax(g, dim=1, keepdim=True)
                coords = coords.new_zeros((b, 1, 3))
            else:
                centers = gather_points(coords, furthest_point_sample(coords, num_centers))
                grouped, _ = query_and_group(coords, centers, h, nsample=num_neighbors,
                                             radius=radius, neighbor_def="radius",
                                             use_xyz=True, subset=True)
                features = torch.amax(getattr(self, f"sa{i}_samod")(grouped), dim=2)
                coords = centers
        # the skip features of level 0: the extra channels of the whole input
        feats_list[0] = x[..., 3:]
        if self.use_att:
            features = self.global_att(features)
        for j, (_, conv_cfg) in enumerate(self.fp_blocks):
            jump_coords, jump_feats = coords_list[-1 - j], feats_list[-1 - j]
            src = torch.cat([features, temb_at(features.shape[1])], dim=-1)
            dist, idx = three_nn(jump_coords, coords)
            interp = three_interpolate(src, idx, interp_weights_from_dists(dist))
            if jump_feats.shape[-1] > 0:
                interp = torch.cat([interp, jump_feats], dim=-1)
            features = getattr(self, f"fp{j}_mlp")(interp)
            coords = jump_coords
            if conv_cfg is not None:
                for p in range(conv_cfg[1]):
                    features = getattr(self, f"fp{j}_pv{p}")(features, coords)
        out = self.cls_out(self.cls_mlp(features))
        return out[:, :n1]
