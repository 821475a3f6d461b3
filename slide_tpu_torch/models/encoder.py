"""The SA-only PointNet++ feature extractor (counterpart:
`slide_tpu/models/encoder.py::PointNetEncoder`): the autoencoder's encoder
and the backbone of its keypoint level.

It returns (last level's features, per-level xyz, per-level features).  With
`transform_output` the original computes a 1x1 conv and then discards it,
so the conv exists here only as a parameter, for checkpoints that hold it,
and never runs.  `global_attention_setting` and `record_neighbor_stats` act
as in the denoiser's SA tower.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from slide_tpu_torch.models.denoiser import (build_sa_stack, pos_encode_out_dim,
                                             positional_encode)
from slide_tpu_torch.nn.layers import Linear, TimestepEmbedder
from slide_tpu_torch.nn.pnet import PNet2Stage


class PointNetEncoder(nn.Module):
    """`config` is the reference's encoder `pointnet_config` dict."""

    def __init__(self, config: Mapping[str, Any]):
        super().__init__()
        hp = config
        self.include_t = hp["include_t"]
        self.include_class_condition = hp.get("include_class_condition", False)
        self.include_global_feature = hp.get("include_global_feature", False)
        self.attach_position = hp["attach_position_to_input_feature"]
        self.use_position_encoding = hp.get("use_position_encoding", False)
        self.pos_multires = hp.get("position_encoding_multires", 0)
        self.pooling = hp.get("pooling", "max")

        pos_dim = pos_encode_out_dim(self.pos_multires) if self.use_position_encoding else 0
        in_fea_dim = hp["in_fea_dim"] + (3 if self.attach_position else 0) + pos_dim
        self.in_fea_dim_full = in_fea_dim
        t_emb_dim = class_dim = global_dim = None
        if self.include_class_condition:
            self.class_emb = nn.Embedding(hp["num_class"], hp["class_condition_dim"])
            class_dim = hp["class_condition_dim"]
        if self.include_t:
            self.t_embedder = TimestepEmbedder(hp["t_dim"])
            t_emb_dim = 4 * hp["t_dim"]
        if self.include_global_feature:
            mlp1, mlp2 = (list(a) for a in hp["pnet_global_feature_architecture"])
            # its input: xyz and the raw features with their positional
            # encoding (flax infers the width from that input)
            mlp1[0] = 3 + self._raw_dim()
            global_dim = mlp2[-1]
            self.global_pnet = PNet2Stage(
                mlp1, mlp2, bn=hp.get("bn", True),
                remove_last_activation=hp.get("global_feature_remove_last_activation", True))
        self.sa_modules = build_sa_stack(
            self, hp, in_fea_dim, t_emb_dim=t_emb_dim, class_dim=class_dim,
            global_dim=global_dim,
            global_attention_setting=hp.get("global_attention_setting"))
        if hp.get("transform_output", False):
            self.head_conv = Linear(hp["architecture"]["feature_dim"][-1], hp["out_dim"])

    def _raw_dim(self) -> int:
        """The feature channels of the global PNet's input."""
        return self.in_fea_dim_full - 3 if self.attach_position else self.in_fea_dim_full

    def forward(self, pointcloud: torch.Tensor, ts: Optional[torch.Tensor] = None,
                label: Optional[torch.Tensor] = None):
        """(B, N, 3 + in_fea_dim) -> (features (B, npoint[-1], feature_dim[-1]),
        [xyz per level], [features per level])."""
        pc = pointcloud
        if self.use_position_encoding:
            pc = torch.cat([pc, positional_encode(pc[..., :3], self.pos_multires)], dim=-1)
        if self.attach_position:
            pc = torch.cat([pc, pc[..., :3]], dim=-1)
        xyz = pc[..., :3]
        features = pc[..., 3:] if pc.shape[-1] > 3 else None
        t_emb = self.t_embedder(ts) if (ts is not None and self.include_t) else None
        class_emb = (self.class_emb(label.long())
                     if (label is not None and self.include_class_condition) else None)
        if self.include_global_feature:
            # [xyz, raw features]: the attached copy of xyz is the leading xyz
            cond, second = self.global_pnet(pc[..., :3 + self._raw_dim()]), class_emb
        else:
            cond, second = class_emb, None

        l_xyz, l_features = [xyz], [features]
        for sa in self.sa_modules:
            u, f = sa(l_xyz[-1], l_features[-1], t_emb=t_emb, condition_emb=cond,
                      second_condition_emb=second, pooling=self.pooling)
            l_xyz.append(u)
            l_features.append(f)
        return l_features[-1], l_xyz, l_features
