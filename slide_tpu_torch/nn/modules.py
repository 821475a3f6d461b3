"""Set-abstraction / feature-propagation / feature-transfer modules
(counterpart: `slide_tpu/nn/modules.py`).

Channel arithmetic is the JAX package's: coordinate channels (+3 relative,
+3 absolute, +3 center) go onto the first conv's input (first_conv mode) or
mlp_spec[0]; KnnFP adds +11 kNN channels to mlp1[0] and +3 xyz channels to
mlp2[0].  Global attention and neighbour-count statistics are options no
preset of the generation path turns on; they are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from slide_tpu_torch.nn.attention import AttentionPool
from slide_tpu_torch.nn.layers import InjectionMLP
from slide_tpu_torch.nn.neighborhood import group_knn_features, query_and_group
from slide_tpu_torch.ops import (furthest_point_sample, gather_points,
                                 interp_weights_from_dists, pool_features,
                                 three_interpolate, three_nn)


def _coord_extra(use_xyz, include_abs, include_center) -> int:
    if not use_xyz:
        return 0
    return 3 * (1 + int(include_abs) + int(include_center))


def _use_attention(setting: Optional[dict]) -> bool:
    return bool(setting) and bool(setting.get("use_attention_module", False))


def _attention(setting: dict, c_in1: int, c_in2: int, c_out: int) -> AttentionPool:
    return AttentionPool(c_in1, c_in2, c_out, attention_bn=setting["attention_bn"],
                         transform_grouped_feat_out=setting["transform_grouped_feat_out"],
                         last_activation=setting["last_activation"])


class SAModule(nn.Module):
    """Set abstraction: FPS down to `npoint` centers (start 0), group each
    center's neighbourhood, injection MLP, attention or max/avg pooling.
    `mlp_spec[0]` is the incoming feature width."""

    def __init__(self, npoint: int, mlp_spec: Sequence[int], nsample: int,
                 radius: float = 0.0, neighbor_def: str = "nn", use_xyz: bool = True,
                 include_abs_coordinate: bool = False,
                 include_center_coordinate: bool = False, include_t: bool = False,
                 include_condition: bool = False,
                 include_second_condition: bool = False, bn: bool = True,
                 bn_first: bool = False, bias: bool = False, first_conv: bool = False,
                 first_conv_in_channel: int = 0, res_connect: bool = False,
                 activation: str = "relu", attention_setting: Optional[dict] = None,
                 t_emb_dim: Optional[int] = None, condition_dim: Optional[int] = None,
                 second_condition_dim: Optional[int] = None):
        super().__init__()
        extra = _coord_extra(use_xyz, include_abs_coordinate, include_center_coordinate)
        spec = list(mlp_spec)
        if first_conv:
            fc_in = first_conv_in_channel + extra
        else:
            fc_in = 0
            spec[0] = spec[0] + extra
        self.npoint = npoint
        self.group_kw = dict(nsample=nsample, radius=radius, neighbor_def=neighbor_def,
                             use_xyz=use_xyz,
                             include_abs_coordinate=include_abs_coordinate,
                             include_center_coordinate=include_center_coordinate,
                             subset=True)
        self.include_t = include_t
        self.include_condition = include_condition
        self.include_second_condition = include_second_condition
        self.mlp = InjectionMLP(
            spec, bn=bn, include_t=include_t, bn_first=bn_first, bias=bias,
            first_conv=first_conv, first_conv_in_channel=fc_in,
            res_connect=res_connect, include_condition=include_condition,
            include_second_condition=include_second_condition, activation=activation,
            t_emb_dim=t_emb_dim, condition_dim=condition_dim,
            second_condition_dim=second_condition_dim)
        self.use_att = _use_attention(attention_setting)
        if self.use_att:
            c_in1 = first_conv_in_channel if first_conv else mlp_spec[0]
            c_in2 = fc_in if first_conv else spec[0]
            self.attention = _attention(attention_setting, c_in1, c_in2, spec[-1])

    def forward(self, xyz, features, t_emb=None, condition_emb=None,
                second_condition_emb=None, pooling: str = "max"):
        if xyz.shape[1] <= self.npoint:
            new_xyz, new_feat_q = xyz, features
        else:
            idx = furthest_point_sample(xyz, self.npoint)
            new_xyz = gather_points(xyz, idx)
            new_feat_q = gather_points(features, idx) if self.use_att else None
        grouped, counts = query_and_group(xyz, new_xyz, features, **self.group_kw)
        out = self.mlp(grouped,
                       t_emb=t_emb if self.include_t else None,
                       condition_emb=condition_emb if self.include_condition else None,
                       second_condition_emb=(second_condition_emb
                                             if self.include_second_condition else None))
        if self.use_att:
            return new_xyz, self.attention(new_feat_q, grouped, out, counts)
        return new_xyz, pool_features(out, counts, pooling)


def _maybe_group(include_grouper, group_kw, unknown, new_features):
    if include_grouper:
        return query_and_group(unknown, unknown, new_features, **group_kw)
    return new_features[:, :, None, :], None


class FPModule(nn.Module):
    """Feature propagation by 3-NN inverse-distance interpolation.
    `mlp_spec[0]` = interpolated + skip widths; the optional grouper adds
    coordinate channels."""

    def __init__(self, mlp_spec: Sequence[int], include_t: bool = False,
                 include_condition: bool = False,
                 include_second_condition: bool = False, bn: bool = True,
                 bn_first: bool = False, bias: bool = False, res_connect: bool = False,
                 include_grouper: bool = False, radius: float = 0.0, nsample: int = 32,
                 use_xyz: bool = True, include_abs_coordinate: bool = True,
                 include_center_coordinate: bool = False, neighbor_def: str = "radius",
                 activation: str = "relu", t_emb_dim: Optional[int] = None,
                 condition_dim: Optional[int] = None,
                 second_condition_dim: Optional[int] = None):
        super().__init__()
        spec = list(mlp_spec)
        if include_grouper:
            spec[0] = spec[0] + _coord_extra(use_xyz, include_abs_coordinate,
                                             include_center_coordinate)
        self.include_grouper = include_grouper
        self.group_kw = dict(nsample=nsample, radius=radius, neighbor_def=neighbor_def,
                             use_xyz=use_xyz,
                             include_abs_coordinate=include_abs_coordinate,
                             include_center_coordinate=include_center_coordinate,
                             subset=True)
        self.include_t = include_t
        self.include_condition = include_condition
        self.include_second_condition = include_second_condition
        self.mlp = InjectionMLP(
            spec, bn=bn, include_t=include_t, bn_first=bn_first, bias=bias,
            res_connect=res_connect, include_condition=include_condition,
            include_second_condition=include_second_condition, activation=activation,
            t_emb_dim=t_emb_dim, condition_dim=condition_dim,
            second_condition_dim=second_condition_dim)

    def forward(self, unknown, known, unknow_feats, known_feats, t_emb=None,
                condition_emb=None, second_condition_emb=None, pooling: str = "max"):
        if known is not None:
            dist, idx = three_nn(unknown, known)
            interpolated = three_interpolate(known_feats, idx,
                                             interp_weights_from_dists(dist))
        else:
            interpolated = known_feats.expand(known_feats.shape[0], unknown.shape[1],
                                              known_feats.shape[-1])
        new_features = interpolated if unknow_feats is None \
            else torch.cat([interpolated, unknow_feats], dim=-1)
        new_features, counts = _maybe_group(self.include_grouper, self.group_kw,
                                            unknown, new_features)
        out = self.mlp(new_features,
                       t_emb=t_emb if self.include_t else None,
                       condition_emb=condition_emb if self.include_condition else None,
                       second_condition_emb=(second_condition_emb
                                             if self.include_second_condition else None))
        if self.include_grouper:
            return pool_features(out, counts, pooling)
        return out[:, :, 0, :]


class KnnFPModule(nn.Module):
    """kNN feature propagation with attention aggregation, the FP of every
    preset (`use_knn_FP`).  mlp1 transforms the +11-augmented kNN
    neighbourhoods of `unknown` in `known`; attention (query = skip features)
    or max-pooling aggregates them; the result, the skip features and xyz
    (+3) go through mlp2 with t / condition injection.  mlp1[0] = decoder
    width of the level above, mlp2[0] = decoder width + skip width."""

    def __init__(self, mlp1_spec: Sequence[int], mlp2_spec: Sequence[int], k: int,
                 include_t: bool = False, include_condition: bool = False,
                 include_second_condition: bool = False, bn: bool = True,
                 bn_first: bool = False, bias: bool = False, res_connect: bool = False,
                 include_grouper: bool = False, radius: float = 0.0, nsample: int = 32,
                 use_xyz: bool = True, include_abs_coordinate: bool = True,
                 include_center_coordinate: bool = False, neighbor_def: str = "radius",
                 activation: str = "relu", attention_setting: Optional[dict] = None,
                 t_emb_dim: Optional[int] = None, condition_dim: Optional[int] = None,
                 second_condition_dim: Optional[int] = None):
        super().__init__()
        spec1 = list(mlp1_spec)
        spec2 = list(mlp2_spec)
        spec1[0] = spec1[0] + 11
        c_in1 = spec2[0] - spec1[-1]          # the skip feature width
        c_in2 = spec1[0]
        if include_grouper:
            spec2[0] = spec2[0] + _coord_extra(use_xyz, include_abs_coordinate,
                                               include_center_coordinate)
        else:
            spec2[0] = spec2[0] + 3
        self.k = k
        self.include_grouper = include_grouper
        self.group_kw = dict(nsample=nsample, radius=radius, neighbor_def=neighbor_def,
                             use_xyz=use_xyz,
                             include_abs_coordinate=include_abs_coordinate,
                             include_center_coordinate=include_center_coordinate,
                             subset=True)
        self.include_t = include_t
        self.include_condition = include_condition
        self.include_second_condition = include_second_condition
        self.mlp1 = InjectionMLP(
            spec1, bn=bn, include_t=False, bn_first=bn_first, bias=bias,
            res_connect=res_connect, include_condition=include_second_condition,
            activation=activation, condition_dim=second_condition_dim)
        self.use_att = _use_attention(attention_setting)
        if self.use_att:
            self.attention = _attention(attention_setting, c_in1, c_in2, spec1[-1])
        self.mlp2 = InjectionMLP(
            spec2, bn=bn, include_t=include_t, bn_first=bn_first, bias=bias,
            res_connect=res_connect, include_condition=include_condition,
            activation=activation, t_emb_dim=t_emb_dim, condition_dim=condition_dim)

    def forward(self, unknown, known, unknow_feats, known_feats, t_emb=None,
                condition_emb=None, second_condition_emb=None, pooling: str = "max"):
        if known is not None:
            grouped = group_knn_features(unknown, known, known_feats, self.k)
            out1 = self.mlp1(grouped, condition_emb=(
                second_condition_emb if self.include_second_condition else None))
            if self.use_att:
                interpolated = self.attention(unknow_feats, grouped, out1, "all")
            else:
                interpolated = pool_features(out1, "all", pooling)
        else:
            if self.use_att:
                raise ValueError("attention KnnFP requires both clouds")
            interpolated = known_feats.expand(known_feats.shape[0], unknown.shape[1],
                                              known_feats.shape[-1])
        new_features = interpolated if unknow_feats is None \
            else torch.cat([interpolated, unknow_feats], dim=-1)
        if not self.include_grouper:
            new_features = torch.cat([new_features, unknown], dim=-1)
        new_features, counts = _maybe_group(self.include_grouper, self.group_kw,
                                            unknown, new_features)
        out = self.mlp2(new_features,
                        t_emb=t_emb if self.include_t else None,
                        condition_emb=condition_emb if self.include_condition else None)
        if self.include_grouper:
            return pool_features(out, counts, pooling)
        return out[:, :, 0, :]


class FeatureMapModule(nn.Module):
    """Cross-cloud feature transfer: for each point of `new_xyz`, group its
    neighbours in the condition cloud `xyz`, transform and pool (attention
    query = the target cloud's own features).  mlp_spec[0] is the condition
    feature width."""

    def __init__(self, mlp_spec: Sequence[int], k: int, radius: float = 0.0,
                 neighbor_def: str = "radius", use_xyz: bool = True,
                 include_abs_coordinate: bool = True,
                 include_center_coordinate: bool = False, bn: bool = True,
                 bn_first: bool = True, bias: bool = True, res_connect: bool = True,
                 first_conv: bool = False, first_conv_in_channel: int = 0,
                 activation: str = "relu", attention_setting: Optional[dict] = None,
                 query_feature_dim: Optional[int] = None):
        super().__init__()
        extra = _coord_extra(use_xyz, include_abs_coordinate, include_center_coordinate)
        spec = list(mlp_spec)
        if first_conv:
            fc_in = first_conv_in_channel + extra
        else:
            fc_in = 0
            spec[0] = spec[0] + extra
        self.group_kw = dict(nsample=k, radius=radius, neighbor_def=neighbor_def,
                             use_xyz=use_xyz,
                             include_abs_coordinate=include_abs_coordinate,
                             include_center_coordinate=include_center_coordinate)
        self.mlp = InjectionMLP(
            spec, bn=bn, include_t=False, bn_first=bn_first, bias=bias,
            first_conv=first_conv, first_conv_in_channel=fc_in,
            res_connect=res_connect, activation=activation)
        self.use_att = _use_attention(attention_setting)
        if self.use_att:
            self.attention = _attention(attention_setting, query_feature_dim,
                                        fc_in if first_conv else spec[0], spec[-1])

    def forward(self, xyz, features, new_xyz, features_at_new_xyz=None,
                subset: bool = False, pooling: str = "max"):
        grouped, counts = query_and_group(xyz, new_xyz, features, subset=subset,
                                          **self.group_kw)
        out = self.mlp(grouped)
        if self.use_att:
            return self.attention(features_at_new_xyz, grouped, out, counts)
        return pool_features(out, counts, pooling)
