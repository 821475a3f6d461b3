"""The conditional PointNet++ denoiser (counterpart:
`slide_tpu/models/denoiser.py::ConditionalPointNet2`): the position DDPM
network, the feature DDPM network, the SAP refine+upsample net, the
backbone of autoencoder decoder levels 2-3, and the dual-tower denoiser of
the conditional tasks.

An SA (set abstraction) tower and an FP (feature propagation) tower run
over the input cloud, with timestep and class embeddings injected into every
block's MLP.  With `include_local_feature` a second pair of towers runs over
a condition cloud (`sa_condition_<i>`, `fp_condition_<i>`), and
`FeatureMapModule`s carry its features onto the input cloud at every level
(`encoder_feature_map_<i>`, `decoder_feature_map_<i>`); with
`include_global_feature` a two-stage PNet of the condition cloud
(`global_pnet`) is injected as the condition and the class embedding as the
second condition.  `encode_condition` runs the condition's towers once and
returns a cache that `forward(cond_cache=)` reuses (a sampling chain
encodes its condition once).  `concate_partial_with_noisy_input` is the
single-tower variant: the condition cloud (tagged 1) is appended to the
input (tagged 0).  Config keys and channel arithmetic are the JAX
package's; the SA tower's builder, `build_sa_stack`, is shared with the
autoencoder's `PointNetEncoder`.  Neighbour statistics and global attention
are not ported (ROADMAP item 18): such a config raises.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from slide_tpu_torch.nn.layers import GroupNorm, Linear, TimestepEmbedder, get_activation
from slide_tpu_torch.nn.modules import FeatureMapModule, FPModule, KnnFPModule, SAModule
from slide_tpu_torch.nn.pnet import PNet2Stage


def positional_encode(x: torch.Tensor, multires: int) -> torch.Tensor:
    """NeRF positional encoding: x, then sin and cos of x at frequencies
    2^0 .. 2^(multires - 1).  (..., 3) -> (..., 3 (1 + 2 multires))."""
    outs = [x]
    for i in range(multires):
        f = float(2 ** i)
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


def pos_encode_out_dim(multires: int) -> int:
    return 3 * (1 + 2 * multires)


def _as_list(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def upsample_factor_multiplier(hp: Mapping) -> int:
    """Output-width multiplier of a refine+upsample head."""
    puf = hp.get("point_upsample_factor", 1)
    if puf > 1:
        if hp["first_refine_coarse_points"]:
            puf = puf + 1
            if hp["include_displacement_center_to_final_output"]:
                puf = puf - 1
        elif hp.get("include_displacement_center_to_final_output", False):
            raise ValueError("include_displacement_center requires "
                             "first_refine_coarse_points")
    return int(puf)


def reject_unported(hp: Mapping) -> None:
    """Raise for the options of `hp` that the port does not build (ROADMAP
    item 18)."""
    on = ["record_neighbor_stats"] if hp.get("record_neighbor_stats", False) else []
    if (hp.get("global_attention_setting") or {}).get("use_global_attention_module", False):
        on.append("global_attention_setting")
    if on:
        raise NotImplementedError(f"not ported yet (ROADMAP Queue A, item 18): {on}")


def _injection(class_dim, global_dim) -> dict:
    """The condition arguments of a block: with a global feature it is the
    condition and the class embedding the second condition."""
    if global_dim is not None:
        return dict(include_condition=True, condition_dim=global_dim,
                    include_second_condition=class_dim is not None,
                    second_condition_dim=class_dim)
    return dict(include_condition=class_dim is not None, condition_dim=class_dim)


def build_sa_stack(owner: nn.Module, hp: Mapping, in_fea_dim: int, *,
                   t_emb_dim: Optional[int] = None, class_dim: Optional[int] = None,
                   global_dim: Optional[int] = None, arch: Optional[Mapping] = None,
                   name: str = "sa_modules", additional_fea_dim=None) -> list:
    """The SA levels of `arch` (default `hp["architecture"]`), registered on
    `owner` as `<name>_<i>` (counterpart:
    `slide_tpu/models/denoiser.py::_build_sa_stack`).  `t_emb_dim` /
    `class_dim` are the widths of the timestep and class embeddings, None
    when not injected.  With a global feature (`global_dim`) it is the
    condition and the class embedding the second condition.
    `additional_fea_dim[i]` widens level i's input (the mapped condition
    features)."""
    arch = hp["architecture"] if arch is None else arch
    neighbor_def = _as_list(arch["neighbor_definition"], len(arch["radius"]))
    fd = arch["feature_dim"]
    mods = []
    for i in range(len(arch["npoint"])):
        spec = [fd[i]] * arch["mlp_depth"] + [fd[i + 1]]
        if additional_fea_dim is not None:
            spec[0] = spec[0] + additional_fea_dim[i]
        first_conv = bool(hp["bn_first"]) if i == 0 else False
        if i == 0 and not first_conv:
            spec[0] = in_fea_dim
        sa = SAModule(arch["npoint"][i], spec, arch["nsample"][i], radius=arch["radius"][i],
                      neighbor_def=neighbor_def[i], use_xyz=hp["model.use_xyz"],
                      include_abs_coordinate=hp["include_abs_coordinate"],
                      include_center_coordinate=hp.get("include_center_coordinate", False),
                      include_t=t_emb_dim is not None, bn=hp.get("bn", True),
                      bn_first=hp["bn_first"], bias=hp["bias"], first_conv=first_conv,
                      first_conv_in_channel=in_fea_dim, res_connect=hp["res_connect"],
                      activation=hp.get("activation", "relu"),
                      attention_setting=hp.get("attention_setting"), t_emb_dim=t_emb_dim,
                      **_injection(class_dim, global_dim))
        owner.add_module(f"{name}_{i}", sa)
        mods.append(sa)
    return mods


def _build_fp_stack(owner: nn.Module, hp: Mapping, arch: Mapping, in_fea_dim: int, *,
                    name: str, t_emb_dim: Optional[int] = None,
                    class_dim: Optional[int] = None, global_dim: Optional[int] = None,
                    additional_fea_dim=None) -> list:
    """The FP levels of `arch`, registered on `owner` as `<name>_<i>`
    (counterpart: `slide_tpu/models/denoiser.py::_build_fp_stack`)."""
    fd, dd = arch["feature_dim"], arch["decoder_feature_dim"]
    depth = arch["decoder_mlp_depth"]
    neighbor_def = _as_list(arch["neighbor_definition"], len(arch["radius"]))
    block_kw = dict(include_t=t_emb_dim is not None, bn=hp.get("bn", True),
                    bn_first=hp["bn_first"], bias=hp["bias"], res_connect=hp["res_connect"],
                    activation=hp.get("activation", "relu"), t_emb_dim=t_emb_dim,
                    use_xyz=hp["model.use_xyz"],
                    include_abs_coordinate=hp["include_abs_coordinate"],
                    include_center_coordinate=hp.get("include_center_coordinate", False),
                    **_injection(class_dim, global_dim))
    mods = []
    for i in range(len(dd) - 1):
        skip_dim = in_fea_dim if i == 0 else fd[i]
        extra = additional_fea_dim[i] if additional_fea_dim is not None else 0
        common = dict(include_grouper=arch.get("include_grouper", False),
                      radius=arch["radius"][i], nsample=arch["nsample"][i],
                      neighbor_def=neighbor_def[i], **block_kw)
        if arch.get("use_knn_FP", False):
            fp = KnnFPModule([dd[i + 1] + extra] + [dd[i]] * depth,
                             [dd[i] + skip_dim] + [dd[i]] * depth, k=arch.get("K", 3),
                             attention_setting=hp.get("attention_setting"), **common)
        else:
            fp = FPModule([dd[i + 1] + skip_dim + extra] + [dd[i]] * depth, **common)
        owner.add_module(f"{name}_{i}", fp)
        mods.append(fp)
    return mods


class ConditionalPointNet2(nn.Module):
    """`config` is the reference's `pointnet_config` dict."""

    def __init__(self, config: Mapping[str, Any]):
        super().__init__()
        hp = config
        reject_unported(hp)
        self.config = config
        self.include_t = hp["include_t"]
        self.include_class_condition = hp.get("include_class_condition", False)
        self.include_local_feature = hp.get("include_local_feature", True)
        self.include_global_feature = hp.get("include_global_feature", False)
        self.concate_partial = hp.get("concate_partial_with_noisy_input", False)
        if self.concate_partial and (self.include_local_feature
                                     or self.include_global_feature):
            raise ValueError("concate_partial excludes local/global condition features")
        self.transform_output = hp.get("transform_output", True)
        self.attach_position = hp["attach_position_to_input_feature"]
        self.use_position_encoding = hp.get("use_position_encoding", False)
        self.pos_multires = hp.get("position_encoding_multires", 0)
        self.pooling = hp.get("pooling", "max")
        self.act = get_activation(hp.get("activation", "relu"))
        self.bn = hp.get("bn", True)
        self.bn_first = hp["bn_first"]
        attention_setting = hp.get("attention_setting", None)
        fm_attention = dict(attention_setting) if attention_setting else None
        if fm_attention is not None:
            fm_attention["use_attention_module"] = fm_attention[
                "add_attention_to_FeatureMapper_module"]

        pos_dim = pos_encode_out_dim(self.pos_multires) if self.use_position_encoding else 0
        in_fea_dim = hp["in_fea_dim"] + (3 if self.attach_position else 0) + pos_dim
        raw_partial = hp.get("partial_in_fea_dim", hp["in_fea_dim"])
        partial_in_fea_dim = raw_partial + (3 if self.attach_position else 0) + pos_dim
        self.partial_in_fea_dim_full = partial_in_fea_dim
        t_emb_dim = class_dim = global_dim = None
        if self.include_class_condition:
            self.class_emb = nn.Embedding(hp["num_class"], hp["class_condition_dim"])
            class_dim = hp["class_condition_dim"]
        if self.include_t:
            self.t_embedder = TimestepEmbedder(hp["t_dim"])
            t_emb_dim = 4 * hp["t_dim"]
        if self.include_global_feature:
            mlp1, mlp2 = (list(a) for a in hp["pnet_global_feature_architecture"])
            # its input: xyz, the condition's raw features, the positional
            # encoding (flax infers the width from that input)
            mlp1[0] = 3 + raw_partial + pos_dim
            global_dim = mlp2[-1]
            self.global_pnet = PNet2Stage(
                mlp1, mlp2, bn=self.bn,
                remove_last_activation=hp.get("global_feature_remove_last_activation", True))

        arch = hp["architecture"]
        fd = arch["feature_dim"]
        dd = arch["decoder_feature_dim"]
        if dd[-1] != fd[-1]:
            raise ValueError("decoder_feature_dim[-1] must equal feature_dim[-1]")

        enc_map_dim = dec_map_dim = None
        if self.include_local_feature:
            cond_arch = hp["condition_net_architecture"]
            mapper = hp["feature_mapper_architecture"]
            cond_fd, cond_dd = cond_arch["feature_dim"], cond_arch["decoder_feature_dim"]
            self.sa_condition = build_sa_stack(self, hp, partial_in_fea_dim, arch=cond_arch,
                                               name="sa_condition")
            map_kw = dict(neighbor_def=mapper["neighbor_definition"],
                          use_xyz=hp["model.use_xyz"],
                          include_abs_coordinate=hp["include_abs_coordinate"],
                          include_center_coordinate=hp.get("include_center_coordinate",
                                                           False),
                          bn=self.bn, bn_first=hp["bn_first"], bias=hp["bias"],
                          res_connect=hp["res_connect"],
                          activation=hp.get("activation", "relu"),
                          attention_setting=fm_attention)
            enc_map_dim = mapper["encoder_feature_map_dim"]
            self.encoder_feature_map = []
            for i in range(len(enc_map_dim)):
                first_conv = bool(hp["bn_first"]) if i == 0 else False
                if i == 0:
                    in_dim = cond_fd[0] if first_conv else partial_in_fea_dim
                    query_dim = in_fea_dim
                else:
                    in_dim, query_dim = cond_fd[i], fd[i]
                fm = FeatureMapModule(
                    [in_dim] + [enc_map_dim[i]] * mapper["encoder_mlp_depth"],
                    k=mapper["encoder_nsample"][i], radius=mapper["encoder_radius"][i],
                    first_conv=first_conv, first_conv_in_channel=partial_in_fea_dim,
                    query_feature_dim=query_dim, **map_kw)
                self.add_module(f"encoder_feature_map_{i}", fm)
                self.encoder_feature_map.append(fm)
            self.fp_condition = _build_fp_stack(self, hp, cond_arch, partial_in_fea_dim,
                                                name="fp_condition")
            dec_map_dim = mapper["decoder_feature_map_dim"]
            self.decoder_feature_map = []
            for i in range(len(dec_map_dim)):
                fm = FeatureMapModule(
                    [cond_dd[i]] + [dec_map_dim[i]] * mapper["decoder_mlp_depth"],
                    k=mapper["decoder_nsample"][i], radius=mapper["decoder_radius"][i],
                    first_conv=False, query_feature_dim=dd[i], **map_kw)
                self.add_module(f"decoder_feature_map_{i}", fm)
                self.decoder_feature_map.append(fm)

        main_in = in_fea_dim + (enc_map_dim[0] if self.include_local_feature else 0)
        self.sa_modules = build_sa_stack(self, hp, main_in, t_emb_dim=t_emb_dim,
                                         class_dim=class_dim, global_dim=global_dim,
                                         additional_fea_dim=enc_map_dim)
        self.fp_modules = _build_fp_stack(
            self, hp, arch, in_fea_dim, name="fp_modules", t_emb_dim=t_emb_dim,
            class_dim=class_dim, global_dim=global_dim,
            additional_fea_dim=dec_map_dim[1:] if self.include_local_feature else None)

        out_dim = hp["out_dim"] * upsample_factor_multiplier(hp)
        if self.transform_output:
            head_in = dd[0] + 3 + (dec_map_dim[0] if self.include_local_feature else 0)
            if self.bn_first:
                self.head_conv_out = Linear(head_in, out_dim)
            else:
                self.head_conv1 = Linear(head_in, 128, bias=hp["bias"])
                if self.bn:
                    self.head_norm = GroupNorm(32, 128)
                self.head_conv_out = Linear(128, out_dim)

    def _prepare(self, pc: torch.Tensor):
        """(xyz, features) of a cloud: the positional encoding and the
        attached copy of xyz go onto its features."""
        if self.use_position_encoding:
            pc = torch.cat([pc, positional_encode(pc[..., :3], self.pos_multires)], dim=-1)
        if self.attach_position:
            pc = torch.cat([pc, pc[..., :3]], dim=-1)
        return pc[..., :3], (pc[..., 3:] if pc.shape[-1] > 3 else None)

    def encode_condition(self, condition: torch.Tensor) -> dict:
        """The condition cloud's towers, run once: {"global": (B, C)} with a
        global feature; {"l_uvw", "enc", "dec"} (per level xyz, SA features,
        FP features) with local features.  `forward(cond_cache=)` reuses it
        at every step of a chain."""
        uvw, cond_features = self._prepare(condition)
        cache = {}
        if self.include_global_feature:
            raw_dim = self.partial_in_fea_dim_full - (3 if self.attach_position else 0)
            global_input = uvw if raw_dim <= 0 else \
                torch.cat([uvw, condition[..., 3:3 + raw_dim]], dim=-1)
            if self.use_position_encoding:
                global_input = torch.cat(
                    [global_input, positional_encode(uvw, self.pos_multires)], dim=-1)
            cache["global"] = self.global_pnet(global_input)
        if self.include_local_feature:
            l_uvw, enc = [uvw], [cond_features]
            for sa in self.sa_condition:
                u, f = sa(l_uvw[-1], enc[-1], pooling=self.pooling)
                l_uvw.append(u)
                enc.append(f)
            dec = list(enc)
            for i in range(-1, -(len(self.fp_condition) + 1), -1):
                dec[i - 1] = self.fp_condition[i](l_uvw[i - 1], l_uvw[i], dec[i - 1], dec[i],
                                                  pooling=self.pooling)
            cache.update(l_uvw=l_uvw, enc=enc, dec=dec)
        return cache

    def _mapped(self, maps, level: int, cache: dict, key: str, xyz, features):
        """The condition's features of `level` mapped onto the input cloud,
        before the input's own features."""
        mapped = maps[level](cache["l_uvw"][level], cache[key][level], xyz,
                             features_at_new_xyz=features, subset=False, pooling=self.pooling)
        return mapped if features is None else torch.cat([mapped, features], dim=-1)

    def forward(self, pointcloud: torch.Tensor, ts: Optional[torch.Tensor] = None,
                label: Optional[torch.Tensor] = None, *,
                condition: Optional[torch.Tensor] = None,
                cond_cache: Optional[dict] = None) -> torch.Tensor:
        """(B, N, 3 + in_fea_dim) -> (B, N, out_dim), or the decoder features
        when transform_output is off.  `condition` (B, M, 3 +
        partial_in_fea_dim) is the condition cloud, `cond_cache` its
        `encode_condition` (either one where the net has condition towers)."""
        uses_cache = self.include_global_feature or self.include_local_feature
        if uses_cache and condition is None and cond_cache is None:
            raise ValueError("this model requires a condition cloud (or its cache)")
        n_out = pointcloud.shape[1]
        if self.concate_partial:
            if pointcloud.shape[-1] != 3:
                raise ValueError("concate_partial expects bare xyz input")
            if condition is None:
                raise ValueError("concate_partial requires a condition cloud")
            if condition.shape[-1] not in (3, 4):
                raise ValueError("concate_partial condition must have 3 or 4 channels "
                                 f"(got {condition.shape[-1]})")
            pc = torch.cat([pointcloud, pointcloud.new_zeros(pointcloud.shape[:2] + (1,))],
                           dim=-1)
            if condition.shape[-1] == 3:
                condition = torch.cat(
                    [condition, condition.new_ones(condition.shape[:2] + (1,))], dim=-1)
            pointcloud = torch.cat([pc, condition], dim=1)
            condition = None

        xyz, features = self._prepare(pointcloud)
        t_emb = self.t_embedder(ts) if (ts is not None and self.include_t) else None
        class_emb = (self.class_emb(label.long())
                     if (label is not None and self.include_class_condition) else None)
        if uses_cache and cond_cache is None:
            cond_cache = self.encode_condition(condition)
        if self.include_global_feature:
            cond, second = cond_cache["global"], class_emb
        else:
            cond, second = class_emb, None
        local = self.include_local_feature

        l_xyz, l_features = [xyz], [features]
        for i, sa in enumerate(self.sa_modules):
            feat = self._mapped(self.encoder_feature_map, i, cond_cache, "enc", l_xyz[i],
                                l_features[i]) if local else l_features[i]
            u, f = sa(l_xyz[i], feat, t_emb=t_emb, condition_emb=cond,
                      second_condition_emb=second, pooling=self.pooling)
            l_xyz.append(u)
            l_features.append(f)
        for i in range(-1, -(len(self.fp_modules) + 1), -1):
            feat = self._mapped(self.decoder_feature_map, i, cond_cache, "dec", l_xyz[i],
                                l_features[i]) if local else l_features[i]
            l_features[i - 1] = self.fp_modules[i](
                l_xyz[i - 1], l_xyz[i], l_features[i - 1], feat, t_emb=t_emb,
                condition_emb=cond, second_condition_emb=second, pooling=self.pooling)

        out = self._mapped(self.decoder_feature_map, 0, cond_cache, "dec", xyz,
                           l_features[0]) if local else l_features[0]
        if self.transform_output:
            out = torch.cat([out, xyz], dim=-1)
            if self.bn_first:
                out = self.head_conv_out(self.act(out))
            else:
                h = self.head_conv1(out)
                if self.bn:
                    h = self.head_norm(h)
                out = self.head_conv_out(self.act(h))
        return out[:, :n_out] if self.concate_partial else out
