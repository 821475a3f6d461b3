"""The conditional PointNet++ denoiser (counterpart:
`slide_tpu/models/denoiser.py::ConditionalPointNet2`): the position DDPM
network, the feature DDPM network and the backbone of autoencoder decoder
levels 2-3.

An SA (set abstraction) tower and a KnnFP (feature propagation) tower run
over the input cloud, with timestep and class embeddings injected into every
block's MLP.  Config keys and channel arithmetic are the JAX package's; the
SA tower's builder, `build_sa_stack`, is shared with the autoencoder's
`PointNetEncoder`, which adds a global feature as the condition.  The
condition-cloud branch (local / global condition features), the
concatenated-partial variant, positional encoding and global attention are
turned on by no preset of the generation path and are not ported: such a
config raises.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from slide_tpu_torch.nn.layers import GroupNorm, TimestepEmbedder, get_activation
from slide_tpu_torch.nn.modules import FPModule, KnnFPModule, SAModule


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


def _check_supported(hp: Mapping) -> None:
    unsupported = {
        "include_local_feature": hp.get("include_local_feature", True),
        "include_global_feature": hp.get("include_global_feature", False),
        "concate_partial_with_noisy_input":
            hp.get("concate_partial_with_noisy_input", False),
        "use_position_encoding": hp.get("use_position_encoding", False),
        "record_neighbor_stats": hp.get("record_neighbor_stats", False),
        "global_attention_setting": bool(
            (hp.get("global_attention_setting") or {}).get(
                "use_global_attention_module", False)),
    }
    on = [k for k, v in unsupported.items() if v]
    if on:
        raise NotImplementedError(f"not ported (no preset of the generation path "
                                  f"uses them): {on}")


def build_sa_stack(owner: nn.Module, hp: Mapping, in_fea_dim: int, *,
                   t_emb_dim: Optional[int] = None, class_dim: Optional[int] = None,
                   global_dim: Optional[int] = None) -> list:
    """The SA levels of `hp["architecture"]`, registered on `owner` as
    `sa_modules_<i>` (counterpart: `slide_tpu/models/denoiser.py::_build_sa_stack`).
    `t_emb_dim` / `class_dim` are the widths of the timestep and class
    embeddings, None when not injected.  With a global feature (`global_dim`)
    it is the condition and the class embedding the second condition."""
    arch = hp["architecture"]
    neighbor_def = _as_list(arch["neighbor_definition"], len(arch["radius"]))
    if global_dim is not None:
        cond = dict(include_condition=True, condition_dim=global_dim,
                    include_second_condition=class_dim is not None,
                    second_condition_dim=class_dim)
    else:
        cond = dict(include_condition=class_dim is not None, condition_dim=class_dim)
    fd = arch["feature_dim"]
    mods = []
    for i in range(len(arch["npoint"])):
        spec = [fd[i]] * arch["mlp_depth"] + [fd[i + 1]]
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
                      **cond)
        owner.add_module(f"sa_modules_{i}", sa)
        mods.append(sa)
    return mods


class ConditionalPointNet2(nn.Module):
    """`config` is the reference's `pointnet_config` dict."""

    def __init__(self, config: Mapping[str, Any]):
        super().__init__()
        hp = config
        _check_supported(hp)
        self.config = config
        self.include_t = hp["include_t"]
        self.include_class_condition = hp.get("include_class_condition", False)
        self.transform_output = hp.get("transform_output", True)
        self.attach_position = hp["attach_position_to_input_feature"]
        self.pooling = hp.get("pooling", "max")
        self.act = get_activation(hp.get("activation", "relu"))
        self.bn = hp.get("bn", True)
        self.bn_first = hp["bn_first"]
        activation = hp.get("activation", "relu")
        attention_setting = hp.get("attention_setting", None)

        in_fea_dim = hp["in_fea_dim"] + (3 if self.attach_position else 0)
        t_emb_dim = cond_dim = None
        if self.include_class_condition:
            self.class_emb = nn.Embedding(hp["num_class"], hp["class_condition_dim"])
            cond_dim = hp["class_condition_dim"]
        if self.include_t:
            self.t_embedder = TimestepEmbedder(hp["t_dim"])
            t_emb_dim = 4 * hp["t_dim"]

        arch = hp["architecture"]
        fd = arch["feature_dim"]
        dd = arch["decoder_feature_dim"]
        if dd[-1] != fd[-1]:
            raise ValueError("decoder_feature_dim[-1] must equal feature_dim[-1]")
        neighbor_def = _as_list(arch["neighbor_definition"], len(arch["radius"]))
        coord_kw = dict(use_xyz=hp["model.use_xyz"],
                        include_abs_coordinate=hp["include_abs_coordinate"],
                        include_center_coordinate=hp.get("include_center_coordinate",
                                                         False))
        block_kw = dict(include_t=self.include_t,
                        include_condition=self.include_class_condition, bn=self.bn,
                        bn_first=hp["bn_first"], bias=hp["bias"],
                        res_connect=hp["res_connect"], activation=activation,
                        t_emb_dim=t_emb_dim, condition_dim=cond_dim)

        self.sa_modules = build_sa_stack(self, hp, in_fea_dim, t_emb_dim=t_emb_dim,
                                         class_dim=cond_dim)

        self.fp_modules = []
        depth = arch["decoder_mlp_depth"]
        for i in range(len(dd) - 1):
            skip_dim = in_fea_dim if i == 0 else fd[i]
            common = dict(include_grouper=arch.get("include_grouper", False),
                          radius=arch["radius"][i], nsample=arch["nsample"][i],
                          neighbor_def=neighbor_def[i], **coord_kw, **block_kw)
            if arch.get("use_knn_FP", False):
                fp = KnnFPModule([dd[i + 1]] + [dd[i]] * depth,
                                 [dd[i] + skip_dim] + [dd[i]] * depth,
                                 k=arch.get("K", 3),
                                 attention_setting=attention_setting, **common)
            else:
                fp = FPModule([dd[i + 1] + skip_dim] + [dd[i]] * depth, **common)
            self.add_module(f"fp_modules_{i}", fp)
            self.fp_modules.append(fp)

        out_dim = hp["out_dim"] * upsample_factor_multiplier(hp)
        if self.transform_output:
            head_in = dd[0] + 3
            if self.bn_first:
                self.head_conv_out = nn.Linear(head_in, out_dim)
            else:
                self.head_conv1 = nn.Linear(head_in, 128, bias=hp["bias"])
                if self.bn:
                    self.head_norm = GroupNorm(32, 128)
                self.head_conv_out = nn.Linear(128, out_dim)

    def forward(self, pointcloud: torch.Tensor, ts: Optional[torch.Tensor] = None,
                label: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, N, 3 + in_fea_dim) -> (B, N, out_dim), or the decoder features
        (B, N, decoder_feature_dim[0]) when transform_output is off."""
        pc = pointcloud
        if self.attach_position:
            pc = torch.cat([pc, pc[..., :3]], dim=-1)
        xyz = pc[..., :3]
        features = pc[..., 3:] if pc.shape[-1] > 3 else None
        t_emb = self.t_embedder(ts) if (ts is not None and self.include_t) else None
        cond = (self.class_emb(label.long())
                if (label is not None and self.include_class_condition) else None)

        l_xyz, l_features = [xyz], [features]
        for i, sa in enumerate(self.sa_modules):
            u, f = sa(l_xyz[i], l_features[i], t_emb=t_emb, condition_emb=cond,
                      pooling=self.pooling)
            l_xyz.append(u)
            l_features.append(f)
        for i in range(-1, -(len(self.fp_modules) + 1), -1):
            l_features[i - 1] = self.fp_modules[i](
                l_xyz[i - 1], l_xyz[i], l_features[i - 1], l_features[i],
                t_emb=t_emb, condition_emb=cond, pooling=self.pooling)

        out = l_features[0]
        if not self.transform_output:
            return out
        out = torch.cat([out, xyz], dim=-1)
        if self.bn_first:
            return self.head_conv_out(self.act(out))
        h = self.head_conv1(out)
        if self.bn:
            h = self.head_norm(h)
        return self.head_conv_out(self.act(h))
