"""Point upsampling decoder stack (counterpart:
`slide_tpu/models/upsample_decoder.py`):

  point_upsample        coarse points + per-point displacement grids
  PointUpsampleDecoder  feature extractor + cross-level FeatureMapModule +
                        fc split head + FPS trim, with optional VAE
                        regularisation of the features
  KeypointDecoder       cascade of PointUpsampleDecoders

FPS trims start at `start_fn(batch, n)` when a caller gives one (the JAX
package draws these from its 'fps' rng stream), else at index 0.  The
posterior's standard-normal noise comes from `noise_fn(shape)` (the JAX
package's 'gaussian' stream).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from slide_tpu_torch.models.denoiser import ConditionalPointNet2
from slide_tpu_torch.models.encoder import PointNetEncoder
from slide_tpu_torch.nn.distributions import DiagonalGaussian
from slide_tpu_torch.nn.layers import Linear
from slide_tpu_torch.nn.modules import FeatureMapModule
from slide_tpu_torch.ops import furthest_point_sample, gather_points

StartFn = Callable[[int, int], torch.Tensor]
NoiseFn = Callable[[tuple], torch.Tensor]


def point_upsample(coarse: torch.Tensor, displacement: torch.Tensor,
                   point_upsample_factor: int, *,
                   include_displacement_center_to_final_output: bool = False,
                   output_scale_factor_value: float = 0.001,
                   first_refine_coarse_points: bool = False) -> torch.Tensor:
    """Split each coarse point into a grid of displaced points: coarse
    (B, N, F), displacement (B, N, F * groups) -> (B, N * factor, F)."""
    if not first_refine_coarse_points and include_displacement_center_to_final_output:
        raise ValueError("center output requires first_refine_coarse_points")
    b, n, f = coarse.shape
    if displacement.shape[-1] % f != 0:
        raise ValueError(f"displacement channels {displacement.shape[-1]} not "
                         f"divisible by {f}")
    groups = displacement.shape[-1] // f
    grid_scale = 1.0 / np.sqrt(point_upsample_factor)
    if first_refine_coarse_points:
        refined = coarse + displacement[..., :f] * output_scale_factor_value
        grid_disp = (displacement[..., f:] * grid_scale).reshape(b, n, groups - 1, f)
    else:
        if groups != point_upsample_factor:
            raise ValueError(f"displacement has {groups} groups, expected "
                             f"{point_upsample_factor}")
        grid_disp = (displacement * grid_scale).reshape(b, n, point_upsample_factor, f)
        refined = coarse
    up = (refined[:, :, None, :] + grid_disp * output_scale_factor_value).reshape(b, -1, f)
    if include_displacement_center_to_final_output:
        up = torch.cat([up, refined], dim=1)
    return up


def upsample_output_multiplier(upsampling_setting: Mapping) -> int:
    factor = upsampling_setting["point_upsample_factor"]
    if upsampling_setting["first_refine_coarse_points"]:
        factor += 1
        if upsampling_setting["include_displacement_center_to_final_output"]:
            factor -= 1
    elif upsampling_setting["include_displacement_center_to_final_output"]:
        raise ValueError("center output requires first_refine_coarse_points")
    return int(factor)


def decoder_feature_out_dim(level_config: Mapping) -> int:
    """Feature width a level hands to the next."""
    arch = level_config["architecture"]
    base = arch["decoder_feature_dim"][0] if "decoder_feature_dim" in arch \
        else arch["feature_dim"][-1]
    return base + level_config["feature_mapper_setting"]["out_dim"]


class PointUpsampleDecoder(nn.Module):
    """One decoder level.  `config` is the level's pointnet_config, `in_dim`
    the previous level's feature width.  The feature extractor is a
    `PointNetEncoder` when the config has no "decoder_feature_dim" (the
    keypoint level), else a `ConditionalPointNet2`.  With
    `apply_kl_regularization` the extractor and the mapper give twice their
    widths, read as a diagonal Gaussian's mean | logvar.  `upsample_only`
    builds just the fc head and trim, which is all decode runs of the
    keypoint level."""

    def __init__(self, config: Mapping[str, Any], in_dim: int,
                 upsample_only: bool = False, apply_kl_regularization: bool = False):
        super().__init__()
        hp = config
        arch = hp["architecture"]
        self.upsample_only = upsample_only
        self.apply_kl_regularization = apply_kl_regularization
        self.is_condition_net = "decoder_feature_dim" in arch
        if not upsample_only:
            # the extractor's output width, doubled for mean | logvar with KL
            kl = 2 if apply_kl_regularization else 1
            key, at = ("decoder_feature_dim", 0) if self.is_condition_net \
                else ("feature_dim", -1)
            widths = list(arch[key])
            query_dim = widths[at]
            widths[at] *= kl
            cfg = dict(hp, architecture=dict(arch, **{key: widths}))
            self.feature_extractor = (ConditionalPointNet2 if self.is_condition_net
                                      else PointNetEncoder)(cfg)
            fm = hp["feature_mapper_setting"]
            self.feature_mapper = FeatureMapModule(
                mlp_spec=[in_dim] + [fm["out_dim"] * kl] * fm["mlp_depth"],
                k=fm["nsample"], radius=fm["radius"],
                neighbor_def=fm["neighbor_definition"], use_xyz=hp["model.use_xyz"],
                include_abs_coordinate=hp["include_abs_coordinate"],
                include_center_coordinate=hp.get("include_center_coordinate", False),
                bn=hp["bn"], bn_first=hp["bn_first"], bias=hp["bias"],
                res_connect=hp["res_connect"], first_conv=False,
                activation=hp.get("activation", "relu"),
                attention_setting=hp["attention_setting"], query_feature_dim=query_dim)
        self.upsampling_setting = hp["upsampling_setting"]
        self.point_upsample_factor = upsample_output_multiplier(self.upsampling_setting)
        self.out_dim = hp["out_dim"]
        self.in_position_and_normal_dim = hp.get("in_position_and_normal_dim",
                                                 hp["out_dim"])
        self.fc_layer = Linear(
            decoder_feature_out_dim(hp) + self.in_position_and_normal_dim,
            self.out_dim * self.point_upsample_factor)

    def propagate_feature(self, xyz, features, new_xyz, label=None,
                          sample_posterior: bool = True,
                          noise_fn: Optional[NoiseFn] = None):
        """Features at new_xyz from the extractor, features of the previous
        level mapped onto new_xyz, concatenated.  With KL regularisation both
        are sampled from their posteriors (their modes when
        `sample_posterior` is off; `noise_fn(shape)` gives the standard-normal
        noise, the extractor's first).  Returns (features, KL (B,) or None)."""
        if self.upsample_only:
            raise NotImplementedError("propagate_feature needs the level's "
                                      "feature extractor")
        out = self.feature_extractor(new_xyz, label=label)
        if not self.is_condition_net:
            out = out[0]
        if not self.apply_kl_regularization:
            mapped = self.feature_mapper(xyz, features, new_xyz[..., :3],
                                         features_at_new_xyz=out, subset=False)
            return torch.cat([out, mapped], dim=-1), None
        out, out_post = self._sample(out, sample_posterior, noise_fn)
        mapped = self.feature_mapper(xyz, features, new_xyz[..., :3],
                                     features_at_new_xyz=out, subset=False)
        mapped, mapped_post = self._sample(mapped, sample_posterior, noise_fn)
        return torch.cat([out, mapped], dim=-1), out_post.kl() + mapped_post.kl()

    @staticmethod
    def _sample(parameters, sample_posterior: bool, noise_fn: Optional[NoiseFn]):
        posterior = DiagonalGaussian.from_parameters(parameters)
        if not sample_posterior:
            return posterior.mode(), posterior
        if noise_fn is None:
            raise ValueError("sampling the posterior needs a noise_fn")
        return posterior.sample(noise_fn(tuple(posterior.mean.shape))), posterior

    def upsample_points(self, final_feature, new_xyz,
                        start_fn: Optional[StartFn] = None):
        """fc -> point_upsample -> FPS trim to num_output_points."""
        splitted = self.fc_layer(torch.cat([final_feature, new_xyz], dim=-1))
        coarse = new_xyz[..., : self.in_position_and_normal_dim]
        if self.in_position_and_normal_dim < self.out_dim:
            pad = coarse.new_zeros(coarse.shape[:2] + (
                self.out_dim - self.in_position_and_normal_dim,))
            coarse = torch.cat([coarse, pad], dim=-1)
        ups = self.upsampling_setting
        up = point_upsample(
            coarse, splitted, self.point_upsample_factor,
            include_displacement_center_to_final_output=ups[
                "include_displacement_center_to_final_output"],
            output_scale_factor_value=ups["output_scale_factor"],
            first_refine_coarse_points=ups["first_refine_coarse_points"])
        num_out = ups["num_output_points"]
        b, n = up.shape[:2]
        if n < num_out:
            raise ValueError(f"upsampled {n} < num_output_points {num_out}")
        if n > num_out:
            start = start_fn(b, n) if start_fn is not None else 0
            idx = furthest_point_sample(up[..., :3], num_out, start_idx=start)
            up = gather_points(up, idx)
        return up

    def forward(self, xyz, features, new_xyz, label=None,
                start_fn: Optional[StartFn] = None, sample_posterior: bool = True,
                noise_fn: Optional[NoiseFn] = None):
        """(features, upsampled points, KL or None)."""
        final_feature, kl = self.propagate_feature(xyz, features, new_xyz, label=label,
                                                   sample_posterior=sample_posterior,
                                                   noise_fn=noise_fn)
        return final_feature, self.upsample_points(final_feature, new_xyz, start_fn), kl


class KeypointDecoder(nn.Module):
    """Cascade of PointUpsampleDecoders, threading feature widths."""

    def __init__(self, config_list: Sequence[Mapping[str, Any]], feature_dim: int):
        super().__init__()
        self.decoders = []
        fdim = feature_dim
        for i, cfg in enumerate(config_list):
            dec = PointUpsampleDecoder(cfg, in_dim=fdim)
            self.add_module(f"decoders_{i}", dec)
            self.decoders.append(dec)
            fdim = decoder_feature_out_dim(cfg)

    def forward(self, xyz0, features0, xyz1, label=None,
                start_fn: Optional[StartFn] = None):
        l_xyzs = [xyz0, xyz1]
        l_features = [features0]
        for i, decoder in enumerate(self.decoders):
            new_feature, new_xyz, _ = decoder(l_xyzs[i][..., :3], l_features[i],
                                              l_xyzs[i + 1], label=label,
                                              start_fn=start_fn)
            l_xyzs.append(new_xyz)
            l_features.append(new_feature)
        return l_xyzs
