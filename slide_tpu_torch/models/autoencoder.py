"""The point autoencoder (counterpart:
`slide_tpu/models/autoencoder.py::PointAutoencoder`): a PointNet++ encoder,
the keypoint level (its `PointNetEncoder` on the keypoints, the encoder's
features mapped onto them, both VAE-regularised with the shipped presets),
then the cascade of upsampling decoders: 16 keypoints -> 256 -> 1024 -> 2048
points.

  encode   cloud + keypoints -> the keypoints' latent features
  decode   keypoints + latent features -> cloud
  forward  the round trip and the per-level chamfer losses against
           FPS-downsampled targets (the training loss)

`decode_only` builds the keypoint level's fc head and trim and the cascade,
all decode reads; `decode_params` picks that subtree from a full tree.
Randomness comes from the caller: `noise_fn(shape)` gives the posteriors'
standard-normal noise, `start_fn(batch, n)` the FPS starts (0 if None).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from slide_tpu_torch.models.encoder import PointNetEncoder
from slide_tpu_torch.models.upsample_decoder import (KeypointDecoder, NoiseFn,
                                                     PointUpsampleDecoder, StartFn,
                                                     decoder_feature_out_dim)
from slide_tpu_torch.ops import calc_cd, furthest_point_sample, gather_points


class PointAutoencoder(nn.Module):
    """decoder_config_list[0] is the keypoint level, the rest the cascade."""

    def __init__(self, encoder_config: Mapping[str, Any],
                 decoder_config_list: Sequence[Mapping[str, Any]], *,
                 apply_kl_regularization: bool = False, kl_weight: float = 0.0,
                 feature_weight: Optional[Sequence[float]] = None,
                 decode_only: bool = False):
        super().__init__()
        self.apply_kl_regularization = apply_kl_regularization
        self.kl_weight = kl_weight
        self.feature_weight = feature_weight
        if not decode_only:
            self.encoder = PointNetEncoder(encoder_config)
        self.keypoint_encoder = PointUpsampleDecoder(
            decoder_config_list[0], in_dim=encoder_config["architecture"]["feature_dim"][-1],
            upsample_only=decode_only, apply_kl_regularization=apply_kl_regularization)
        self.decoder = KeypointDecoder(decoder_config_list[1:],
                                       decoder_feature_out_dim(decoder_config_list[0]))

    def encode(self, pointcloud: torch.Tensor, keypoint: torch.Tensor,
               label: Optional[torch.Tensor] = None, sample_posterior: bool = True,
               noise_fn: Optional[NoiseFn] = None) -> torch.Tensor:
        """(B, N, 3 + F) cloud + (B, K, 3) keypoints -> (B, K, latent) features."""
        out, l_xyz, _ = self.encoder(pointcloud, label=label)
        feature, _ = self.keypoint_encoder.propagate_feature(
            l_xyz[-1], out, keypoint, label=label, sample_posterior=sample_posterior,
            noise_fn=noise_fn)
        return feature

    def decode(self, keypoint: torch.Tensor, feature_at_keypoint: torch.Tensor,
               label: Optional[torch.Tensor] = None,
               start_fn: Optional[StartFn] = None) -> torch.Tensor:
        """(B, K, 3) keypoints + (B, K, F) features -> (B, N, out_dim) cloud."""
        new_xyz = self.keypoint_encoder.upsample_points(feature_at_keypoint, keypoint,
                                                        start_fn)
        l_xyz = self.decoder(keypoint[..., :3], feature_at_keypoint, new_xyz,
                             label=label, start_fn=start_fn)
        return l_xyz[-1]

    def forward(self, pointcloud: torch.Tensor, keypoint: torch.Tensor,
                label: Optional[torch.Tensor] = None, loss_type: str = "cd_p",
                sample_posterior: bool = True, noise_fn: Optional[NoiseFn] = None,
                start_fn: Optional[StartFn] = None, return_keypoint_feature: bool = False):
        """The round trip and its losses: (clouds per level, [per level: dict
        of (B,) values with "training_loss" and `calc_cd`'s metrics]), and
        with `return_keypoint_feature` the (sampled) features at the
        keypoints third.  The FPS starts are drawn in the JAX package's
        order: the three trims, then the targets'."""
        if pointcloud.shape[-1] not in (3, 6):
            raise ValueError("pointcloud must be xyz or xyz+normals")
        if loss_type not in ("cd_p", "cd_t"):
            raise ValueError(f"loss type {loss_type} is not supported")
        out, l_xyz_enc, _ = self.encoder(pointcloud, label=label)
        feature, new_xyz, kl = self.keypoint_encoder(
            l_xyz_enc[-1], out, keypoint, label=label, start_fn=start_fn,
            sample_posterior=sample_posterior, noise_fn=noise_fn)
        l_xyz = self.decoder(keypoint[..., :3], feature, new_xyz, label=label,
                             start_fn=start_fn)

        # per-level targets: the whole cloud where a level has all N points,
        # else a prefix of ONE FPS to the largest smaller size (FPS's greedy
        # picks make each prefix the FPS of its own size from that start)
        b, n = pointcloud.shape[:2]
        sizes = sorted({x.shape[1] for x in l_xyz[1:] if x.shape[1] < n})
        idx_full = None
        if sizes:
            start = start_fn(b, n) if start_fn is not None else 0
            idx_full = furthest_point_sample(pointcloud[..., :3], sizes[-1], start_idx=start)
        loss_list = []
        last = len(l_xyz) - 1
        for i in range(1, len(l_xyz)):
            uvw = l_xyz[i]
            m = uvw.shape[1]
            down = pointcloud if m >= n else gather_points(pointcloud, idx_full[:, :m])
            loss_dict = calc_cd(uvw, down, calc_f1=True, f1_threshold=0.0001,
                                normal_loss_type="mse")
            fw = 0.0 if self.feature_weight is None else self.feature_weight[i - 1]
            suffix = loss_type[-1]
            loss = loss_dict[f"cd_{suffix}"]
            if f"cd_feature_{suffix}" in loss_dict:
                loss = loss + loss_dict[f"cd_feature_{suffix}"] * fw
            if self.apply_kl_regularization and self.kl_weight > 0:
                if i == last:
                    loss_dict["kl_loss"] = kl
                    loss = loss + self.kl_weight * kl
                else:
                    loss_dict["kl_loss"] = torch.zeros_like(loss)
            loss_dict["training_loss"] = loss
            loss_list.append(loss_dict)
        if return_keypoint_feature:
            return l_xyz, loss_list, feature
        return l_xyz, loss_list


def build_autoencoder(pointnet_config: Mapping[str, Any], *,
                      decode_only: bool = False) -> PointAutoencoder:
    """The autoencoder of an AE `pointnet_config` (its KL regularisation,
    KL weight and per-level feature weights included)."""
    fw = pointnet_config.get("feature_weight")
    return PointAutoencoder(pointnet_config["encoder_config"],
                            pointnet_config["decoder_config_list"],
                            apply_kl_regularization=pointnet_config.get(
                                "apply_kl_regularization", False),
                            kl_weight=pointnet_config.get("kl_weight", 0.0),
                            feature_weight=tuple(fw) if fw else None,
                            decode_only=decode_only)


def decode_params(params: Mapping[str, Any]) -> dict:
    """The subtree of a full autoencoder parameter tree that decode reads."""
    return {"keypoint_encoder": {"fc_layer": params["keypoint_encoder"]["fc_layer"]},
            "decoder": params["decoder"]}
