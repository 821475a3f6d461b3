"""Point autoencoder, decode half (counterpart:
`slide_tpu/models/autoencoder.py::PointAutoencoder.decode`).

Decode runs the keypoint level's fc head and trim, then the cascade of
upsampling decoders: 16 keypoints -> 256 -> 1024 -> 2048 points.  The
encoder, the keypoint level's feature propagation and the training loss
belong to encode and training, later slices; `decode_params` picks from a
full checkpoint tree the parameters decode reads.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from slide_tpu_torch.models.upsample_decoder import (KeypointDecoder,
                                                     PointUpsampleDecoder, StartFn,
                                                     decoder_feature_out_dim)


class PointAutoencoder(nn.Module):
    """decoder_config_list[0] is the keypoint level, the rest the cascade."""

    def __init__(self, encoder_config: Mapping[str, Any],
                 decoder_config_list: Sequence[Mapping[str, Any]]):
        super().__init__()
        self.keypoint_encoder = PointUpsampleDecoder(
            decoder_config_list[0], in_dim=encoder_config["architecture"]["feature_dim"][-1],
            upsample_only=True)
        self.decoder = KeypointDecoder(decoder_config_list[1:],
                                       decoder_feature_out_dim(decoder_config_list[0]))

    def decode(self, keypoint: torch.Tensor, feature_at_keypoint: torch.Tensor,
               label: Optional[torch.Tensor] = None,
               start_fn: Optional[StartFn] = None) -> torch.Tensor:
        """(B, K, 3) keypoints + (B, K, F) features -> (B, N, out_dim) cloud.
        start_fn(batch, n) gives each FPS trim's start indices (0 if None)."""
        new_xyz = self.keypoint_encoder.upsample_points(feature_at_keypoint, keypoint,
                                                        start_fn)
        l_xyz = self.decoder(keypoint[..., :3], feature_at_keypoint, new_xyz,
                             label=label, start_fn=start_fn)
        return l_xyz[-1]


def build_autoencoder(pointnet_config: Mapping[str, Any]) -> PointAutoencoder:
    return PointAutoencoder(pointnet_config["encoder_config"],
                            pointnet_config["decoder_config_list"])


def decode_params(params: Mapping[str, Any]) -> dict:
    """The subtree of a full autoencoder parameter tree that decode reads."""
    return {"keypoint_encoder": {"fc_layer": params["keypoint_encoder"]["fc_layer"]},
            "decoder": params["decoder"]}
