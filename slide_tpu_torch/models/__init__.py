"""Networks of generation and training (counterpart: `slide_tpu/models/`)."""

from slide_tpu_torch.models.autoencoder import (PointAutoencoder, build_autoencoder,
                                                decode_params)
from slide_tpu_torch.models.denoiser import ConditionalPointNet2
from slide_tpu_torch.models.encoder import PointNetEncoder
from slide_tpu_torch.models.upsample_decoder import (KeypointDecoder,
                                                     PointUpsampleDecoder,
                                                     point_upsample)

__all__ = ["PointAutoencoder", "build_autoencoder", "decode_params",
           "ConditionalPointNet2", "PointNetEncoder", "KeypointDecoder", "PointUpsampleDecoder",
           "point_upsample"]
