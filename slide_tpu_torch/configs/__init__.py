from slide_tpu_torch.configs.presets import (
    SHAPENET_CATEGORIES,
    autoencoder_config,
    keypoint_ddpm_config,
    latent_ddpm_config,
    upsampler_config,
)

__all__ = ["SHAPENET_CATEGORIES", "autoencoder_config", "keypoint_ddpm_config",
           "latent_ddpm_config", "upsampler_config"]
