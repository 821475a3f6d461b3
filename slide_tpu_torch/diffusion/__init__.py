"""DDPM samplers and the eps, x0 and latent training losses (counterpart:
`slide_tpu/diffusion/`)."""

from slide_tpu_torch.diffusion.eps import (DiffusionSchedule,
                                           calc_diffusion_hyperparams,
                                           diffusion_sampling, diffusion_training_loss)
from slide_tpu_torch.diffusion.fastdpm import (diffusion_config_of, fast_sampling,
                                               fast_x0_denoise)
from slide_tpu_torch.diffusion.latent import (latent_config_weights,
                                              latent_denoise_and_reconstruct,
                                              latent_encode, latent_train_loss)
from slide_tpu_torch.diffusion.x0 import (X0Schedule, denoising_step, diffuse,
                                          diffuse_t_steps, get_beta_schedule,
                                          predict_xstart, x0_denoise, x0_training_loss)

__all__ = ["DiffusionSchedule", "calc_diffusion_hyperparams", "diffusion_sampling",
           "diffusion_training_loss",
           "diffusion_config_of", "fast_sampling", "fast_x0_denoise",
           "latent_config_weights", "latent_denoise_and_reconstruct", "latent_encode",
           "latent_train_loss", "X0Schedule", "denoising_step", "diffuse",
           "diffuse_t_steps", "get_beta_schedule", "predict_xstart", "x0_denoise",
           "x0_training_loss"]
