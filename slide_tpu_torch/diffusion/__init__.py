"""DDPM samplers and the eps training loss (counterpart: `slide_tpu/diffusion/`)."""

from slide_tpu_torch.diffusion.eps import (DiffusionSchedule,
                                           calc_diffusion_hyperparams,
                                           diffusion_sampling, diffusion_training_loss)
from slide_tpu_torch.diffusion.fastdpm import (diffusion_config_of, fast_sampling,
                                               fast_x0_denoise)
from slide_tpu_torch.diffusion.latent import latent_denoise_and_reconstruct
from slide_tpu_torch.diffusion.x0 import (X0Schedule, denoising_step,
                                          get_beta_schedule, predict_xstart,
                                          x0_denoise)

__all__ = ["DiffusionSchedule", "calc_diffusion_hyperparams", "diffusion_sampling",
           "diffusion_training_loss",
           "diffusion_config_of", "fast_sampling", "fast_x0_denoise",
           "latent_denoise_and_reconstruct", "X0Schedule", "denoising_step",
           "get_beta_schedule", "predict_xstart", "x0_denoise"]
