"""Diagonal Gaussian posterior (counterpart: `slide_tpu/nn/distributions.py`),
channels-last: parameters (..., 2C) split into mean | logvar.  Decode reads
no posterior; the autoencoder's encode, a later slice, samples from it."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    mean: torch.Tensor
    logvar: torch.Tensor

    @staticmethod
    def from_parameters(parameters: torch.Tensor) -> "DiagonalGaussian":
        c = parameters.shape[-1]
        if c % 2 != 0:
            raise ValueError("parameter channels must be even (mean|logvar)")
        return DiagonalGaussian(parameters[..., : c // 2],
                                torch.clamp(parameters[..., c // 2:], -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std * noise, with standard-normal `noise` drawn by the caller."""
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL against N(0, I), summed over all non-batch dims -> (B,)."""
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=dims)
