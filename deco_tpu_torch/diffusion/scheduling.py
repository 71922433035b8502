"""Flow-matching interpolant schedulers (``deco_tpu/diffusion/scheduling.py``).

A scheduler defines ``x_t = alpha(t) * x + sigma(t) * eps`` and its
derivatives. The functions take numpy arrays (the sampler precomputes its
per-step tables in numpy, as the JAX package does) or torch tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def bcast_right(t, ndim: int):
    """Append trailing singleton dims so ``t`` broadcasts against an ndim tensor."""
    return t.reshape(tuple(t.shape) + (1,) * (ndim - t.dim()))


def _ones_like(t):
    return torch.ones_like(t) if isinstance(t, torch.Tensor) else np.ones_like(t)


@dataclasses.dataclass(frozen=True)
class BaseScheduler:
    """Interpolant abstraction: alpha/sigma and derivatives as functions of t."""

    def alpha(self, t):
        raise NotImplementedError

    def sigma(self, t):
        raise NotImplementedError

    def dalpha(self, t):
        raise NotImplementedError

    def dsigma(self, t):
        raise NotImplementedError

    def dalpha_over_alpha(self, t):
        return self.dalpha(t) / self.alpha(t)

    def dsigma_mul_sigma(self, t):
        return self.dsigma(t) * self.sigma(t)

    def drift_coefficient(self, t):
        return self.dalpha(t) / (self.alpha(t) + 1e-6)

    def diffuse_coefficient(self, t):
        return self.dsigma(t) * self.sigma(t) - self.dalpha(t) / (
            self.alpha(t) + 1e-6
        ) * self.sigma(t) ** 2

    def w(self, t):
        return self.sigma(t)

    def isotropic_coeffs(self, t):
        """(alpha, dalpha, sigma, dsigma) evaluated together."""
        return self.alpha(t), self.dalpha(t), self.sigma(t), self.dsigma(t)


@dataclasses.dataclass(frozen=True)
class LinearScheduler(BaseScheduler):
    """Rectified-flow linear interpolant: alpha = t, sigma = 1 - t."""

    def alpha(self, t):
        return t

    def sigma(self, t):
        return 1.0 - t

    def dalpha(self, t):
        return _ones_like(t)

    def dsigma(self, t):
        return -_ones_like(t)
