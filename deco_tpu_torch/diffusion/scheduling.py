"""Flow-matching and diffusion interpolant schedulers
(``deco_tpu/diffusion/scheduling.py``).

A scheduler defines ``x_t = alpha(t) * x + sigma(t) * eps`` and its
derivatives. The functions take numpy arrays (the samplers precompute their
per-step tables in numpy, as the JAX package does) or torch tensors. A
derivative the reference leaves undefined (the VP and DDPM schedulers')
raises ``NotImplementedError``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def bcast_right(t, ndim: int):
    """Append trailing singleton dims so ``t`` broadcasts against an ndim tensor."""
    return t.reshape(tuple(t.shape) + (1,) * (ndim - t.dim()))


def _ones_like(t):
    return torch.ones_like(t) if isinstance(t, torch.Tensor) else np.ones_like(t)


def _lib(t):
    """torch for a tensor, numpy for anything else (the elementwise functions
    used here have one name in both)."""
    return torch if isinstance(t, torch.Tensor) else np


def _clip(t, lo, hi):
    return torch.clamp(t, lo, hi) if isinstance(t, torch.Tensor) else np.clip(t, lo, hi)


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


@dataclasses.dataclass(frozen=True)
class GVPScheduler(BaseScheduler):
    """Generalized VP (cosine) interpolant: alpha = cos(pi t / 2), sigma = sin(pi t / 2)."""

    def alpha(self, t):
        return _lib(t).cos(t * (math.pi / 2))

    def sigma(self, t):
        return _lib(t).sin(t * (math.pi / 2))

    def dalpha(self, t):
        return -_lib(t).sin(t * (math.pi / 2))

    def dsigma(self, t):
        return _lib(t).cos(t * (math.pi / 2))

    def w(self, t):
        # the reference's sin(t)**2, not sin(pi t / 2)**2
        return _lib(t).sin(t) ** 2


@dataclasses.dataclass(frozen=True)
class ConstScheduler(BaseScheduler):
    """w = 1; used only as a ``w_scheduler``."""

    def w(self, t):
        return _ones_like(t)


@dataclasses.dataclass(frozen=True)
class VPScheduler(BaseScheduler):
    """Continuous-time VP scheduler: t (clamped to [1e-3, 1]) is diffusion
    time, beta(t) = beta_min + (beta_max - beta_min) t, alpha = exp(-I(t) / 2)
    and sigma = sqrt(1 - exp(-I(t))) with I(t) = (beta_max - beta_min) t^2 / 2
    + beta_min t. The derivatives are not defined (the reference raises)."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    @property
    def beta_d(self):
        return self.beta_max - self.beta_min

    def beta(self, t):
        return self.beta_min + self.beta_d * _clip(t, 1e-3, 1.0)

    def _integral_beta(self, t):
        t = _clip(t, 1e-3, 1.0)
        return 0.5 * self.beta_d * t**2 + self.beta_min * t

    def alpha(self, t):
        return _lib(t).exp(-0.5 * self._integral_beta(t))

    def sigma(self, t):
        return _lib(t).sqrt(1.0 - _lib(t).exp(-self._integral_beta(t)))


@dataclasses.dataclass(frozen=True)
class DDPMScheduler(BaseScheduler):
    """Discrete DDPM tables; ``t`` indexes them (integer timesteps in
    [0, num_steps), truncated as ``astype(int32)`` does). The tables are
    float32, as the JAX package builds them."""

    beta_min: float = 0.0001
    beta_max: float = 0.02
    num_steps: int = 1000

    def _tables(self):
        betas = np.linspace(self.beta_min, self.beta_max, self.num_steps, dtype=np.float32)
        alphas = np.cumprod(1.0 - betas, dtype=np.float32)
        return betas, alphas, 1.0 - alphas

    def _lookup(self, table, t):
        if isinstance(t, torch.Tensor):
            return torch.from_numpy(table).to(t.device)[t.long()]
        return table[np.asarray(t).astype(np.int32)]

    def beta(self, t):
        return self._lookup(self._tables()[0], t)

    def alpha(self, t):
        return self._lookup(self._tables()[1], t) ** 0.5

    def sigma(self, t):
        return self._lookup(self._tables()[2], t) ** 0.5


@dataclasses.dataclass(frozen=True)
class VPBetaScheduler(VPScheduler):
    """VP scheduler whose w(t) is beta(t)."""

    def w(self, t):
        return self.beta(t)
