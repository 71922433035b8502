"""DDPM-family samplers (``deco_tpu/diffusion/ddpm_sampling.py``): DDIM over a
discrete-t eps-prediction network, and the VP probability-flow ODE / reverse
SDE Euler sampler for continuous VP models.

The per-step scheduler coefficients are precomputed in numpy (float32, as
the JAX package computes them) and the sampler is a Python loop. Both apply
the one guidance scale ``guidance`` at every step; at 1 the network runs on
the conditional half only. The SDE draws its noise from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deco_tpu_torch.diffusion.sampling import BaseSampler
from deco_tpu_torch.diffusion.scheduling import BaseScheduler


def _trajectories(xs, vs, noise):
    vs.append(torch.zeros_like(noise))
    return torch.stack(xs), torch.stack(vs)


class DDIMSampler(BaseSampler):
    """Deterministic DDIM: ``num_steps - 1`` steps over the table timesteps
    from ``train_num_steps - 1`` down to 0."""

    def __init__(self, scheduler: BaseScheduler = None, train_num_steps: int = 1000, **kwargs):
        super().__init__(scheduler=scheduler, **kwargs)
        if self.scheduler is None:
            raise ValueError("DDIMSampler needs a scheduler")
        self.train_num_steps = train_num_steps
        self._ts = np.linspace(0.0, train_num_steps - 1, self.num_steps)[::-1].copy()

    def _impl_sampling(self, net, noise, condition, uncondition, generator, collect=False):
        cfg_condition = torch.cat([uncondition, condition], dim=0)
        ts = self._ts.astype(np.float32)
        t_cur, t_next = ts[:-1], ts[1:]
        tables = [np.asarray(f(t), np.float32) for f in (self.scheduler.alpha, self.scheduler.sigma)
                  for t in (t_cur, t_next)]
        x = noise
        xs, vs = [noise], []
        for i, (alpha, alpha_next, sigma, sigma_next) in enumerate(zip(*tables)):
            eps = self._guided(net, x, float(t_cur[i]), self.guidance, condition,
                               cfg_condition).to(x.dtype)
            x0 = (x - float(sigma) * eps) / float(alpha)
            x = float(alpha_next) * x0 + float(sigma_next) * eps
            if collect:
                xs.append(x)
                vs.append(eps)
        return _trajectories(xs, vs, noise) if collect else (x[None], None)


class VPEulerSampler(BaseSampler):
    """Probability-flow ODE / reverse SDE Euler for continuous VP models.

    step: ``x' = x + (-0.5 beta x + k eps beta / sigma) dt [+ sqrt(|dt| beta) z]``
    with k = 0.5 (ODE) or k = 1 and noise (SDE); time runs from 1 to 0. The
    network sees ``t * train_max_t``. The last step integrates to t = 0
    without noise, with ``last_step_fn``'s k.
    """

    def __init__(self, scheduler: BaseScheduler = None, train_max_t: int = 1000,
                 step_fn: str = "ode", last_step: Optional[float] = None,
                 last_step_fn: str = "ode", **kwargs):
        super().__init__(scheduler=scheduler, **kwargs)
        if self.scheduler is None:
            raise ValueError("VPEulerSampler needs a scheduler")
        self.train_max_t = train_max_t
        self.step_type = step_fn
        self.last_step_type = last_step_fn
        if last_step is None or self.num_steps == 1:
            last_step = 1.0 / self.num_steps
        if not last_step > 0.0:
            raise ValueError(f"last_step={last_step}: must be > 0")
        self.last_step = last_step
        self._ts = np.concatenate([np.linspace(1.0, last_step, self.num_steps), [0.0]])
        n = self.num_steps
        self._k = np.full(n, 0.5 if step_fn == "ode" else 1.0)
        self._b = np.zeros(n) if step_fn == "ode" else np.ones(n)
        self._k[-1] = 0.5 if last_step_fn == "ode" else 1.0
        self._b[-1] = 0.0  # the last step is deterministic, as in the reference

    def _impl_sampling(self, net, noise, condition, uncondition, generator, collect=False):
        cfg_condition = torch.cat([uncondition, condition], dim=0)
        ts = self._ts.astype(np.float32)
        t_cur, t_next = ts[:-1], ts[1:]
        dt = t_next - t_cur
        sigma = np.asarray(self.scheduler.sigma(t_cur), np.float32)
        beta = np.asarray(self.scheduler.beta(t_cur), np.float32)
        k, b = self._k.astype(np.float32), self._b.astype(np.float32)
        x = noise
        xs, vs = [noise], []
        for i in range(self.num_steps):
            eps = self._guided(net, x, float(t_cur[i] * np.float32(self.train_max_t)),
                               self.guidance, condition, cfg_condition).to(x.dtype)
            drift = -0.5 * float(beta[i]) * x + float(k[i]) * eps * float(beta[i]) / float(sigma[i])
            x_next = x + drift * float(dt[i])
            if b[i] != 0:
                if generator is None:
                    raise ValueError("step_fn='sde' draws noise: pass a torch.Generator")
                z = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                device=generator.device).to(x.device)
                x_next = x_next + float(b[i]) * float(np.sqrt(abs(dt[i]) * beta[i])) * z
            x = x_next
            if collect:
                xs.append(x)
                vs.append(eps)
        return _trajectories(xs, vs, noise) if collect else (x[None], None)
