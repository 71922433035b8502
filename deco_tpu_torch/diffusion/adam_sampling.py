"""Adams-Lagrange linear multistep sampler (``deco_tpu/diffusion/adam_sampling.py``).

An order-k (k <= 4) multistep ODE sampler. Its per-step coefficients are
precomputed in numpy by integrating the Lagrange interpolant of the last k
velocity predictions over each ``[t_i, t_{i+1}]``, optionally in a
transformed time coordinate (``lms_transform_fn``: "nop", "snr", "logsnr",
"isnr"). At step i the order is min(order, i + 1). The sampler is a Python
loop over the steps that keeps the last ``order`` predictions; steps whose
guidance scale is 1 at either end of the schedule run the network on the
conditional half only, as in :class:`~deco_tpu_torch.diffusion.sampling.EulerSampler`.
Its loop state, for ``sample_chunked``, is x and the predictions kept.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from deco_tpu_torch.diffusion.pre_integral import lagrange_preint
from deco_tpu_torch.diffusion.sampling import BaseSampler, shift_respace_fn
from deco_tpu_torch.diffusion.scheduling import BaseScheduler


def t2snr(t):
    t = max(float(t), 1e-8)
    return t / (1 - t + 1e-8)


def t2logsnr(t):
    t = max(float(t), 1e-3)
    return math.log(t / (1 - t + 1e-3))


def t2isnr(t):
    return 1.0 / t2snr(t)


def nop(t):
    return float(t)


LMS_TRANSFORMS = {"nop": nop, "snr": t2snr, "logsnr": t2logsnr, "isnr": t2isnr}


class AdamLMSampler(BaseSampler):
    """Adams-Lagrange multistep ODE sampler (the t2i production sampler)."""

    def __init__(self, scheduler: BaseScheduler = None, order: int = 2,
                 timeshift: float = 1.0, guidance_interval_min: float = 0.0,
                 guidance_interval_max: float = 1.0, lms_transform_fn="nop",
                 last_step: Optional[float] = None, **kwargs):
        super().__init__(scheduler=scheduler, **kwargs)
        if self.scheduler is None:
            raise ValueError("AdamLMSampler needs a scheduler")
        if order not in (1, 2, 3, 4):
            raise ValueError(f"order={order}: the Lagrange integrals go to order 4")
        self.order = order
        self.guidance_interval_min = guidance_interval_min
        self.guidance_interval_max = guidance_interval_max
        if isinstance(lms_transform_fn, str):
            lms_transform_fn = LMS_TRANSFORMS[lms_transform_fn]
        self.lms_transform_fn = lms_transform_fn
        if last_step is None:
            last_step = 1.0 / self.num_steps
        self.last_step = last_step
        timesteps = np.concatenate([np.linspace(0.0, 1 - last_step, self.num_steps), [1.0]])
        self.timesteps = shift_respace_fn(timesteps, timeshift)
        self.timedeltas = self.timesteps[1:] - self.timesteps[:-1]
        self._reparameterize_coeffs()

    def _reparameterize_coeffs(self):
        """``solver_coeffs`` (num_steps, order), float32: row i weighs the
        last min(order, i + 1) predictions, oldest first, right-aligned (the
        older slots zero); and the per-step guidance scales."""
        coeff_rows = np.zeros((self.num_steps, self.order), dtype=np.float64)
        for i in range(self.num_steps):
            pre_ts = [self.lms_transform_fn(t) for t in self.timesteps[: i + 1]]
            _, coeffs = lagrange_preint(min(self.order, i + 1), [1.0] * (i + 1), pre_ts,
                                        self.lms_transform_fn(self.timesteps[i]),
                                        self.lms_transform_fn(self.timesteps[i + 1]))
            coeff_rows[i, self.order - len(coeffs):] = np.asarray(coeffs)
        self.solver_coeffs = coeff_rows.astype(np.float32)
        # the guidance interval is open at both ends here (the reference's `<`)
        t_cur = self.timesteps[:-1]
        in_interval = (t_cur > self.guidance_interval_min) & (t_cur < self.guidance_interval_max)
        self._cfg_per_step = np.where(in_interval, self.guidance, 1.0).astype(np.float32)

    def _cfg_array(self):
        return self._cfg_per_step

    def _init_carry(self, noise):
        return noise, []  # x and the last `order` predictions, oldest first

    def _carry_x(self, carry):
        return carry[0]

    def _run_steps(self, net, carry, start, end, condition, cfg_condition, generator, collect):
        t_cur = self.timesteps[:-1].astype(np.float32)
        dts = self.timedeltas.astype(np.float32)
        x, history = carry
        xs, vs = [], []
        for i in range(start, end):
            pred = self._guided(net, x, float(t_cur[i]), float(self._cfg_per_step[i]),
                                condition, cfg_condition).to(x.dtype)
            history = (history + [pred])[-self.order:]
            coeffs = self.solver_coeffs[i, self.order - len(history):]
            v = sum(float(c) * h for c, h in zip(coeffs, history))
            x = x + v * float(dts[i])
            if collect:
                xs.append(x)
                vs.append(v)
        return (x, history), xs, vs

    def _impl_sampling(self, net, noise, condition, uncondition, generator, collect=False):
        cfg_condition = torch.cat([uncondition, condition], dim=0)
        (x, _), xs, vs = self._run_steps(net, self._init_carry(noise), 0, self.num_steps,
                                         condition, cfg_condition, generator, collect)
        xs = [noise] + xs
        if collect:
            vs.append(torch.zeros_like(noise))
            return torch.stack(xs), torch.stack(vs)
        return x[None], None
