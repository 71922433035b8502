"""Flow-matching Euler and Heun samplers (``deco_tpu/diffusion/sampling.py``).

The per-step scalars (timestep, dt, scheduler coefficients, guidance scale,
step-function coefficients) are precomputed in numpy exactly as the JAX
package computes them, and the sampler runs a Python loop over the steps.
Every step function is one member of the family

    x' = x + v*dt + a*(s*w*dt) + b*sqrt(c*w*dt)*eps

with per-step coefficients (a, b, c) from :data:`STEP_COEFFS`. The CFG batch
is laid out ``[uncondition; condition]``. Steps whose guidance scale is 1 at
either end of the schedule run the network on the conditional half only.
The SDE step types draw ``eps`` from an explicit ``torch.Generator``.
:meth:`BaseSampler.sample_chunked` runs the same step loop in
``num_dispatches`` segments (the JAX package's split of its one-dispatch
scan, for transports that cap a dispatch's time); each segment continues
the last one's state, so the result equals the unsegmented call bit for
bit. The Euler samplers and ``AdamLMSampler`` take it, as in the JAX package.
:class:`EulerSamplerJiT` is the Euler sampler for x-prediction networks;
:class:`HeunSampler` adds a corrector evaluation per step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from deco_tpu_torch.diffusion.guidance import simple_guidance_fn
from deco_tpu_torch.diffusion.scheduling import BaseScheduler

STEP_COEFFS = {
    "ode": (0.0, 0.0, 0.0),
    "sde_mean": (1.0, 0.0, 0.0),
    "sde": (1.0, 1.0, 2.0),
    "sde_preserve": (0.5, 1.0, 1.0),
}


def shift_respace_fn(t, shift=3.0):
    """Timestep respacing t -> t / (t + (1 - t) * shift)."""
    return t / (t + (1 - t) * shift)


class BaseSampler:
    """Common CFG sampling surface.

    ``net`` passed to ``__call__`` is a callable ``net(x, t, y)``: ``x`` is
    NHWC, ``t`` a (B,) float tensor, ``y`` the condition.
    """

    def __init__(self, scheduler: Optional[BaseScheduler] = None,
                 guidance_fn: Callable = simple_guidance_fn,
                 num_steps: int = 250, guidance: float = 1.0, **kwargs):
        if kwargs:
            raise TypeError(
                f"unknown sampler kwargs: {sorted(kwargs)} "
                "(did you mean guidance_interval_min/guidance_interval_max, "
                "timeshift, step_fn, last_step, ...?)"
            )
        self.scheduler = scheduler
        self.guidance_fn = guidance_fn
        self.num_steps = num_steps
        self.guidance = guidance

    def _impl_sampling(self, net, noise, condition, uncondition, generator, collect):
        raise NotImplementedError

    def _guided(self, net, x, t: float, cfg: float, condition, cfg_condition):
        """The guided network output at ``x``, time ``t``: the CFG-doubled
        call, or where ``cfg == 1`` (to which every guidance fn reduces) the
        conditional half alone."""
        batch = x.shape[0]
        if cfg == 1.0:
            return net(x, torch.full((batch,), t, dtype=x.dtype, device=x.device), condition)
        cfg_t = torch.full((2 * batch,), t, dtype=x.dtype, device=x.device)
        return self.guidance_fn(net(torch.cat([x, x], dim=0), cfg_t, cfg_condition), cfg)

    def _cfg_array(self):
        """The (num_steps,) per-step cfg scales (for _segment_table)."""
        raise NotImplementedError

    def _segment_table(self):
        """Step segments [(start, end, kind)]: "skip" for the contiguous
        cfg == 1 stretches at either end (conditional-only, half the batch)
        and "cfg" for the middle. Interior cfg == 1 steps go through the CFG
        body, which handles them exactly."""
        cfg_active = np.asarray(self._cfg_array()) != 1.0
        if cfg_active.any():
            lo = int(np.argmax(cfg_active))
            hi = int(len(cfg_active) - np.argmax(cfg_active[::-1]))
        else:
            lo = hi = self.num_steps
        return [(0, lo, "skip"), (lo, hi, "cfg"), (hi, self.num_steps, "skip")]

    def _init_carry(self, noise):
        """The loop state before step 0."""
        return noise

    def _carry_x(self, carry):
        return carry

    def _run_steps(self, net, carry, start: int, end: int, condition, cfg_condition,
                   generator, collect: bool):
        """Steps ``start`` to ``end - 1`` from the loop state ``carry``:
        (carry, the x after each step, the velocity of each step), the
        lists empty unless ``collect``."""
        raise NotImplementedError(f"{type(self).__name__} has no segmented step loop")

    @torch.no_grad()
    def sample_chunked(self, net, noise, condition, uncondition,
                       generator: Optional[torch.Generator] = None, num_dispatches: int = 2):
        """The sampler's step loop run as ``num_dispatches`` segments of
        ``linspace(0, num_steps, num_dispatches + 1)`` steps, each from the
        last one's state: the final x equals ``__call__``'s bit for bit.
        Trajectories are not collected here."""
        if num_dispatches < 1:
            raise ValueError(f"num_dispatches={num_dispatches}: need >= 1 (use the plain "
                             "__call__ for a single dispatch)")
        cfg_condition = torch.cat([uncondition, condition], dim=0)
        bounds = np.linspace(0, self.num_steps, num_dispatches + 1).astype(int)
        carry = self._init_carry(noise)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            carry, _, _ = self._run_steps(net, carry, int(lo), int(hi), condition, cfg_condition,
                                          generator, collect=False)
        return self._carry_x(carry)

    @torch.no_grad()
    def __call__(self, net, noise, condition, uncondition,
                 generator: Optional[torch.Generator] = None,
                 return_x_trajs: bool = False, return_v_trajs: bool = False):
        x_trajs, v_trajs = self._impl_sampling(
            net, noise, condition, uncondition, generator,
            collect=return_x_trajs or return_v_trajs,
        )
        if return_x_trajs and return_v_trajs:
            return x_trajs[-1], x_trajs, v_trajs
        if return_x_trajs:
            return x_trajs[-1], x_trajs
        if return_v_trajs:
            return x_trajs[-1], v_trajs
        return x_trajs[-1]


class EulerSampler(BaseSampler):
    """Euler ODE/SDE sampler with a guidance interval."""

    def __init__(self, scheduler: BaseScheduler = None,
                 w_scheduler: Optional[BaseScheduler] = None,
                 timeshift: float = 1.0, guidance_interval_min: float = 0.0,
                 guidance_interval_max: float = 1.0, step_fn: str = "ode",
                 last_step: Optional[float] = None, last_step_fn: str = "ode",
                 **kwargs):
        super().__init__(scheduler=scheduler, **kwargs)
        if self.scheduler is None:
            raise ValueError("EulerSampler needs a scheduler")
        if step_fn not in STEP_COEFFS or last_step_fn not in STEP_COEFFS:
            raise ValueError(f"step_fn/last_step_fn must be in {sorted(STEP_COEFFS)}")
        if w_scheduler is None and step_fn != "ode":
            raise ValueError(f"step_fn={step_fn!r} needs a w_scheduler")
        self.w_scheduler = w_scheduler
        self.timeshift = timeshift
        self.guidance_interval_min = guidance_interval_min
        self.guidance_interval_max = guidance_interval_max
        self.step_type = step_fn
        self.last_step_type = last_step_fn
        if last_step is None or self.num_steps == 1:
            last_step = 1.0 / self.num_steps
        if not last_step > 0.0:
            raise ValueError(f"last_step={last_step}: must be > 0")
        self.last_step = last_step
        timesteps = np.linspace(0.0, 1 - self.last_step, self.num_steps)
        timesteps = np.concatenate([timesteps, [1.0]])
        self.timesteps = shift_respace_fn(timesteps, self.timeshift)
        self._precompute()

    def _precompute(self):
        n = self.num_steps
        ts = np.asarray(self.timesteps, dtype=np.float32)
        t_cur, t_next = ts[:-1], ts[1:]
        sigma = self.scheduler.sigma(t_cur)
        # 1 / (dalpha/alpha); for LinearScheduler at t=0 this is alpha/dalpha = 0
        inv_doa = self.scheduler.alpha(t_cur) / self.scheduler.dalpha(t_cur)
        dsm = self.scheduler.dsigma_mul_sigma(t_cur)
        w = self.w_scheduler.w(t_cur) if self.w_scheduler is not None else np.zeros_like(t_cur)
        # guidance only inside (min, max], tested on the float32 timesteps
        in_interval = (t_cur > self.guidance_interval_min) & (
            t_cur <= self.guidance_interval_max)
        cfg = np.where(in_interval, self.guidance, 1.0)
        a, b, c = np.zeros(n), np.zeros(n), np.zeros(n)
        a[:-1], b[:-1], c[:-1] = STEP_COEFFS[self.step_type]
        a[-1], b[-1], c[-1] = STEP_COEFFS[self.last_step_type]
        self._steps = dict(
            t=np.asarray(t_cur, np.float32),
            dt=np.asarray(t_next - t_cur, np.float32),
            sigma=np.asarray(sigma, np.float32),
            inv_doa=np.asarray(inv_doa, np.float32),
            dsm=np.asarray(dsm, np.float32),
            w=np.asarray(w, np.float32),
            cfg=cfg.astype(np.float32),
            a=a.astype(np.float32),
            b=b.astype(np.float32),
            c=c.astype(np.float32),
        )
        self._needs_noise = bool(np.any(self._steps["b"] != 0))

    def _cfg_array(self):
        return self._steps["cfg"]

    def _velocity(self, out, x, t):
        """Map raw network output to a velocity field (identity for v-pred)."""
        return out

    def _score(self, v, x, i, suffix=""):
        """s = (inv_doa v - x) / (sigma^2 - inv_doa dsm) from step ``i``'s
        coefficients (``suffix`` "_h": those at the step's end point)."""
        sigma, inv_doa, dsm = (self._steps[k + suffix][i] for k in ("sigma", "inv_doa", "dsm"))
        denom = np.float32(sigma) ** 2 - np.float32(inv_doa) * np.float32(dsm)
        return (float(inv_doa) * v - x) / (1.0 if denom == 0 else float(denom))

    def _draw(self, x, generator):
        """Step noise, or None where the step types draw none."""
        if not self._needs_noise:
            return None
        return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                           device=generator.device).to(x.device)

    def _update(self, x, v, s, i, eps):
        """x + v dt + a s w dt + b sqrt(c w dt) eps with step ``i``'s coefficients."""
        st = {k: float(arr[i]) for k, arr in self._steps.items()}
        x_next = x + v * st["dt"] + st["a"] * s * st["w"] * st["dt"]
        if eps is not None:
            x_next = x_next + st["b"] * float(
                np.sqrt(max(np.float32(st["c"]) * np.float32(st["w"]) * np.float32(st["dt"]), 0.0))
            ) * eps
        return x_next

    def _step_update(self, x, v, i, generator):
        v = v.to(x.dtype)
        return self._update(x, v, self._score(v, x, i), i, self._draw(x, generator))

    def _run_steps(self, net, x, start, end, condition, cfg_condition, generator, collect):
        if self._needs_noise and generator is None:
            raise ValueError(
                f"step types {self.step_type!r}/{self.last_step_type!r} draw "
                "noise: pass a torch.Generator")
        batch = x.shape[0]
        xs, vs = [], []
        for seg_start, seg_end, kind in self._segment_table():
            for i in range(max(seg_start, start), min(seg_end, end)):
                t = float(self._steps["t"][i])
                if kind == "cfg":
                    cfg_x = torch.cat([x, x], dim=0)
                    cfg_t = torch.full((2 * batch,), t, dtype=x.dtype, device=x.device)
                    out = self._velocity(net(cfg_x, cfg_t, cfg_condition), cfg_x, cfg_t)
                    v = self.guidance_fn(out, float(self._steps["cfg"][i]))
                else:
                    # cfg == 1: every guidance fn reduces to the conditional
                    # branch, so the unconditional half is skipped
                    t_vec = torch.full((batch,), t, dtype=x.dtype, device=x.device)
                    v = self._velocity(net(x, t_vec, condition), x, t_vec)
                x = self._step_update(x, v, i, generator)
                if collect:
                    xs.append(x)
                    vs.append(v.to(x.dtype))
        return x, xs, vs

    def _impl_sampling(self, net, noise, condition, uncondition, generator,
                       collect=False):
        cfg_condition = torch.cat([uncondition, condition], dim=0)
        x, xs, vs = self._run_steps(net, noise, 0, self.num_steps, condition, cfg_condition,
                                    generator, collect)
        xs = [noise] + xs
        if collect:
            vs.append(torch.zeros_like(noise))
            return torch.stack(xs), torch.stack(vs)
        return x[None], None


class EulerSamplerJiT(EulerSampler):
    """Euler sampler for x-prediction networks: the velocity is
    ``(out - x_t) / max(1 - t, 5e-2)``, taken before guidance."""

    def _velocity(self, out, x, t):
        t = t.reshape((-1,) + (1,) * (out.dim() - 1))
        return (out - x) / torch.clamp(1.0 - t, min=5e-2)


class HeunSampler(EulerSampler):
    """Heun predictor-corrector sampler: each step predicts with the current
    velocity (the previous step's corrector evaluation unless ``exact_heun``),
    then corrects with the average of it and the velocity at the predicted
    point; the last step is plain Euler. Both updates of a step use the same
    noise draw. The network runs CFG-doubled only where the step's guidance
    scale is not 1."""

    def __init__(self, scheduler: BaseScheduler = None, exact_heun: bool = False, **kwargs):
        super().__init__(scheduler=scheduler, **kwargs)
        self.exact_heun = exact_heun

    def _precompute(self):
        super()._precompute()
        t_next = np.asarray(self.timesteps, dtype=np.float32)[1:]
        self._steps.update(
            t_hat=t_next,
            sigma_h=np.asarray(self.scheduler.sigma(t_next), np.float32),
            inv_doa_h=np.asarray(self.scheduler.alpha(t_next) / self.scheduler.dalpha(t_next),
                                 np.float32),
            dsm_h=np.asarray(self.scheduler.dsigma_mul_sigma(t_next), np.float32))

    def _run_steps(self, *args, **kwargs):
        raise NotImplementedError("HeunSampler has no segmented step loop (sample_chunked), "
                                  "as in the JAX package")

    def _impl_sampling(self, net, noise, condition, uncondition, generator, collect=False):
        if self._needs_noise and generator is None:
            raise ValueError(f"step types {self.step_type!r}/{self.last_step_type!r} draw "
                             "noise: pass a torch.Generator")
        cfg_condition = torch.cat([uncondition, condition], dim=0)
        x = noise
        v_hat = s_hat = None
        xs, vs = [noise], []
        for i in range(self.num_steps):
            cfg = float(self._steps["cfg"][i])
            if i == 0 or self.exact_heun:
                v = self._guided(net, x, float(self._steps["t"][i]), cfg, condition,
                                 cfg_condition).to(x.dtype)
                s = self._score(v, x, i)
            else:
                v, s = v_hat, s_hat
            eps = self._draw(x, generator)
            x_hat = self._update(x, v, s, i, eps)
            if i < self.num_steps - 1:  # the corrector; the last step is Euler
                v_hat = self._guided(net, x_hat, float(self._steps["t_hat"][i]), cfg, condition,
                                     cfg_condition).to(x.dtype)
                s_hat = self._score(v_hat, x_hat, i, "_h")
                v = (v + v_hat) / 2
                x_hat = self._update(x, v, (s + s_hat) / 2, i, eps)
            x = x_hat
            if collect:
                xs.append(x)
                vs.append(v)
        if collect:
            vs.append(torch.zeros_like(noise))
            return torch.stack(xs), torch.stack(vs)
        return x[None], None
