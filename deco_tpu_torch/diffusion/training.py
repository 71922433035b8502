"""Diffusion training objectives (``deco_tpu/diffusion/training.py``).

:class:`BaseTrainer` (CFG label dropout), :class:`FlowMatchingTrainer` and
:class:`DeCoTrainer` (90/10 lognorm/uniform t mix, timeshift, velocity MSE
and the optional 8x8 block-DCT frequency loss) as loss functions of
``(net, x, condition, uncondition)``.

Randomness comes from an explicit ``torch.Generator``; the JAX package
splits one ``jax.random`` key instead, and the two give different numbers.
So every draw can also be passed in through ``draws``, a dict keyed by
:data:`DRAWS`, which is how the tests feed both sides the same numbers:

- ``drop_u`` (B,) uniform: the label is dropped where ``drop_u < p``;
- ``t_normal`` (B,) normal: t = sigmoid(t_normal) (lognorm t);
- ``t_uniform`` (B,) uniform: t for the uniform share;
- ``mix_u`` (B,) uniform: DeCoTrainer takes the lognorm t where
  ``mix_u <= lognorm_mix_p``;
- ``noise``, x's shape, normal: the interpolation noise.

The REPA, JiT, VP and DDPM objectives are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from deco_tpu_torch.diffusion.scheduling import BaseScheduler, bcast_right
from deco_tpu_torch.ops import block_dct

DRAWS = ("drop_u", "t_normal", "t_uniform", "mix_u", "noise")


# loss weight functions of (alpha, sigma)
def inverse_sigma(alpha, sigma):
    return 1 / sigma**2


def snr(alpha, sigma):
    return alpha / sigma


def minsnr(alpha, sigma, threshold=5):
    return torch.clamp(alpha / sigma, min=threshold)


def maxsnr(alpha, sigma, threshold=5):
    return torch.clamp(alpha / sigma, max=threshold)


def constant(alpha, sigma):
    return 1.0


LOSS_WEIGHT_FNS = {
    "inverse_sigma": inverse_sigma,
    "snr": snr,
    "minsnr": minsnr,
    "maxsnr": maxsnr,
    "constant": constant,
}


def time_shift_fn(t, timeshift=1.0):
    return t / (t + (1 - t) * timeshift)


def _resolve_weight_fn(fn: Union[str, Callable]) -> Callable:
    return LOSS_WEIGHT_FNS[fn] if isinstance(fn, str) else fn


def draw(draws, key: str, shape, normal: bool, generator, device) -> torch.Tensor:
    """``draws[key]`` (checked against ``shape``) when given, else a fresh
    fp32 normal or uniform draw from ``generator`` on ``device``."""
    if draws is not None and key in draws:
        x = torch.as_tensor(draws[key], dtype=torch.float32, device=device)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"draw {key!r} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        return x
    if generator is None:
        raise ValueError(f"draw {key!r}: pass a torch.Generator or the draw itself")
    sample = torch.randn if normal else torch.rand
    return sample(tuple(shape), generator=generator, device=device)


class BaseTrainer:
    """CFG label dropout, then the objective's ``_impl_trainstep``."""

    def __init__(self, null_condition_p: float = 0.1):
        self.null_condition_p = null_condition_p

    def preprocess(self, x, condition, uncondition, generator=None, draws=None):
        if self.null_condition_p > 0:
            u = draw(draws, "drop_u", (x.shape[0],), False, generator, x.device)
            mask = (u < self.null_condition_p).reshape((-1,) + (1,) * (condition.dim() - 1))
            condition = torch.where(mask, uncondition, condition)
        return x, condition

    def _impl_trainstep(self, net, x, y, generator, draws):
        raise NotImplementedError

    def __call__(self, net, x, condition, uncondition, generator=None, draws=None):
        x, condition = self.preprocess(x, condition, uncondition, generator, draws)
        return self._impl_trainstep(net, x, condition, generator, draws)


def _interpolate(scheduler, x, t, noise):
    alpha, dalpha, sigma, dsigma = (bcast_right(c, x.dim()) for c in scheduler.isotropic_coeffs(t))
    return alpha * x + noise * sigma, dalpha * x + dsigma * noise, alpha, sigma


class FlowMatchingTrainer(BaseTrainer):
    """Plain velocity-matching objective."""

    def __init__(self, scheduler: BaseScheduler, loss_weight_fn: Union[str, Callable] = "constant",
                 lognorm_t: bool = False, timeshift: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.scheduler = scheduler
        self.loss_weight_fn = _resolve_weight_fn(loss_weight_fn)
        self.lognorm_t = lognorm_t
        self.timeshift = timeshift

    def _impl_trainstep(self, net, x, y, generator, draws):
        b = (x.shape[0],)
        if self.lognorm_t:
            t = torch.sigmoid(draw(draws, "t_normal", b, True, generator, x.device))
        else:
            t = draw(draws, "t_uniform", b, False, generator, x.device)
        t = time_shift_fn(t, self.timeshift)
        noise = draw(draws, "noise", x.shape, True, generator, x.device)
        x_t, v_t, alpha, sigma = _interpolate(self.scheduler, x, t, noise)
        out = net(x_t, t, y)
        weight = self.loss_weight_fn(alpha, sigma)
        return dict(loss=(weight * (out.float() - v_t.float()) ** 2).mean())


class DeCoTrainer(BaseTrainer):
    """The DeCo objective: t from 90% sigmoid(randn) and 10% uniform (the
    mix ignores ``lognorm_t``, as in the JAX package), velocity MSE, and with
    ``enable_freq_loss`` the frequency-weighted MSE of the velocity error.

    The REPA arguments (``feat_loss_weight``, ``encoder``, ``align_layer``,
    ``proj_*_dim``) are taken and stored as the JAX constructor does, so the
    reference configs that pass them build this trainer; the DeCo loss does
    not use them (its REPA branch is off upstream)."""

    def __init__(self, scheduler: BaseScheduler, loss_weight_fn: Union[str, Callable] = "constant",
                 lognorm_t: bool = False, timeshift: float = 1.0, lognorm_mix_p: float = 0.9,
                 feat_loss_weight: float = 0.5, encoder=None, align_layer: int = 8,
                 proj_denoiser_dim: int = 256, proj_hidden_dim: int = 256,
                 proj_encoder_dim: int = 256,
                 freq_loss_weight: float = 1.0, freq_quality: int = 85,
                 freq_mode: str = "inv_gamma", freq_gamma: float = 1.0,
                 enable_freq_loss: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.scheduler = scheduler
        self.loss_weight_fn = _resolve_weight_fn(loss_weight_fn)
        self.lognorm_t = lognorm_t
        self.timeshift = timeshift
        self.lognorm_mix_p = lognorm_mix_p
        self.feat_loss_weight = feat_loss_weight
        self.encoder = encoder
        self.align_layer = align_layer
        self.proj_denoiser_dim = proj_denoiser_dim
        self.proj_hidden_dim = proj_hidden_dim
        self.proj_encoder_dim = proj_encoder_dim
        self.freq_loss_weight = freq_loss_weight
        self.enable_freq_loss = enable_freq_loss
        self.freq_w = block_dct.build_freq_weight(quality=freq_quality, mode=freq_mode,
                                                  gamma=freq_gamma)

    def _impl_trainstep(self, net, x, y, generator, draws):
        b, dev = (x.shape[0],), x.device
        t_lognorm = torch.sigmoid(draw(draws, "t_normal", b, True, generator, dev))
        t_uniform = draw(draws, "t_uniform", b, False, generator, dev)
        mix = draw(draws, "mix_u", b, False, generator, dev)
        t = time_shift_fn(torch.where(mix <= self.lognorm_mix_p, t_lognorm, t_uniform),
                          self.timeshift)
        noise = draw(draws, "noise", x.shape, True, generator, dev)
        x_t, v_t, alpha, sigma = _interpolate(self.scheduler, x, t, noise)

        out = net(x_t, t, y)
        weight = self.loss_weight_fn(alpha, sigma)
        diff = out.float() - v_t.float()
        fm_loss = (weight * diff**2).mean()
        losses = dict(fm_loss=fm_loss, loss=fm_loss)
        if self.enable_freq_loss:
            freq_loss = block_dct.frequency_weighted_mse(diff, self.freq_w)
            losses["fm_loss_freq"] = freq_loss
            losses["loss"] = fm_loss + self.freq_loss_weight * freq_loss
        return losses
