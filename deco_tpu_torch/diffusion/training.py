"""Diffusion training objectives (``deco_tpu/diffusion/training.py``).

:class:`BaseTrainer` (CFG label dropout), :class:`FlowMatchingTrainer`,
:class:`DeCoTrainer` (90/10 lognorm/uniform t mix, timeshift, velocity MSE
and the optional 8x8 block-DCT frequency loss), :class:`REPATrainer` and
:class:`JiTTrainer` (velocity or x-prediction with the REPA cosine
alignment), :class:`VPTrainer` and :class:`DDPMTrainer` (eps prediction) as
loss functions of ``(net, x, condition, uncondition, metadata)``.

The REPA trainers own a trainable projection, ``proj_module``
(:class:`REPAProjection`, fp32), which the train state trains in the same
AdamW as the model and carries in the EMA (the JAX combined
``{"model", "trainer"}`` layout). Its target is ``metadata["repa_features"]``
when given, else the frozen ``encoder`` of ``metadata["raw_image"]``;
``metadata_keys`` names what a trainer reads from the loader's metadata.

Randomness comes from an explicit ``torch.Generator``; the JAX package
splits one ``jax.random`` key instead, and the two give different numbers.
So every draw can also be passed in through ``draws``, a dict keyed by
:data:`DRAWS`, which is how the tests feed both sides the same numbers:

- ``drop_u`` (B,) uniform: the label is dropped where ``drop_u < p``;
- ``t_normal`` (B,) normal: t = sigmoid(t_normal) (lognorm t);
- ``t_uniform`` (B,) uniform: t for the uniform share;
- ``mix_u`` (B,) uniform: DeCoTrainer takes the lognorm t where
  ``mix_u <= lognorm_mix_p``;
- ``t_int`` (B,) integers in [0, train_max_t): the DDPM timestep;
- ``noise``, x's shape, normal: the interpolation noise.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from deco_tpu_torch.diffusion.scheduling import BaseScheduler, bcast_right
from deco_tpu_torch.ops import block_dct

DRAWS = ("drop_u", "t_normal", "t_uniform", "mix_u", "t_int", "noise")


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

    # the loader metadata this objective reads (the loop forwards these keys)
    metadata_keys: tuple = ()
    # the trainable parameters this objective owns (an nn.Module), if any
    proj_module: Optional[nn.Module] = None

    def __init__(self, null_condition_p: float = 0.1):
        self.null_condition_p = null_condition_p

    def preprocess(self, x, condition, uncondition, generator=None, draws=None):
        if self.null_condition_p > 0:
            u = draw(draws, "drop_u", (x.shape[0],), False, generator, x.device)
            mask = (u < self.null_condition_p).reshape((-1,) + (1,) * (condition.dim() - 1))
            condition = torch.where(mask, uncondition, condition)
        return x, condition

    def _impl_trainstep(self, net, x, y, generator, draws, metadata=None):
        raise NotImplementedError

    def __call__(self, net, x, condition, uncondition, generator=None, draws=None,
                 metadata=None):
        x, condition = self.preprocess(x, condition, uncondition, generator, draws)
        return self._impl_trainstep(net, x, condition, generator, draws, metadata)


def _draw_t(lognorm_t: bool, x, generator, draws):
    """t of shape (B,): sigmoid(normal) with ``lognorm_t``, else uniform."""
    b = (x.shape[0],)
    if lognorm_t:
        return torch.sigmoid(draw(draws, "t_normal", b, True, generator, x.device))
    return draw(draws, "t_uniform", b, False, generator, x.device)


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

    def _impl_trainstep(self, net, x, y, generator, draws, metadata=None):
        t = time_shift_fn(_draw_t(self.lognorm_t, x, generator, draws), self.timeshift)
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
    not use them (its REPA branch is off upstream). So a config's ``encoder``
    node reaches it unbuilt (``deferred_args``, a
    :class:`~deco_tpu_torch.config.registry.Deferred` handle): no tower, no
    weight file read."""

    deferred_args = ("encoder",)

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

    def _impl_trainstep(self, net, x, y, generator, draws, metadata=None):
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


class REPAProjection(nn.Module):
    """The REPA projection: Linear, SiLU, Linear, SiLU, Linear, in fp32.

    Its parameters are named as in the reference trainer, whose
    ``nn.Sequential`` sits inside another (``proj.0.0``, ``proj.0.2``,
    ``proj.0.4``); the JAX package names them ``fc0``, ``fc1``, ``fc2``.
    Initialised as flax's ``nn.Dense`` (lecun-normal kernels, zero biases)
    from ``seed`` on the CPU (:meth:`reset_parameters`; the run loop
    redraws them from the run's seed).
    """

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, seed: int = 0):
        super().__init__()
        self.proj = nn.Sequential(nn.Sequential(
            nn.Linear(in_dim, hidden_dim), nn.SiLU(), nn.Linear(hidden_dim, hidden_dim),
            nn.SiLU(), nn.Linear(hidden_dim, out_dim)))
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for layer in self.proj[0][::2]:
            std = layer.in_features ** -0.5 / 0.87962566103423978
            w = torch.empty(layer.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
            layer.weight.copy_(w)
            layer.bias.zero_()

    def forward(self, x):
        return self.proj(x.float())


def _cos_align_loss(proj, feat, metadata, encoder):
    """REPA cosine-alignment term (``_cos_align_loss``): 1 - cos(proj(feat),
    target) averaged over tokens, the target ``metadata["repa_features"]``
    or ``encoder(metadata["raw_image"])`` without gradient; src is cut to the
    target's token count; 0 without a target. The norms keep +1e-24 inside
    the square root and 1e-8 in the denominator, so an all-zero tap has a
    finite gradient."""
    src = proj(feat)
    dst = None
    if metadata is not None and metadata.get("repa_features") is not None:
        dst = metadata["repa_features"].detach()
    elif encoder is not None and metadata is not None and metadata.get("raw_image") is not None:
        with torch.no_grad():
            dst = encoder(metadata["raw_image"])
    if dst is None:
        return torch.zeros((), dtype=torch.float32, device=feat.device)
    n = dst.shape[1]
    if src.shape[1] != n:
        src = src[:, :n]
    sf, df = src.float(), dst.float()
    sn = torch.sqrt((sf * sf).sum(-1) + 1e-24)
    dn = torch.sqrt((df * df).sum(-1) + 1e-24)
    return (1 - (sf * df).sum(-1) / (sn * dn + 1e-8)).mean()


class REPATrainer(DeCoTrainer):
    """Velocity matching plus REPA alignment (``REPATrainer``): t drawn pure
    lognorm or uniform (not DeCo's 90/10 mix), the network's tap at
    ``align_layer`` (the loop sets the model's) through ``proj_module``
    against the encoder's features, loss = fm + feat_loss_weight * cos."""

    metadata_keys = ("repa_features", "raw_image")
    deferred_args = ()  # the encoder runs every step: built with the trainer

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.proj_module = REPAProjection(self.proj_denoiser_dim, self.proj_hidden_dim,
                                          self.proj_encoder_dim)

    def _impl_trainstep(self, net, x, y, generator, draws, metadata=None):
        t = time_shift_fn(_draw_t(self.lognorm_t, x, generator, draws), self.timeshift)
        noise = draw(draws, "noise", x.shape, True, generator, x.device)
        x_t, v_t, alpha, sigma = _interpolate(self.scheduler, x, t, noise)
        out, feat = net(x_t, t, y, return_features=True)
        cos_loss = _cos_align_loss(self.proj_module, feat, metadata, self.encoder)
        weight = self.loss_weight_fn(alpha, sigma)
        diff = out.float() - v_t.float()
        fm_loss = (weight * diff**2).mean()
        losses = dict(fm_loss=fm_loss, cos_loss=cos_loss,
                      loss=fm_loss + self.feat_loss_weight * cos_loss)
        if self.enable_freq_loss:
            freq_loss = block_dct.frequency_weighted_mse(diff, self.freq_w)
            losses["fm_loss_freq"] = freq_loss
            losses["loss"] = losses["loss"] + self.freq_loss_weight * freq_loss
        return losses


class JiTTrainer(BaseTrainer):
    """x-prediction flow matching plus REPA (``JiTTrainer``): the network
    predicts x; prediction and target become velocities by dividing by
    max(1 - t, t_eps), so the x-space loss is weighted by 1/(1-t)^2 up to
    that clamp."""

    metadata_keys = ("repa_features", "raw_image")

    def __init__(self, scheduler: BaseScheduler, loss_weight_fn: Union[str, Callable] = "constant",
                 lognorm_t: bool = False, timeshift: float = 1.0, encoder=None,
                 align_layer: int = 8, proj_denoiser_dim: int = 256, proj_hidden_dim: int = 256,
                 proj_encoder_dim: int = 256, feat_loss_weight: float = 0.5,
                 t_eps: float = 5e-2, **kwargs):
        super().__init__(**kwargs)
        self.scheduler = scheduler
        self.loss_weight_fn = _resolve_weight_fn(loss_weight_fn)
        self.lognorm_t = lognorm_t
        self.timeshift = timeshift
        self.encoder = encoder
        self.align_layer = align_layer
        self.feat_loss_weight = feat_loss_weight
        self.t_eps = t_eps
        self.proj_module = REPAProjection(proj_denoiser_dim, proj_hidden_dim, proj_encoder_dim)

    def _impl_trainstep(self, net, x, y, generator, draws, metadata=None):
        t = time_shift_fn(_draw_t(self.lognorm_t, x, generator, draws), self.timeshift)
        noise = draw(draws, "noise", x.shape, True, generator, x.device)
        x_t, _, alpha, sigma = _interpolate(self.scheduler, x, t, noise)
        denom = torch.clamp(1.0 - bcast_right(t, x.dim()), min=self.t_eps)
        v_t = (x.float() - x_t.float()) / denom
        out, feat = net(x_t, t, y, return_features=True)
        cos_loss = _cos_align_loss(self.proj_module, feat, metadata, self.encoder)
        out_v = (out.float() - x_t.float()) / denom
        fm_loss = (self.loss_weight_fn(alpha, sigma) * (out_v - v_t) ** 2).mean()
        return dict(fm_loss=fm_loss, cos_loss=cos_loss,
                    loss=fm_loss + self.feat_loss_weight * cos_loss)


class VPTrainer(BaseTrainer):
    """eps-prediction VP objective (``VPTrainer``): t lognorm or uniform,
    the network sees t * train_max_t."""

    def __init__(self, scheduler: BaseScheduler, loss_weight_fn: Union[str, Callable] = "constant",
                 train_max_t: int = 1000, lognorm_t: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.scheduler = scheduler
        self.loss_weight_fn = _resolve_weight_fn(loss_weight_fn)
        self.train_max_t = train_max_t
        self.lognorm_t = lognorm_t

    def _impl_trainstep(self, net, x, y, generator, draws, metadata=None):
        t = _draw_t(self.lognorm_t, x, generator, draws)
        return self._eps_loss(net, x, y, t, t * self.train_max_t, generator, draws)

    def _eps_loss(self, net, x, y, t, t_net, generator, draws):
        noise = draw(draws, "noise", x.shape, True, generator, x.device)
        alpha = bcast_right(self.scheduler.alpha(t), x.dim())
        sigma = bcast_right(self.scheduler.sigma(t), x.dim())
        out = net(alpha * x + noise * sigma, t_net, y)
        weight = self.loss_weight_fn(alpha, sigma)
        return dict(loss=(weight * (out.float() - noise.float()) ** 2).mean())


class DDPMTrainer(VPTrainer):
    """Discrete-t eps-prediction objective (``DDPMTrainer``): t an integer
    in [0, train_max_t), given to the network as a float."""

    def __init__(self, scheduler: BaseScheduler, loss_weight_fn: Union[str, Callable] = "constant",
                 train_max_t: int = 1000, **kwargs):
        super().__init__(scheduler, loss_weight_fn, train_max_t, **kwargs)

    def _impl_trainstep(self, net, x, y, generator, draws, metadata=None):
        b = (x.shape[0],)
        if draws is not None and "t_int" in draws:
            t = torch.as_tensor(draws["t_int"], dtype=torch.long, device=x.device)
            if tuple(t.shape) != b:
                raise ValueError(f"draw 't_int' has shape {tuple(t.shape)}, expected {b}")
        elif generator is None:
            raise ValueError("draw 't_int': pass a torch.Generator or the draw itself")
        else:
            t = torch.randint(0, self.train_max_t, b, generator=generator, device=x.device)
        return self._eps_loss(net, x, y, t, t.to(x.dtype), generator, draws)
