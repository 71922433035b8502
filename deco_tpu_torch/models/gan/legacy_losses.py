"""The legacy TiTok reconstruction losses (``deco_tpu/models/gan/legacy_losses.py``;
the reference's ``ReconstructionLoss_Base``, ``_Stage1`` and ``_Stage2``,
``src/models/modules/losses.py:67-468``).

No shipped config names these classes (they predate
:class:`~deco_tpu_torch.models.gan.vae_loss.VAEGANLoss`); the registry maps
their three class paths to :class:`TiTokLoss`, as the JAX package does.
Against the VAE-GAN loss:

- ``quantize_mode="vq"`` adds the tokenizer's quantizer loss (codebook and
  commitment) from ``extra_result_dict``;
- ``quantize_mode="vae"`` divides the reconstruction loss by a fixed
  ``exp(logvar)`` (the reference creates the parameter with
  ``requires_grad=False``) and adds ``kl_weight`` x the posterior's KL;
- stages 1 and 2 take ImageNet-normalised inputs and reconstructions in
  [-1, 1], and align both to [0, 1] before any loss; stage 0 takes both in
  [0, 1];
- the discriminator weight is the static ``discriminator_weight`` (no
  adaptive balancing), gated to 0 before ``discriminator_start``.

The discriminator is a callable of images (``disc_apply(x)``); the LeCam
EMA of its mean logits is an explicit
:class:`~deco_tpu_torch.models.gan.vae_loss.LeCamState` that
:meth:`TiTokLoss.discriminator_loss` returns updated. All sums in fp32.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import torch

from deco_tpu_torch.models.gan.vae_loss import LeCamState, compute_lecam_loss, hinge_d_loss

# the ImageNet statistics of the stage-1/2 de-normalisation, NHWC
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _align01(inputs, reconstructions, stage: int):
    """Stage >= 1: ImageNet-normalised inputs and [-1, 1] reconstructions,
    both to [0, 1]; stage 0: both already in [0, 1]."""
    if stage >= 1:
        mean = torch.tensor(_IMAGENET_MEAN, device=inputs.device)
        std = torch.tensor(_IMAGENET_STD, device=inputs.device)
        inputs = inputs * std + mean
        reconstructions = (reconstructions + 1.0) / 2.0
    return inputs, reconstructions


class TiTokLoss:
    """The settings and loss functions of the legacy TiTok GAN stages.

    ``stage``: 0 = Base (VQ only, [0, 1] inputs), 1 = Stage1 (adds the vae
    mode and the de-normalisation), 2 = Stage2 (adds distillation).
    ``quantize_mode``: "vq" or "vae"."""

    def __init__(self, stage: int = 1, quantize_mode: str = "vq",
                 reconstruction_loss: str = "l2", reconstruction_weight: float = 1.0,
                 quantizer_weight: float = 1.0, perceptual_weight: float = 1.0,
                 discriminator_start: int = 0, discriminator_factor: float = 1.0,
                 discriminator_weight: float = 0.1, lecam_regularization_weight: float = 0.0,
                 lecam_ema_decay: float = 0.999, kl_weight: float = 1e-6, logvar_init: float = 0.0,
                 distill_weight: float = 0.0):
        if stage == 0 and quantize_mode != "vq":
            raise ValueError("Base stage supports only quantize_mode='vq'")
        self.stage = stage
        self.quantize_mode = quantize_mode
        self.reconstruction_loss = reconstruction_loss
        self.reconstruction_weight = reconstruction_weight
        self.quantizer_weight = quantizer_weight
        self.perceptual_weight = perceptual_weight
        self.discriminator_start = discriminator_start
        self.discriminator_factor = discriminator_factor
        self.discriminator_weight = discriminator_weight
        self.lecam_regularization_weight = lecam_regularization_weight
        self.lecam_ema_decay = lecam_ema_decay
        self.kl_weight = kl_weight
        self.logvar = logvar_init  # fixed: requires_grad=False in the reference
        self.distill_weight = distill_weight

    def _d_factor(self, global_step: int) -> float:
        """The discriminator's gate: ``global_step >= discriminator_start``."""
        return self.discriminator_factor if global_step >= self.discriminator_start else 0.0

    def _rec(self, inputs, reconstructions):
        diff = inputs.float() - reconstructions.float()
        if self.reconstruction_loss == "l1":
            return diff.abs().mean()
        if self.reconstruction_loss == "l2":
            return diff.square().mean()
        raise ValueError(self.reconstruction_loss)

    def generator_loss(self, disc_apply: Callable, inputs, reconstructions,
                       extra_result_dict: Mapping[str, torch.Tensor], global_step: int,
                       perceptual_fn: Optional[Callable] = None,
                       distill_fn: Optional[Callable] = None) -> Tuple[torch.Tensor, dict]:
        """(total, metrics) of the generator. ``extra_result_dict`` holds the
        tokenizer's terms: ``quantizer_loss`` in vq mode (and
        ``commitment_loss`` / ``codebook_loss`` to log), ``kl`` (a batch
        mean) in vae mode, ``distill_feat`` at stage 2."""
        inputs, reconstructions = _align01(inputs, reconstructions, self.stage)
        zero = torch.zeros((), device=inputs.device)
        rec = self._rec(inputs, reconstructions) * self.reconstruction_weight
        perc = zero
        if perceptual_fn is not None:
            perc = perceptual_fn(inputs, reconstructions).float().mean()
        d_factor = self._d_factor(global_step)
        d_weight = self.discriminator_weight
        gan = -disc_apply(reconstructions).float().mean()
        distill = zero
        if self.stage >= 2 and distill_fn is not None:
            distill = distill_fn(inputs, extra_result_dict["distill_feat"])
        metrics = dict(reconstruction_loss=rec, perceptual_loss=self.perceptual_weight * perc,
                       gan_loss=gan, weighted_gan_loss=d_weight * d_factor * gan,
                       discriminator_factor=torch.tensor(d_factor, device=inputs.device),
                       d_weight=torch.tensor(d_weight, device=inputs.device))
        if self.quantize_mode == "vq":
            q = extra_result_dict["quantizer_loss"]
            total = (rec + self.perceptual_weight * perc + self.quantizer_weight * q
                     + d_weight * d_factor * gan)
            metrics.update(quantizer_loss=self.quantizer_weight * q,
                           commitment_loss=extra_result_dict.get("commitment_loss", zero),
                           codebook_loss=extra_result_dict.get("codebook_loss", zero))
        else:  # vae: the fixed-logvar NLL and the posterior's KL
            rec = rec / torch.exp(torch.tensor(self.logvar, dtype=torch.float32))
            kl = extra_result_dict.get("kl", zero) if self.kl_weight > 0.0 else zero
            total = (rec + self.perceptual_weight * perc + self.kl_weight * kl
                     + d_weight * d_factor * gan)
            metrics.update(reconstruction_loss=rec, kl_loss=self.kl_weight * kl)
        if self.stage >= 2:
            total = total + self.distill_weight * distill
            metrics.update(distill_loss=self.distill_weight * distill)
        metrics.update(total_loss=total)
        return total, metrics

    def discriminator_loss(self, disc_apply: Callable, inputs, reconstructions, global_step: int,
                           lecam: LeCamState) -> Tuple[torch.Tensor, LeCamState, dict]:
        """(loss, the advanced LeCam state, metrics) of the discriminator;
        the reconstructions carry no gradient."""
        inputs, reconstructions = _align01(inputs, reconstructions.detach(), self.stage)
        logits_real = disc_apply(inputs).float()
        logits_fake = disc_apply(reconstructions).float()
        d_loss = self._d_factor(global_step) * hinge_d_loss(logits_real, logits_fake)
        real_mean, fake_mean = logits_real.mean(), logits_fake.mean()
        lecam_loss = torch.zeros((), device=d_loss.device)
        if self.lecam_regularization_weight > 0.0:
            lecam_loss = compute_lecam_loss(real_mean, fake_mean, lecam.ema_real, lecam.ema_fake
                                            ) * self.lecam_regularization_weight
            lecam = lecam.updated(real_mean, fake_mean, self.lecam_ema_decay)
        d_loss = d_loss + lecam_loss
        return d_loss, lecam, dict(discriminator_loss=d_loss, logits_real=real_mean,
                                   logits_fake=fake_mean, lecam_loss=lecam_loss)
