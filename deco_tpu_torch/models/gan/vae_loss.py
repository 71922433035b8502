"""The VAE-GAN's losses (``deco_tpu/models/gan/vae_loss.py``): reconstruction,
perceptual, the hinge GAN with the adaptive weight, LeCam regularisation,
feature distillation and the posterior's KL.

- generator: L1 or L2 reconstruction in [0, 1] + weighted perceptual
  (:meth:`VAEGANLoss.nll`), the hinge generator term with the adaptive
  weight ``|grad(nll, w_last)| / (|grad(g, w_last)| + 1e-4)``
  (:func:`adaptive_d_weight`), and optional distillation (MSE, or cosine +
  MSE);
- discriminator: hinge(real, fake) + LeCam, whose EMA logit means are an
  explicit :class:`LeCamState` that the step updates.

All sums in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def compute_lecam_loss(real_mean, fake_mean, ema_real_mean, ema_fake_mean):
    return F.relu(real_mean - ema_fake_mean).pow(2).mean() + F.relu(
        ema_real_mean - fake_mean).pow(2).mean()


@dataclasses.dataclass
class LeCamState:
    """The EMA of the discriminator's mean logits on real and fake images."""

    ema_real: torch.Tensor
    ema_fake: torch.Tensor

    @classmethod
    def create(cls, device="cpu"):
        return cls(ema_real=torch.zeros((), device=device), ema_fake=torch.zeros((), device=device))

    def updated(self, real_mean, fake_mean, decay: float) -> "LeCamState":
        return LeCamState(ema_real=self.ema_real * decay + real_mean.detach() * (1 - decay),
                          ema_fake=self.ema_fake * decay + fake_mean.detach() * (1 - decay))


def gradient_norm(grads, eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sum of squares + ``eps``) over a list of tensors (the JAX step's ``gn``)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads) + eps)


def distillation_terms(student, teacher, loss_type: str):
    """(MSE, cosine loss) of the student features against the fixed teacher's."""
    sf, tf = student.float(), teacher.float().detach()
    mse = ((sf - tf) ** 2).mean()
    cos = torch.zeros((), device=sf.device)
    if loss_type == "cosine":
        sn = sf / (torch.linalg.vector_norm(sf, dim=-1, keepdim=True) + 1e-8)
        tn = tf / (torch.linalg.vector_norm(tf, dim=-1, keepdim=True) + 1e-8)
        cos = 1.0 - (sn * tn).sum(-1).mean()
    return mse, cos


class VAEGANLoss:
    """The loss settings (reference ``VAEReconstructionLoss``) and its pieces."""

    def __init__(self, reconstruction_loss: str = "l2", reconstruction_weight: float = 1.0,
                 perceptual_weight: float = 1.1, discriminator_weight: float = 0.1,
                 discriminator_factor: float = 1.0, discriminator_iter_start: int = 0,
                 lecam_regularization_weight: float = 0.001, lecam_ema_decay: float = 0.999,
                 distillation_weight: float = 0.0, distillation_loss_type: str = "mse",
                 adaptive_weight: bool = True, kl_weight: float = 0.0, logvar_init: float = 0.0):
        # logvar_init is read for the configs' sake: the NLL is plain L1/L2,
        # as the reference's with the shipped logvar 0
        self.reconstruction_loss = reconstruction_loss
        self.reconstruction_weight = float(reconstruction_weight)
        self.perceptual_weight = float(perceptual_weight)
        self.discriminator_weight = float(discriminator_weight)
        self.discriminator_factor = float(discriminator_factor)
        self.discriminator_iter_start = int(discriminator_iter_start)
        self.lecam_regularization_weight = float(lecam_regularization_weight)
        self.lecam_ema_decay = float(lecam_ema_decay)
        self.distillation_weight = float(distillation_weight)
        self.distillation_loss_type = distillation_loss_type
        self.adaptive_weight = adaptive_weight
        self.kl_weight = float(kl_weight)
        self.logvar_init = float(logvar_init)

    def disc_factor(self, step: int) -> float:
        return self.discriminator_factor if step >= self.discriminator_iter_start else 0.0

    def nll(self, inputs01, recon01, perceptual_fn: Optional[Callable] = None):
        """(reconstruction, perceptual, nll = reconstruction + weight x perceptual)."""
        diff = inputs01 - recon01
        rec = (diff.abs() if self.reconstruction_loss == "l1" else diff ** 2).mean()
        rec = rec * self.reconstruction_weight
        perc = (perceptual_fn(inputs01, recon01).mean() if perceptual_fn is not None
                else torch.zeros((), device=rec.device))
        return rec, perc, rec + self.perceptual_weight * perc

    def generator_loss(self, inputs, reconstructions, disc_apply: Optional[Callable], step: int,
                       perceptual_fn: Optional[Callable] = None, student_features=None,
                       teacher_features=None, d_weight=None):
        """(total, metrics) for images in [-1, 1]; ``d_weight`` from
        :func:`adaptive_d_weight`, or None for the configured constant."""
        inputs01 = inputs.float() * 0.5 + 0.5
        recon01 = reconstructions.float() * 0.5 + 0.5
        rec, perc, nll = self.nll(inputs01, recon01, perceptual_fn)
        zero = torch.zeros((), device=rec.device)
        g_loss = zero
        if disc_apply is not None and self.discriminator_weight > 0:
            g_loss = -disc_apply(recon01).mean()
        if d_weight is None:
            d_weight = torch.tensor(self.discriminator_weight, device=rec.device)
        distill = cos = mse = zero
        if (self.distillation_weight > 0 and student_features is not None
                and teacher_features is not None):
            mse, cos = distillation_terms(student_features, teacher_features,
                                          self.distillation_loss_type)
            distill = (cos + mse if self.distillation_loss_type == "cosine" else mse
                       ) * self.distillation_weight
        weighted = d_weight * self.disc_factor(step) * g_loss
        total = nll + weighted + distill
        return total, dict(total_loss=total, reconstruction_loss=rec,
                           perceptual_loss=self.perceptual_weight * perc, gan_loss=g_loss,
                           d_weight=d_weight, weighted_gan_loss=weighted,
                           distillation_loss=distill, distillation_cosine_loss=cos,
                           mse_loss=mse)

    def discriminator_loss(self, inputs, reconstructions, disc_apply: Callable, step: int,
                           lecam_state: Optional[LeCamState] = None):
        """(loss, metrics, new LeCam state); the reconstructions carry no gradient."""
        logits_real = disc_apply(inputs.float() * 0.5 + 0.5)
        logits_fake = disc_apply(reconstructions.detach().float() * 0.5 + 0.5)
        d_loss = self.disc_factor(step) * hinge_d_loss(logits_real, logits_fake)
        lecam = torch.zeros((), device=d_loss.device)
        new_state = lecam_state
        real_mean, fake_mean = logits_real.mean(), logits_fake.mean()
        if self.lecam_regularization_weight > 0 and lecam_state is not None:
            lecam = compute_lecam_loss(real_mean, fake_mean, lecam_state.ema_real,
                                       lecam_state.ema_fake) * self.lecam_regularization_weight
            new_state = lecam_state.updated(real_mean, fake_mean, self.lecam_ema_decay)
        d_loss = d_loss + lecam
        return d_loss, dict(discriminator_loss=d_loss, logits_real=real_mean,
                            logits_fake=fake_mean, lecam_loss=lecam), new_state


def adaptive_d_weight(nll, g_loss, last_layer_params, base_weight: float) -> torch.Tensor:
    """|grad(nll)| / (|grad(g_loss)| + 1e-4) x ``base_weight``, clipped to
    [0, 1e4] before the weight, over ``last_layer_params`` (the decoder's
    output conv), without gradient; the graph is kept for the caller's
    backward."""
    nll_grads = torch.autograd.grad(nll, last_layer_params, retain_graph=True)
    g_grads = torch.autograd.grad(g_loss, last_layer_params, retain_graph=True)
    w = gradient_norm(nll_grads, 0.0) / (gradient_norm(g_grads, 0.0) + 1e-4)
    return torch.clamp(w, 0.0, 1e4).detach() * base_weight
