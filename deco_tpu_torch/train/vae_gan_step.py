"""The two-optimizer VAE-GAN training step: generator, then discriminator
(``deco_tpu/train/vae_gan_step.py``).

The JAX step takes one forward of the generator's losses and three
pullbacks of it (nll, GAN and distillation gradients), weighs the GAN
gradient by the adaptive weight from the decoder's output layer, and sums.
The port takes the same forward and, because a gradient is linear in its
cotangent, gets the same sum with fewer backward passes:

1. the nll and GAN gradients of the decoder's ``conv_out`` alone
   (``torch.autograd.grad`` with the graph kept), which stop at that layer
   and do not pass through the decoder or the tower, give ``d_weight``;
2. one backward of ``nll + d_weight * disc_factor * g_loss + distill`` over
   every generator parameter gives the gradient JAX sums from its three
   pullbacks (the GAN term is left out while ``disc_factor`` is 0, when it
   adds exact zeros).

So a step runs each attention layer's forward with lse once and its two
backward kernels once. Then, as in JAX: the clip by the global norm of
*all* generator gradients, frozen parameters included (``train/freeze.py``:
they take no update), AdamW with the cosine-with-min-lr rate of the step,
the generator EMA over every parameter, and the discriminator step on the
detached reconstruction with LeCam, its clip, its AdamW and the LeCam EMA.
The step updates the state in place and returns its metrics as 0-d tensors.

On a mesh (``mesh``) each process takes its rows of the global batch, and
the step computes the world-1 step of that batch: the two last-layer
gradients behind ``d_weight`` are averaged over the world before their
norms (each rank's are its rows' alone), so are both sides' gradients
before the clip (ROADMAP §C 12's norm is the global gradient's), LeCam's
batch means carry their global value (``parallel.mesh.global_value``: the
term is not linear in them), and the metrics are their global means. The
steps take ``torch.autograd.grad``, which no DDP hook sees, so the means
are explicit all-reduces (``parallel.mesh.mean_over_world``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from deco_tpu_torch.models.gan.vae_loss import (
    LeCamState,
    VAEGANLoss,
    distillation_terms,
    gradient_norm,
    hinge_d_loss,
)
from deco_tpu_torch.parallel import mesh as mesh_lib
from deco_tpu_torch.train.freeze import split_frozen
from deco_tpu_torch.train.state import ema_update


@dataclasses.dataclass
class VAEGANTrainState:
    """The generator (``vae``) and discriminator with their AdamW optimizers
    and learning-rate schedules, the LeCam state, the generator EMA (a list
    of fp32 tensors in ``vae.parameters()`` order, or None) and the step."""

    vae: nn.Module
    disc: nn.Module
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    gen_lr: Callable[[int], float]
    disc_lr: Callable[[int], float]
    lecam: LeCamState
    gen_ema: Optional[list] = None
    step: int = 0

    @classmethod
    def create(cls, vae: nn.Module, disc: nn.Module, gen_opt: tuple, disc_opt: tuple,
               gen_lr: Callable, disc_lr: Callable, ema: bool = False,
               frozen: Sequence[str] = ()):
        """``gen_opt`` and ``disc_opt`` are (weight decay, betas), AdamW with
        optax's eps; parameters under the ``frozen`` prefixes stay out of the
        generator's optimizer, so they take no update."""
        trainable, _ = split_frozen(vae.named_parameters(), frozen)
        device = next(vae.parameters()).device

        def adamw(params, spec):
            return torch.optim.AdamW(params, lr=0.0, weight_decay=spec[0], betas=spec[1],
                                     eps=1e-8)

        return cls(vae=vae, disc=disc, gen_opt=adamw([p for _, p in trainable], gen_opt),
                   disc_opt=adamw(list(disc.parameters()), disc_opt), gen_lr=gen_lr,
                   disc_lr=disc_lr, lecam=LeCamState.create(device),
                   gen_ema=[p.detach().clone() for p in vae.parameters()] if ema else None)


def _clip_(grads: list, grad_clip: float) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, clip / (norm + 1e-6)); returns the norm."""
    norm = gradient_norm(grads)
    torch._foreach_mul_(grads, torch.clamp(grad_clip / (norm + 1e-6), max=1.0))
    return norm


def _apply(optimizer: torch.optim.Optimizer, params: list, grads: list, lr: float) -> None:
    """Give ``params`` their gradients and step ``optimizer`` at ``lr``; a
    parameter the optimizer does not hold (a frozen one) is not updated."""
    for p, g in zip(params, grads):
        p.grad = g
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def make_vae_gan_step(loss_cfg: VAEGANLoss, perceptual_fn: Optional[Callable] = None,
                      teacher_fn: Optional[Callable] = None, grad_clip: float = 1.0,
                      ema_decay: float = 0.9999, last_layer: str = "decoder.conv_out",
                      mesh=None):
    """Build ``step(state, x, generator=None, noise=None) -> metrics``.

    ``x`` is (B, H, W, 3) in [-1, 1]; ``generator`` draws the stochastic
    posterior's noise, or ``noise`` gives it. ``last_layer`` names the
    decoder's output layer, whose parameters give the adaptive weight.
    """

    def mean(grads):
        if mesh is not None:
            mesh_lib.mean_over_world(grads)
        return grads

    def step(state: VAEGANTrainState, x, generator=None, noise=None) -> dict:
        vae, disc = state.vae, state.disc
        names, params = zip(*vae.named_parameters())
        last = [p for n, p in zip(names, params) if n.startswith(last_layer + ".")]
        disc_factor = loss_cfg.disc_factor(state.step)

        # ---- generator ----
        recon, extra = vae(x, generator=generator, noise=noise)
        inputs01 = x.float() * 0.5 + 0.5
        recon01 = recon.float() * 0.5 + 0.5
        rec, perc, nll = loss_cfg.nll(inputs01, recon01, perceptual_fn)
        zero = torch.zeros((), device=rec.device)
        kl = extra.get("kl", zero)
        if loss_cfg.kl_weight > 0:
            nll = nll + loss_cfg.kl_weight * kl
        g_loss = -disc(recon01).mean()
        distill = zero
        if loss_cfg.distillation_weight > 0 and teacher_fn is not None:
            with torch.no_grad():
                teacher = teacher_fn(x)
            mse, cos = distillation_terms(extra["student_features"], teacher,
                                          loss_cfg.distillation_loss_type)
            distill = (cos + mse if loss_cfg.distillation_loss_type == "cosine" else mse
                       ) * loss_cfg.distillation_weight
        if loss_cfg.adaptive_weight:
            g_nll = mean(list(torch.autograd.grad(nll, last, retain_graph=True)))
            g_gan = mean(list(torch.autograd.grad(g_loss, last, retain_graph=True)))
            d_weight = torch.clamp(gradient_norm(g_nll) / (gradient_norm(g_gan) + 1e-4),
                                   0.0, 1e4) * loss_cfg.discriminator_weight
        else:
            d_weight = torch.tensor(loss_cfg.discriminator_weight, device=rec.device)
        d_weight = d_weight.detach()
        total = nll + distill
        if disc_factor:
            total = total + d_weight * disc_factor * g_loss
        grads = list(torch.autograd.grad(total, params, allow_unused=True))
        grads = mean([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])
        gnorm = _clip_(grads, grad_clip)
        _apply(state.gen_opt, params, grads, state.gen_lr(state.step))
        if state.gen_ema is not None:
            ema_update(state.gen_ema, list(params), ema_decay)

        # ---- discriminator ----
        recon01 = recon01.detach()
        d_params = list(disc.parameters())
        logits_real, logits_fake = disc(inputs01), disc(recon01)
        real_mean, fake_mean = logits_real.mean(), logits_fake.mean()
        if mesh is not None:
            real_mean, fake_mean = (mesh_lib.global_value(m) for m in (real_mean, fake_mean))
        d_loss = disc_factor * hinge_d_loss(logits_real, logits_fake)
        lecam = zero
        if loss_cfg.lecam_regularization_weight > 0:
            lecam = (torch.relu(real_mean - state.lecam.ema_fake) ** 2
                     + torch.relu(state.lecam.ema_real - fake_mean) ** 2
                     ) * loss_cfg.lecam_regularization_weight
        d_loss = d_loss + lecam
        d_grads = list(torch.autograd.grad(d_loss, d_params, allow_unused=True))
        d_grads = mean([torch.zeros_like(p) if g is None else g for p, g in zip(d_params, d_grads)])
        d_gnorm = _clip_(d_grads, grad_clip)
        _apply(state.disc_opt, d_params, d_grads, state.disc_lr(state.step))
        state.lecam = state.lecam.updated(real_mean, fake_mean, loss_cfg.lecam_ema_decay)
        state.step += 1

        metrics = dict(total_loss=(nll + d_weight * disc_factor * g_loss + distill).detach(),
                       reconstruction_loss=rec.detach(),
                       perceptual_loss=(loss_cfg.perceptual_weight * perc).detach(),
                       gan_loss=g_loss.detach(), d_weight=d_weight, distillation_loss=distill,
                       kl_loss=kl.detach(), discriminator_loss=d_loss.detach(),
                       logits_real=real_mean.detach(), logits_fake=fake_mean.detach(),
                       lecam_loss=lecam.detach(), gen_grad_norm=gnorm.detach(),
                       disc_grad_norm=d_gnorm.detach())
        if mesh is not None:  # the global batch's values
            names = [k for k in metrics if k not in ("gen_grad_norm", "disc_grad_norm")]
            values = [metrics[k].float().reshape(1).clone() for k in names]
            mesh_lib.mean_over_world(values)
            metrics.update({k: v.reshape(()) for k, v in zip(names, values)})
        return metrics

    return step
