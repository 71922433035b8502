"""The training step: loss, gradients, clip, AdamW and EMA
(``deco_tpu/train/train_step.py`` ``make_train_step``).

The JAX step is one jitted program; here it is eager PyTorch, and it
updates the :class:`~deco_tpu_torch.train.state.TrainState` in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from deco_tpu_torch.train.state import TrainState, ema_update


def make_train_step(trainer, ema_decay: float = 0.9999, ema_every: int = 1,
                    diffusion_batch_mul: int = 1, grad_clip: Optional[float] = None,
                    accumulate_grad_batches: int = 1):
    """Build ``train_step(state, batch, generator=None, draws=None) -> metrics``.

    ``trainer`` is a :mod:`deco_tpu_torch.diffusion.training` objective;
    ``batch`` holds ``x`` (NHWC), ``condition`` and ``uncondition``, and
    optionally ``metadata``, a dict of tensors with the batch's leading dim
    (the trainer's ``metadata_keys``: ``raw_image``, ``repa_features``).

    - ``diffusion_batch_mul`` repeats the batch, metadata included, along
      dim 0 inside the step.
    - A trainer with an ``encoder`` and a ``raw_image`` but no
      ``repa_features`` gets ``repa_features`` = its encoder of the
      microbatch's images, computed once per microbatch without gradient
      before the repeat: the features of a repeated row are the same row
      repeated.
    - ``accumulate_grad_batches`` = k splits the batch into k microbatches,
      one forward and backward each; gradients and metrics are averaged and
      there is one optimizer and EMA update.
    - ``grad_clip`` scales the (accumulated) gradients by
      ``min(1, grad_clip / (global_norm + 1e-6))``.
    - The EMA moves with ``ema_decay`` when ``state.step % ema_every == 0``.

    ``draws`` is None (every draw comes from ``generator``) or one dict of
    draws per microbatch (see ``training.DRAWS``). The metrics are the
    trainer's losses averaged over microbatches and ``grad_norm``, the global
    norm before clipping (the JAX step reports it only when clipping), as
    0-d tensors on the model's device. After the step each parameter's
    ``.grad`` holds the gradient that was applied.
    """
    k = accumulate_grad_batches

    def train_step(state: TrainState, batch, generator=None,
                   draws: Optional[Sequence[dict]] = None):
        params = state.parameters()
        if draws is not None and len(draws) != k:
            raise ValueError(f"draws: expected {k} dicts (one per microbatch), got {len(draws)}")
        x, cond, uncond = batch["x"], batch["condition"], batch["uncondition"]
        meta = batch.get("metadata")
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} does not split into {k} microbatches")
        m = x.shape[0] // k
        state.optimizer.zero_grad(set_to_none=True)
        metrics: dict = {}
        for i in range(k):
            part = [a[i * m:(i + 1) * m] for a in (x, cond, uncond)]
            mpart = None if meta is None else _encoded(
                trainer, {key: v[i * m:(i + 1) * m] for key, v in meta.items()})
            if diffusion_batch_mul > 1:
                part = [torch.cat([a] * diffusion_batch_mul) for a in part]
                if mpart is not None:
                    mpart = {key: torch.cat([v] * diffusion_batch_mul) for key, v in mpart.items()}
            out = trainer(state.model, *part, generator=generator,
                          draws=None if draws is None else draws[i], metadata=mpart)
            (out["loss"] / k).backward()
            for name, value in out.items():
                metrics[name] = metrics.get(name, 0.0) + value.detach() / k
        for p in params:  # a parameter the loss does not reach gets a zero gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if grad_clip is not None:
            torch._foreach_mul_(grads, torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0))
        metrics["grad_norm"] = gnorm
        state.optimizer.step()
        if state.ema_params is not None and state.step % ema_every == 0:
            ema_update(state.ema_params, params, ema_decay)
        state.step += 1
        return metrics

    return train_step


def _encoded(trainer, meta: dict) -> dict:
    """``meta`` with ``repa_features`` from the trainer's frozen encoder
    when it has ``raw_image`` and no features yet."""
    encoder = getattr(trainer, "encoder", None)
    if encoder is None or "raw_image" not in meta or "repa_features" in meta:
        return meta
    with torch.no_grad():
        features = encoder(meta["raw_image"])
    return {**{k: v for k, v in meta.items() if k != "raw_image"}, "repa_features": features}
