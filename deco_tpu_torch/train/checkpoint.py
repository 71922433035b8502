"""Step checkpoints of a training run (``deco_tpu/train/checkpoint.py``).

The JAX package writes Orbax directories; the port cannot read or write
Orbax without JAX, so it writes one torch file per step,
``<directory>/<step>.pt``, holding

- ``state_dict``: ``denoiser.<name>`` (the parameters) and
  ``ema_denoiser.<name>`` (their EMA), the layout of the JAX package's
  ``export_checkpoint``, which ``convert.load_checkpoint`` reads; a
  trainer's own parameters (the REPA projection) as
  ``diffusion_trainer.<name>``, the reference trainer's keys, and their EMA
  as ``ema_diffusion_trainer.<name>``;
- ``optimizer``: the AdamW moments keyed by parameter name (a trainer's
  under ``diffusion_trainer.``),
  ``{name: {"exp_avg", "exp_avg_sq", "step"}}``, so a restore does not
  depend on the order of ``model.parameters()``;
- ``step``: the number of train steps taken.

Only tensors, dicts and ints, so ``torch.load(weights_only=True)`` reads
it. A save goes to a temporary file in the same directory, is flushed to
disk and then renamed over the final name, so a crash never leaves a
half-written checkpoint under a step's name.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch
from torch import nn

from deco_tpu_torch.train.state import TRAINER_PREFIX, TrainState

_NAME = re.compile(r"^(\d+)\.pt$")
MOMENTS = ("exp_avg", "exp_avg_sq", "step")


def payload(params: Dict[str, torch.Tensor], ema: Optional[Dict[str, torch.Tensor]],
            moments: Dict[str, dict], step: int) -> dict:
    """The checkpoint dict from named parameters, their EMA (or None), the
    AdamW state by parameter name, and the step; tensors on the CPU."""
    state_dict = {_key(k): v.detach().cpu() for k, v in params.items()}
    if ema is not None:
        state_dict.update({_key(k, ema=True): v.detach().cpu() for k, v in ema.items()})
    optimizer = {name: {k: m[k].detach().cpu() for k in MOMENTS} for name, m in moments.items()}
    return {"state_dict": state_dict, "optimizer": optimizer, "step": int(step)}


def _key(name: str, ema: bool = False) -> str:
    """The state-dict key of a parameter of :meth:`TrainState.named_parameters`."""
    if name.startswith(TRAINER_PREFIX):
        return "ema_" + name if ema else name
    return ("ema_denoiser." if ema else "denoiser.") + name


def state_payload(state: TrainState) -> dict:
    named = state.named_parameters()
    ema = (None if state.ema_params is None
           else {n: e for (n, _), e in zip(named, state.ema_params)})
    moments = {n: state.optimizer.state[p] for n, p in named if p in state.optimizer.state}
    return payload(dict(named), ema, moments, state.step)


class CheckpointManager:
    """Saves every ``every_n_steps`` steps (and when forced) and restores."""

    def __init__(self, directory: str, every_n_steps: int = 10000):
        self.directory = os.path.abspath(directory)
        self.every_n_steps = every_n_steps

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def maybe_save(self, state: TrainState, force: bool = False,
                   step: Optional[int] = None) -> bool:
        step = state.step if step is None else int(step)
        if not force and (self.every_n_steps <= 0 or step % self.every_n_steps != 0):
            return False
        obj = state_payload(state)
        obj["step"] = step
        self.save(obj, step)
        return True

    def save(self, obj: dict, step: int) -> str:
        os.makedirs(self.directory, exist_ok=True)
        final = self.path(step)
        tmp = os.path.join(self.directory, f".{int(step)}.pt.tmp")
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        return final

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.directory):
            return None
        steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m]
        return max(steps) if steps else None

    def load(self, step: Optional[int] = None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        # mmap: a predict that needs only the EMA reads only its pages
        return torch.load(self.path(step), map_location="cpu", weights_only=True, mmap=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Full resume, in place: parameters, EMA, AdamW moments and step."""
        obj = self.load(step)
        sd, named = obj["state_dict"], state.named_parameters()
        _check_keys(sd, {_key(n) for n, _ in named}
                    | ({_key(n, ema=True) for n, _ in named} if state.ema_params is not None
                       else set()), "state_dict")
        with torch.no_grad():
            for n, p in named:
                p.copy_(sd[_key(n)])
            if state.ema_params is not None:
                for (n, _), e in zip(named, state.ema_params):
                    e.copy_(sd[_key(n, ema=True)])
        index = {n: i for i, (n, _) in enumerate(named)}
        unknown = set(obj["optimizer"]) - set(index)
        if unknown:
            raise KeyError(f"checkpoint optimizer state for unknown parameters {sorted(unknown)[:5]}")
        osd = state.optimizer.state_dict()
        osd["state"] = {index[n]: dict(m) for n, m in obj["optimizer"].items()}
        state.optimizer.load_state_dict(osd)
        state.step = int(obj["step"])
        return state

    def restore_params(self, model: nn.Module, step: Optional[int] = None,
                       use_ema: bool = True) -> int:
        """Load the EMA (``use_ema``) or the raw parameters into ``model``;
        returns the checkpoint's step."""
        obj = self.load(step)
        prefix = "ema_denoiser." if use_ema else "denoiser."
        sd = {k[len(prefix):]: v for k, v in obj["state_dict"].items() if k.startswith(prefix)}
        model.load_state_dict(sd, strict=True)
        return int(obj["step"])


def _check_keys(found, expected, what: str) -> None:
    missing, extra = set(expected) - set(found), set(found) - set(expected)
    if missing or extra:
        raise KeyError(f"checkpoint {what}: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
