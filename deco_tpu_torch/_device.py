"""Device resolution shared by the port's entry points.

Entry points default to ``"cuda"``. Asking for CUDA where there is none
raises instead of quietly running on the CPU: a CPU run must be asked for
(``device="cpu"``), as the tests do. ``"meta"`` builds a model's shapes
without its data (the tests count full-width parameters that way).
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this process; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device {device!r}: expected 'cuda', 'cpu' or 'meta'")
    return dev


def card_info() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
