"""Process group start-up and cross-process helpers
(``deco_tpu/parallel/distributed.py``).

JAX runs one controller over every device of a host and starts its
cluster from ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``. The port runs one process per GPU, as ``torchrun``
launches it (the reference's Lightning DDP does the same), and
:func:`initialize` starts the default ``torch.distributed`` group from
``torchrun``'s environment: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``. The backend is NCCL for a CUDA run,
which never falls back to gloo, and gloo for a CPU run. Without that
environment the run is a single process and no group is started, as in
JAX. :func:`barrier` and :func:`process_allgather` replace the reference's
``trainer.strategy.barrier()`` and ``pl_module.all_gather``; both are
no-ops in a single process.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The number of processes of the default group (1 without a group)."""
    return dist.get_world_size() if is_initialized() else 1


def initialize(device="cuda") -> None:
    """Start the default process group from ``torchrun``'s environment and
    set this rank's card from ``LOCAL_RANK``.

    ``device`` is the run's device: "cuda" takes NCCL (and raises where
    there is no card), "cpu" gloo. Without ``WORLD_SIZE`` this is a
    single-process run and nothing is started (with it, the other variables
    must be set too); a group that is already up is kept.
    """
    if is_initialized() or "WORLD_SIZE" not in os.environ:
        return  # a group already up, or a single-process run
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"torchrun environment incomplete: {missing} unset")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA run under torchrun needs a card (NCCL); pass "
                               "--device cpu for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def barrier() -> None:
    """Wait for every process (the reference's ``strategy.barrier()``)."""
    if is_initialized():
        dist.barrier()


def process_allgather(x) -> np.ndarray:
    """Host arrays of every process stacked on a new leading axis, in rank
    order (``multihost_utils.process_allgather``); one process gives its own."""
    x = np.asarray(x)
    if not is_initialized():
        return x
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return np.stack(out)
