"""Pipeline parallelism for the DiT trunk, GPipe style
(``deco_tpu/parallel/pipeline.py``).

Each stage (rank of the mesh's model axis) holds L/S consecutive layers.
The rank's batch rows split into M microbatches, and the schedule runs
M + S - 1 ticks: at tick t stage s works on microbatch t - s, stage 0
takes a fresh microbatch, and each stage's output moves to the next stage
by point-to-point send and receive (a ring shift, whose backward is the
reverse shift). The last stage collects the outputs and a masked
all-reduce gives them to the whole model group, so the result is laid out
as the sequential trunk's, on every stage. The bubble is (S-1)/(M+S-1);
a stage with no microbatch at a tick computes nothing.

Gradients follow the executors' convention: the masked all-reduce's
backward hands every stage S times the upstream gradient, so a stage's
layers get S times their gradient and the other layers none: the exact
gradient is the mean over the model group.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from deco_tpu_torch.parallel import collectives
from deco_tpu_torch.parallel import mesh as mesh_lib


class _RingShift(torch.autograd.Function):
    """Send to the next stage, receive from the previous (the ring of the
    group); the backward shifts the gradient the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, +1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _shift(x, group, step: int):
    ranks = dist.get_process_group_ranks(group)
    r, s = dist.get_rank(group), len(ranks)
    x = x.contiguous()
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(r + step) % s], group),
           dist.P2POp(dist.irecv, buf, ranks[(r - step) % s], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


def pipeline_apply(apply_layer: Callable, layers: Sequence, x, mb_args: Sequence = (),
                   bcast_args: Sequence = (), *, mesh=None, num_microbatches: int):
    """``x`` through every layer of ``layers``, pipelined over ``mesh``'s
    model axis (default the current mesh).

    ``apply_layer(layer, x, *mb, *bcast) -> x`` applies one layer; the
    layer count must divide by the stages. ``x`` and each of ``mb_args``
    lead with this rank's batch rows, which must divide into
    ``num_microbatches``; ``bcast_args`` pass unchanged (RoPE tables).
    Returns the full-depth output on every stage.
    """
    group = mesh_lib.axis_group(mesh_lib.current_mesh() if mesh is None else mesh,
                                mesh_lib.MODEL_AXIS)
    s, stage = mesh_lib.group_size(group), mesh_lib.group_rank(group)
    n, m = len(layers), num_microbatches
    if n % s:
        raise ValueError(f"{n} layers do not split over {s} pipeline stages")
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} per rank is not divisible into {m} microbatches")
    own = layers[stage * (n // s):(stage + 1) * (n // s)]
    x_mb = x.chunk(m, dim=0)
    mb_mb = [a.chunk(m, dim=0) for a in mb_args]
    ring = torch.zeros_like(x_mb[0])
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for layer in layers if isinstance(layer, torch.nn.Module)
            for p in layer.parameters())):
        # every stage records every shift, so that each runs its backward
        # (a collective) in the same order as the other stages
        ring.requires_grad_()
    outs = [torch.zeros_like(x_mb[0]) for _ in range(m)]
    for t in range(m + s - 1):
        mb = t - stage
        out = ring
        if 0 <= mb < m:
            # stage 0 drops what it receives, but keeps it in the graph: every
            # shift must run its backward, in the same order on every stage
            out = x_mb[mb] + 0 * ring if stage == 0 and s > 1 else x_mb[mb] if stage == 0 \
                else ring
            for layer in own:
                out = apply_layer(layer, out, *(a[mb] for a in mb_mb), *bcast_args)
            if stage == s - 1:
                outs[mb] = out
        if s > 1 and t < m + s - 2:
            ring = _RingShift.apply(out, group)
    buf = torch.cat(outs, dim=0) if stage == s - 1 else torch.zeros_like(torch.cat(outs, 0))
    if s > 1:
        buf = buf + 0 * ring.sum()  # the last shift in the graph too
    # the last stage's outputs to every stage
    return collectives.all_reduce(buf, group)


def dit_block_apply(block, x, c, rope):
    """``apply_layer`` for :func:`pipeline_apply` over ``FlattenDiTBlock``s."""
    return block(x, c, rope, None)
