"""Ring attention: the sequence split over the mesh's model axis
(``deco_tpu/parallel/ring_attention.py``).

Each rank of the model group holds N/S tokens of q, k and v. The K/V
chunks travel around the ring (``batch_isend_irecv`` to the next rank,
from the previous one) while each rank attends its queries to every chunk
in turn, and the partial results merge by the flash rule on (o, lse), in
fp32. No rank ever holds the (N, N) scores or the whole sequence's K/V.

Each hop's partial attention is the port's forward with logsumexp,
:func:`~deco_tpu_torch.ops.flash_attention.flash_attention_fwd_lse`: the
kernel on CUDA tensors, its plain version on the CPU (the dispatch the
JAX module names and leaves to XLA). The backward is written by hand
(JAX differentiates through its hop scan): with the merged O and lse of
the whole sequence, the dQ kernel gives each chunk's share of dQ and the
dK/dV kernel the chunk's dK and dV from this rank's queries; those sums
are kept in fp32, and the dK/dV accumulator travels around the ring with
its chunk and arrives back at the chunk's owner after S hops. So a ring
call launches S forwards with lse, and in the backward S dQ and S dK/dV
kernels; ``extra_kv`` adds one of each.

``extra_kv`` are the t2i text keys and values, replicated on every rank:
every query attends to them outside the ring (they seed the (o, lse)
accumulator), and their dK/dV are summed over the model group
(``reduce_extra``). At S = 1 the ring is one hop and sends nothing (a
process cannot send to itself); the group's other collectives are still
issued.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from deco_tpu_torch.ops.flash_attention import (
    _readable_in_place,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd_lse,
)
from deco_tpu_torch.parallel import mesh as mesh_lib

def _shift(tensors, group):
    """Send each tensor to the next rank of ``group``'s ring and return the
    previous rank's (waited for)."""
    ranks = dist.get_process_group_ranks(group)
    r, s = dist.get_rank(group), len(ranks)
    nxt, prv = ranks[(r + 1) % s], ranks[(r - 1) % s]
    out, ops = [], []
    for t in tensors:
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, nxt, group), dist.P2POp(dist.irecv, buf, prv, group)]
        out.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _merge(o_a, lse_a, o_b, lse_b):
    """Two normalised partial attentions combined, o = sum Z_i o_i / sum Z_i,
    in fp32; o (B, N, H, D), lse (B, H, N). The ring seeds its accumulator
    with the first partial, so a ring of one merges nothing."""
    m = torch.maximum(lse_a, lse_b)
    w_a, w_b = torch.exp(lse_a - m), torch.exp(lse_b - m)
    den = w_a + w_b
    o = (o_a.float() * (w_a / den).transpose(1, 2)[..., None]
         + o_b.float() * (w_b / den).transpose(1, 2)[..., None])
    return o, m + torch.log(den)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ek, ev, group, scale, reduce_extra):
        s = mesh_lib.group_size(group)
        o = lse = None
        if ek is not None:
            o, lse = flash_attention_fwd_lse(q, ek, ev, scale)
        kc, vc = k, v
        for hop in range(s):
            o_i, lse_i = flash_attention_fwd_lse(q, kc, vc, scale)
            # the first partial needs no merge: it is the accumulator
            o, lse = (o_i, lse_i) if o is None else _merge(o, lse, o_i, lse_i)
            if hop < s - 1:
                kc, vc = _shift([kc, vc], group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, ek, ev, out, lse.contiguous())
        ctx.group, ctx.scale, ctx.reduce_extra = group, scale, reduce_extra
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, ek, ev, o, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        s = mesh_lib.group_size(group)
        if do.is_cuda and not _readable_in_place(do):
            do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dek = dev = None
        if ek is not None:
            dq_e, delta = flash_attention_bwd_dq(q, ek, ev, o, lse, do, scale)
            dq += dq_e.float()
            dek, dev = (t.float() for t in flash_attention_bwd_dkv(q, ek, ev, do, lse, delta,
                                                                   scale))
            if ctx.reduce_extra and group is not None:
                dist.all_reduce(dek, group=group)
                dist.all_reduce(dev, group=group)
            dek, dev = dek.to(ek.dtype), dev.to(ev.dtype)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for hop in range(s):
            dq_i, delta = flash_attention_bwd_dq(q, kc, vc, o, lse, do, scale)
            dq += dq_i.float()
            dk_i, dv_i = flash_attention_bwd_dkv(q, kc, vc, do, lse, delta, scale)
            dk += dk_i.float()
            dv += dv_i.float()
            if s > 1:  # the accumulators move on with their chunk; the last send
                # brings each home to its owner
                moving = [dk, dv] if hop == s - 1 else [dk, dv, kc, vc]
                moved = _shift(moving, group)
                dk, dv = moved[0], moved[1]
                if hop < s - 1:
                    kc, vc = moved[2], moved[3]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dek, dev, None, None, None)


def ring_attention_local(q, k, v, *, group=None, scale: Optional[float] = None,
                         extra_kv=None, reduce_extra: bool = True):
    """Attention of this rank's queries over the whole ring's keys.

    q, k, v: this rank's (B, N/S, H, D) chunks of a sequence split over
    ``group`` (the model axis; None is a ring of one). DiT attention is
    bidirectional, so every chunk is attended, with no hop masked.
    ``extra_kv``: (k, v) of replicated tokens every query also attends to
    (the t2i text); their gradients are summed over the group unless
    ``reduce_extra`` is False (the sequence-parallel trunk, whose ranks each
    carry S times their share, leaves that sum to the gradients' mean over
    the model group). Returns (B, N/S, H, D) in q's dtype.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ek, ev = (None, None) if extra_kv is None else extra_kv
    return _RingAttention.apply(q, k, v, ek, ev, group, float(scale), reduce_extra)


class _GatherSequence(torch.autograd.Function):
    """The model group's chunks concatenated along ``dim``; the backward
    takes this rank's chunk of the gradient times S (see
    :func:`gather_sequence`)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        if group is None:
            return x.clone()
        s = mesh_lib.group_size(group)
        parts = x.new_empty((s * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(parts, x.contiguous(), group=group)
        return torch.cat(parts.chunk(s, dim=0), dim=dim) if s > 1 else parts

    @staticmethod
    def backward(ctx, g):
        s, r = mesh_lib.group_size(ctx.group), mesh_lib.group_rank(ctx.group)
        return g.chunk(s, dim=ctx.dim)[r] * s, None, None


def split_sequence(x, group, dim: int = 1):
    """This rank's chunk of ``x`` along ``dim``; the axis must divide it."""
    s, r = mesh_lib.group_size(group), mesh_lib.group_rank(group)
    if x.shape[dim] % s:
        raise ValueError(f"sequence of {x.shape[dim]} tokens does not split over {s} ranks "
                         "of the model axis")
    return x.chunk(s, dim=dim)[r]


def gather_sequence(x, group, dim: int = 1):
    """The whole sequence from every rank's chunk (an all-gather, issued at
    any group size). Every rank of the group then holds the same tensor,
    and the loss computed from it is the same on each; the backward gives
    a rank its chunk of the gradient times S, so that the parameter
    gradients, each rank's S times its tokens' share, are exact in their
    mean over the model group, which DDP and FSDP2 take."""
    return _GatherSequence.apply(x, group, dim)


def ring_attention(q, k, v, *, mesh=None, scale: Optional[float] = None):
    """Full (non-causal) attention with the sequence split over ``mesh``'s
    model axis (default the current mesh): q, k, v are this rank's
    (B, N, H, D) rows, whole along N; each rank takes its N/S chunk, runs
    the ring and all-gathers the result, (B, N, H, D). Gradients follow
    :func:`gather_sequence`: exact in their mean over the model group."""
    mesh = mesh_lib.current_mesh() if mesh is None else mesh
    group = mesh_lib.axis_group(mesh, mesh_lib.MODEL_AXIS)
    out = ring_attention_local(split_sequence(q, group), split_sequence(k, group),
                               split_sequence(v, group), group=group, scale=scale)
    return gather_sequence(out, group)
