"""Autograd-aware collectives over a process group (None: a group of one,
where each is the identity): the sum all-reduce, whose backward is the
sum all-reduce of the gradient, and the all-gather and reduce-scatter
along dim 0, each the other's backward."""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


def _gather0(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def _scatter0(x, group):
    parts = [p.contiguous() for p in x.chunk(dist.get_world_size(group), dim=0)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter0(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.group), None


def all_reduce(x, group):
    """The sum over the group; the backward sums the gradient likewise."""
    return x if group is None else _AllReduce.apply(x, group)


def all_gather(x, group):
    """Every rank's x concatenated along dim 0, in rank order."""
    return x if group is None else _AllGather.apply(x, group)


def reduce_scatter(x, group):
    """This rank's 1/P along dim 0 of the sum over the group."""
    return x if group is None else _ReduceScatter.apply(x, group)
