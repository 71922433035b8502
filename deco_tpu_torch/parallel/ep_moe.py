"""Expert parallelism: the MoE MLP split expert-wise over the mesh's model
axis (``deco_tpu/parallel/ep_moe.py``).

Tokens are split as the sequence-parallel trunk splits them (this rank's
batch rows, its 1/P of the sequence); the experts are split over the model
axis (E divisible by it) and the router is replicated. A layer's
collectives are EP's pair:

1. each rank routes its tokens and builds its partial (E, C, d) dispatch
   slab; a reduce-scatter over the expert axis leaves each rank its own
   experts' whole slabs;
2. the local experts run their SwiGLU on (E/P, C, d);
3. an all-gather brings every expert's output back to each rank, which
   combines it into its tokens.

Slot assignment is global, k-major in token order, as in the dense
:class:`~deco_tpu_torch.models.moe.MoEMLP`: each rank counts its claims per
(choice, expert), all-gathers the (P, K, E) count table, and offsets its
local cumulative sum by the slots that earlier ranks, and earlier choices
on every rank, took; so the dispatch, combine and drops are the dense
module's exactly. The aux loss is taken from the group's mean fractions
and probabilities (a product of means, as the dense form is).

Gradients follow the executors' convention: a rank's router and expert
gradients are P times its share (autograd-aware collectives, the
parameters' gradients scaled by P), exact in their mean over the model
group; a token's gradient is exact on its rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deco_tpu_torch.models.moe import dispatch_tensors, expert_swiglu, topk_masks
from deco_tpu_torch.parallel import collectives
from deco_tpu_torch.parallel import mesh as mesh_lib
from deco_tpu_torch.parallel.tp_trunk import _ScaleGrad


def _mean(x, group, p):
    return collectives.all_reduce(x, group) / p


def expert_parallel_moe(params: dict, x, *, top_k: int = 2, capacity: int, mesh=None,
                        dtype=torch.bfloat16, return_routing: bool = False):
    """The MoE MLP over this rank's tokens x (B, S/P, d), experts split over
    ``mesh``'s model axis (default the current mesh); equals
    ``MoEMLP.forward`` on the whole sequence, restricted to these tokens.

    ``params``: ``router`` (d, E), ``w1``/``w3`` (E, d, m), ``w2`` (E, m, d)
    (``MoEMLP.params()``); ``capacity``: the dense module's, computed from
    the whole sequence length. Returns (y (B, S/P, d), aux), and with
    ``return_routing`` also each row's (dispatch, combine) of these tokens.
    """
    group = mesh_lib.axis_group(mesh_lib.current_mesh() if mesh is None else mesh,
                                mesh_lib.MODEL_AXIS)
    p, me = mesh_lib.group_size(group), mesh_lib.group_rank(group)
    e = params["router"].shape[-1]
    if e % p:
        raise ValueError(f"{e} experts do not split over {p} ranks of the model axis")
    if p > 1:
        params = {k: _ScaleGrad.apply(v, p) for k, v in params.items()}
    lo, hi = me * (e // p), (me + 1) * (e // p)
    local = {k: params[k][lo:hi] for k in ("w1", "w3", "w2")}
    probs = torch.softmax(x.float() @ params["router"], dim=-1)  # (B, S/P, E)
    ys, auxes, routing = [], [], []
    for pr, xr in zip(probs, x):
        masks = topk_masks(pr.detach(), top_k)
        counts = masks.sum(1)  # (K, E)
        table = [torch.empty_like(counts) for _ in range(p)]
        if group is None:
            table = [counts]
        else:
            dist.all_gather(table, counts.contiguous(), group=group)
        table = torch.stack(table)  # (P, K, E)
        total = table.sum(0)
        offset = ((torch.cumsum(total, 0) - total) - (torch.cumsum(counts, 0) - counts)
                  + table[:me].sum(0))
        dispatch, combine, _ = dispatch_tensors(pr, top_k, capacity, position_offset=offset)
        aux = e * (_mean(masks[0].mean(0), group, p) * _mean(pr.mean(0), group, p)).sum()
        slab = torch.einsum("sec,sd->ecd", dispatch.to(dtype), xr.to(dtype))  # partial
        slab = collectives.reduce_scatter(slab, group)  # this rank's experts' whole slabs
        out = collectives.all_gather(expert_swiglu(local, slab, dtype), group)  # (E, C, d)
        ys.append(torch.einsum("sec,ecd->sd", combine.to(dtype), out))
        auxes.append(aux)
        routing.append((dispatch, combine))
    y, aux = torch.stack(ys).to(x.dtype), torch.stack(auxes).mean()
    return (y, aux, routing) if return_routing else (y, aux)
