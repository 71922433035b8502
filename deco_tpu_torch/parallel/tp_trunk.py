"""Tensor-parallel trunk execution, Megatron style
(``deco_tpu/parallel/tp_trunk.py``).

A DiT block's two matmul chains split over the mesh's model axis without a
change to the checkpoint layout: each rank takes its H/S heads of the
fused ``qkv`` (``kv_y`` too in the joint block) and their columns of the
out-projection, and its 1/S of the SwiGLU width (rows of ``w1``/``w3``, or
of both halves of the fused ``w12``, and the matching columns of the down
projection), as slices of the same ``blocks.*`` parameters. Megatron's two
autograd-aware collectives: an all-reduce after the attention
out-projection and after the down-projection (identity in the backward),
and their transpose on the inputs of the sharded products (identity
forward, all-reduce backward). Activations stay whole on every rank; the
small operations (adaLN, the norms, the biases) are computed redundantly
on each.

The local heads go through the port's attention, :func:`layers.sdpa`
(:func:`~deco_tpu_torch.ops.flash_attention.flash_attention`: the forward
kernel when sampling, the forward with lse and the two backward kernels
when training), where JAX takes a plain fp32-softmax einsum that rounds the
probabilities to the compute dtype as the kernel does.

Gradients: a rank's small parameters get the exact gradient (the same on
every rank), a sliced weight its slice's exact gradient times S, zeros
elsewhere, and the q/k norm weights, which see only the local heads, S
times those heads' share; so the exact gradient is the mean over the model group,
the mean DDP and FSDP2 take over the world, and the small parameters are
not counted S times.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from deco_tpu_torch.models import layers
from deco_tpu_torch.parallel import mesh as mesh_lib


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward all-reduces the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.group is not None:
            dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) over the group; identity in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        if group is not None:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, s):
        ctx.s = s
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _check_divisible(s: int, num_heads: int, width: int) -> None:
    if num_heads % s or width % s:
        raise ValueError(
            f"tensor parallelism over {s} ranks needs heads ({num_heads}) and SwiGLU width "
            f"({width}) divisible by the axis size")


class _Split:
    """This rank's share of one block's sliced weights."""

    def __init__(self, group, num_heads: int, hidden: int):
        self.group = group
        self.s, self.r = mesh_lib.group_size(group), mesh_lib.group_rank(group)
        self.heads = num_heads // self.s
        self.hd = hidden // num_heads
        self.num_heads = num_heads

    def _scaled(self, w):
        return _ScaleGrad.apply(w, self.s) if self.s > 1 else w

    def head_rows(self, w, parts: int):
        """Rows of a (parts * hidden, hidden) projection for the local heads."""
        h0 = self.r * self.heads
        w = self._scaled(w).view(parts, self.num_heads, self.hd, -1)[:, h0:h0 + self.heads]
        return w.reshape(parts * self.heads * self.hd, -1)

    def head_cols(self, w):
        n = self.heads * self.hd
        return self._scaled(w)[:, self.r * n:(self.r + 1) * n]

    def width_rows(self, w, offset: int = 0, width: int = 0):
        n = width // self.s
        return self._scaled(w)[offset + self.r * n:offset + (self.r + 1) * n]

    def width_cols(self, w):
        n = w.shape[1] // self.s
        return self._scaled(w)[:, self.r * n:(self.r + 1) * n]

    def head_norm(self, norm, x):
        """``norm`` (the q/k RMSNorm over a head's channels) on the local
        heads, its weight's gradient scaled as a sliced weight's: each rank
        sees only its heads' share."""
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + norm.eps)
        return (self._scaled(norm.weight) * xf).to(x.dtype)

    def copy(self, x):
        return _CopyToModel.apply(x, self.group)

    def reduce(self, x):
        return _ReduceFromModel.apply(x, self.group)


def _attn_out(sp: _Split, attn, o, dt):
    b, n = o.shape[:2]
    part = F.linear(o.reshape(b, n, -1).to(dt), sp.head_cols(attn.proj.weight).to(dt))
    return sp.reduce(part) + attn.proj.bias.to(dt)


def _tp_block(block, x, c, rope, group):
    attn, mlp, dt = block.attn, block.mlp, block.attn.qkv.compute_dtype
    b, n, hidden = x.shape
    sp = _Split(group, attn.num_heads, hidden)
    (shift_msa, scale_msa, gate_msa,
     shift_mlp, scale_mlp, gate_mlp) = block.adaLN_modulation(c).chunk(6, dim=-1)
    h = sp.copy(layers.modulate(block.norm1(x), shift_msa, scale_msa))
    qkv = F.linear(h.to(dt), sp.head_rows(attn.qkv.weight, 3).to(dt))
    qkv = qkv.reshape(b, n, 3, sp.heads, sp.hd)
    q, k = layers.apply_rope(sp.head_norm(attn.q_norm, qkv[:, :, 0]),
                             sp.head_norm(attn.k_norm, qkv[:, :, 1]), rope)
    x = x + gate_msa * _attn_out(sp, attn, layers.sdpa(q, k, qkv[:, :, 2]), dt)
    h2 = sp.copy(layers.modulate(block.norm2(x), shift_mlp, scale_mlp)).to(dt)
    width = mlp.w1.weight.shape[0]
    a = F.linear(h2, sp.width_rows(mlp.w1.weight, width=width).to(dt))
    g = F.linear(h2, sp.width_rows(mlp.w3.weight, width=width).to(dt))
    part = F.linear(F.silu(a) * g, sp.width_cols(mlp.w2.weight).to(dt))
    return x + gate_mlp * sp.reduce(part)


def _tp_joint_block(block, x, y, c, rope, group):
    attn, mlp, dt = block.attn, block.mlp, block.attn.qkv_x.compute_dtype
    b, n, hidden = x.shape
    sp = _Split(group, attn.num_heads, hidden)
    (shift_msa, scale_msa, gate_msa,
     shift_mlp, scale_mlp, gate_mlp) = block.adaLN_modulation(c).chunk(6, dim=-1)
    h = sp.copy(layers.modulate(block.norm1(x), shift_msa, scale_msa))
    qkv = F.linear(h.to(dt), sp.head_rows(attn.qkv_x.weight, 3).to(dt))
    qkv = qkv.reshape(b, n, 3, sp.heads, sp.hd)
    q, kx = layers.apply_rope(sp.head_norm(attn.q_norm, qkv[:, :, 0]),
                              sp.head_norm(attn.k_norm, qkv[:, :, 1]), rope)
    kv = F.linear(y.to(dt), sp.head_rows(attn.kv_y.weight, 2).to(dt))
    kv = kv.reshape(b, y.shape[1], 2, sp.heads, sp.hd)
    o = layers.sdpa(q, kx, qkv[:, :, 2],
                    extra_kv=(sp.head_norm(attn.k_norm, kv[:, :, 0]), kv[:, :, 1]))
    x = x + gate_msa * _attn_out(sp, attn, o, dt)
    h2 = sp.copy(layers.modulate(block.norm2(x), shift_mlp, scale_mlp)).to(dt)
    width = mlp.w12.weight.shape[0] // 2
    h1 = F.linear(h2, sp.width_rows(mlp.w12.weight, 0, width).to(dt))
    gate = F.linear(h2, sp.width_rows(mlp.w12.weight, width, width).to(dt))
    part = F.linear(F.silu(h1) * gate, sp.width_cols(mlp.w3.weight).to(dt))
    return x + gate_mlp * sp.reduce(part)


def _group(blocks, mesh, width_of):
    group = mesh_lib.axis_group(mesh_lib.current_mesh() if mesh is None else mesh,
                                mesh_lib.MODEL_AXIS)
    for block in blocks:
        _check_divisible(mesh_lib.group_size(group), block.attn.num_heads, width_of(block.mlp))
    return group


def tensor_parallel_trunk(blocks, x, c, rope, *, mesh=None, remat: bool = False,
                          policy: str = "full"):
    """The c2i trunk (``FlattenDiTBlock``s) tensor-parallel over ``mesh``'s
    model axis (default the current mesh), which must divide the heads and
    the SwiGLU width. x: (B, N, hidden), c: (B, 1, hidden), rope: (cos, sin);
    returns (B, N, hidden) on every rank of the group."""
    group = _group(blocks, mesh, lambda m: m.w1.weight.shape[0])
    for block in blocks:
        x = layers.run_checkpointed(_tp_block, block, x, c, rope, group, enabled=remat,
                                    policy=policy)
    return x


def tensor_parallel_joint_trunk(blocks, x, y, c, rope, *, mesh=None, remat: bool = False,
                                policy: str = "full"):
    """The t2i joint trunk (``JointDiTBlock``s) tensor-parallel: heads split
    for both the image ``qkv_x`` and the text ``kv_y`` projections, so each
    rank attends its heads over the whole (image, text) key set with no
    further collective; the exact-width fused SwiGLU splits its width. x:
    image tokens (B, N, hidden); y: text tokens (B, M, hidden); rope covers
    the image positions."""
    group = _group(blocks, mesh, lambda m: m.w12.weight.shape[0] // 2)
    y = _CopyToModel.apply(y, group)
    for block in blocks:
        x = layers.run_checkpointed(_tp_joint_block, block, x, y, c, rope, group,
                                    enabled=remat, policy=policy)
    return x
