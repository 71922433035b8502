"""The c2i and t2i layer sets of ``deco_tpu/models/layers.py`` as PyTorch modules.

Module and parameter names follow the reference torch state-dict keys that
``convert.state_dict_from_jax`` writes, so reference-layout checkpoints load
with ``strict=True``. Numerics follow the Flax modules:

- :class:`Linear` is ``nn.Dense(dtype=..., param_dtype=...)``: parameters
  stored in ``param_dtype`` (fp32 for training, as Flax keeps them; by
  default the compute dtype, as in sampling, where a cast at every use would
  only add kernels), input, weight and bias cast to the compute ``dtype``.
  Every module built from it takes both.
- :class:`RMSNorm` and :class:`LayerNorm` compute in fp32 with fp32
  parameters and cast back to the input dtype.
- RoPE rotates in the input dtype (the JAX package's deliberate deviation).
- The t2i blocks (:class:`JointDiTBlock`, :class:`TextRefineBlock`) use the
  fused SwiGLU of exact width (:class:`SwiGLUFused`, ``w12 = [w1; gate]``,
  ``w3`` the output projection), the layout of the reference's
  ``src/models/layers/swiglu.py`` that ``export_deco_t2i`` writes.
- ``grad_checkpoint`` on :class:`SimpleMLPAdaLN` recomputes each res block in
  the backward (``torch.utils.checkpoint``, non-reentrant), the counterpart
  of ``nn.remat(AdaLNResBlock)``; :func:`run_pixel_decoder` runs it over
  patch chunks under whole-chunk remat (``decoder_chunks``).
- :func:`run_checkpointed` takes the trunk's remat policies: "full" keeps
  nothing, "dots" keeps the matmul outputs (``checkpoint_dots``), "attn"
  keeps each attention's output and logsumexp (``save_only_these_names(
  "attn_out", "attn_lse")``).
- ``quantize`` on the trunk blocks (:class:`FlattenDiTBlock`,
  :class:`JointDiTBlock`, :class:`TextRefineBlock`) runs their attention and
  MLP products through int8 (:class:`Int8Linear`, the fused ``w13`` of
  :class:`SwiGLU`; ``ops/quant.py``); adaLN and the attention stay bf16.
  The int8 weight cache is a set of non-persistent buffers, built by
  ``ops/quant.refresh_quant_cache`` and checked by
  :func:`verify_quant_cache`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from deco_tpu_torch.ops import quant as quant_ops
from deco_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain


class Linear(nn.Linear):
    """``nn.Dense``: parameters in ``param_dtype`` (default ``dtype``),
    input, weight and bias cast to the compute ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, param_dtype=None):
        super().__init__(in_features, out_features, bias=bias, dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _weight_fingerprint(weight: torch.Tensor) -> torch.Tensor:
    """(sum, l1, sum of squares) of a weight in fp32: what an int8 cache
    remembers of the weights it was quantised from (``_kernel_fingerprint``).
    Weights that differ by a step or two of training can pass; different
    weight sets (a restore) move all three at O(1) relative."""
    wf = weight.detach().float()
    return torch.stack([wf.sum(), wf.abs().sum(), (wf * wf).sum()])


class _Int8Cache:
    """The int8 weight cache of a quantised module: the non-persistent
    buffers ``<name>_q`` (int8), ``<name>_scale`` and ``<name>_fp`` (the
    source fingerprint), None until :meth:`refresh_quant_cache_` runs. The
    subclass names its caches and their source weights in
    :meth:`_cache_sources`."""

    def _init_cache(self):
        for name in self._cache_sources():
            for part in ("q", "scale", "fp"):
                self.register_buffer(f"{name}_{part}", None, persistent=False)

    def _cache_sources(self) -> dict:
        raise NotImplementedError

    def refresh_quant_cache_(self):
        for name, source in self._cache_sources().items():
            w = source()
            q, scale = quant_ops.quantize_weight(w)
            setattr(self, f"{name}_q", q)
            setattr(self, f"{name}_scale", scale)
            setattr(self, f"{name}_fp", _weight_fingerprint(w))

    def clear_quant_cache_(self):
        for name in self._cache_sources():
            for part in ("q", "scale", "fp"):
                setattr(self, f"{name}_{part}", None)

    def _quantized(self, name: str):
        """(int8 weight, scale) from the cache, or quantised now without one."""
        q = getattr(self, f"{name}_q")
        if q is not None:
            return q, getattr(self, f"{name}_scale")
        return quant_ops.quantize_weight(self._cache_sources()[name]())


class Int8Linear(_Int8Cache, Linear):
    """:class:`Linear` through the W8A8 int8 product (``Int8Dense``): the same
    ``weight`` and ``bias`` (so a checkpoint of the exact path loads as it
    is); the input quantised per row, the weight per output channel, the
    int32 product rescaled in fp32, cast to the compute dtype, then the bias
    added in it. Inference only. The cache (``weight_q``, ``weight_scale``,
    ``weight_fp``) is built by ``ops/quant.refresh_quant_cache``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_cache()

    def _cache_sources(self) -> dict:
        return {"weight": lambda: self.weight}

    def forward(self, x):
        dt = self.compute_dtype
        y = quant_ops.int8_matmul_prequant(x, *self._quantized("weight")).to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class StaleQuantCacheError(ValueError):
    """The int8 weight cache was built from other weights than the live ones."""


def verify_quant_cache(model: nn.Module, rtol: float = 1e-5) -> None:
    """Raise :class:`StaleQuantCacheError` where a built int8 cache of
    ``model`` does not match the live weights: each cached fingerprint
    against one recomputed from them (one pass over the weights; run it once
    when a pipeline is built, not per call). Modules without a cache pass."""
    bad = []
    for name, module in model.named_modules():
        if not isinstance(module, _Int8Cache):
            continue
        for cache, source in module._cache_sources().items():
            cached = getattr(module, f"{cache}_fp")
            if cached is None:
                continue
            live = _weight_fingerprint(source()).double()
            if not bool(((cached.double() - live).abs()
                         <= rtol * live.abs().clamp(min=1.0)).all()):
                bad.append(f"{name}.{cache}_q: fingerprint mismatch")
    if bad:
        raise StaleQuantCacheError(
            f"int8 quant cache does not match the live weights ({len(bad)} entries — "
            f"{'; '.join(bad[:8])}). The cache was built from other weights (e.g. the random "
            "init before a checkpoint restore); serving it produces garbage. Rebuild it from "
            "the loaded weights with ops/quant.refresh_quant_cache.")


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _policy_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots``: keep what the matmuls give, recompute the rest.
    The attention forward is one opaque op here, as the Pallas call is to
    JAX, so it is recomputed."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _policy_attn(ctx, op, *args, **kwargs):
    """``save_only_these_names("attn_out", "attn_lse")``: keep the forward
    with logsumexp's (o, lse), so the recompute does not launch it again."""
    if op is torch.ops.deco_tpu_torch.flash_attention_fwd_lse.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {"full": None, "dots": _policy_dots, "attn": _policy_attn}


def run_checkpointed(fn, *args, enabled: bool, policy: str = "full"):
    """``fn(*args)``, recomputed in the backward when ``enabled`` and grad is
    on (``nn.remat``), keeping what the ``policy`` of :data:`REMAT_POLICIES`
    names. No block draws random numbers, so no RNG state is kept."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    select = REMAT_POLICIES[policy]
    if select is None:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(select))


def modulate(x, shift, scale):
    """adaLN modulation: x * (1 + scale) + shift."""
    return x * (1 + scale) + shift


class RMSNorm(nn.Module):
    """RMSNorm in fp32 with an fp32 weight, cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.weight * xf).to(x.dtype)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(epsilon, dtype)``: fp32 statistics (E[x^2] - E[x]^2,
    clipped at 0) and fp32 scale/bias, output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, affine: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
            self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.pow(2).mean(-1, keepdim=True) - mean.pow(2), min=0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class SwiGLU(_Int8Cache, nn.Module):
    """c2i SwiGLU (unfused w1/w3/w2) of width ``int(2 * hidden_dim / 3)``.

    ``quantize``: the int8 path, always fused as in the JAX package: one
    activation quantisation feeds the product with ``w13`` = concat(w1, w3)
    (its cache ``w13_q``, fingerprint that of the concatenation, the sum of
    the two), then ``w2`` (an :class:`Int8Linear`)."""

    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32, param_dtype=None,
                 quantize: bool = False):
        super().__init__()
        hidden = int(2 * hidden_dim / 3)
        kw = dict(bias=False, dtype=dtype, param_dtype=param_dtype)
        self.quantize = quantize
        self.dtype = dtype
        self.w1 = Linear(dim, hidden, **kw)
        self.w3 = Linear(dim, hidden, **kw)
        self.w2 = (Int8Linear if quantize else Linear)(hidden, dim, **kw)
        if quantize:
            self._init_cache()

    def _cache_sources(self) -> dict:
        return {"w13": lambda: torch.cat([self.w1.weight, self.w3.weight])} if self.quantize \
            else {}

    def forward(self, x):
        if self.quantize:
            h = quant_ops.int8_matmul_prequant(x, *self._quantized("w13")).to(self.dtype)
            h1, h3 = h.chunk(2, dim=-1)
            return self.w2(F.silu(h1) * h3)
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class SwiGLUFused(nn.Module):
    """SwiGLU of exact width ``hidden_dim`` (``SwiGLU(exact_hidden=True)``)
    with one fused input GEMM: ``w12`` is ``[w1; gate]``, (2 * hidden, dim),
    silu goes on its first half, and ``w3`` is the output projection; both
    :class:`Int8Linear` under ``quantize``."""

    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32, param_dtype=None,
                 quantize: bool = False):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, param_dtype=param_dtype)
        lin = Int8Linear if quantize else Linear
        self.w12 = lin(dim, 2 * hidden_dim, **kw)
        self.w3 = lin(hidden_dim, dim, **kw)

    def forward(self, x):
        h1, gate = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(h1) * gate)


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep embedding (cos before sin, ``max_period`` 10) + MLP."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 max_period: float = 10.0, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.max_period = max_period
        self.dtype = dtype
        self.mlp = nn.Sequential(
            Linear(frequency_embedding_size, hidden_size, dtype=dtype, param_dtype=param_dtype),
            nn.SiLU(),
            Linear(hidden_size, hidden_size, dtype=dtype, param_dtype=param_dtype),
        )

    def timestep_embedding(self, t, dim: int):
        half = dim // 2
        freqs = torch.exp(
            -math.log(self.max_period)
            * torch.arange(half, dtype=torch.float32, device=t.device) / half
        )
        args = t[..., None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
        return emb

    def forward(self, t):
        t_freq = self.timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(t_freq.to(self.dtype))


class Embed(nn.Module):
    """Linear patch/feature embed, then an :class:`RMSNorm` under ``norm``
    when ``use_norm``."""

    def __init__(self, in_dim: int, embed_dim: int, bias: bool = True, use_norm: bool = False,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.proj = Linear(in_dim, embed_dim, bias=bias, dtype=dtype, param_dtype=param_dtype)
        self.norm = RMSNorm(embed_dim) if use_norm else None

    def forward(self, x):
        x = self.proj(x)
        return x if self.norm is None else self.norm(x)


class LabelEmbedder(nn.Module):
    """Class-label table; ``num_classes`` rows (callers add the null class).
    The table is stored in ``param_dtype`` and the rows cast to ``dtype``."""

    def __init__(self, num_classes: int, hidden_size: int, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.embedding_table = nn.Embedding(num_classes, hidden_size, dtype=param_dtype or dtype)

    def forward(self, labels):
        return self.embedding_table(labels).to(self.dtype)


def precompute_rope_2d(dim: int, height: int, width: int,
                       theta: float = 10000.0, scale=16.0, extrapolate: bool = False):
    """Axial 2-D RoPE tables as float32 numpy (cos, sin), each (N, dim/2).

    Positions span [0, scale] on both axes; angle columns interleave x/y
    frequencies: [x_f0, y_f0, x_f1, y_f1, ...]. ``extrapolate`` gives the
    t2i tables, which grow with the grid: ``scale`` is (scale_h, scale_w)
    (a number means both), x spans [0, height * scale_h] over ``width``
    points and y [0, width * scale_w] over ``height`` points. The height
    sets the span of x and the width that of y, as in the JAX package.
    """
    if extrapolate:
        if isinstance(scale, (int, float)):
            scale = (float(scale), float(scale))
        x_pos = np.linspace(0, height * scale[0], width)
        y_pos = np.linspace(0, width * scale[1], height)
    else:
        x_pos = np.linspace(0, scale, width)
        y_pos = np.linspace(0, scale, height)
    y_grid, x_grid = np.meshgrid(y_pos, x_pos, indexing="ij")
    y_flat, x_flat = y_grid.reshape(-1), x_grid.reshape(-1)
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[: dim // 4] / dim))
    x_angles = np.outer(x_flat, freqs)
    y_angles = np.outer(y_flat, freqs)
    angles = np.stack([x_angles, y_angles], axis=-1).reshape(len(x_flat), -1)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rope(xq, xk, rope):
    """Rotate (even, odd) channel pairs of q/k, in their own dtype.

    xq, xk: (B, N, H, Hc); rope: (cos, sin) tensors, each (N, Hc/2).
    """
    cos, sin = rope
    cos = cos.to(xq.dtype)[None, :, None, :]
    sin = sin.to(xq.dtype)[None, :, None, :]

    def rot(x):
        even, odd = x[..., 0::2], x[..., 1::2]
        return torch.stack([even * cos - odd * sin, even * sin + odd * cos],
                           dim=-1).reshape(x.shape)

    return rot(xq), rot(xk)


def sdpa(q, k, v, mask=None, causal: bool = False, impl: str = "auto", extra_kv=None):
    """Attention dispatch. q: (B, Nq, H, Hc); k/v: (B, Nkv, H, Hc).

    Without a mask this is :func:`flash_attention` (the kernel on CUDA, its
    plain version on CPU), ``causal`` masking the keys past each query (the
    kernel's causal instantiation). Any other mask takes the plain version
    on CPU and raises on CUDA: no ported model passes one.

    ``extra_kv``: (k, v) of further tokens every query attends to (the t2i
    text), concatenated after k and v on the key axis. ``impl="ring"`` is
    ring attention over the current mesh's model axis
    (:func:`~deco_tpu_torch.parallel.ring_attention.ring_attention_local`),
    valid only inside the sequence-parallel trunk, whose tokens are split
    over that axis; the extra tokens stay replicated and their gradient
    sum is left to the model group's mean (``reduce_extra=False``). The
    ring is unmasked only.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "ring":
        if mask is not None or causal:
            raise ValueError("ring attention is unmasked only")
        from deco_tpu_torch.parallel import mesh as mesh_lib
        from deco_tpu_torch.parallel.ring_attention import ring_attention_local

        group = mesh_lib.axis_group(mesh_lib.current_mesh(), mesh_lib.MODEL_AXIS)
        return ring_attention_local(q, k, v, group=group, scale=scale, extra_kv=extra_kv,
                                    reduce_extra=False)
    if impl != "auto":
        raise ValueError(f"sdpa impl {impl!r}: expected 'auto' or 'ring'")
    if extra_kv is not None:
        k = torch.cat([k, extra_kv[0]], dim=1)
        v = torch.cat([v, extra_kv[1]], dim=1)
    if mask is None:
        return flash_attention(q, k, v, scale=scale, causal=causal)
    if q.is_cuda:
        raise NotImplementedError("masked attention has no CUDA kernel in the port")
    return flash_attention_plain(q, k, v, scale=scale, mask=mask, causal=causal)


class RAttention(nn.Module):
    """RoPE + qk-RMSNorm multi-head self-attention; ``rope=None`` (the t2i
    text-refine blocks) rotates nothing. ``quantize``: int8 ``qkv`` and
    ``proj`` (:class:`Int8Linear`); the attention stays bf16. ``forward``'s
    ``attn_impl`` goes to :func:`sdpa` ("ring": sequence-parallel)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, param_dtype=None,
                 quantize: bool = False):
        super().__init__()
        lin = Int8Linear if quantize else Linear
        self.num_heads = num_heads
        self.qkv = lin(dim, 3 * dim, bias=False, dtype=dtype, param_dtype=param_dtype)
        self.q_norm = RMSNorm(dim // num_heads)
        self.k_norm = RMSNorm(dim // num_heads)
        self.proj = lin(dim, dim, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x, rope, mask=None, causal: bool = False, attn_impl=None):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = self.q_norm(qkv[:, :, 0]), self.k_norm(qkv[:, :, 1]), qkv[:, :, 2]
        if rope is not None:
            q, k = apply_rope(q, k, rope)
        out = sdpa(q, k, v, mask=mask, causal=causal, impl=attn_impl or "auto")
        return self.proj(out.reshape(b, n, c))


class FlattenDiTBlock(nn.Module):
    """adaLN-gated DiT block: RAttention + SwiGLU; ``quantize`` makes their
    products int8 (adaLN stays bf16); ``forward``'s ``attn_impl`` as :class:`RAttention`'s."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, param_dtype=None, quantize: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.adaLN_modulation = nn.Sequential(Linear(hidden, 6 * hidden, **kw))
        self.norm1 = RMSNorm(hidden)
        self.attn = RAttention(hidden, num_heads, **kw, quantize=quantize)
        self.norm2 = RMSNorm(hidden)
        self.mlp = SwiGLU(hidden, int(hidden * mlp_ratio), **kw, quantize=quantize)

    def forward(self, x, c, rope, mask=None, attn_impl=None):
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        h = modulate(self.norm1(x), shift_msa, scale_msa)
        x = x + gate_msa * self.attn(h, rope, mask, attn_impl=attn_impl)
        h = modulate(self.norm2(x), shift_mlp, scale_mlp)
        return x + gate_mlp * self.mlp(h)


class JointAttention(nn.Module):
    """t2i attention: image queries over concat(image k/v, text k/v).

    ``qkv_x`` projects the image tokens and ``kv_y`` the text tokens (no
    bias on either); one ``k_norm`` normalises both keys; RoPE rotates the
    image q and k only; the text keys and values follow the image ones on
    the key axis (the JAX ``sdpa(..., extra_kv=...)`` concatenation), so
    Nkv = N + M. ``quantize``: the three projections are :class:`Int8Linear`.
    ``forward``'s ``attn_impl="ring"``: the image keys ride
    the ring and the text keys seed every rank's accumulator
    (:func:`sdpa`'s ``extra_kv``).
    """

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, param_dtype=None,
                 quantize: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        lin = Int8Linear if quantize else Linear
        self.num_heads = num_heads
        self.qkv_x = lin(dim, 3 * dim, bias=False, **kw)
        self.kv_y = lin(dim, 2 * dim, bias=False, **kw)
        self.q_norm = RMSNorm(dim // num_heads)
        self.k_norm = RMSNorm(dim // num_heads)
        self.proj = lin(dim, dim, **kw)

    def forward(self, x, y, rope, attn_impl=None):
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qkv = self.qkv_x(x).reshape(b, n, 3, self.num_heads, head_dim)
        q, kx, vx = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q, kx = apply_rope(self.q_norm(q), self.k_norm(kx), rope)
        kv = self.kv_y(y).reshape(b, y.shape[1], 2, self.num_heads, head_dim)
        ky, vy = self.k_norm(kv[:, :, 0]), kv[:, :, 1]
        out = sdpa(q, kx, vx, impl=attn_impl or "auto", extra_kv=(ky, vy))
        return self.proj(out.reshape(b, n, c))


class _T2IBlock(nn.Module):
    """adaLN-gated t2i block: ``attn`` (built by the subclass) and the fused
    SwiGLU of exact width ``hidden * mlp_ratio``."""

    def __init__(self, hidden: int, attn: nn.Module, mlp_ratio: float = 4.0,
                 dtype=torch.float32, param_dtype=None, quantize: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.adaLN_modulation = nn.Sequential(Linear(hidden, 6 * hidden, **kw))
        self.norm1 = RMSNorm(hidden)
        self.attn = attn
        self.norm2 = RMSNorm(hidden)
        self.mlp = SwiGLUFused(hidden, int(hidden * mlp_ratio), **kw, quantize=quantize)

    def _forward(self, x, c, *attn_args):
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + gate_msa * self.attn(modulate(self.norm1(x), shift_msa, scale_msa), *attn_args)
        return x + gate_mlp * self.mlp(modulate(self.norm2(x), shift_mlp, scale_mlp))


class JointDiTBlock(_T2IBlock):
    """t2i encoder block: :class:`JointAttention` + fused SwiGLU (both int8
    under ``quantize``); ``forward``'s ``attn_impl`` as :class:`JointAttention`'s."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, param_dtype=None, quantize: bool = False):
        super().__init__(hidden, JointAttention(hidden, num_heads, dtype, param_dtype, quantize),
                         mlp_ratio, dtype, param_dtype, quantize)

    def forward(self, x, y, c, rope, attn_impl=None):
        """x: (B, N, C) image tokens; y: (B, M, C) text tokens; c: (B, 1, C)."""
        return self._forward(x, c, y, rope, attn_impl)


class TextRefineBlock(_T2IBlock):
    """Text self-attention refinement block: :class:`RAttention` without
    RoPE (the JAX block's flat ``attn_*`` parameters, under ``attn.``) +
    fused SwiGLU."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, param_dtype=None, quantize: bool = False):
        super().__init__(hidden, RAttention(hidden, num_heads, dtype, param_dtype, quantize),
                         mlp_ratio, dtype, param_dtype, quantize)

    def forward(self, x, c):
        """x: (B, M, C) text tokens; c: (B, 1, C)."""
        return self._forward(x, c, None)


def nerf_dct_basis(patch_size: int, max_freqs: int) -> np.ndarray:
    """Per-pixel 2-D DCT positional features, (patch_size**2, max_freqs**2)."""
    pos = np.linspace(0, 1, patch_size)
    y_grid, x_grid = np.meshgrid(pos, pos, indexing="ij")
    x_flat = x_grid.reshape(-1, 1, 1)
    y_flat = y_grid.reshape(-1, 1, 1)
    freqs = np.linspace(0, max_freqs, max_freqs)
    fx = freqs[None, :, None]
    fy = freqs[None, None, :]
    coeffs = (1 + fx * fy) ** -1
    dct = np.cos(x_flat * fx * np.pi) * np.cos(y_flat * fy * np.pi) * coeffs
    return dct.reshape(patch_size**2, max_freqs**2).astype(np.float32)


class NerfEmbedder(nn.Module):
    """Concatenate the per-pixel DCT basis, then a linear embed.

    Input (..., P^2, C) per-patch pixels; output (..., P^2, hidden).
    """

    def __init__(self, in_channels: int, hidden_size: int, patch_size: int,
                 max_freqs: int = 8, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer(
            "basis", torch.from_numpy(nerf_dct_basis(patch_size, max_freqs)),
            persistent=False,
        )
        self.embedder = nn.Sequential(
            Linear(in_channels + max_freqs**2, hidden_size, dtype=dtype, param_dtype=param_dtype))

    def forward(self, x):
        basis = self.basis.to(self.dtype).expand(x.shape[:-1] + self.basis.shape[-1:])
        return self.embedder(torch.cat([x.to(self.dtype), basis], dim=-1))


class AdaLNResBlock(nn.Module):
    """Pixel-decoder res block with a per-pixel adaLN condition ``y``."""

    def __init__(self, channels: int, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.in_ln = LayerNorm(channels, eps=1e-6, dtype=dtype)
        self.mlp = nn.Sequential(
            Linear(channels, channels, **kw),
            nn.SiLU(),
            Linear(channels, channels, **kw),
        )
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(channels, 3 * channels, **kw))
        nn.init.zeros_(self.adaLN_modulation[1].weight)
        nn.init.zeros_(self.adaLN_modulation[1].bias)

    def forward(self, x, y):
        shift, scale, gate = self.adaLN_modulation(y).chunk(3, dim=-1)
        h = self.mlp(modulate(self.in_ln(x), shift, scale))
        return x + gate * h


class FinalLayer(nn.Module):
    """A parameter-free LayerNorm and a zero-initialised linear: the pixel
    decoder's final layer, and with ``modulated`` the DiT's adaLN one
    (``layers.FinalLayer``), whose zero-initialised ``adaLN_modulation``
    maps the condition ``c`` to a shift and a scale of the normed tokens."""

    def __init__(self, channels: int, out_channels: int, dtype=torch.float32,
                 param_dtype=None, modulated: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.adaLN_modulation = None
        if modulated:
            self.adaLN_modulation = nn.Sequential(Linear(channels, 2 * channels, **kw))
            nn.init.zeros_(self.adaLN_modulation[0].weight)
        self.norm_final = LayerNorm(channels, eps=1e-6, affine=False, dtype=dtype)
        self.linear = Linear(channels, out_channels, **kw)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x, c=None):
        x = self.norm_final(x)
        if self.adaLN_modulation is not None:
            shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
            x = modulate(x, shift, scale)
        return self.linear(x)


class SimpleMLPAdaLN(nn.Module):
    """DeCo per-patch pixel decoder.

    x: (B, L, P^2, C_in) per-pixel features; z: (B, L, z_channels) patch
    conditions. ``cond_embed`` turns each patch token into P^2 per-pixel
    conditions, so every pixel gets its own modulation. ``grad_checkpoint``
    recomputes each res block in the backward.
    """

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 z_channels: int, num_res_blocks: int, patch_size: int,
                 dtype=torch.float32, param_dtype=None, grad_checkpoint: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.model_channels = model_channels
        self.patch_size = patch_size
        self.grad_checkpoint = grad_checkpoint
        self.input_proj = Linear(in_channels, model_channels, **kw)
        self.cond_embed = Linear(z_channels, patch_size**2 * model_channels, **kw)
        self.res_blocks = nn.ModuleList(
            AdaLNResBlock(model_channels, **kw) for _ in range(num_res_blocks))
        self.final_layer = FinalLayer(model_channels, out_channels, **kw)

    def forward(self, x, z, block_checkpoint: bool | None = None):
        """``block_checkpoint`` (default ``grad_checkpoint``) recomputes each
        res block in the backward."""
        if block_checkpoint is None:
            block_checkpoint = self.grad_checkpoint
        x = self.input_proj(x)
        c = self.cond_embed(z)
        y = c.reshape(c.shape[:-1] + (self.patch_size**2, self.model_channels))
        for block in self.res_blocks:
            x = run_checkpointed(block, x, y, enabled=block_checkpoint)
        return self.final_layer(x)


def run_pixel_decoder(dec: SimpleMLPAdaLN, x_pix, s, decoder_chunks: int = 0):
    """``dec`` over per-patch pixels ``x_pix`` (B, L, P^2, C) with patch
    conditions ``s`` (B, L, z), optionally in chunks (``layers.run_pixel_decoder``).

    ``decoder_chunks > 1`` runs ``dec`` over L / decoder_chunks patches at a
    time, each chunk recomputed whole in the backward (the inner per-block
    remat off), so the per-pixel intermediates, the 512 px training memory
    peak, live for one chunk at a time. Every patch is decoded on its own,
    so chunked and unchunked runs compute the same values with the same
    parameters.
    """
    n = x_pix.shape[1]
    if decoder_chunks > 1 and n % decoder_chunks:
        raise ValueError(
            f"decoder_chunks={decoder_chunks} does not divide the {n}-patch grid; pick a "
            f"divisor of L (the knob bounds the 512px+ decoder memory peak; silently "
            f"falling back would bring back the peak it prevents)")
    if decoder_chunks <= 1:
        return dec(x_pix, s)
    size = n // decoder_chunks
    outs = [run_checkpointed(dec, x_pix[:, i:i + size], s[:, i:i + size], False, enabled=True)
            for i in range(0, n, size)]
    return torch.cat(outs, dim=1)


class NerfBlock(nn.Module):
    """PixNerd's hyper-network pixel-decoder block (``layers.NerfBlock``).

    ``param_generator1`` turns each patch token ``s`` (B, L, cond) into that
    patch's MLP weights, fc1 (hidden_x, hidden_x * mlp_ratio) and fc2
    (hidden_x * mlp_ratio, hidden_x); the columns of fc1, and of fc2 with
    ``normalize_fc2`` (the c2i variant), are L2-normalised in fp32 with a
    1e-12 floor. The pixels x (B, L, P^2, hidden_x) then pass RMSNorm, fc1,
    SiLU and fc2, plus the residual: two batched products per patch.
    """

    def __init__(self, hidden_x: int, cond_dim: int, mlp_ratio: int = 4,
                 normalize_fc2: bool = False, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.hidden_x = hidden_x
        self.mlp_ratio = mlp_ratio
        self.normalize_fc2 = normalize_fc2
        self.param_generator1 = nn.Sequential(
            Linear(cond_dim, 2 * hidden_x * hidden_x * mlp_ratio, dtype=dtype,
                   param_dtype=param_dtype))
        self.norm = RMSNorm(hidden_x)

    @staticmethod
    def _unit_columns(w):
        norm = torch.linalg.vector_norm(w.float(), dim=-2, keepdim=True)
        return w / torch.clamp(norm, min=1e-12).to(w.dtype)

    def forward(self, x, s):
        hx, wide = self.hidden_x, self.hidden_x * self.mlp_ratio
        fc1, fc2 = self.param_generator1(s).chunk(2, dim=-1)
        fc1 = self._unit_columns(fc1.reshape(fc1.shape[:-1] + (hx, wide)))
        fc2 = fc2.reshape(fc2.shape[:-1] + (wide, hx))
        if self.normalize_fc2:
            fc2 = self._unit_columns(fc2)
        h = torch.matmul(F.silu(torch.matmul(self.norm(x), fc1)), fc2)
        return h + x
