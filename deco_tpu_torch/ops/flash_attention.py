"""Flash attention, forward and backward: the Hopper kernels and their plain
PyTorch versions.

Counterpart of ``deco_tpu/ops/flash_attention.py`` (``flash_attention``
:631 -> ``_flash_core``, a ``jax.custom_vjp`` over ``_flash_fwd``,
``_flash_core_fwd`` and ``_flash_core_bwd``). :func:`flash_attention` takes
(B, N, H, D) operands as the JAX function does:

- under autograd (grad enabled and an input that requires grad) it runs
  :class:`FlashAttention`, whose forward is the forward-with-logsumexp
  (:func:`flash_attention_fwd_lse`, ``csrc/flash_attention_fwd.cu``) and
  whose backward is the dQ kernel, which also computes delta = rowsum(dO * O)
  (XLA in the JAX package), then the dK/dV kernel
  (``csrc/flash_attention_bwd.cu``);
- otherwise, as in sampling, it launches the plain forward kernel, with no
  logsumexp work: for bf16 operands the tensor-core kernel, for fp32
  operands (the frozen DINOv2 tower of the REPA objectives, D = 64; the
  DC-AE's attention, D = 32) the fp32 kernel (:func:`flash_attention_fwd_f32`,
  3xTF32 on the tensor cores), forward only: fp32 under autograd raises.

The autograd Function reaches the forward with logsumexp through the custom
op :data:`flash_attention_fwd_lse_op` (``deco_tpu_torch::flash_attention_fwd_lse``),
so a selective-checkpoint policy can name it and keep its (o, lse): the
counterpart of the ``attn_out``/``attn_lse`` ``checkpoint_name`` tags in
``_flash_core_fwd``.

The kernels read the operands in place through their strides (no fold to
(B*H, N, D)) and mask ragged N themselves, so unlike the JAX wrapper they
need no detour to a library call when N is not a multiple of 8. Every
wrapper runs its plain version on CPU tensors and launches its kernel, or
raises, on CUDA tensors; each counts its launches in ``.launches``.

``causal=True`` masks every key past its query (Nq = Nkv), the function
``jax.nn.dot_product_attention(mask=tril)`` computes for UniFlow's
semantic blocks, where the JAX package takes XLA: the forward, the forward
with lse and both backward kernels take it as a template flag at
``CAUSAL_HEAD_DIMS``, and count its launches in ``.causal_launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deco_tpu_torch.ops import _build

SUPPORTED_HEAD_DIMS = (32, 64, 72, 128)
F32_HEAD_DIMS = (32, 64)  # the fp32 forward
CAUSAL_HEAD_DIMS = (64,)  # the causal instantiations, bf16
_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y, which spans B*H


def causal_mask(n_q: int, n_kv: int, device=None):
    """(Nq, Nkv) bool, True where key <= query: ``jnp.tril(ones)``."""
    return torch.ones(n_q, n_kv, dtype=torch.bool, device=device).tril()


def _logits(q, k, scale, causal: bool = False):
    """fp32 scale * q k^T, (B, H, Nq, Nkv); with ``causal`` the keys past
    each query at -inf."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        logits = logits.masked_fill(~causal_mask(q.shape[1], k.shape[1], q.device), -math.inf)
    return logits


def flash_attention_plain(q, k, v, scale: float | None = None, mask=None, causal: bool = False):
    """softmax(scale * q k^T) v with fp32 logits and softmax; any device.

    q: (B, Nq, H, D); k, v: (B, Nkv, H, D); ``mask`` (broadcastable to
    (B, H, Nq, Nkv), True = attend) as in ``sdpa(impl="einsum")``;
    ``causal`` masks the keys past each query. The probabilities are rounded
    to v's dtype before the product with v.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _logits(q, k, scale, causal)
    if mask is not None:
        logits = logits.masked_fill(~mask.bool(), torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_fwd_lse_plain(q, k, v, scale: float, causal: bool = False):
    """(o, lse): the output as :func:`flash_attention_plain` and the fp32
    logsumexp of the scaled logits, (B, H, Nq) (``_fwd_kernel_lse``)."""
    logits = _logits(q, k, scale, causal)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def attention_delta(o, do):
    """delta = rowsum(dO * O) in fp32, (B, H, Nq) contiguous (``_flash_core_bwd``
    :623, XLA in the JAX package); the plain version of the dQ kernel's prologue."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, do, lse, delta, scale, causal=False):
    """fp32 (P, dS), each (B, H, Nq, Nkv), from the saved lse and delta."""
    p = torch.exp(_logits(q, k, scale, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale: float, causal: bool = False):
    """(dQ, delta): dQ = scale * dS K in fp32, returned in q's dtype
    (``_bwd_dq_kernel``), and the delta it used (:func:`attention_delta`)."""
    delta = attention_delta(o, do)
    _, ds = _bwd_probs(q, k, v, do, lse, delta, scale, causal)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype), delta


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float,
                                  causal: bool = False):
    """(dK, dV) = (scale * dS^T Q, P^T dO) in fp32, returned in k's and v's
    dtypes (``_bwd_dkv_kernel``)."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, scale, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float, causal: bool = False):
    """(dQ, dK, dV), the counterpart of ``_flash_core_bwd_xla`` (:592-609)."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale, causal)
    return (dq, *flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal))


def _readable_in_place(x) -> bool:
    """A contiguous head dim, 16-byte aligned rows and base."""
    return x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3]) and not x.data_ptr() % 16


def _check_operand(name, x, dtype=torch.bfloat16) -> None:
    if x.dtype != dtype:
        need = str(dtype).removeprefix("torch.")
        raise TypeError(f"flash_attention kernel: {name} is {x.dtype}, needs {need}")
    if x.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be (B, N, H, D), got {tuple(x.shape)}")
    if not _readable_in_place(x):
        raise ValueError(
            f"flash_attention kernel: {name} needs a contiguous head dim, "
            f"strides that are multiples of 8 and a 16-byte aligned base "
            f"(strides {x.stride()}); pass x.contiguous()"
        )


def _check_kernel_args(q, k, v, do=None, dtype=torch.bfloat16, causal: bool = False) -> None:
    """Raise for operands the CUDA kernels do not take."""
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if x is not None:
            _check_operand(name, x, dtype)
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not agree"
        )
    if do is not None and do.shape != q.shape:
        raise ValueError(f"flash_attention: do {tuple(do.shape)} is not q's shape")
    dims = F32_HEAD_DIMS if dtype == torch.float32 else SUPPORTED_HEAD_DIMS
    if causal:
        dims = CAUSAL_HEAD_DIMS
        if q.shape[1] != k.shape[1]:
            raise ValueError(f"flash_attention kernel: causal needs Nq = Nkv, got {q.shape[1]} "
                             f"and {k.shape[1]}")
    if d not in dims:
        raise ValueError(f"flash_attention kernel: head dim {d} not in {dims} for {dtype}"
                         + (" (causal)" if causal else ""))
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"flash_attention kernel: B*H = {b * h} > {_MAX_GRID_Y}")
    devices = {x.device for x in (q, k, v, do) if x is not None}
    if len(devices) != 1:
        raise ValueError("flash_attention: operands must be on one CUDA device")


def _check_stats(q, *stats) -> None:
    b, nq, h, _ = q.shape
    for x in stats:
        if x.dtype != torch.float32 or tuple(x.shape) != (b, h, nq) or not x.is_contiguous():
            raise ValueError(
                f"flash_attention backward: lse/delta must be fp32 contiguous "
                f"{(b, h, nq)}, got {x.dtype} {tuple(x.shape)}")


def _fn(source: str, symbol: str, argtypes):
    lib = _build.load(source)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [_P] * 4 + [_I] * 5 + [_LL] * 12 + [ctypes.c_float, _I, _P]


def _strides(*xs):
    return [s for x in xs for s in x.stride()[:3]]


def _run_fwd(q, k, v, scale, with_lse: bool, causal: bool = False):
    """(o, lse or None) from the forward kernel (the fp32 one for fp32
    operands); q/k/v already checked."""
    if not scale > 0:
        raise ValueError(f"flash_attention kernel: scale must be positive, got {scale}")
    b, n_q, h, d = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
    lse = None
    if q.dtype == torch.float32:
        lib, fn = _fn("flash_attention_fwd", "deco_flash_attention_fwd_f32", _FWD_ARGS)
    elif with_lse:
        lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
        lib, fn = _fn("flash_attention_fwd", "deco_flash_attention_fwd_lse", [_P] + _FWD_ARGS)
        ptrs.append(lse.data_ptr())
    else:
        lib, fn = _fn("flash_attention_fwd", "deco_flash_attention_fwd", _FWD_ARGS)
    with torch.cuda.device(q.device):
        err = fn(*ptrs, b, h, n_q, k.shape[1], d, *_strides(q, k, v, o), float(scale),
                 int(causal), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    return o, lse


def _count(fn, causal: bool) -> None:
    if causal:
        fn.causal_launches += 1
    else:
        fn.launches += 1


def flash_attention_fwd_lse(q, k, v, scale: float, causal: bool = False):
    """(o, lse) of the forward with logsumexp; lse is fp32 (B, H, Nq).

    CPU tensors take :func:`flash_attention_fwd_lse_plain`; CUDA tensors
    launch the kernel's LSE instantiation or raise.
    """
    if not q.is_cuda:
        return flash_attention_fwd_lse_plain(q, k, v, scale, causal)
    if q.dtype == torch.float32:
        raise TypeError("flash_attention: fp32 operands have a forward kernel only (the frozen "
                        "encoder's); no forward with lse and no backward")
    _check_kernel_args(q, k, v, causal=causal)
    o, lse = _run_fwd(q, k, v, scale, with_lse=True, causal=causal)
    _count(flash_attention_fwd_lse, causal)
    return o, lse


def _bwd_args(q, k, v, do, *stats, causal=False):
    _check_kernel_args(q, k, v, do, causal=causal)
    _check_stats(q, *stats)
    b, n_q, h, d = q.shape
    return b, h, n_q, k.shape[1], d


def flash_attention_bwd_dq(q, k, v, o, lse, do, scale: float, causal: bool = False):
    """(dQ, delta): dQ (B, Nq, H, D) in q's dtype and delta = rowsum(dO * O),
    fp32 (B, H, Nq), which the dK/dV kernel reads. CPU tensors take
    :func:`flash_attention_bwd_dq_plain`; CUDA tensors launch the kernel,
    which computes delta in its prologue, or raise."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale, causal)
    dims = _bwd_args(q, k, v, do, lse, causal=causal)
    _check_operand("o", o)
    if o.shape != q.shape or o.device != q.device:
        raise ValueError(f"flash_attention: o {tuple(o.shape)} is not q's shape or device")
    b, h, n_q = dims[:3]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    lib, fn = _fn("flash_attention_bwd", "deco_flash_attention_bwd_dq",
                  [_P] * 8 + [_I] * 5 + [_P, ctypes.c_float, _I, _P])
    strides = (ctypes.c_longlong * 18)(*_strides(q, k, v, do, o, dq))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims, strides,
                 float(scale), int(causal), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_bwd_dq launch")
    _count(flash_attention_bwd_dq, causal)
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool = False):
    """(dK, dV), each (B, Nkv, H, D). CPU tensors take
    :func:`flash_attention_bwd_dkv_plain`; CUDA tensors launch the kernel or raise."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    dims = _bwd_args(q, k, v, do, lse, delta, causal=causal)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    lib, fn = _fn("flash_attention_bwd", "deco_flash_attention_bwd_dkv",
                  [_P] * 8 + [_I] * 5 + [_P, ctypes.c_float, _I, _P])
    strides = (ctypes.c_longlong * 18)(*_strides(q, k, v, do, dk, dv))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims, strides,
                 float(scale), int(causal), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_bwd_dkv launch")
    _count(flash_attention_bwd_dkv, causal)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale: float, causal: bool = False):
    """(dQ, dK, dV): the dQ wrapper, which also gives delta, then the dK/dV
    wrapper, on the same stream."""
    if do.is_cuda and not _readable_in_place(do):
        do = do.contiguous()  # autograd may hand back a gradient of any layout
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, scale, causal)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal))


def forward_kernel_info(head_dim: int) -> dict:
    """What the current card makes of the forward kernels built for
    ``head_dim`` (:func:`_build.kernel_info`): the bf16 kernel's two
    instantiations where D is in ``SUPPORTED_HEAD_DIMS``, their causal ones
    where it is in ``CAUSAL_HEAD_DIMS``, the fp32 kernel where it is in
    ``F32_HEAD_DIMS``."""
    kinds = {0: "flash_fwd_kernel", 1: "flash_fwd_kernel_lse"} if (
        head_dim in SUPPORTED_HEAD_DIMS) else {}
    if head_dim in F32_HEAD_DIMS:
        kinds[2] = "flash_fwd_f32_kernel"
    if head_dim in CAUSAL_HEAD_DIMS:
        kinds.update({3: "flash_fwd_kernel_causal", 4: "flash_fwd_kernel_lse_causal"})
    return {name: _build.kernel_info("flash_attention_fwd", "deco_flash_attention_fwd_info",
                                     kind, head_dim)
            for kind, name in kinds.items()}


def backward_kernel_info(head_dim: int) -> dict:
    """What the current card makes of the dQ and dK/dV kernels at ``head_dim``
    (:func:`_build.kernel_info`), and of their causal instantiations where
    it is in ``CAUSAL_HEAD_DIMS``."""
    names = ["flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"]
    if head_dim in CAUSAL_HEAD_DIMS:
        names += ["flash_bwd_dq_kernel_causal", "flash_bwd_dkv_kernel_causal"]
    return {name: _build.kernel_info("flash_attention_bwd", "deco_flash_attention_bwd_info",
                                     kind, head_dim)
            for kind, name in enumerate(names)}


@torch.library.custom_op("deco_tpu_torch::flash_attention_fwd_lse", mutates_args=())
def flash_attention_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float, causal: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd_lse` as one operator that dispatch (and so a
    selective-checkpoint policy) sees whole."""
    return flash_attention_fwd_lse(q, k, v, scale, causal)


@flash_attention_fwd_lse_op.register_fake
def _(q, k, v, scale, causal=False):
    b, n_q, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, n_q), dtype=torch.float32))


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward (``_flash_core``'s custom VJP).

    The forward saves (q, k, v, o, lse) as ``_flash_core_fwd`` does; the
    backward recomputes P from lse. CPU tensors run the plain versions.
    """

    @staticmethod
    def forward(ctx, q, k, v, scale, causal=False):
        o, lse = flash_attention_fwd_lse_op(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do, ctx.scale, ctx.causal), None, None)


def flash_attention_fwd_f32(q, k, v, scale: float):
    """The forward of fp32 operands, (B, Nq, H, D) fp32 with D in
    ``F32_HEAD_DIMS``. CPU tensors take :func:`flash_attention_plain`; CUDA
    tensors launch the fp32 kernel or raise."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    _check_kernel_args(q, k, v, dtype=torch.float32)
    if q.shape[1] == 0:
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    o, _ = _run_fwd(q, k, v, scale, with_lse=False)
    flash_attention_fwd_f32.launches += 1
    return o


def flash_attention(q, k, v, scale: float | None = None, causal: bool = False):
    """Attention. q: (B, Nq, H, D); k, v: (B, Nkv, H, D); ``causal`` masks
    the keys past each query (Nq = Nkv, bf16 at D in ``CAUSAL_HEAD_DIMS`` on
    the card).

    Returns (B, Nq, H, D) in q's dtype. Under autograd this is
    :class:`FlashAttention` (bf16 on the card); otherwise CPU tensors take
    :func:`flash_attention_plain` and CUDA tensors launch the forward kernel
    (bf16 with D in ``SUPPORTED_HEAD_DIMS``, or fp32 with D in
    ``F32_HEAD_DIMS`` through :func:`flash_attention_fwd_f32`) or raise.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, causal)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale, causal=causal)
    if q.dtype == torch.float32:
        if causal:
            raise ValueError("flash_attention: the fp32 kernel has no causal instantiation")
        return flash_attention_fwd_f32(q, k, v, scale)
    _check_kernel_args(q, k, v, causal=causal)
    if q.shape[1] == 0:
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    o, _ = _run_fwd(q, k, v, scale, with_lse=False, causal=causal)
    _count(flash_attention, causal)
    return o


# kernel launches since the last reset, one count per kernel (the causal
# instantiations in .causal_launches)
flash_attention.launches = 0
flash_attention_fwd_f32.launches = 0
flash_attention_fwd_lse.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention.causal_launches = 0
flash_attention_fwd_lse.causal_launches = 0
flash_attention_bwd_dq.causal_launches = 0
flash_attention_bwd_dkv.causal_launches = 0
