"""W8A8 int8 matmuls for the DiT trunks, the opt-in serving mode
(``deco_tpu/ops/quant.py``).

Standard W8A8 post-training quantisation, as in the JAX package:

- weights: symmetric per-output-channel scale (amax / 127 over the
  reduction axis). A torch ``weight`` is (N, K), so the scale is taken over
  dim 1 and the int8 weight is kept (N, K) contiguous; the product reads its
  transpose, the column-major (K, N) operand the int8 GEMM takes;
- activations: symmetric per-row dynamic scale, recomputed at every call;
- the product accumulates in int32 (``torch._int_mm``, the library's int8
  GEMM: the JAX package's is XLA's ``dot_general`` with an int32 result, no
  Pallas kernel), and is rescaled in fp32 as ``acc * x_scale * w_scale``.

The mode is opt-in (``quantize="int8"`` on ``DeCoC2I``, ``DeCoT2I`` and
``PixNerdT2I``, or ``DECO_QUANT=int8`` when the model is built) and
inference-only. :func:`refresh_quant_cache` quantises a model's trunk
weights once, into non-persistent buffers of the quantised modules
(``models/layers.py``), so a sampler loop does not re-read the bf16 weights
at every step; without it the weights are quantised at every call.

Departures from the JAX package: the cache lives in buffers that no
``state_dict`` holds, where JAX keeps a ``quant`` variable collection; the
environment override is read when the model is built, where JAX reads it at
every apply; and :func:`int8_mm` pads a product of 16 rows or fewer with
zero rows (cut off after), since CUDA's int8 GEMM refuses such shapes. The
result is the same: the padded rows never meet the real ones.
"""

from __future__ import annotations

import contextlib
import os

import torch

from deco_tpu_torch.utils.profiling import annotate

_EPS = 1e-8
# CUDA's int8 GEMM takes more than 16 rows and reductions and outputs in
# multiples of 8
_MIN_ROWS = 16
_PAD_ROWS = 32


def env_quant_mode():
    """``DECO_QUANT``: "int8" forces the quantised trunk on; unset or empty
    is the exact path, and any other value raises, so a typo (``INT8``,
    ``int4``) never serves the exact path believing it is quantised."""
    mode = os.environ.get("DECO_QUANT")
    if mode in (None, ""):
        return None
    if mode != "int8":
        raise ValueError(f"DECO_QUANT={mode!r}: the only supported mode is 'int8' "
                         "(unset it or leave it empty for the exact bf16 path)")
    return mode


def resolve_mode(quantize) -> bool:
    """Whether a model built with ``quantize`` runs the int8 trunk: the
    field, else the environment. A mode other than None, "" or "int8"
    raises."""
    if quantize not in (None, "", "int8"):
        raise ValueError(f"quantize={quantize!r}: expected None or 'int8'")
    return (quantize or env_quant_mode()) == "int8"


def model_quant_active(model) -> bool:
    """Whether ``model`` resolves to the int8 trunk (field or env override)."""
    return (getattr(model, "quantize", None) or env_quant_mode()) == "int8"


def quant_modules(model):
    """The modules of ``model`` that hold an int8 weight cache."""
    return [m for m in model.modules()
            if hasattr(m, "refresh_quant_cache_") and m._cache_sources()]


def refresh_quant_cache(model):
    """(Re)build every int8 weight cache of ``model`` from its current
    weights, in place; returns ``model``. Call it after any weight load: a
    cache quantised from other weights (say, the random init before a
    checkpoint restore) serves garbage, which
    :func:`~deco_tpu_torch.models.layers.verify_quant_cache` detects. A
    model without quantised modules is left as it is."""
    with torch.no_grad():
        for module in quant_modules(model):
            module.refresh_quant_cache_()
    return model


def clear_quant_cache(model):
    """Drop every int8 weight cache of ``model`` (the modules then quantise
    their weights at each call); returns ``model``."""
    for module in quant_modules(model):
        module.clear_quant_cache_()
    return model


def _range(name: str):
    """A profiler range around the quantisation and the rescale, only while
    a profiler records (the trunk runs 4 products a block a call)."""
    return annotate(name) if torch._C._autograd._profiler_enabled() else contextlib.nullcontext()


def quantize_rowwise(x: torch.Tensor):
    """Symmetric per-row int8 quantisation over the last dim: (q int8,
    scale fp32 with a trailing keepdim axis)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, _EPS)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(weight: torch.Tensor):
    """Symmetric per-output-channel int8 quantisation of an (N, K) weight:
    (q (N, K) int8 contiguous, scale (N,) fp32)."""
    q, scale = quantize_rowwise(weight.detach())
    return q.contiguous(), scale.reshape(-1)


def int8_mm(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``a @ wq.T`` in int32 for int8 ``a`` (M, K) and ``wq`` (N, K), through
    ``torch._int_mm``. At most 16 rows are padded with zero rows, which are
    cut off after. On CUDA a K or N that is not a multiple of 8 raises (no
    shipped config has one): nothing routes an int8 product to a float one.
    Each CUDA call counts one in ``int8_mm.launches``."""
    m, k = a.shape
    n = wq.shape[0]
    if a.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"int8 GEMM of ({m}, {k}) x ({k}, {n}): CUDA's int8 GEMM needs K "
                             "and N in multiples of 8")
        int8_mm.launches += 1
    if m <= _MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_PAD_ROWS - m, k)])
    return torch._int_mm(a, wq.t())[:m]


int8_mm.launches = 0


def int8_matmul_prequant(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(wq, ws).T`` in fp32 for x (..., K) and a quantised (N, K)
    weight: the activation quantised per row, the int32 product, then
    ``acc * x_scale * w_scale`` in that order (the JAX package's)."""
    with _range("int8_quantize"):
        xq, xs = quantize_rowwise(x)
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq)
    with _range("int8_rescale"):
        return acc.float().reshape(*x.shape[:-1], -1) * xs * ws


def int8_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` through int8 with the (N, K) weight quantised on the
    fly; fp32 out. No gradient: the int8 path serves, it does not train."""
    return int8_matmul_prequant(x, *quantize_weight(weight))
