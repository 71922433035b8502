"""8x8 block-DCT ops for the DeCo frequency loss, and its Hopper kernel.

Counterpart of ``deco_tpu/ops/block_dct.py``: the orthonormal 8x8 DCT-II
matrix, RGB->YCbCr, the blockwise DCT and its inverse, the JPEG-derived
frequency weights, and :func:`frequency_weighted_mse`, an autograd Function
whose forward is ``csrc/freq_mse.cu`` on CUDA (the counterpart of the Pallas
``_freq_mse_kernel``) and :func:`frequency_weighted_mse_plain` on the CPU,
and whose backward is ``_fwm_bwd`` in torch ops (XLA in the JAX package):
grad = 2/N * YCbCr^T(IDCT(w o F)). The numpy helpers are the port's own
copies; nothing here imports the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from deco_tpu_torch.ops import _build

BLOCK = 8

# RGB -> YCbCr (JPEG convention): ycc[k] = sum_c RGB2YCBCR[k, c] * rgb[c]
RGB2YCBCR = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float32,
)


def dct_matrix(n: int = BLOCK) -> np.ndarray:
    """Orthonormal DCT-II matrix C[u, i], float32 (computed in float64)."""
    i = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)[:, None]
    c = np.cos(math.pi * (2 * i + 1) * k / (2.0 * n))
    alpha = np.full(n, math.sqrt(2.0 / n))
    alpha[0] = math.sqrt(1.0 / n)
    return (alpha[:, None] * c).astype(np.float32)


@functools.lru_cache()
def dct_kron_matrix(n: int = BLOCK) -> np.ndarray:
    """64x64 Kronecker lift: vec(C X C^T) = (C (x) C) vec(X)."""
    c = dct_matrix(n).astype(np.float64)
    return np.kron(c, c).astype(np.float32)


def build_freq_weight(quality: int = 85, mode: str = "inv_gamma", gamma: float = 1.0) -> np.ndarray:
    """Per-frequency loss weights from the JPEG quantisation tables, (3, 8, 8)
    in channel order (Y, Cb, Cr), each channel normalised to mean 1."""
    lum_q = np.array([
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ], dtype=np.float64)
    chr_q = np.full((8, 8), 99.0)
    chr_q[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]

    def scale_q(base_q):
        q = max(1, min(100, int(quality)))
        scale = 5000 / q if q < 50 else 200 - 2 * q
        return np.clip(np.floor((base_q * scale + 50) / 100), 1, 255)

    def q_to_weight(q):
        if mode == "inv":
            w = 1.0 / q
        elif mode == "inv_gamma":
            w = (q.mean() / q) ** gamma
        else:
            raise ValueError("mode must be 'inv' or 'inv_gamma'")
        return w / w.mean()

    q_y, q_c = scale_q(lum_q), scale_q(chr_q)
    return np.stack([q_to_weight(q_y), q_to_weight(q_c), q_to_weight(q_c)]).astype(np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def rgb_to_ycbcr(x):
    """RGB -> YCbCr over the trailing channel axis (NHWC)."""
    return torch.einsum("...c,kc->...k", x, _const(RGB2YCBCR, x))


def _blockify(x):
    """(B, H, W, C) -> (B, Bh, Bw, C, 64), reflect-padded to multiples of 8."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % BLOCK, (-w) % BLOCK
    if pad_h or pad_w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect").permute(0, 2, 3, 1)
    bh, bw = (h + pad_h) // BLOCK, (w + pad_w) // BLOCK
    x = x.reshape(b, bh, BLOCK, bw, BLOCK, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, bh, bw, c, BLOCK * BLOCK)


def block_dct_8x8(x):
    """Blockwise 8x8 DCT of an NHWC image: (B, Bh, Bw, C, 8, 8), fp32."""
    blocks = _blockify(x.float())
    out = torch.einsum("...k,fk->...f", blocks, _const(dct_kron_matrix(), blocks))
    return out.reshape(out.shape[:-1] + (BLOCK, BLOCK))


def block_idct_8x8(y):
    """Inverse of :func:`block_dct_8x8` (no unpadding; shapes 8-aligned)."""
    b, bh, bw, c, _, _ = y.shape
    flat = y.reshape(b, bh, bw, c, BLOCK * BLOCK)
    x = torch.einsum("...f,fk->...k", flat, _const(dct_kron_matrix(), y))  # D^T = D^-1
    x = x.reshape(b, bh, bw, c, BLOCK, BLOCK).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, bh * BLOCK, bw * BLOCK, c)


def frequency_weighted_mse_plain(diff, freq_w):
    """mean(freq_w * DCT(YCbCr(diff))^2), fp32; the counterpart of
    ``frequency_weighted_mse_xla``. ``diff`` is NHWC, ``freq_w`` (3, 8, 8)."""
    f = block_dct_8x8(rgb_to_ycbcr(diff.float()))
    return (_const(freq_w, f) * f**2).mean()


def _aligned(diff) -> bool:
    _, h, w, c = diff.shape
    return c == 3 and h % BLOCK == 0 and w % BLOCK == 0


@functools.lru_cache()
def _host_consts():
    """ctypes pointers to the float32 DCT and YCbCr tables, which the kernel
    takes by value."""
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in (dct_matrix(), RGB2YCBCR)]
    return arrays, [a.ctypes.data_as(ctypes.c_void_p) for a in arrays]


_device_weights: dict[tuple, torch.Tensor] = {}


def _weights_on(device, freq_w) -> torch.Tensor:
    """The (3, 8, 8) fp32 weights in ``device``'s memory, copied once per
    device and table."""
    w = np.ascontiguousarray(freq_w, dtype=np.float32)
    key = (device, w.tobytes())
    if key not in _device_weights:
        _device_weights[key] = torch.from_numpy(w.copy()).to(device)
    return _device_weights[key]


_tickets: dict[torch.device, torch.Tensor] = {}


def _ticket(device) -> torch.Tensor:
    """The kernel's ticket counter on ``device``: one int32, zero between
    calls (the kernel's last CTA resets it)."""
    if device not in _tickets:
        _tickets[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tickets[device]


def freq_mse(diff, freq_w):
    """The loss as a 0-d fp32 tensor from the kernel, for a CUDA fp32
    contiguous NHWC ``diff`` with C = 3, H, W multiples of 8 and a 16-byte
    aligned base; raises on anything else. CPU tensors take
    :func:`frequency_weighted_mse_plain`. One launch per call; calls on one
    device share its ticket counter, so they must not run concurrently on
    two streams."""
    if not diff.is_cuda:
        return frequency_weighted_mse_plain(diff, freq_w)
    if diff.dim() != 4 or not _aligned(diff):
        raise ValueError(f"freq_mse kernel: needs (B, H, W, 3) with H, W multiples of 8, "
                         f"got {tuple(diff.shape)}")
    if diff.dtype != torch.float32 or not diff.is_contiguous():
        raise ValueError(f"freq_mse kernel: needs a contiguous float32 diff, got {diff.dtype}")
    if diff.data_ptr() % 16:
        raise ValueError("freq_mse kernel: needs a 16-byte aligned diff (it reads 16-byte "
                         "chunks); pass diff.clone()")
    b, h, w, _ = diff.shape
    lib = _build.load("freq_mse")
    fn = lib.deco_freq_mse
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        lib.deco_freq_mse_partials.argtypes = [ctypes.c_int] * 3
        lib.deco_freq_mse_partials.restype = ctypes.c_int
    out = torch.empty((), dtype=torch.float32, device=diff.device)
    _, ptrs = _host_consts()
    with torch.cuda.device(diff.device):
        partial = torch.empty(lib.deco_freq_mse_partials(b, h, w), dtype=torch.float32,
                              device=diff.device)
        err = fn(diff.data_ptr(), _weights_on(diff.device, freq_w).data_ptr(),
                 partial.data_ptr(), _ticket(diff.device).data_ptr(), out.data_ptr(), b, h, w,
                 *ptrs, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "freq_mse launch")
    freq_mse.launches += 1
    return out


freq_mse.launches = 0  # kernel launches since the last reset


def kernel_info() -> dict:
    """What the current card makes of the kernel (:func:`_build.kernel_info`)."""
    return {"freq_mse_kernel": _build.kernel_info("freq_mse", "deco_freq_mse_info")}


class FrequencyWeightedMSE(torch.autograd.Function):
    """mean(w * DCT(YCbCr(diff))^2) with the hand-written VJP of ``_fwm_bwd``."""

    @staticmethod
    def forward(ctx, diff, freq_w):
        ctx.save_for_backward(diff)
        ctx.freq_w = freq_w
        return freq_mse(diff, freq_w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (diff,) = ctx.saved_tensors
        _, h, w, _ = diff.shape
        f = block_dct_8x8(rgb_to_ycbcr(diff.float()))
        wf = _const(ctx.freq_w, f) * f  # (3, 8, 8) broadcasts from the right
        grad_y = block_idct_8x8(wf)[:, :h, :w, :]
        grad_rgb = torch.einsum("...k,kc->...c", grad_y, _const(RGB2YCBCR, grad_y))
        return (g * 2.0 / f.numel() * grad_rgb).to(diff.dtype), None


def frequency_weighted_mse(diff, freq_w):
    """Frequency-weighted MSE of an NHWC difference; ``freq_w`` is a (3, 8, 8)
    array. The kernel on CUDA, the plain version on the CPU."""
    return FrequencyWeightedMSE.apply(diff, np.asarray(freq_w, np.float32))
