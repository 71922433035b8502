"""The numerics of the fp32 attention kernel's 3xTF32 products, emulated in
numpy (no card, no JAX).

``flash_fwd_f32_kernel`` (``deco_tpu_torch/csrc/flash_attention_fwd.cu``)
runs Q K^T and P V on the tensor cores at TF32: each fp32 operand x is split
into big = rna(x) and small = rna(x - big), both TF32 (10 stored mantissa
bits, rounded to nearest, ties away), and a b is taken as
small_a big_b + big_a small_b + big_a big_b, accumulated in fp32. Here TF32
rounding masks the low 13 mantissa bits after adding half of their range, a
product of two TF32 values is exact in fp32, and the sums are fp32 matrix
products. The tests pin the choice: the 3xTF32 output sits within the
kernel's gate of 1e-5 x max|v| of the fp64 attention, at a DINOv2-like and
a DC-AE-like shape, and one TF32 pass does not. They stand in for no test
of the kernel itself (tests/test_torch_kernels_cuda.py, on the card).
"""

import numpy as np
import pytest

F32_REL = 1e-5  # the gate of chip_smoke.py and tests/test_torch_kernels_cuda.py


def tf32(x: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32, to nearest with ties away from zero (cvt.rna)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    big = tf32(x)
    return big, tf32(x.astype(np.float32) - big)


def product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b with fp32 accumulation of TF32 products: 3 passes
    (small_a big_b, big_a small_b, then big_a big_b) or 1 (big_a big_b)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    if passes == 1:
        return ab @ bb
    return (as_ @ bb + ab @ bs) + ab @ bb


def attention(q, k, v, passes=None):
    """softmax(q k^T / sqrt(D)) v per head, (H, N, D) operands: in fp64
    when ``passes`` is None, else fp32 with the TF32 products."""
    scale = q.shape[-1] ** -0.5
    if passes is None:
        s = q.astype(np.float64) @ k.astype(np.float64).transpose(0, 2, 1) * scale
        p = np.exp(s - s.max(-1, keepdims=True))
        return p @ v.astype(np.float64) / p.sum(-1, keepdims=True)
    s = product(q, k.transpose(0, 2, 1), passes) * np.float32(scale)
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    return product(p, v, passes) / p.sum(-1, keepdims=True, dtype=np.float32)


@pytest.mark.parametrize("heads,n,d", [(6, 257, 64), (8, 256, 32)], ids=["dinov2", "dcae"])
def test_three_tf32_passes_hold_the_fp32_gate_and_one_does_not(heads, n, d):
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((heads, n, d)).astype(np.float32) for _ in range(3))
    ref = attention(q, k, v)
    limit = F32_REL * np.abs(v).max()
    three = np.abs(attention(q, k, v, passes=3) - ref).max()
    one = np.abs(attention(q, k, v, passes=1) - ref).max()
    assert three <= limit / 4, (three, limit)
    assert one > limit, (one, limit)


def test_split_is_exact_to_about_two_to_the_minus_22():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * 10.0 ** rng.uniform(-3, 3, 100_000)).astype(np.float32)
    big, small = split(x)
    assert not (big.view(np.uint32) & 0x1FFF).any() and not (small.view(np.uint32) & 0x1FFF).any()
    rel = np.abs(x.astype(np.float64) - big - small) / np.abs(x)
    assert rel.max() < 2.0 ** -21
    assert np.abs(x.astype(np.float64) - big).max() / np.abs(x).max() > 2.0 ** -13
