"""The port's flash attention (deco_tpu_torch.ops.flash_attention) against
the JAX package's.

On the CPU the wrapper runs its plain version, which is compared with the
JAX Pallas kernel in interpret mode (as tests/test_ops.py runs it): fp32 at
atol 2e-5, bf16 at atol 3e-2 (bf16 output rounding, 2^-8 relative, on
values of order 1, plus the two kernels' different P rounding). The CUDA
kernel itself is tested in tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deco_tpu.models.layers import sdpa as jax_sdpa
from deco_tpu.ops.flash_attention import flash_attention as jax_flash
from deco_tpu_torch.models import layers as tl
from deco_tpu_torch.ops.flash_attention import (
    _check_kernel_args, flash_attention, flash_attention_bwd_dq, flash_attention_fwd_lse,
    flash_attention_plain)


def _qkv(b, nq, nkv, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nq, h, d)).astype(np.float32),
            rng.standard_normal((b, nkv, h, d)).astype(np.float32),
            rng.standard_normal((b, nkv, h, d)).astype(np.float32))


def _jax_flash(q, k, v, dtype):
    with pltpu.force_tpu_interpret_mode():
        out = jax_flash(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("d", [32, 64, 72])
def test_plain_matches_jax_flash_fp32(n, d):
    q, k, v = _qkv(2, n, n, 2, d)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), _jax_flash(q, k, v, jnp.float32), atol=2e-5)


def test_plain_matches_jax_flash_cross_lengths():
    """Nq != Nkv, as t2i joint attention will need."""
    q, k, v = _qkv(1, 64, 96, 2, 72, seed=1)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), _jax_flash(q, k, v, jnp.float32), atol=2e-5)


def test_plain_matches_jax_flash_bf16():
    q, k, v = _qkv(2, 256, 256, 2, 72, seed=2)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    # both sides see the same bf16-rounded inputs
    q, k, v = (x.float().numpy() for x in (qb, kb, vb))
    out = flash_attention(qb, kb, vb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _jax_flash(q, k, v, jnp.bfloat16), atol=3e-2)


def test_ragged_length_matches_einsum_sdpa():
    """N = 37 (not a multiple of 8): the JAX wrapper detours to a library
    call there, so the reference is its explicit einsum path."""
    q, k, v = _qkv(2, 37, 37, 3, 72, seed=3)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    ref = jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)), dtype=jnp.float32, impl="einsum")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_masked_plain_matches_einsum_sdpa():
    q, k, v = _qkv(1, 16, 16, 2, 64, seed=4)
    mask = np.random.default_rng(5).uniform(size=(1, 2, 16, 16)) > 0.3
    mask[..., 0] = True
    out = tl.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), mask=torch.from_numpy(mask))
    ref = jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(mask),
                   dtype=jnp.float32, impl="einsum")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_cpu_call_launches_no_kernel():
    before = flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 1, 64))
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert flash_attention.launches == before


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float32), "needs bfloat16"),
    (dict(d=80), "head dim 80"),
    (dict(stride=True), "contiguous head dim"),
])
def test_kernel_argument_checks(bad, match):
    d = bad.get("d", 72)
    q = torch.zeros(1, 16, 2, d, dtype=bad.get("dtype", torch.bfloat16))
    if bad.get("stride"):
        q = torch.zeros(1, 16, 2, 2 * d, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises((TypeError, ValueError), match=match):
        _check_kernel_args(q, q, q)


def test_entry_point_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeCoC2I(hidden_size=144, num_groups=2, num_blocks=2, num_cond_blocks=1)


# ---- training path: forward with logsumexp and the backward ----------------
# The JAX side runs its Pallas kernels in interpret mode, as tests/test_ops.py
# does: `_flash_fwd_lse` for (o, lse) and, with DECO_FLASH_BWD=pallas, the dq
# and dk/dv kernels under jax.vjp. "stream" shrinks the VMEM budget so the
# streaming variants run. Tolerances: fp32, atol 2e-5 on o and lse and 1e-4
# on gradients (fp32 sums in another order); bf16, atol 3e-2 on o and lse
# and 2e-2 of the largest gradient (the Pallas kernels round P and dS to
# bf16 before their products, the port's plain version keeps them fp32).
@pytest.mark.parametrize("variant,dtype", [
    ("resident", "float32"), ("stream", "float32"), ("resident", "bfloat16"),
    ("stream", "bfloat16"),
])
def test_fwd_lse_and_backward_match_jax_pallas(monkeypatch, variant, dtype):
    _fwd_lse_and_backward_vs_pallas(monkeypatch, variant, dtype, 72)


@pytest.mark.parametrize("variant", ["resident", "stream"])
def test_d32_bf16_fwd_lse_and_backward_match_jax_pallas(monkeypatch, variant):
    """The VAE-GAN's DC-AE attention (bf16, D = 32), which the JAX package
    sends to its Pallas kernels."""
    _fwd_lse_and_backward_vs_pallas(monkeypatch, variant, "bfloat16", 32)


def _fwd_lse_and_backward_vs_pallas(monkeypatch, variant, dtype, d):
    import jax

    from deco_tpu.ops import flash_attention as jfa

    b, n, h = 1, 64, 2
    q, k, v = _qkv(b, n, n, h, d, seed=11)
    g = np.random.default_rng(12).standard_normal((b, n, h, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    q, k, v, g = (x.float().numpy() for x in (tq, tk, tv, tg))  # both sides see the same values
    jq, jk, jv, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v, g))
    scale = d ** -0.5
    if variant == "stream":
        monkeypatch.setattr(jfa, "_RESIDENT_VMEM_BUDGET", 1)
    monkeypatch.setenv("DECO_FLASH_BWD", "pallas")

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, n, d)

    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = jfa._flash_fwd_lse(fold(jq), fold(jk), fold(jv), scale)
        _, vjp = jax.vjp(jax_flash, jq, jk, jv)
        grads_ref = vjp(jg)
    o_ref = np.asarray(o_ref.astype(jnp.float32)).reshape(b, h, n, d).transpose(0, 2, 1, 3)
    lse_ref = np.asarray(lse_ref).reshape(b, h, n)

    o, lse = flash_attention_fwd_lse(tq, tk, tv, scale)
    atol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(o.float().numpy(), o_ref, atol=atol)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=atol)

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = flash_attention(*leaves)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(tg)
    for got, want in zip(leaves, grads_ref):
        assert got.grad.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        got = got.grad.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-4)
        else:
            assert np.abs(got - want).max() < 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("variant,dtype", [
    ("resident", "float32"), ("stream", "float32"), ("resident", "bfloat16"),
    ("stream", "bfloat16"),
])
def test_bwd_dq_and_delta_match_jax_pallas(monkeypatch, variant, dtype):
    """The dQ wrapper's plain version, which takes o and returns (dQ, delta),
    against `_flash_bwd_pallas`'s dq in interpret mode and the delta that
    `_flash_core_bwd` computes with XLA (:623), from the same o and lse.
    delta: atol 2e-5 (fp32 sums in another order); dQ as above."""
    from deco_tpu.ops import flash_attention as jfa

    b, n, h, d = 1, 64, 2, 72
    q, k, v = _qkv(b, n, n, h, d, seed=13)
    g = np.random.default_rng(14).standard_normal((b, n, h, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    jq, jk, jv, jg = (jnp.asarray(x.float().numpy(), getattr(jnp, dtype)) for x in (tq, tk, tv, tg))
    scale = d ** -0.5
    if variant == "stream":
        monkeypatch.setattr(jfa, "_RESIDENT_VMEM_BUDGET", 1)

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, n, d)

    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_fwd_lse(fold(jq), fold(jk), fold(jv), scale)
        delta_ref = jnp.sum(fold(jg).astype(jnp.float32) * o.astype(jnp.float32),
                            axis=-1)[:, None, :]
        dq_ref, _, _ = jfa._flash_bwd_pallas(fold(jq), fold(jk), fold(jv), fold(jg), lse,
                                             delta_ref, scale)
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).to(tdt)
    to = to.reshape(b, h, n, d).transpose(1, 2)
    tlse = torch.from_numpy(np.array(lse)).reshape(b, h, n)
    dq, delta = flash_attention_bwd_dq(tq, tk, tv, to, tlse, tg, scale)
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_ref).reshape(b, h, n), atol=2e-5)
    assert dq.dtype == tdt
    got = dq.float().numpy()
    want = np.asarray(dq_ref.astype(jnp.float32)).reshape(b, h, n, d).transpose(0, 2, 1, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        assert np.abs(got - want).max() < 2e-2 * np.abs(want).max()


def test_cpu_autograd_reaches_qkv_through_the_function():
    """Under autograd on the CPU attention goes through FlashAttention, and
    the trunk's qkv projection gets a gradient from it."""
    from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I, init_random_

    model = DeCoC2I(hidden_size=144, num_groups=2, num_blocks=3, num_cond_blocks=1,
                    patch_size=4, hidden_size_x=16, num_classes=10,
                    dtype=torch.float32, device="cpu")
    init_random_(model, 0)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(1, 16, 16, 2, 72))
    assert type(flash_attention(q, k, v).grad_fn).__name__ == "FlashAttentionBackward"
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    model(x, torch.tensor([0.3, 0.6]), torch.tensor([1, 2])).square().mean().backward()
    grad = model.blocks[0].attn.qkv.weight.grad
    assert grad is not None and grad.abs().max() > 0
