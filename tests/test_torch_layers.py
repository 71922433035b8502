"""Parity of the port's c2i layers (deco_tpu_torch.models.layers/patching)
with deco_tpu.models.layers/patching, in fp32 on the CPU.

Each case draws its inputs and parameters with numpy, runs the Flax module
and the torch module on them, and compares at atol = 1e-6 * max|ref| (a few
fp32 ulps of the output scale: the two frameworks sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from deco_tpu.models import layers as jl
from deco_tpu.models import patching as jp
from deco_tpu_torch.models import layers as tl
from deco_tpu_torch.models import patching as tp
from torch_port_util import redrawn_init


def _init(module, *args, seed=0):
    return redrawn_init(module, *args, seed=seed)["params"]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _load_dense(linear, node):
    with torch.no_grad():
        linear.weight.copy_(_t(node["kernel"]).T)
        if "bias" in node:
            linear.bias.copy_(_t(node["bias"]))


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rmsnorm():
    x = _x(2, 5, 3, 72)
    p = _init(jl.RMSNorm(), jnp.asarray(x))
    m = tl.RMSNorm(72)
    with torch.no_grad():
        m.weight.copy_(_t(p["weight"]))
    _close(m(_t(x)), jl.RMSNorm().apply({"params": p}, jnp.asarray(x)))


def test_swiglu():
    x = _x(2, 7, 48)
    mod = jl.SwiGLU(hidden_dim=4 * 48, dtype=jnp.float32)
    p = _init(mod, jnp.asarray(x))
    m = tl.SwiGLU(48, 4 * 48)
    for w in ("w1", "w2", "w3"):
        _load_dense(getattr(m, w), p[w])
    assert m.w1.out_features == int(2 * 4 * 48 / 3)
    _close(m(_t(x)), mod.apply({"params": p}, jnp.asarray(x)))


def test_timestep_embedder():
    t = np.random.default_rng(2).uniform(0, 1, (5,)).astype(np.float32)
    mod = jl.TimestepEmbedder(64, dtype=jnp.float32)
    p = _init(mod, jnp.asarray(t))
    m = tl.TimestepEmbedder(64)
    _load_dense(m.mlp[0], p["mlp_0"])
    _load_dense(m.mlp[2], p["mlp_2"])
    _close(m(_t(t)), mod.apply({"params": p}, jnp.asarray(t)))


def test_label_embedder():
    labels = np.array([0, 3, 10, 7])
    mod = jl.LabelEmbedder(11, 32, dtype=jnp.float32)
    p = _init(mod, jnp.asarray(labels))
    m = tl.LabelEmbedder(11, 32)
    with torch.no_grad():
        m.embedding_table.weight.copy_(_t(p["embedding"]))
    _close(m(torch.from_numpy(labels)), mod.apply({"params": p}, jnp.asarray(labels)))


@pytest.mark.parametrize("dim,h,w", [(72, 16, 16), (64, 4, 6)])
def test_rope_table(dim, h, w):
    cos, sin = tl.precompute_rope_2d(dim, h, w)
    jcos, jsin = jl.precompute_rope_2d(dim, h, w)
    assert cos.shape == (h * w, dim // 2) and cos.dtype == np.float32
    np.testing.assert_array_equal(cos, np.asarray(jcos))
    np.testing.assert_array_equal(sin, np.asarray(jsin))


def test_apply_rope():
    q, k = _x(2, 16, 2, 72, seed=3), _x(2, 16, 2, 72, seed=4)
    cos, sin = tl.precompute_rope_2d(72, 4, 4)
    oq, ok = tl.apply_rope(_t(q), _t(k), (_t(cos), _t(sin)))
    rq, rk = jl.apply_rope(jnp.asarray(q), jnp.asarray(k), jl.precompute_rope_2d(72, 4, 4))
    _close(oq, rq)
    _close(ok, rk)


def test_flatten_dit_block():
    """RMSNorm/adaLN/RAttention (RoPE, qk-norm, attention)/SwiGLU together."""
    x, c = _x(2, 16, 144, seed=5), _x(2, 1, 144, seed=6)
    rope = jl.precompute_rope_2d(72, 4, 4)
    mod = jl.FlattenDiTBlock(num_heads=2, dtype=jnp.float32)
    p = _init(mod, jnp.asarray(x), jnp.asarray(c), rope)
    m = tl.FlattenDiTBlock(144, 2)
    _load_dense(m.adaLN_modulation[0], p["adaLN_modulation"])
    for name in ("norm1", "norm2"):
        with torch.no_grad():
            getattr(m, name).weight.copy_(_t(p[name]["weight"]))
    a = p["attn"]
    _load_dense(m.attn.qkv, a["qkv"])
    _load_dense(m.attn.proj, a["proj"])
    with torch.no_grad():
        m.attn.q_norm.weight.copy_(_t(a["q_norm"]["weight"]))
        m.attn.k_norm.weight.copy_(_t(a["k_norm"]["weight"]))
    for w in ("w1", "w2", "w3"):
        _load_dense(getattr(m.mlp, w), p["mlp"][w])
    trope = tuple(_t(r) for r in rope)
    _close(m(_t(x), _t(c), trope),
           mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(c), rope))


@pytest.mark.parametrize("patch,freqs", [(4, 8), (16, 8)])
def test_nerf_embedder(patch, freqs):
    np.testing.assert_array_equal(tl.nerf_dct_basis(patch, freqs),
                                  jl.nerf_dct_basis(patch, freqs))
    x = _x(2, 3, patch * patch, 3, seed=7)
    mod = jl.NerfEmbedder(16, max_freqs=freqs, dtype=jnp.float32)
    p = _init(mod, jnp.asarray(x))
    m = tl.NerfEmbedder(3, 16, patch, max_freqs=freqs)
    _load_dense(m.embedder[0], p["embedder"])
    _close(m(_t(x)), mod.apply({"params": p}, jnp.asarray(x)))


def _load_resblock(m, p):
    with torch.no_grad():
        m.in_ln.weight.copy_(_t(p["in_ln"]["scale"]))
        m.in_ln.bias.copy_(_t(p["in_ln"]["bias"]))
    _load_dense(m.mlp[0], p["mlp_0"])
    _load_dense(m.mlp[2], p["mlp_2"])
    _load_dense(m.adaLN_modulation[1], p["adaLN_modulation"])


def test_adaln_resblock():
    x, y = _x(2, 3, 16, 16, seed=8), _x(2, 3, 16, 16, seed=9)
    mod = jl.AdaLNResBlock(dtype=jnp.float32)
    p = _init(mod, jnp.asarray(x), jnp.asarray(y))
    m = tl.AdaLNResBlock(16)
    _load_resblock(m, p)
    _close(m(_t(x), _t(y)), mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(y)))


def test_simple_mlp_adaln():
    x, z = _x(2, 3, 16, 16, seed=10), _x(2, 3, 48, seed=11)
    mod = jl.SimpleMLPAdaLN(model_channels=16, out_channels=3, num_res_blocks=2,
                            patch_size=4, dtype=jnp.float32)
    p = _init(mod, jnp.asarray(x), jnp.asarray(z))
    m = tl.SimpleMLPAdaLN(16, 16, 3, 48, 2, 4)
    _load_dense(m.input_proj, p["input_proj"])
    _load_dense(m.cond_embed, p["cond_embed"])
    _load_dense(m.final_layer.linear, p["final_linear"])
    for i, block in enumerate(m.res_blocks):
        _load_resblock(block, p[f"res_blocks_{i}"])
    _close(m(_t(x), _t(z)), mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(z)))


def test_layernorm_bf16_output_dtype():
    """Flax LayerNorm(dtype=bf16) on bf16 input: fp32 statistics, bf16 out."""
    x = _x(3, 32, seed=12)
    xb = jnp.asarray(x, jnp.bfloat16)
    mod = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16)
    p = _init(mod, xb)
    m = tl.LayerNorm(32, dtype=torch.bfloat16)
    with torch.no_grad():
        m.weight.copy_(_t(p["scale"]))
        m.bias.copy_(_t(p["bias"]))
    out = m(_t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    ref = mod.apply({"params": p}, xb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=2 ** -7 * np.abs(np.asarray(ref, np.float32)).max())


@pytest.mark.parametrize("shape,patch", [((2, 16, 24, 3), 4), ((1, 32, 32, 3), 16)])
def test_patchify_matches_and_roundtrips(shape, patch):
    x = _x(*shape, seed=13)
    out = tp.patchify(_t(x), patch)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jp.patchify(jnp.asarray(x), patch)))
    gh, gw = shape[1] // patch, shape[2] // patch
    np.testing.assert_array_equal(tp.unpatchify(out, gh, gw, patch).numpy(), x)


def test_patchify_rejects_indivisible():
    with pytest.raises(ValueError, match="not divisible by patch_size=16"):
        tp.patchify(torch.zeros(1, 40, 32, 3), 16)
