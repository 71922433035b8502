"""Parity of the port's t2i model (deco_tpu_torch.models.dit_t2i, the t2i
layers, convert.state_dict_from_jax_t2i) and conditioners with the JAX
package's, in fp32 on the CPU.

The tiny t2i config is tests/test_serve.py's (hidden 32, 2 heads, 2 joint
and 1 text blocks, patch 4, 6 text tokens of 16), with weights redrawn at
unit scale so that attention moves the output. Tolerances: a layer's
output within atol = 1e-6 * max|ref| (fp32 sums in another order), the
whole model's within 1e-5 * max|ref| (two blocks deep, as the c2i model
tests).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.convert.flax_to_torch import export_deco_t2i
from deco_tpu.models import conditioners as jc
from deco_tpu.models import layers as jl
from deco_tpu.models.dit_t2i import DeCoT2I as JaxDeCoT2I
from deco_tpu_torch import convert
from deco_tpu_torch.models import conditioners as tc
from deco_tpu_torch.models import layers as tl
from deco_tpu_torch.models.dit_c2i_deco import init_like_jax_
from deco_tpu_torch.models.dit_t2i import DeCoT2I
from torch_port_util import TINY_T2I, fast_jit, redrawn_init, tiny_jax_t2i

LAYER_ATOL = 1e-6
MODEL_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, ref, atol):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol * np.abs(ref).max())


def _init(module, *args, seed=0):
    return redrawn_init(module, *args, seed=seed)["params"]


def _stacked(params):
    """One block's params with a leading layer axis, as ``nn.scan`` stacks them."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[None], params)


def _rope(dim, h, w, scale):
    cos, sin = tl.precompute_rope_2d(dim, h, w, scale=scale, extrapolate=True)
    return _t(cos), _t(sin)


# ---- layers ----

def test_fused_swiglu_of_exact_width():
    """w12 = [w1; gate] (silu on the first half), w3 = the JAX w2."""
    x = _x(2, 7, 32)
    mod = jl.SwiGLU(hidden_dim=128, exact_hidden=True, dtype=jnp.float32)
    p = _init(mod, jnp.asarray(x))
    m = tl.SwiGLUFused(32, 128)
    m.load_state_dict({"w12.weight": torch.cat([_t(p["w1"]["kernel"]).T, _t(p["w3"]["kernel"]).T]),
                       "w3.weight": _t(p["w2"]["kernel"]).T})
    assert m.w12.weight.shape == (256, 32) and m.w3.weight.shape == (32, 128)
    _close(m(_t(x)), mod.apply({"params": p}, jnp.asarray(x)), LAYER_ATOL)


def test_embed_with_norm():
    x = _x(2, 6, 16)
    mod = jl.Embed(32, use_norm=True, dtype=jnp.float32)
    p = _init(mod, jnp.asarray(x))
    m = tl.Embed(16, 32, use_norm=True)
    m.load_state_dict({"proj.weight": _t(p["proj"]["kernel"]).T, "proj.bias": _t(p["proj"]["bias"]),
                       "norm.weight": _t(p["norm"]["weight"])})
    _close(m(_t(x)), mod.apply({"params": p}, jnp.asarray(x)), LAYER_ATOL)


@pytest.mark.parametrize("dim,h,w,scale", [(64, 3, 5, (1.5, 0.5)), (16, 6, 2, (0.75, 2.0)),
                                           (64, 32, 32, (1.0, 1.0))])
def test_extrapolating_rope_on_a_non_square_grid(dim, h, w, scale):
    """x spans [0, h * scale_h] over w points and y [0, w * scale_w] over h:
    only a grid with h != w and scale_h != scale_w tells them apart."""
    ours = tl.precompute_rope_2d(dim, h, w, scale=scale, extrapolate=True)
    ref = jl.precompute_rope_2d(dim, h, w, scale=scale, extrapolate=True)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    # column 0 is the x angle at frequency 1 along the first row of w points:
    # it spans the height, not the width
    np.testing.assert_allclose(ours[0][:w, 0], np.cos(np.linspace(0, h * scale[0], w)),
                               rtol=0, atol=1e-6)
    if h * scale[0] != w * scale[1]:
        assert not np.allclose(ours[0][:w, 0], np.cos(np.linspace(0, w * scale[1], w)))


def test_joint_attention_image_queries_over_image_and_text_keys():
    x, y = _x(2, 15, 32), _x(2, 6, 32, seed=2)
    rope = _rope(16, 3, 5, (1.5, 0.5))
    mod = jl.JointAttention(num_heads=2, dtype=jnp.float32, attn_impl="einsum")
    jrope = tuple(jnp.asarray(r.numpy()) for r in rope)
    p = _init(mod, jnp.asarray(x), jnp.asarray(y), jrope)
    m = tl.JointAttention(32, 2)
    sd = {f"{n}.weight": _t(p[n]["kernel"]).T for n in ("qkv_x", "kv_y", "proj")}
    sd.update({"proj.bias": _t(p["proj"]["bias"]), "q_norm.weight": _t(p["q_norm"]["weight"]),
               "k_norm.weight": _t(p["k_norm"]["weight"])})
    m.load_state_dict(sd)
    assert m.qkv_x.bias is None and m.kv_y.bias is None
    ref = mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(y), jrope)
    _close(m(_t(x), _t(y), rope), ref, LAYER_ATOL)


@pytest.mark.parametrize("joint", [True, False])
def test_t2i_blocks(joint):
    x, y, c = _x(2, 15, 32), _x(2, 6, 32, seed=2), _x(2, 1, 32, seed=3)
    rope = _rope(16, 3, 5, (1.5, 0.5))
    jrope = tuple(jnp.asarray(r.numpy()) for r in rope)
    if joint:
        mod = jl.JointDiTBlock(num_heads=2, dtype=jnp.float32)
        args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(c), jrope)
        m, targs = tl.JointDiTBlock(32, 2), (_t(x), _t(y), _t(c), rope)
    else:
        mod = jl.TextRefineBlock(num_heads=2, dtype=jnp.float32)
        args = (jnp.asarray(y), jnp.asarray(c))
        m, targs = tl.TextRefineBlock(32, 2), (_t(y), _t(c))
    p = _init(mod, *args)
    sd = {}
    convert._t2i_block(_stacked(p), sd, "", 0, joint=joint)
    m.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    _close(m(*targs), mod.apply({"params": p}, *args), LAYER_ATOL)


# ---- the model ----

@functools.lru_cache(maxsize=1)
def _tiny():
    """(redrawn numpy params of the JAX model, the port's model loaded from them)."""
    params = jax.tree_util.tree_map(np.asarray, tiny_jax_t2i(0)[1])
    model = DeCoT2I(**TINY_T2I, dtype=torch.float32, device="cpu").eval()
    model.load_state_dict(convert.state_dict_from_jax_t2i(params, patch_size=4), strict=True)
    return params, model


def _inputs(h, w, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, h, w, 3)).astype(np.float32),
            np.array([0.2, 0.7], np.float32),
            rng.standard_normal((2, TINY_T2I["txt_max_length"],
                                 TINY_T2I["txt_embed_dim"])).astype(np.float32))


def _ref(params, x, t, y, scale=(1.0, 1.0)):
    jmodel = JaxDeCoT2I(**TINY_T2I, dtype=jnp.float32, patch_scaling_hw=scale)
    return np.asarray(fast_jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                            jnp.asarray(y)))


@pytest.mark.parametrize("h,w,scale,chunks", [(16, 16, (1.0, 1.0), 0), (16, 16, (1.0, 1.0), 4),
                                              (16, 24, (0.5, 0.75), 0), (24, 16, (1.5, 1.0), 4)])
def test_forward_matches_jax(h, w, scale, chunks):
    params, model = _tiny()
    x, t, y = _inputs(h, w)
    model.decoder_chunks = chunks
    try:
        with torch.no_grad():
            out = model(_t(x), _t(t), _t(y), patch_scaling_hw=scale)
    finally:
        model.decoder_chunks = 0
    _close(out, _ref(params, x, t, y, scale), MODEL_ATOL)


def test_text_keys_and_values_move_the_image():
    """Zeroing kv_y (the text k/v of every joint block) moves the output by
    far more than the parity tolerance: the joint path is exercised."""
    _, model = _tiny()
    x, t, y = (_t(a) for a in _inputs(16, 24))
    with torch.no_grad():
        out = model(x, t, y)
        saved = [b.attn.kv_y.weight.clone() for b in model.blocks]
        for b in model.blocks:
            b.attn.kv_y.weight.zero_()
        try:
            cut = model(x, t, y)
        finally:
            for b, w in zip(model.blocks, saved):
                b.attn.kv_y.weight.copy_(w)
    moved = (out - cut).abs().max().item() / out.abs().max().item()
    assert moved > 1e3 * MODEL_ATOL, moved


def test_state_dict_equals_reference_export():
    params, model = _tiny()
    ours = convert.state_dict_from_jax_t2i(params, patch_size=4)
    ref = export_deco_t2i(params, patch_size=4, prefix="")
    assert list(ours) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert set(ours) == set(model.state_dict())


def test_init_follows_the_jax_initializers():
    """Zeros, ones and the spread of every parameter as the JAX DeCoT2I's
    initializers give them (the values differ: another generator)."""
    jmodel = JaxDeCoT2I(**TINY_T2I, dtype=jnp.float32)
    x, t, y = _inputs(16, 16)
    ref = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x[:1], t[:1], y[:1])
    ref = convert.state_dict_from_jax_t2i(jax.tree_util.tree_map(np.asarray, ref), patch_size=4)
    model = init_like_jax_(DeCoT2I(**TINY_T2I, dtype=torch.float32, device="cpu"), seed=0)
    ours = dict(model.named_parameters())
    assert ours.keys() == ref.keys()
    for name, want in ref.items():
        got = ours[name].detach()
        if not want.any() or bool((want == 1).all()):
            assert torch.equal(got, want), name
        elif want.numel() >= 256:
            assert abs(got.std().item() / want.std().item() - 1) < 0.2, name
            assert got.abs().max() <= 2.01 * want.abs().max() + 1e-6 or name.endswith(
                "y_pos_embedding"), name
    assert ours["y_pos_embedding"].dtype == torch.float32


@pytest.mark.parametrize("kwarg,item", [({"trunk_parallel": "sp"}, 6), ({"quantize": "int8"}, 7)])
def test_unported_options_raise_naming_their_roadmap_item(kwarg, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP §A {item}"):
        DeCoT2I(**TINY_T2I, device="cpu", **kwarg)


def test_return_features_raises():
    """return_features is ported (the REPA tap): no longer raising, it gives
    the image and the joint trunk's tokens after block align_layer, zeros
    when that is 0 (tests/test_torch_c2i_families.py holds them against JAX)."""
    _, model = _tiny()
    x, t, y = (_t(a) for a in _inputs(16, 16))
    with torch.no_grad():
        img, feat = model(x, t, y, return_features=True)
        model.align_layer = 2
        tapped = model(x, t, y, return_features=True)[1]
    assert img.shape == (2, 16, 16, 3) and not feat.any()
    assert tapped.shape == (2, 16, TINY_T2I["hidden_size"]) and tapped.abs().max() > 0


# ---- conditioners ----

PROMPTS = ["A photo of a cat", "two dogs on a red sofa", ""]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def test_qwen3_hash_fallback_matches_jax():
    """Same process, so Python's salted hash() agrees: embeddings, bf16,
    valid_length_y and the uncondition cached per negative prompt."""
    ours_enc, ref_enc = tc.Qwen3TextEncoder(embed_dim=16, max_length=6), jc.Qwen3TextEncoder(
        embed_dim=16, max_length=6)
    for neg in ("", "blurry, low quality"):
        md, md_ref = {"negative_prompt": neg}, {"negative_prompt": neg}
        cond, uncond = ours_enc(PROMPTS, md)
        ref, ref_u = ref_enc(PROMPTS, md_ref)
        assert cond.dtype == uncond.dtype == torch.bfloat16
        assert tuple(cond.shape) == tuple(uncond.shape) == (3, 6, 16)
        np.testing.assert_array_equal(_np(cond), _np(ref))
        np.testing.assert_array_equal(_np(uncond), _np(ref_u))
        np.testing.assert_array_equal(np.asarray(md["valid_length_y"]),
                                      np.asarray(md_ref["valid_length_y"]))
        assert md["valid_length_y"].dtype == torch.int32
    assert set(ours_enc._uncond_cache) == set(ref_enc._uncond_cache) == {"", "blurry, low quality"}


def test_qwen3_missing_weight_dir_warns_then_falls_back(tmp_path):
    with pytest.warns(UserWarning, match="hash-embedding fallback"):
        enc = tc.Qwen3TextEncoder(weight_path=str(tmp_path / "absent"), embed_dim=16,
                                  max_length=6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jc.Qwen3TextEncoder(weight_path=str(tmp_path / "absent"), embed_dim=16,
                                  max_length=6)
    np.testing.assert_array_equal(_np(enc(PROMPTS)[0]), _np(ref(PROMPTS)[0]))


@pytest.mark.parametrize("embed_dim", [16, 48])
def test_qwen3_hf_branch_matches_jax(tmp_path_factory, embed_dim):
    """A weight directory takes the Hugging Face model (tiny random Qwen3):
    the hidden states cut (16 < 32) or zero-padded (48) to embed_dim."""
    pytest.importorskip("transformers")
    from tests.helpers_offline import build_tiny_qwen3

    d = build_tiny_qwen3(str(tmp_path_factory.mktemp("qwen3")))
    ours_enc = tc.Qwen3TextEncoder(weight_path=d, embed_dim=embed_dim, max_length=6)
    ref_enc = jc.Qwen3TextEncoder(weight_path=d, embed_dim=embed_dim, max_length=6)
    md, md_ref = {}, {}
    (cond, uncond), (ref, ref_u) = ours_enc(["a cat", "dog"], md), ref_enc(["a cat", "dog"], md_ref)
    np.testing.assert_array_equal(_np(cond), _np(ref))
    np.testing.assert_array_equal(_np(uncond), _np(ref_u))
    np.testing.assert_array_equal(np.asarray(md["valid_length_y"]),
                                  np.asarray(md_ref["valid_length_y"]))


def test_qwen3_hf_branch_without_transformers_names_it(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_transformers(name, *args, **kwargs):
        if name.startswith("transformers"):
            raise ImportError("No module named 'transformers'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="transformers"):
        tc.Qwen3TextEncoder(weight_path=str(tmp_path))


def test_base_conditioner_casts_floats_to_bf16_and_keeps_integers():
    class Floats(tc.BaseConditioner):
        def _impl_condition(self, y, metadata):
            return torch.ones(len(y), 2, dtype=torch.float64)

        def _impl_uncondition(self, y, metadata):
            return torch.zeros(len(y), 2, dtype=torch.int32)

    cond, uncond = Floats()(["a", "b"])
    assert cond.dtype == torch.bfloat16 and uncond.dtype == torch.int32
    cond, uncond = tc.LabelConditioner(10)([3, 4])
    assert cond.dtype == uncond.dtype == torch.long and uncond.tolist() == [10, 10]
    cond, uncond = tc.ImageConditioner()(np.ones((2, 4, 4, 3)))
    assert cond.dtype == torch.bfloat16 and not uncond.any()


def test_compose_and_placeholder_conditioners_match_jax():
    ours = tc.ComposeConditioner([tc.Qwen3TextEncoder(embed_dim=8, max_length=4),
                                  tc.Qwen3TextEncoder(embed_dim=8, max_length=3)])
    ref = jc.ComposeConditioner([jc.Qwen3TextEncoder(embed_dim=8, max_length=4),
                                 jc.Qwen3TextEncoder(embed_dim=8, max_length=3)])
    for a, b in zip(ours(PROMPTS), ref(PROMPTS)):
        assert tuple(a.shape) == (3, 7, 8) and a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(a), _np(b))
    ours, ref = tc.PlaceHolderConditioner(num_classes=7, seed=3), jc.PlaceHolderConditioner(
        num_classes=7, seed=3)
    for _ in range(2):  # the generator advances alike
        (a, au), (b, bu) = ours(PROMPTS), ref(PROMPTS)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(au.numpy(), np.asarray(bu))
