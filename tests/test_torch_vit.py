"""Parity of the port's ViT tower, its cubic resize and the DINOv2 encoder
(``deco_tpu_torch.models.uniflow.vit``, ``models.encoders``) with the JAX
package's, in fp32 on the CPU, and the fp32 attention wrapper's CPU path.

Sizes: hidden 128, 2 heads of 64, 1-2 layers, a 64 px input (a 4 x 4 grid
of 14 px patches) and ``image_size`` 70, so the 5 x 5 position grid is
cubic-resized to 4 x 4. Tolerances: the resize within atol 1e-5 of
``jax.image.resize(..., "cubic")`` (fp32 weights summed in another order);
the towers within atol 1e-4 (two layers of fp32 products and an exact
softmax in another order).
"""

import sys

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.convert.vit_bridge import dinov2_params_from_torch
from deco_tpu.models import encoders as jenc
from deco_tpu.models.uniflow import vit as jvit
from deco_tpu_torch import convert
from deco_tpu_torch.models import encoders
from deco_tpu_torch.models.uniflow import vit
from deco_tpu_torch.ops import flash_attention as fa
from torch_port_util import fast_jit, redraw, redrawn_init

HID, HEADS, LAYERS, IMAGE_SIZE = 128, 2, 2, 70
ATOL = 1e-4


def _images(n=2, size=64, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("src,dst", [((256, 256), (224, 224)), ((64, 64), (56, 56)),
                                     ((5, 5), (4, 4)), ((37, 37), (16, 16)), ((9, 7), (12, 5))])
def test_cubic_resize_matches_jax(src, dst):
    x = np.random.default_rng(1).standard_normal((2, *src, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *dst, 3), "cubic")
    out = vit.resize_cubic(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_cubic_resize_is_not_torch_bicubic():
    """torch's bicubic (a = -0.75, no antialias) differs from the JAX
    resize by far more than the tolerance on a downscale."""
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 56, 56, 3), "cubic"))
    torch_bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), (56, 56), mode="bicubic").permute(0, 2, 3, 1)
    assert np.abs(torch_bicubic.numpy() - ref).max() > 100 * 1e-5


def _cfg(**kw):
    base = dict(hidden_size=HID, num_layers=LAYERS, num_heads=HEADS, intermediate_size=4 * HID,
                patch_size=14, image_size=IMAGE_SIZE)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [dict(), dict(norm_type="rms_norm", qk_normalization=True,
                                              qkv_bias=False, initializer_factor=0.5)],
                         ids=["layer_norm", "rms_norm_qk_norm"])
@pytest.mark.parametrize("select_layer", [0, 1])
def test_vision_model_matches_jax(kw, select_layer):
    x = _images()
    jmodel = jvit.VisionModel(jvit.ViTConfig(**_cfg(**kw)), dtype=jnp.float32,
                              select_layer=select_layer)
    params = redrawn_init(jmodel, jnp.asarray(x), seed=3)
    ref, ref_tap = fast_jit(jmodel.apply)(params, jnp.asarray(x))
    model = vit.VisionModel(vit.ViTConfig(**_cfg(**kw)), select_layer=select_layer)
    model.load_state_dict(convert.vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        out, tap = model(torch.from_numpy(x))
    assert out.shape == (2, 17, HID)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    if select_layer:
        np.testing.assert_allclose(tap.numpy(), np.asarray(ref_tap), rtol=0, atol=ATOL)
    else:
        assert tap is None and ref_tap is None


def test_vit_init_follows_the_jax_initializers():
    model = vit.init_like_jax_(vit.VisionModel(vit.ViTConfig(**_cfg(initializer_factor=0.5))), 0)
    sd = model.state_dict()
    assert torch.equal(sd["encoder.layers.0.ls1"], torch.full((HID,), 0.5))
    assert torch.equal(sd["encoder.layers.1.norm2.weight"], torch.ones(HID))
    assert not sd["encoder.layers.0.attn.qkv.bias"].any()
    assert abs(float(sd["embeddings.position_embedding"].std()) - 1.0) < 0.1
    w = sd["embeddings.patch_embedding.weight"]  # lecun over the 3 x 14 x 14 fan-in
    assert abs(float(w.std()) * (3 * 14 * 14) ** 0.5 - 1.0) < 0.1


@functools.lru_cache(maxsize=None)
def _jax_dinov2_tower():
    """The random-weight JAX tower (its eager init runs once) and its redrawn params."""
    with pytest.warns(UserWarning):
        tower = jenc.DINOv2(hidden_size=HID, num_layers=LAYERS, num_heads=HEADS,
                            image_size=IMAGE_SIZE)
    return tower, redraw(tower.params, 4)["params"]


def _jax_dinov2(final_norm: bool):
    base, redrawn = _jax_dinov2_tower()
    tower = copy.copy(base)
    params = {"params": redrawn}
    if final_norm:
        rng = np.random.default_rng(5)
        params["final_norm"] = {"scale": 1 + 0.1 * rng.standard_normal(HID).astype(np.float32),
                                "bias": 0.1 * rng.standard_normal(HID).astype(np.float32)}
    tower.params = params
    return tower


@pytest.mark.parametrize("final_norm", [False, True])
def test_dinov2_matches_jax(final_norm):
    tower = _jax_dinov2(final_norm)
    x = _images(seed=6)
    ref = np.asarray(jax.jit(tower)(jnp.asarray(x)))  # one compile, not an eager op each
    with pytest.warns(UserWarning, match="random weights"):
        port = encoders.DINOv2(hidden_size=HID, num_layers=LAYERS, num_heads=HEADS,
                               image_size=IMAGE_SIZE, device="cpu")
    if final_norm:
        port.final_norm = torch.nn.LayerNorm(HID, eps=1e-6).requires_grad_(False)
    port.load_state_dict(convert.dinov2_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tower.params)), strict=True)
    out = port(torch.from_numpy(x))
    assert out.shape == (2, 16, HID) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def _hub_state_dict(seed=7):
    """A torch-hub dinov2_vitb14-layout state dict at the tiny size."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sd = {"cls_token": r(1, 1, HID, scale=1), "pos_embed": r(1, 26, HID, scale=1),
          "mask_token": r(1, HID), "patch_embed.proj.weight": r(HID, 3, 14, 14),
          "patch_embed.proj.bias": r(HID), "norm.weight": 1 + r(HID), "norm.bias": r(HID)}
    for i in range(LAYERS):
        p = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[p + norm + ".weight"], sd[p + norm + ".bias"] = 1 + r(HID), r(HID)
        sd[p + "attn.qkv.weight"], sd[p + "attn.qkv.bias"] = r(3 * HID, HID), r(3 * HID)
        sd[p + "attn.proj.weight"], sd[p + "attn.proj.bias"] = r(HID, HID), r(HID)
        sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"] = r(4 * HID, HID), r(4 * HID)
        sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"] = r(HID, 4 * HID), r(HID)
        sd[p + "ls1.gamma"], sd[p + "ls2.gamma"] = 1 + r(HID), 1 + r(HID)
    return sd


def test_dinov2_reads_the_torch_hub_layout(tmp_path):
    """weight_path loads a hub file with torch.load: the same features as
    the JAX tower with the JAX converter's params (final norm included)."""
    sd = _hub_state_dict()
    path = tmp_path / "dinov2_vitb14_pretrain.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    port = encoders.DINOv2(weight_path=str(path), hidden_size=HID, num_layers=LAYERS,
                           num_heads=HEADS, image_size=IMAGE_SIZE, device="cpu")
    assert port.final_norm is not None
    assert not any(p.requires_grad for p in port.parameters())
    with pytest.warns(UserWarning):
        tower = jenc.DINOv2(hidden_size=HID, num_layers=LAYERS, num_heads=HEADS,
                            image_size=IMAGE_SIZE)
    tower.params = dinov2_params_from_torch(sd, num_layers=LAYERS)
    x = _images(seed=8)
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                               np.asarray(tower(jnp.asarray(x))), rtol=0, atol=ATOL)


def test_dinov2_missing_weights_raise_and_none_warns():
    with pytest.raises(FileNotFoundError, match="no weights"):
        encoders.DINOv2(weight_path="/nonexistent/dinov2_vitb14_pretrain.pth", device="cpu")
    with pytest.warns(UserWarning, match="random weights"):
        tower = encoders.DINOv2(hidden_size=HID, num_layers=1, num_heads=HEADS, device="cpu")
    assert tower.final_norm is None  # a random tower has none, as in JAX
    assert tower(torch.rand(1, 32, 32, 3)).shape == (1, 4, HID)  # 28 px: a 2 x 2 grid


@pytest.mark.parametrize("cls", ["CLIP", "SigLIP", "SigLIPVision"])
def test_hf_encoders_name_transformers_and_the_weights(cls, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # as on the card's host
    with pytest.raises(ImportError, match="transformers.*|.*/w/" + cls):
        getattr(encoders, cls)("/w/" + cls, device="cpu")


def test_fp32_attention_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 17, 2, 64)).astype(np.float32))
               for _ in range(3))
    before = fa.flash_attention_fwd_f32.launches
    ref = fa.flash_attention_plain(q, k, v)
    assert torch.equal(fa.flash_attention(q, k, v), ref)
    assert torch.equal(fa.flash_attention_fwd_f32(q, k, v, 0.125), ref)
    assert fa.flash_attention_fwd_f32.launches == before  # nothing launched on the CPU


@pytest.mark.parametrize("shape,dtypes,match", [
    ((2, 17, 2, 72), (torch.float32,) * 3, "head dim 72"),
    ((2, 17, 2, 64), (torch.float32, torch.float32, torch.bfloat16), "v is torch.bfloat16, needs float32"),
    # the bf16 kernels take D = 32 since the VAE-GAN's DC-AE decoder; the
    # case keeps its name and holds the bf16 refusal at D = 16
    pytest.param((2, 17, 2, 16), (torch.bfloat16,) * 3, "head dim 16 not in .* for torch.bfloat16",
                 id="shape2-dtypes2-head dim 32 not in .* for torch.bfloat16"),
    ((2, 17, 2, 16), (torch.float32,) * 3, "head dim 16"),
])
def test_fp32_kernel_refuses_what_it_does_not_take(shape, dtypes, match):
    """The fp32 kernel takes D = 32 and 64 only, the bf16 kernels D = 32,
    64, 72 and 128."""
    q, k, v = (torch.zeros(shape, dtype=d) for d in dtypes)
    with pytest.raises((TypeError, ValueError), match=match):
        fa._check_kernel_args(q, k, v, dtype=dtypes[0])


@pytest.mark.parametrize("d", [32, 64])
def test_fp32_kernel_takes_head_dims_32_and_64(d):
    """DINOv2's D = 64 and the DC-AE's D = 32 pass the fp32 kernel's checks."""
    q, k, v = (torch.zeros((2, 17, 2, d)) for _ in range(3))
    fa._check_kernel_args(q, k, v, dtype=torch.float32)
    assert fa.F32_HEAD_DIMS == (32, 64)
