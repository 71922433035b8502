"""The port's DC-AE (deco_tpu_torch.models.dcae, convert.dcae_from_torch_state,
DCLatentAE.from_torch_state) against the JAX package's, on the CPU.

A tiny geometry, the published one cut to size: block channels (8, 16, 32,
32, 64, 64), one layer a stage, attention in the top three stages at head
dim 32 (1, 2 and 2 heads), fp32. The port's modules carry the diffusers
``AutoencoderDC`` names, so each test draws the port's parameters from a
seed (no parameter zero), takes its state dict as the seeded
diffusers-layout state dict, and hands it to the JAX package through its own
bridge (``deco_tpu/convert/dcae_bridge.py``). Inputs are numpy draws given
to both.

Tolerances: fp32 outputs atol 1e-5 x the reference's largest value (sums in
another order through the convolutions and 3 attention layers); the
bilinear resize atol 1e-5 (values of order 1, fp32 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deco_tpu.convert import dcae_bridge
from deco_tpu.models import dcae as jdcae
from deco_tpu.models.autoencoders import DCLatentAE as JaxDCLatentAE
from deco_tpu_torch import convert
from deco_tpu_torch.models import dcae, vae_models
from deco_tpu_torch.models.autoencoders import DCLatentAE
from torch_port_util import fast_jit, numpy_state, randomize_

CHANNELS = (8, 16, 32, 32, 64, 64)
ENC_LAYERS = (1, 1, 1, 1, 1, 1)
DEC_LAYERS = (1, 1, 1, 1, 1, 1)
ATTN = (False, False, False, True, True, True)
ATOL = 1e-5  # x the reference's largest value


def _close(out, ref, atol=ATOL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= atol * np.abs(ref).max(), (err, np.abs(ref).max())


def _port_autoencoder(seed=0, decoder_head=True):
    model = dcae.AutoencoderDC(
        latent_channels=8, encoder_block_out_channels=CHANNELS,
        encoder_layers_per_block=ENC_LAYERS, encoder_attention_stages=ATTN,
        decoder_block_out_channels=CHANNELS, decoder_layers_per_block=DEC_LAYERS,
        decoder_attention_stages=ATTN, decoder_head=decoder_head, device="cpu")
    return randomize_(model, seed).eval()


@pytest.fixture(scope="module")
def pair():
    """(port AutoencoderDC, JAX (module, params)) with the same weights."""
    port = _port_autoencoder()
    module, params = dcae_bridge.dcae_flax_from_torch(numpy_state(port))
    return port, module, params


def _images(seed, n=2, size=64):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def test_pixel_shuffle_orders_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 4, 6, 8)).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(F.pixel_unshuffle(t, 2).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jdcae.pixel_unshuffle(jnp.asarray(x))))
    np.testing.assert_array_equal(F.pixel_shuffle(t, 2).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jdcae.pixel_shuffle(jnp.asarray(x))))


def test_state_dict_is_the_diffusers_layout(pair):
    """The JAX bridge reads every key of the port's state dict (strict), and
    infers the same stage geometry from it."""
    port, module, _ = pair
    sd = numpy_state(port)
    dec = {k[8:]: v for k, v in sd.items() if k.startswith("decoder.")}
    enc = {k[8:]: v for k, v in sd.items() if k.startswith("encoder.")}
    dcae_bridge.dcae_decoder_params_from_torch(dec, strict=True)
    dcae_bridge.dcae_encoder_params_from_torch(enc, strict=True)
    assert convert.infer_dcae_stage_config(dec, "up_blocks") == (
        dcae_bridge.infer_dcae_stage_config(dec, "up_blocks")) == (CHANNELS, DEC_LAYERS, ATTN)
    assert convert.infer_dcae_stage_config(enc, "down_blocks") == (
        dcae_bridge.infer_dcae_stage_config(enc, "down_blocks"))
    assert port.spatial_compression == module.spatial_compression == 32
    assert port.decoder_expansion == module.decoder_expansion == 32


def test_encoder_matches_jax(pair):
    port, module, params = pair
    x = _images(1)
    ref = fast_jit(lambda p, v: module.apply({"params": p}, v, method=module.encode))(params, x)
    with torch.no_grad():
        _close(port.encode(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("grid", [2, 3])  # 3: a 96 px output, 9 tokens at the top stage
def test_decoder_matches_jax(pair, grid):
    port, module, params = pair
    z = np.random.default_rng(2).standard_normal((2, grid, grid, 8)).astype(np.float32)
    ref = fast_jit(lambda p, v: module.apply({"params": p}, v, method=module.decode))(params, z)
    with torch.no_grad():
        out = port.decode(torch.from_numpy(z)).numpy()
    assert out.shape == (2, 32 * grid, 32 * grid, 3)
    _close(out, ref)


def test_autoencoder_round_trip_matches_jax(pair):
    port, module, params = pair
    x = _images(3)
    ref = fast_jit(lambda p, v: module.apply({"params": p}, v))(params, x)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), ref)


def test_tiled_decode_matches_jax(pair):
    """A 2 x 2 latent in 2 x 2 tiles at stride 1: four tiles (the later ones
    cut by the edge), each seam blended with the tile above and the one to
    the left."""
    port, module, params = pair
    z = np.random.default_rng(4).standard_normal((1, 2, 2, 8)).astype(np.float32)
    ref = fast_jit(lambda p, v: module.apply({"params": p}, v, tile_latent=2, tile_stride=1,
                                            method=module.tiled_decode))(params, z)
    with torch.no_grad():
        out = port.tiled_decode(torch.from_numpy(z), tile_latent=2, tile_stride=1).numpy()
    assert out.shape == (1, 64, 64, 3)
    _close(out, ref)


def test_headless_decoder_matches_jax():
    """``head=False``: the block_out_channels[0]-wide feature map (the
    reference's vendored decoder)."""
    port = _port_autoencoder(seed=5, decoder_head=False)
    module, params = dcae_bridge.dcae_flax_from_torch(numpy_state(port))
    assert not module.decoder_head
    z = np.random.default_rng(6).standard_normal((1, 2, 2, 8)).astype(np.float32)
    ref = fast_jit(lambda p, v: module.apply({"params": p}, v, method=module.decode))(params, z)
    with torch.no_grad():
        out = port.decode(torch.from_numpy(z)).numpy()
    assert out.shape == (1, 64, 64, CHANNELS[0])
    _close(out, ref)


def test_dc_latent_ae_from_torch_state_matches_jax(pair):
    """The codec built from a seeded diffusers-layout state dict: encode and
    decode (scale and shift applied) against ``dcae_flax_from_torch``'s."""
    port, _, _ = pair
    sd = numpy_state(port)
    ours = DCLatentAE.from_torch_state(sd, device="cpu")
    ref = JaxDCLatentAE.from_torch_state(sd)
    ref._encode_fn, ref._decode_fn = jax.jit(ref._encode_fn), jax.jit(ref._decode_fn)
    x = _images(7)
    with torch.no_grad():
        z = ours.encode(torch.from_numpy(x))
        _close(z.numpy(), ref.encode(jnp.asarray(x)))
        _close(ours.decode(z).numpy(), ref.decode(jnp.asarray(z.numpy())))


def test_from_torch_state_refuses_a_partial_state_dict(pair):
    sd = numpy_state(pair[0])
    with pytest.raises(ValueError, match="encoder"):
        convert.dcae_from_torch_state({k: v for k, v in sd.items() if k.startswith("decoder.")},
                                      device="cpu")
    del sd["decoder.conv_in.bias"]
    with pytest.raises(RuntimeError, match="conv_in.bias"):
        convert.dcae_from_torch_state(sd, device="cpu")


@pytest.mark.parametrize("size_in,size_out", [(256, 224), (512, 448), (320, 280), (7, 9)])
def test_bilinear_resize_is_jax_image_resize(size_in, size_out):
    """The 14/16 rescale (and an upscale): ``resize_bilinear`` against
    ``jax.image.resize(..., "bilinear")``, which antialiases on a downscale."""
    x = np.random.default_rng(8).standard_normal((2, size_in, size_in, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, size_out, size_out, 3), "bilinear")
    out = vae_models.resize_bilinear(torch.from_numpy(x), size_out, size_out).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("size_in,size_out", [(256, 224), (512, 448)])
def test_torch_antialiased_interpolate_agrees_with_jax_resize_in_fp32(size_in, size_out):
    """``F.interpolate(mode="bilinear", antialias=True)`` agrees with
    ``jax.image.resize`` at the 14/16 downscales in fp32; the port still
    applies JAX's weights (``resize_bilinear``), because the CPU's
    antialiased interpolate takes no bf16 and the VAE decodes in bf16."""
    x = np.random.default_rng(9).standard_normal((1, size_in, size_in, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, size_out, size_out, 3), "bilinear"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = F.interpolate(t, size=(size_out, size_out), mode="bilinear", antialias=True,
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_attention_block_takes_the_plain_attention_at_head_dim_32():
    """On the CPU a DC-AE attention block runs the kernels' plain version
    (no launch) at D = 32, bf16 included."""
    from deco_tpu_torch.ops import flash_attention as fa

    block = randomize_(dcae.AttentionBlock(64, dtype=torch.bfloat16), 0)
    before = (fa.flash_attention.launches, fa.flash_attention_fwd_lse.launches)
    x = torch.randn(2, 64, 4, 4, generator=torch.Generator().manual_seed(0)).bfloat16()
    out = block(x.requires_grad_(True))
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(x.grad).all())
    assert (fa.flash_attention.launches, fa.flash_attention_fwd_lse.launches) == before
