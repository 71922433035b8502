"""The port's UniFlow model (deco_tpu_torch.models.uniflow, convert's UniFlow
bridge, the causal attention) against the JAX package, on the CPU.

A tiny width, the published one cut to size (tests/test_uniflow_training.py's
config): a 2-layer ViT of width 64 (4 heads of 16, patch 4, 32 px images),
``llm_hidden_size`` 24, one block in each trunk (the semantic one causal,
32 heads of 4), one flow-head res block, 2 sampling steps; the semantic
flow head keeps its fixed width of 2,048 and 4 blocks. fp32 on both sides.
The port's parameters are drawn from a seed (``torch_port_util.randomize_``,
no parameter zero, so the zero-initialised modulations and heads carry
signal) and reach the JAX package through its own torch bridge
(``uniflow_params_from_torch``, ``dcae_decoder_params_from_torch``); the
port's bridge (``convert.state_dict_from_jax_uniflow``) is held to the
round trip. The random draws (times, noise) are the JAX package's, handed
to the port.

The JAX model is compiled once: ``test_uniflow_vision_matches_jax`` jits
one program that returns the loss terms, every gradient, a semantic
reconstruction, the padded pixel reconstruction of a 30 x 26 image and the
DC-AE variant's pixel condition, and its checks read it (one test, so
that the suite's parallel workers never compile it twice).

Tolerances: losses and outputs within 1e-4 relative (outputs: of their
largest value), gradients within 1e-3 of each tensor's largest value.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.convert import dcae_bridge
from deco_tpu.convert.uniflow_bridge import uniflow_params_from_torch, uniflow_params_to_torch
from deco_tpu.models.uniflow import UniFlowConfig as JaxUniFlowConfig
from deco_tpu.models.uniflow import UniFlowVision as JaxUniFlowVision
from deco_tpu.models.uniflow import components as jcomponents
from deco_tpu.models.uniflow import flow_decoder as jflow
from deco_tpu.train.uniflow_loop import UniFlowExperiment as JaxUniFlowExperiment
from deco_tpu_torch import convert
from deco_tpu_torch.config import registry
from deco_tpu_torch.models.uniflow import components
from deco_tpu_torch.models import layers
from deco_tpu_torch.models.uniflow import flow_decoder as flow
from deco_tpu_torch.models.uniflow import vit
from deco_tpu_torch.models.uniflow.model import UniFlowConfig, UniFlowVision
from deco_tpu_torch.ops import flash_attention as fa
from deco_tpu_torch.train import workloads
from deco_tpu_torch.train.uniflow_loop import UniFlowExperiment
from deco_tpu_torch.utils.flops import uniflow_flops
from torch_port_util import FAST_COMPILE, numpy_state, randomize_, redraw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vit_hidden_size=64, llm_hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, patch_size=4, image_size=32, global_blocks_depth=1,
            num_decoder_layers=1, num_sampling_steps=2)
DCAE = dict(decoder_type="dcae", latent_ch=8, dcae_block_out_channels=(16, 32),
            dcae_layers_per_block=(1, 1), dcae_attention_stages=(False, False),
            dcae_flow_width=16, dcae_flow_depth=1)
RTOL = 1e-4
GRAD_REL = 1e-3
UNIFLOW_CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs_flow"))
                         if f.startswith("uniflow_"))


def _close(out, ref, rel=RTOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-6), (err, np.abs(ref).max())


def _flow_draws(rng, b: int, n: int, c: int) -> dict:
    """The four per-token draws of the JAX ``FlowDecoder.forward_train`` from
    ``rng`` (traced inside the tests' jitted programs: no eager op compiles)."""
    r_nt, r_mix, r_u, r_x0 = jax.random.split(rng, 4)
    return dict(t_normal=jax.random.normal(r_nt, (b, n)),
                t_mix=jax.random.uniform(r_mix, (b, n)),
                t_uniform=jax.random.uniform(r_u, (b, n)),
                x0=jax.random.normal(r_x0, (b, n, c)))


def _drawn_model(seed: int, **cfg) -> UniFlowVision:
    """The port's model with every parameter drawn from ``seed``
    (``randomize_``: no parameter zero)."""
    model = UniFlowVision(UniFlowConfig(**{**TINY, **cfg}), dtype=torch.float32, device="cpu")
    return randomize_(model, seed, scale=0.5)


def _jax_params(model: UniFlowVision) -> dict:
    """The port model's weights as the JAX tree, through the JAX package's
    own torch bridge (no JAX init is traced)."""
    sd = numpy_state(model)
    params = uniflow_params_from_torch({k: v for k, v in sd.items()
                                        if not k.startswith("dcae_decoder.")})
    if model.cfg.decoder_type == "dcae":
        params["dcae_decoder"] = dcae_bridge.dcae_decoder_params_from_torch(
            {k[len("dcae_decoder."):]: v for k, v in sd.items() if k.startswith("dcae_decoder.")})
    return {"params": params}


def _jax_reference() -> dict:
    """The JAX side of every check of ``test_uniflow_vision_matches_jax``,
    from one jitted program, and the port's models."""
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    small = np.random.default_rng(1).uniform(-1, 1, (2, 30, 26, 3)).astype(np.float32)
    jm = JaxUniFlowVision(JaxUniFlowConfig(**TINY), dtype=jnp.float32)
    port, port_dcae = _drawn_model(1), _drawn_model(2, **DCAE)  # the DC-AE pixel branch
    params, dparams = _jax_params(port), _jax_params(port_dcae)
    jexp = JaxUniFlowExperiment(JaxUniFlowConfig(**TINY), dtype=jnp.float32)
    jd = JaxUniFlowVision(JaxUniFlowConfig(**TINY, **DCAE), dtype=jnp.float32)
    keys = dict(loss=jax.random.PRNGKey(3), semantic=jax.random.PRNGKey(5),
                small=jax.random.PRNGKey(6))
    # the DC-AE branch's own part, its condition from a latent (the rest of
    # that model is the main one's code): gen_latent_proj, the headless
    # DC-AE decoder and the bilinear resize onto the 32 x 32 image
    latent = np.random.default_rng(2).standard_normal((2, 16, 256)).astype(np.float32)

    def program(p, dp, v, s, lat):
        def loss(q):
            out = jm.apply(q, v, keys["loss"], method=jm.forward_loss)
            return out["loss"], out

        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return dict(
            losses=losses, grads=grads,
            semantic=jm.apply(p, v, keys["semantic"], mode="semantic"),
            small_recon=jexp.reconstruct(p, s, keys["small"], mode="pixel"),
            # the draws and starting noises those calls take, for the port
            loss_draws=_loss_draws(keys["loss"], 64, 48),
            semantic_noise=jax.random.normal(keys["semantic"], (2, 16, 256)),
            small_noise=jax.random.normal(keys["small"], (2, 64, 48)),
            dcae_cond=jd.apply(dp, lat, method=lambda m, z: m._run_pixel_trunk_dcae(z, (32, 32))))

    args = (params, dparams, jnp.asarray(x), jnp.asarray(small), jnp.asarray(latent))
    out = jax.device_get(jax.jit(program).lower(*args).compile(FAST_COMPILE)(*args))
    return dict(out, params=params, dparams=dparams, x=x, small=small, latent=latent, keys=keys,
                port=port, port_dcae=port_dcae)


def _loss_draws(key, pix_tokens: int, pix_channels: int) -> dict:
    """The draws of JAX ``forward_loss`` under ``key``: the semantic head's
    (16 tokens of 4 x 64) on the first split, the pixel head's on the second."""
    r_sem, r_pix = jax.random.split(key)
    return dict(sem=_flow_draws(r_sem, 2, 16, 256), pix=_flow_draws(r_pix, 2, pix_tokens,
                                                                   pix_channels))


def test_components_match_jax():
    """The token shuffles, the patch transforms, the sincos table and the
    flow-decoder tables, exactly."""
    x = np.random.default_rng(4).standard_normal((2, 64, 12)).astype(np.float32)
    for s in (0.5, 2.0):
        y = x if s == 0.5 else x[:, :16]
        np.testing.assert_array_equal(components.resample_tokens(torch.from_numpy(y), s).numpy(),
                                      np.asarray(jcomponents.resample_tokens(jnp.asarray(y), s)))
    img = np.random.default_rng(5).standard_normal((2, 12, 12, 3)).astype(np.float32)
    tokens = components.p2l_transform(torch.from_numpy(img), 4)
    np.testing.assert_array_equal(tokens.numpy(),
                                  np.asarray(jcomponents.p2l_transform(jnp.asarray(img), 4)))
    np.testing.assert_array_equal(components.l2p_transform(tokens, 4).numpy(), img)
    np.testing.assert_array_equal(components.get_2d_sincos_pos_embed(64, 8),
                                  jcomponents.get_2d_sincos_pos_embed(64, 8))
    for schedule in ("linear", "pow_2", "pow_3"):
        for ours, ref in zip(flow.flow_decoder_timesteps(4, schedule),
                             jflow.flow_decoder_timesteps(4, schedule)):
            np.testing.assert_array_equal(ours, ref)


def test_flow_decoder_matches_jax():
    """``FlowDecoder`` alone: training with the JAX draws (loss and x1
    prediction), and 2-step sampling, linear and ``pow_2``, with CFG against
    a nonzero ``mask_token`` inside an interval that keeps one step off."""
    kw = dict(target_channels=12, z_channels=16, width=16, depth=2, num_sampling_steps=2,
              patch_size=2, max_freqs=4)
    jfd = jflow.FlowDecoder(**kw, dtype=jnp.float32)
    rng = np.random.default_rng(6)
    x1 = rng.standard_normal((2, 4, 12)).astype(np.float32)
    z = rng.standard_normal((2, 4, 16)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    params = redraw(jax.eval_shape(jfd.init, key, x1, z, key), 7, scale=0.5)
    noise_key = jax.random.PRNGKey(10)
    interval = (0.5, 2.0)  # t in [1/3, 2/3]: the second of two steps only

    @jax.jit
    def program(p):
        return dict(train=jfd.apply(p, x1, z, key),
                    linear=jfd.apply(p, z, noise_key, "linear", 3.0, interval,
                                     method=jfd.sample),
                    pow2=jfd.apply(p, z, noise_key, "pow_2", 3.0, None, method=jfd.sample),
                    draws=_flow_draws(key, 2, 4, 12),
                    noise=jax.random.normal(noise_key, (2, 4, 12)))

    ref = jax.device_get(program(params))
    port = flow.FlowDecoder(**kw, dtype=torch.float32)
    sd = {}
    convert._flow_decoder(jax.tree_util.tree_map(np.asarray, params["params"]), sd, "")
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    out = port.forward_train(torch.from_numpy(x1), torch.from_numpy(z),
                             draws=ref["draws"])
    np.testing.assert_allclose(float(out["mse_loss"]), float(ref["train"]["mse_loss"]), rtol=RTOL)
    _close(out["pred"].detach(), ref["train"]["pred"])
    noise = torch.from_numpy(ref["noise"])
    for name, schedule, interval_ in (("linear", "linear", interval), ("pow2", "pow_2", None)):
        img = port.sample(torch.from_numpy(z), noise, schedule=schedule, cfg=3.0,
                          cfg_interval=interval_)
        assert img.shape == (2, 4, 4, 3)
        _close(img, ref[name])
    plain = port.sample(torch.from_numpy(z), noise, schedule="linear")
    assert np.abs(plain.numpy() - ref["linear"]).max() > 1e-3  # CFG moved the sample


def _check_forward_loss(jax_ref):
    """All five loss terms and their sum, from the JAX draws."""
    out = jax_ref["port"].forward_loss(
        torch.from_numpy(jax_ref["x"]), draws=jax_ref["loss_draws"])
    ref = jax_ref["losses"]
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=RTOL, atol=1e-7, err_msg=k)
    assert float(out["distill_loss"]) > 0 and float(out["lpips_loss"]) == 0.0


def _check_gradients(jax_ref):
    """Every parameter's gradient, by name, through the bridge's layouts."""
    model = jax_ref["port"]
    model.zero_grad()
    model.forward_loss(torch.from_numpy(jax_ref["x"]),
                       draws=jax_ref["loss_draws"])["loss"].backward()
    ref = convert.state_dict_from_jax_uniflow(jax_ref["grads"])
    names = dict(model.named_parameters())
    assert set(names) == set(ref)
    for k, g in ref.items():
        got = names[k].grad
        if got is None:  # the loss does not read it (the CFG mask tokens): JAX's zeros
            assert k.endswith("mask_token") and not g.abs().max(), k
            continue
        _close(got, g.numpy(), rel=GRAD_REL)
    model.zero_grad()


def _check_causal_semantic_trunk(jax_ref):
    """The semantic blocks attend causally: a change in the last latent token
    leaves every earlier condition token as it was."""
    model = jax_ref["port"]
    with torch.no_grad():
        _, _, latent = model.forward_encoder(torch.from_numpy(jax_ref["x"]))
        bumped = latent.clone()
        bumped[:, -1] += 1.0
        a, b = model.run_semantic_trunk(latent), model.run_semantic_trunk(bumped)
    assert torch.equal(a[:, :-1], b[:, :-1]) and not torch.equal(a[:, -1], b[:, -1])


def _check_reconstruct_modes(jax_ref):
    """``forward`` in the semantic mode (ViT tokens) from the JAX starting
    noise (the pixel mode: ``_check_padded_reconstruct``); another mode raises."""
    model, x = jax_ref["port"], torch.from_numpy(jax_ref["x"])
    noise = torch.from_numpy(jax_ref["semantic_noise"])
    semantic = model(x, mode="semantic", noise=noise)
    assert semantic.shape == (2, 16, 256)
    _close(semantic, jax_ref["semantic"])
    with pytest.raises(ValueError, match="mode"):
        model(x, mode="latent")


def _check_padded_reconstruct(jax_ref):
    """``UniFlowExperiment.reconstruct`` in the pixel mode: 30 x 26 pads to
    32 x 32 (multiples of 2 x patch), centred, with zeros, the images are
    reconstructed from the JAX starting noise and cropped back."""
    exp = UniFlowExperiment.__new__(UniFlowExperiment)
    exp.model = jax_ref["port"]
    seen = []
    forward = exp.model.forward
    exp.model.forward = lambda v, **kw: seen.append(v.clone()) or forward(v, **kw)
    noise = torch.from_numpy(jax_ref["small_noise"])
    try:
        out = exp.reconstruct(torch.from_numpy(jax_ref["small"]), noise=noise)
    finally:
        del exp.model.forward
    assert out.shape == (2, 30, 26, 3) and seen[0].shape == (2, 32, 32, 3)
    assert bool((seen[0][:, 0] == 0).all()) and bool((seen[0][:, :, :3] == 0).all())
    _close(out, jax_ref["small_recon"])


def _check_dcae_variant(jax_ref):
    """``decoder_type: dcae``: its pixel condition (``gen_latent_proj`` to
    ``latent_ch``, the headless DC-AE decoder, a bilinear resize onto the
    image, one token a pixel) against JAX's from the same latent; its loss
    terms finite and its reconstruction an image (the per-pixel flow head
    is the main model's ``FlowDecoder`` at patch 1)."""
    model, x = jax_ref["port_dcae"], torch.from_numpy(jax_ref["x"])
    assert not hasattr(model, "global_blocks")
    with torch.no_grad():
        cond = model.run_pixel_trunk(torch.from_numpy(jax_ref["latent"]), (32, 32))
    assert cond.shape == (2, 1024, 16)
    _close(cond, jax_ref["dcae_cond"])
    out = model.forward_loss(x, generator=torch.Generator().manual_seed(0))
    assert set(out) == set(jax_ref["losses"]) and all(np.isfinite(float(v)) for v in out.values())
    img = model(x, generator=torch.Generator().manual_seed(1))
    assert img.shape == (2, 32, 32, 3) and bool(torch.isfinite(img).all())


def _check_bridges(jax_ref):
    """The port's bridge inverts the JAX package's torch -> JAX bridge, and
    the JAX ``uniflow_params_to_torch`` writes the port's keys and values:
    bare, under the Lightning ``model.``/``ema_model.`` namespaces, and
    without the ``mask_token`` the reference model lacks (zero-filled)."""
    params = jax.tree_util.tree_map(np.asarray, jax_ref["params"])
    ours = convert.state_dict_from_jax_uniflow(params)
    bare = uniflow_params_to_torch(params, prefix="")
    assert set(bare) == set(ours) == set(jax_ref["port"].state_dict())
    assert all(np.array_equal(bare[k], ours[k].numpy()) for k in bare)
    # the round trip through the JAX tree gives the port's weights back
    assert all(torch.equal(v, ours[k]) for k, v in jax_ref["port"].state_dict().items())
    model = jax_ref["port"]  # the last check: its weights are overwritten here
    lightning = {**{f"model.{k}": torch.from_numpy(v) for k, v in bare.items()
                    if not k.endswith("mask_token")},
                 **{f"ema_model.{k}": torch.zeros(v.shape) for k, v in bare.items()}}
    model.load_state_dict(convert.uniflow_state_dict(lightning), strict=True)
    assert torch.equal(model.flow_head.mask_token, torch.zeros(1, 1, 64))
    assert torch.equal(model.encoder.layers[1].attn.qkv.weight,
                       torch.from_numpy(bare["encoder.layers.1.attn.qkv.weight"]))
    model.load_state_dict(convert.uniflow_state_dict(lightning, use_ema=True), strict=True)
    assert float(model.mlp1[1].weight.abs().sum()) == 0.0
    assert convert._model_bridge(params) is convert.state_dict_from_jax_uniflow


def test_uniflow_vision_matches_jax():
    """``UniFlowVision`` against the JAX model, every check reading one JAX
    program compiled once (one test, so that the suite's parallel workers
    never compile it twice): the loss terms, every gradient, the causal
    semantic trunk, reconstruction in both modes and of a padded image, the
    DC-AE variant, and the weight bridges."""
    ref = _jax_reference()
    for check in (_check_forward_loss, _check_gradients, _check_causal_semantic_trunk,
                  _check_reconstruct_modes, _check_padded_reconstruct, _check_dcae_variant,
                  _check_bridges):  # _check_bridges last: it loads other weights into the model
        check(ref)


@pytest.mark.parametrize("n", [9, 16])
def test_causal_plain_attention_matches_jax_masked_attention(n):
    """``flash_attention_plain(causal=True)`` and the autograd Function's
    CPU path against ``jax.nn.dot_product_attention`` with a lower-triangular
    mask, the output and the gradients of q, k and v."""
    rng = np.random.default_rng(n)
    q, k, v, w = (rng.standard_normal((2, n, 3, 8)).astype(np.float32) for _ in range(4))
    mask = jnp.tril(jnp.ones((n, n), bool))[None, None]

    def jloss(a, b, c):
        return (jax.nn.dot_product_attention(a, b, c, mask=mask) * w).sum()

    ref, ref_grads = jax.jit(lambda a, b, c: (jax.nn.dot_product_attention(a, b, c, mask=mask),
                                              jax.grad(jloss, argnums=(0, 1, 2))(a, b, c)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    _close(fa.flash_attention_plain(tq, tk, tv, causal=True).detach(), ref, rel=1e-5)
    out = fa.flash_attention(tq, tk, tv, causal=True)
    _close(out.detach(), ref, rel=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        _close(got, want, rel=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_param_count(pixel: bool) -> int:
    cfg = JaxUniFlowConfig.from_pretrained(os.path.join(REPO, "deco_tpu/models/uniflow/config.json"))
    import dataclasses

    model = JaxUniFlowVision(dataclasses.replace(cfg, enable_pixel_branch=pixel))
    x = jnp.zeros((1, 224, 224, 3))
    shapes = jax.eval_shape(lambda r, v: model.init({"params": r}, v, r,
                                                    method=model.forward_loss),
                            jax.random.PRNGKey(0), x)
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


@pytest.mark.parametrize("name", UNIFLOW_CONFIGS)
def test_every_uniflow_config_builds_with_the_jax_parameter_count(name, tmp_path):
    """Each ``configs_flow/uniflow_*.yaml`` builds ``UniFlowRun`` on the meta
    device with the JAX model's parameter count (the semantic-AE config
    without its pixel branch), the configs' optimizer and freeze settings."""
    config = registry.load_yaml(os.path.join(REPO, "configs_flow", name))
    run = workloads.UniFlowRun(config, workdir=str(tmp_path), device="meta")
    m = config["model"]
    pixel = not m.get("train_semantic_ae", False)
    assert run.model_cfg.enable_pixel_branch == pixel
    assert sum(p.numel() for p in run.exp.model.parameters()) == _jax_param_count(pixel)
    if "config_path" in m:
        assert run.train_cfg.lr == float(m["optimizer"]["init_args"]["lr"])
        assert run.train_cfg.frozen_encoder == m.get("frozen_encoder", True)
        assert run.train_cfg.use_ema == m.get("use_ema", True)
        assert run.model_cfg.num_sampling_steps == 4
    else:
        assert run.train_cfg.lr == 1e-4 and not run.train_cfg.frozen_encoder


def test_config_json_loads_like_jax():
    """The port's copy of ``config.json``: every key, ``num_sampling_steps``
    an int, the ``vision_config`` unwrap and ``hidden_size``."""
    ours = UniFlowConfig.from_pretrained()
    ref = JaxUniFlowConfig.from_pretrained(os.path.join(REPO, "deco_tpu/models/uniflow/config.json"))
    assert ours.to_dict() == ref.to_dict()
    assert ours.num_sampling_steps == 4
    wrapped = UniFlowConfig.from_dict({"vision_config": {"hidden_size": 96, "foo": 1}})
    assert wrapped.vit_hidden_size == 96 == JaxUniFlowConfig.from_dict(
        {"vision_config": {"hidden_size": 96}}).vit_hidden_size


def test_uniflow_flops_counts_the_models_matmuls(monkeypatch):
    """``uniflow_flops`` against the products ``forward_loss`` runs, counted
    by module: every linear and patch embedding at the tokens it sees, and
    every attention call (half of QK^T and PV when causal, as the kernel
    visits). The MLP ratio is 4, as in every shipped config."""
    model = UniFlowVision(UniFlowConfig(**{**TINY, "intermediate_size": 256}),
                          dtype=torch.float32, device="cpu")
    counted = []

    def count_linear(module, inputs, out):
        counted.append(2 * out.numel() * module.in_features)

    def count_patches(module, inputs, out):
        counted.append(2 * out.numel() * module.weight[0].numel())

    for module in model.modules():
        if isinstance(module, torch.nn.Linear):
            module.register_forward_hook(count_linear)
        elif isinstance(module, vit.PatchEmbedding):
            module.register_forward_hook(count_patches)
    attention = layers.flash_attention

    def count_attention(q, k, v, scale=None, causal=False):
        b, nq, h, d = q.shape
        counted.append(2 * 2 * b * nq * k.shape[1] * h * d // (2 if causal else 1))
        return attention(q, k, v, scale=scale, causal=causal)

    monkeypatch.setattr(layers, "flash_attention", count_attention)
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    model.forward_loss(x, generator=torch.Generator().manual_seed(0))
    assert sum(counted) == uniflow_flops(image_size=32, patch=4, vit_hidden=64, vit_layers=2,
                                         llm_hidden=24, depth=1, decoder_layers=1)
