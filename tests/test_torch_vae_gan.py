"""The port's VAE-GAN (deco_tpu_torch.models.vae_models, .gan, .perceptual,
train.vae_gan_step, train.workloads, the registry's VAE nodes, eval_dcae and
the CLI routing) against the JAX package, on the CPU.

A tiny width, the published one cut to size: a 2-layer ViT of width 64 (2
heads of 32, patch 14, a 56 px position table, RMSNorm and the qk-norm),
the generation tap at layer 1, ``llm_hidden_size`` 48, the DC-AE decoder of
tests/test_torch_dcae.py (channels 8 ... 64, one layer a stage, head dim
32), 56 px images (a 2 x 2 latent), fp32 on both sides. The port's
parameters are drawn from a seed with no parameter zero (the zero-initialised
residual layers carry signal) and reach the JAX package through its own
torch converters (``convert_vae_encoder``, ``dcae_decoder_params_from_torch``,
``convert_discriminator``, ``vgg16_params_from_torch``,
``convnext_s_params_from_torch``): the port keeps the reference torch names.

Tolerances: the issue-wide fp32 tolerance, 1e-5 relative (outputs atol 1e-5
x the reference's largest value, scalars rtol 1e-5), except where a test
states another: parameters after AdamW steps, see test_two_steps_match_jax.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deco_tpu.convert import dcae_bridge
from deco_tpu.convert.torch_to_flax import (
    _vision_tower_and_mlp1,
    convert_discriminator,
    convert_vae_encoder,
)
from deco_tpu.models import internvl as jinternvl
from deco_tpu.models import perceptual as jperceptual
from deco_tpu.models import vae_models as jvae
from deco_tpu.models.gan import discriminator as jdisc
from deco_tpu.models.gan import vae_loss as jloss
from deco_tpu.models.uniflow.vit import ViTConfig as JaxViTConfig
from deco_tpu.train import freeze as jfreeze
from deco_tpu.train import schedules as jschedules
from deco_tpu.train import vae_gan_step as jstep
from deco_tpu.train import workloads as jworkloads
from deco_tpu_torch import cli, eval_dcae
from deco_tpu_torch.config import registry
from deco_tpu_torch.models import internvl, perceptual, vae_models
from deco_tpu_torch.models.gan import discriminator, vae_loss
from deco_tpu_torch.models.uniflow.vit import ViTConfig
from deco_tpu_torch.train import hooks, schedules, vae_gan_step, workloads
from torch_port_util import FAST_COMPILE, all_cores, fast_jit, numpy_state, randomize_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, patch_size=14,
           image_size=56, qk_normalization=True, norm_type="rms_norm", initializer_factor=0.1)
DECODER = dict(decoder_channels=(8, 16, 32, 32, 64, 64), decoder_layers=(1,) * 6)
TINY = dict(llm_hidden_size=48, gen_select_layer=1, **DECODER)
SIZE = 56
ATOL = 1e-5  # x the reference's largest value
RTOL = 1e-5
VAE_CONFIGS = ["vae_training.yaml", "vae_training_flat.yaml", "vae_training_sim.yaml",
               "vae_training_sim_stage2.yaml", "vae_training_stage2.yaml",
               "vae_training_stage2_224.yaml", "vae_val_224px.yaml", "vae_val_256px.yaml",
               "vae_val_448px_sim.yaml", "vae_val_sim.yaml"]
JSONL_CONFIGS = ["vae_training.yaml", "vae_training_sim.yaml", "vae_training_sim_stage2.yaml"]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """``torch.utils.tensorboard`` pulls TensorFlow into the process (~18 s)."""
    monkeypatch.setattr(hooks, "_tensorboard", lambda logdir: None)


def _close(out, ref, atol=ATOL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= atol * max(np.abs(ref).max(), 1e-30), (err, np.abs(ref).max())


def _images(seed, n=2, size=SIZE):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def port_vae(stochastic=False, seed=0):
    model = vae_models.VAEModel(ViTConfig(**VIT), stochastic=stochastic, dtype=torch.float32,
                                device="cpu", **TINY)
    return randomize_(model, seed, scale=0.5)


def jax_vae_params(model) -> dict:
    """The JAX VAEModel's parameters from the port model's state dict."""
    sd = numpy_state(model)
    params = convert_vae_encoder(sd)
    params["decoder"] = dcae_bridge.dcae_decoder_params_from_torch(
        {k[8:]: v for k, v in sd.items() if k.startswith("decoder.")})
    return jax.tree.map(jnp.asarray, params)


def jax_vae(stochastic=False):
    return jvae.VAEModel(vit=JaxViTConfig(**VIT), stochastic=stochastic, dtype=jnp.float32,
                         latent_channel=32, **TINY)


# ---- the generator ----

@pytest.mark.parametrize("stochastic", [False, True])
def test_vae_model_matches_jax(stochastic):
    """The reconstruction and the student features; stochastic: the KL and
    the sample with the posterior noise JAX draws from its key, injected."""
    model = port_vae(stochastic)
    params, jmodel = jax_vae_params(model), jax_vae(stochastic)
    x = _images(1)
    key = jax.random.PRNGKey(3)
    recon, extra = fast_jit(lambda p, v: jmodel.apply({"params": p}, v, key if stochastic
                                                      else None))(params, x)
    noise = None
    if stochastic:
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, (2, 4, 32), jnp.float32)))
    with torch.no_grad():
        out, ours = model(torch.from_numpy(x), noise=noise)
    assert out.shape == (2, SIZE, SIZE, 3)
    _close(out.numpy(), recon)
    _close(ours["student_features"].numpy(), extra["student_features"])
    assert set(ours) == set(extra)
    if stochastic:
        np.testing.assert_allclose(float(ours["kl"]), float(extra["kl"]), rtol=RTOL)
        with torch.no_grad():  # no noise and no generator: the posterior mean
            mean_out, _ = model(torch.from_numpy(x))
        ref_mean, _ = fast_jit(lambda p, v: jmodel.apply({"params": p}, v))(params, x)
        _close(mean_out.numpy(), ref_mean)


def test_vae_model_in_bf16_runs_and_tracks_fp32():
    """The bf16 compute path (the shipped dtype) on the CPU: finite, and
    within 5% (relative L2) of the same weights in fp32."""
    model = port_vae()
    bf16 = vae_models.VAEModel(ViTConfig(**VIT), dtype=torch.bfloat16, device="cpu", **TINY)
    bf16.load_state_dict(model.state_dict())
    x = torch.from_numpy(_images(2))
    with torch.no_grad():
        ref, out = model(x)[0], bf16(x)[0]
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert ((out.float() - ref).norm() / ref.norm()).item() < 0.05


def test_internvl_vision_and_dcae_decoder_eval_match_jax():
    """InternVL's extract_feature path (last layer) into the DC-AE eval
    decoder (three residual LayerNorm-GELU blocks, the 32-channel MLP, the
    decoder)."""
    enc = randomize_(internvl.InternVLVision(ViTConfig(**VIT), llm_hidden_size=48,
                                               dtype=torch.float32, device="cpu"), 4, 0.5)
    dec = randomize_(vae_models.DCAEDecoderEval(llm_hidden_size=48, dtype=torch.float32,
                                                device="cpu", **DECODER), 5, 0.5)
    enc_params = _vision_tower_and_mlp1(numpy_state(enc))
    sd = numpy_state(dec)

    def dense(name):
        return {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}

    def ln(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}

    dec_params = {f"down_blocks_{i}": {"norm": ln(f"down_blocks.{i}.norm"),
                                       "fc1": dense(f"down_blocks.{i}.fc1"),
                                       "fc2": dense(f"down_blocks.{i}.fc2")} for i in range(3)}
    dec_params.update(down_norm=ln("down_norm"), down_fc1=dense("down_fc1"),
                      down_fc2=dense("down_fc2"), decoder=dcae_bridge.dcae_decoder_params_from_torch(
                          {k[8:]: v for k, v in sd.items() if k.startswith("decoder.")}))
    jenc = jinternvl.InternVLVision(vit=JaxViTConfig(**VIT), llm_hidden_size=48,
                                    dtype=jnp.float32)
    jdec = jvae.DCAEDecoderEval(llm_hidden_size=48, dtype=jnp.float32, **DECODER)
    x = _images(6)
    feats, out = fast_jit(lambda pe, pd, v: (lambda f: (f, jdec.apply({"params": pd}, f)))(
        jenc.apply({"params": pe}, v)))(enc_params, dec_params, x)
    with torch.no_grad():
        ours = enc(torch.from_numpy(x))
        _close(ours.numpy(), feats)
        _close(dec(ours).numpy(), out)


# ---- the discriminator and the perceptual towers ----

@pytest.mark.parametrize("hw", [(37, 64), (264, 264)])  # odd "SAME" pads; the 16 x 16 max pool
def test_discriminator_matches_jax(hw):
    disc = randomize_(discriminator.NLayerDiscriminator(hidden_channels=32), 7)
    params = convert_discriminator(numpy_state(disc))
    jd = jdisc.NLayerDiscriminator(hidden_channels=32)
    x = np.random.default_rng(8).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = fast_jit(lambda p, v: jd.apply({"params": p}, v))(params, x)
    with torch.no_grad():
        out = disc(torch.from_numpy(x)).numpy()
    assert out.shape == np.shape(ref) and out.shape[-1] == 1
    _close(out, ref)


def test_lpips_matches_jax():
    lp = randomize_(perceptual.LPIPS(), 9)
    params = jperceptual.vgg16_params_from_torch(numpy_state(lp))
    a, b = (np.random.default_rng(s).uniform(0, 1, (2, 32, 40, 3)).astype(np.float32)
            for s in (10, 11))
    ref = fast_jit(lambda p, u, v: jperceptual.LPIPS().apply(p, u, v))(params, a, b)
    with torch.no_grad():
        out = lp(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert out.shape == (2,)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL)


def test_convnext_s_matches_jax():
    cn = randomize_(perceptual.ConvNeXtS(), 12, 0.5)
    params = jperceptual.convnext_s_params_from_torch(numpy_state(cn))
    x = np.random.default_rng(13).uniform(-2, 2, (2, 32, 32, 3)).astype(np.float32)
    ref = fast_jit(lambda p, v: jperceptual.ConvNeXtS().apply(p, v))(params, x)
    with torch.no_grad():
        _close(cn(torch.from_numpy(x)).numpy(), ref)


class _Stand:
    """A tower stand-in with the Flax ``apply(params, *inputs)`` surface."""

    def __init__(self, fn):
        self.fn = fn

    def apply(self, params, *inputs):
        return self.fn(*inputs)


class _TorchStand(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(*inputs)


def test_perceptual_loss_matches_jax():
    """The combination (weights 1.0 and 0.1 from the name), the ConvNeXt
    input resized from 48 to 224 px and normalised, and the logit MSE,
    with both towers replaced on both sides by seeded stand-ins (a channel-
    weighted squared error for LPIPS, a projection of the whole 224 px
    input for ConvNeXt-S) whose outputs depend on every step before them;
    the towers themselves are held by test_lpips_matches_jax and
    test_convnext_s_matches_jax."""
    rng = np.random.default_rng(14)
    wl = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    wc = (rng.standard_normal((224 * 224 * 3, 4)) / 388.0).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = perceptual.PerceptualLoss("lpips-convnext_s-1.0-0.1", device="cpu")
    # the towers: frozen, in the torchvision (and LPIPS) layouts the JAX
    # converters read
    assert not any(p.requires_grad for p in ours.parameters())
    assert {"features.0.weight", "lin0.model.1.weight"} <= set(ours.lpips.state_dict())
    assert {"features.1.0.block.3.weight", "features.1.0.layer_scale",
            "classifier.2.weight"} <= set(ours.convnext.state_dict())
    ref = jperceptual.PerceptualLoss("lpips-convnext_s-1.0-0.1", lpips_params={"unused": 0},
                                     convnext_params={"unused": 0})
    ours.lpips = _TorchStand(lambda a, b: (((a - b) ** 2) * torch.from_numpy(wl)).mean((1, 2, 3)))
    ours.convnext = _TorchStand(lambda x: x.reshape(x.shape[0], -1) @ torch.from_numpy(wc))
    ref.lpips = _Stand(lambda a, b: jnp.mean((a - b) ** 2 * wl, axis=(1, 2, 3)))
    ref.convnext = _Stand(lambda x: x.reshape(x.shape[0], -1) @ wc)
    a, b = (rng.uniform(0, 1, (2, 48, 48, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        out = ours(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (ours.w_lpips, ours.w_convnext) == (1.0, 0.1) == (ref.w_lpips, ref.w_convnext)
    np.testing.assert_allclose(out, np.asarray(ref(a, b)), rtol=RTOL)


def test_random_perceptual_towers_warn():
    with pytest.warns(UserWarning, match="LPIPS running with random weights"):
        perceptual.PerceptualLoss("lpips", device="cpu")


# ---- the losses ----

def test_loss_pieces_match_jax():
    rng = np.random.default_rng(18)
    real, fake = rng.standard_normal((2, 4, 4, 1)), rng.standard_normal((2, 4, 4, 1))
    np.testing.assert_allclose(
        float(vae_loss.hinge_d_loss(torch.tensor(real), torch.tensor(fake))),
        float(jloss.hinge_d_loss(jnp.asarray(real), jnp.asarray(fake))), rtol=RTOL)
    args = (0.3, -0.2, 0.1, 0.5)
    np.testing.assert_allclose(
        float(vae_loss.compute_lecam_loss(*map(torch.tensor, args))),
        float(jloss.compute_lecam_loss(*map(jnp.asarray, args))), rtol=RTOL)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    param = torch.nn.Parameter(torch.from_numpy(w))
    ours = vae_loss.adaptive_d_weight((param ** 2).sum() * 3, (param ** 3).sum(), [param], 0.1)
    ref = jloss.adaptive_d_weight(lambda t: (t ** 2).sum() * 3, lambda t: (t ** 3).sum(),
                                  jnp.asarray(w), 0.1)
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)


@pytest.mark.parametrize("step", [0, 5])  # before and after discriminator_iter_start
def test_generator_and_discriminator_losses_match_jax(step):
    cfg = dict(reconstruction_loss="l1", discriminator_iter_start=5, distillation_weight=0.5,
               distillation_loss_type="cosine", lecam_regularization_weight=0.01)
    ours, ref = vae_loss.VAEGANLoss(**cfg), jloss.VAEGANLoss(**cfg)
    rng = np.random.default_rng(19)
    x, r = (rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    sf, tf = (rng.standard_normal((2, 4, 6)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((3,)).astype(np.float32)

    def disc_t(img):
        return (img * torch.from_numpy(w)).sum(-1, keepdim=True)

    def disc_j(img):
        return (img * jnp.asarray(w)).sum(-1, keepdims=True)

    total, metrics = ours.generator_loss(torch.from_numpy(x), torch.from_numpy(r), disc_t, step,
                                         student_features=torch.from_numpy(sf),
                                         teacher_features=torch.from_numpy(tf))
    jtotal, jmetrics = ref.generator_loss(x, r, disc_j, step, student_features=sf,
                                          teacher_features=tf)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=RTOL, err_msg=k)
    state = vae_loss.LeCamState(torch.tensor(0.2), torch.tensor(-0.1))
    d, dm, new = ours.discriminator_loss(torch.from_numpy(x), torch.from_numpy(r), disc_t, step,
                                         state)
    jd, jdm, jnew = ref.discriminator_loss(x, r, disc_j, step,
                                           jloss.LeCamState(jnp.float32(0.2), jnp.float32(-0.1)))
    np.testing.assert_allclose(float(d), float(jd), rtol=RTOL)
    for k in dm:
        np.testing.assert_allclose(float(dm[k]), float(jdm[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose([float(new.ema_real), float(new.ema_fake)],
                               [float(jnew.ema_real), float(jnew.ema_fake)], rtol=RTOL)


# ---- the training step ----

LOSS = dict(reconstruction_loss="l2", perceptual_weight=1.1, discriminator_weight=0.1,
            discriminator_iter_start=1, lecam_regularization_weight=0.01, kl_weight=1e-3)
LR, WD, BETAS, EMA = 1e-3, 1e-2, (0.9, 0.95), 0.9
# AdamW's first update of an element is lr x g / (|g| + eps): at optax's eps
# of 1e-8 an element whose |g| is near eps (the corner taps of the decoder's
# conv_in over a 2 x 2 latent; the LeCam-only gradient of the discriminator
# at step 0) turns fp32 noise in g into a few percent of lr (seen: 2.4e-2 x
# lr after one step, and d_weight 1.4e-4 apart at the next). The two-step
# test takes eps 1e-4 on both sides, over most gradients here, so the
# update follows g smoothly; the parameters are held to 1e-5 relative plus
# 1e-2 x lr absolute.
EPS = 1e-4
UPDATE_ATOL = 1e-2 * LR


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
@all_cores()
def two_steps():
    """Two steps of the JAX step (jitted) and the port's on the same
    weights, images and posterior noise; the discriminator starts at step 1."""
    model = port_vae(stochastic=True, seed=20)
    disc = randomize_(discriminator.NLayerDiscriminator(hidden_channels=32, num_stages=2), 21)
    # the perceptual term: a seeded stand-in on both sides (the towers are
    # held by their own tests; VGG16 in the jitted step costs ~10 s here)
    wl = np.random.default_rng(22).uniform(0.5, 1.5, 3).astype(np.float32)
    perc = _TorchStand(lambda a, b: (((a - b) ** 2) * torch.from_numpy(wl)).mean((1, 2, 3)))

    def jperc(a, b):
        return jnp.mean((a - b) ** 2 * wl, axis=(1, 2, 3))

    before = {"vae": numpy_state(model), "disc": numpy_state(disc)}

    jmodel = jax_vae(stochastic=True)
    jd = jdisc.NLayerDiscriminator(hidden_channels=32, num_stages=2)
    make_tx = lambda: optax.adamw(jschedules.cosine_with_min_lr(LR, 0, 100, 0.0), b1=BETAS[0],
                                  b2=BETAS[1], eps=EPS, weight_decay=WD)
    gen_params = jax_vae_params(model)
    # jitted: the zero moments and the EMA copy in one compile, not one per leaf shape
    jstate = jax.jit(lambda g, d: jstep.VAEGANTrainState.create(g, d, make_tx(), make_tx(),
                                                                ema=True))(
        gen_params, convert_discriminator(before["disc"]))
    loss_cfg = jloss.VAEGANLoss(**LOSS)
    step_fn = jstep.make_vae_gan_step(
        vae_apply=lambda p, x, r: jmodel.apply({"params": p}, x, r),
        disc_apply=lambda p, img: jd.apply({"params": p}, img), loss_cfg=loss_cfg,
        last_layer_path=("decoder", "conv_out"), perceptual_fn=jperc, grad_clip=1.0,
        ema_decay=EMA, donate=False)

    schedule = schedules.cosine_with_min_lr(LR, 0, 100, 0.0)
    state = vae_gan_step.VAEGANTrainState.create(model, disc, (WD, BETAS), (WD, BETAS),
                                                 schedule, schedule, ema=True)
    for opt in (state.gen_opt, state.disc_opt):
        for group in opt.param_groups:
            group["eps"] = EPS
    ours = vae_gan_step.make_vae_gan_step(vae_loss.VAEGANLoss(**LOSS), perceptual_fn=perc,
                                          grad_clip=1.0, ema_decay=EMA)
    results = []
    for i in range(2):
        x = _images(30 + i)
        key = jax.random.PRNGKey(40 + i)
        if i == 0:  # one compile for both steps, as fast_jit compiles
            step_fn = step_fn.lower(jstate, {"x": jnp.asarray(x)}, key).compile(FAST_COMPILE)
        jstate, jmetrics = step_fn(jstate, {"x": jnp.asarray(x)}, key)
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, (2, 4, 32), jnp.float32)))
        metrics = ours(state, torch.from_numpy(x), noise=noise)
        results.append((jax.device_get(jmetrics), {k: float(v) for k, v in metrics.items()},
                        _flat(jax.device_get(jstate.gen_params)), _port_params(model),
                        jax.device_get(jstate), state))
    return before, results, (model, disc)


# after the discriminator starts, the terms through it (its mean logits
# are ~1e-2 over values of order 1, and their fp32 sums cancel) carry ~1e-5
# of relative error, which d_weight, the clipped norm and the total inherit
GAN_TERMS = ("total_loss", "gan_loss", "d_weight", "logits_real", "logits_fake", "lecam_loss",
             "gen_grad_norm")
GAN_RTOL = 1e-4


def _port_params(model) -> dict:
    """The port's generator parameters under the JAX tree's names."""
    return _flat(jax_vae_params(model))


@pytest.mark.parametrize("step", [0, 1], ids=["before_disc_start", "after_disc_start"])
def test_two_steps_match_jax(two_steps, step):
    """Each step's metrics (``gen_grad_norm``, ``d_weight`` and the losses)
    at rtol 1e-5 (after the discriminator starts, its terms at GAN_RTOL) and
    the parameters after it."""
    _, results, _ = two_steps
    jmetrics, metrics, jparams, params, _, _ = results[step]
    for k in ("total_loss", "reconstruction_loss", "perceptual_loss", "gan_loss", "d_weight",
              "kl_loss", "discriminator_loss", "logits_real", "logits_fake", "lecam_loss",
              "gen_grad_norm", "disc_grad_norm"):
        rtol = GAN_RTOL if step and k in GAN_TERMS else RTOL
        np.testing.assert_allclose(metrics[k], float(jmetrics[k]), rtol=rtol, err_msg=k)
    assert metrics["d_weight"] > 0 and metrics["kl_loss"] > 0
    assert jparams.keys() == params.keys()
    for k in jparams:
        np.testing.assert_allclose(params[k], jparams[k], rtol=RTOL, atol=UPDATE_ATOL,
                                   err_msg=k)


def test_two_steps_move_the_state_like_jax(two_steps):
    """After both steps: the LeCam EMA, the discriminator's parameters and
    the generator EMA (e d + p (1 - d) after each update)."""
    before, results, (model, disc) = two_steps
    _, _, _, _, jstate, state = results[-1]
    np.testing.assert_allclose([float(state.lecam.ema_real), float(state.lecam.ema_fake)],
                               [float(jstate.lecam.ema_real), float(jstate.lecam.ema_fake)],
                               rtol=GAN_RTOL)
    assert state.step == int(jstate.step) == 2
    jd = _flat(jstate.disc_params)
    ours = _flat(convert_discriminator(numpy_state(disc)))
    for k in jd:
        np.testing.assert_allclose(ours[k], jd[k], rtol=RTOL, atol=UPDATE_ATOL, err_msg=k)
    ema_model = port_vae(stochastic=True)
    with torch.no_grad():
        for p, e in zip(ema_model.parameters(), state.gen_ema):
            p.copy_(e)
    ema, jema = _port_params(ema_model), _flat(jstate.gen_ema_params)
    for k in jema:
        np.testing.assert_allclose(ema[k], jema[k], rtol=RTOL, atol=UPDATE_ATOL, err_msg=k)
    start = np.transpose(before["vae"]["decoder.conv_out.weight"], (2, 3, 1, 0))
    assert np.abs(ema["decoder/conv_out/kernel"] - start).max() > 0


def test_frozen_tower_keeps_its_gradient_in_the_norm():
    """``freeze_encoder``: the tower's gradient counts in ``gen_grad_norm``
    (as under JAX's ``with_frozen``, which zeroes the update after the clip),
    its parameters do not move, and every other parameter takes the update
    of the unfrozen step; the JAX mask freezes the same subtree."""
    runs = []
    for frozen in ((), ("vision_model",)):
        model = port_vae(seed=23)
        disc = randomize_(discriminator.NLayerDiscriminator(hidden_channels=32, num_stages=2), 24)
        schedule = schedules.cosine_with_min_lr(LR, 0, 100, 0.0)
        state = vae_gan_step.VAEGANTrainState.create(model, disc, (WD, BETAS), (WD, BETAS),
                                                     schedule, schedule, frozen=frozen)
        step = vae_gan_step.make_vae_gan_step(vae_loss.VAEGANLoss(**LOSS))
        before = numpy_state(model)
        metrics = step(state, torch.from_numpy(_images(25)))
        runs.append((before, numpy_state(model), float(metrics["gen_grad_norm"])))
    (b0, a0, n0), (b1, a1, n1) = runs
    assert n0 == n1
    for k in a1:
        if k.startswith("vision_model."):
            np.testing.assert_array_equal(a1[k], b1[k])
        else:
            np.testing.assert_array_equal(a1[k], a0[k])
    mask = jfreeze.freeze_mask(jax_vae_params(port_vae(seed=23)), ["vision_model"])
    assert not any(jax.tree.leaves(mask["vision_model"])) and all(jax.tree.leaves(mask["decoder"]))


# ---- the workload ----

def _png_folder(root, count=4, size=SIZE):
    from deco_tpu_torch.utils import png

    rng = np.random.default_rng(0)
    for c in range(2):
        os.makedirs(os.path.join(root, f"class_{c}"), exist_ok=True)
        for i in range(count // 2):
            png.write(os.path.join(root, f"class_{c}", f"{i}.png"),
                      rng.integers(0, 256, (size + 8 * i, size, 3), dtype=np.uint8))
    return str(root)


def _tiny_reference_config(folder, root) -> dict:
    """configs/vae_training_stage2_224.yaml with the deterministic encoder
    node (the posterior's noise is a draw of each framework's own), the tiny
    widths, no perceptual towers (test_two_steps_match_jax holds LPIPS in
    the step), image-folder data nodes, a log line a step and FID at 64
    features."""
    config = registry.load_yaml(os.path.join(REPO, "configs/vae_training_stage2_224.yaml"))
    node = config["model"]["vae_model"]
    node["class_path"] = "src.models.transformer.encoder_ae_sim.VAEModel"
    node["init_args"].update({f"vit_{k}": v for k, v in VIT.items()},
                             llm_hidden_size=48, gen_select_layer=1,
                             decoder_channels="8,16,32,32,64,64", decoder_layers=1,
                             dtype="float32")
    config["model"]["loss_module"]["init_args"]["perceptual_loss"] = None
    image_node = {"class_path": "src.data.dataset.imagenet.PixImageNet",
                  "init_args": {"root": folder, "resolution": SIZE}}
    config["data"].update(train_dataset=image_node, eval_dataset=image_node, train_batch_size=2,
                          pred_batch_size=2, train_num_workers=1, pred_num_workers=1)
    config["trainer"].update(default_root_dir=str(root), log_every_n_steps=1)
    for cb in config["trainer"]["callbacks"]:
        if cb["class_path"].endswith("ComputeMetricsHook"):
            cb["init_args"]["fid_feature_dim"] = 64
    config["mesh"] = {"data": 1}
    return config


def test_reference_schema_fit_and_validate_match_jax(tmp_path, monkeypatch):
    """``VAEGANRun`` fit (one step: the JAX run compiles its step again for
    a second, ~10 s here) and validate through the reference schema on
    both sides, from the same weights (the port's seeded draw, handed to
    the JAX run), the same images: the logged metrics at rtol 1e-5
    (d_weight 1e-3), PSNR after the AdamW update at rtol 1e-4 and SSIM at
    atol 1e-5 (see the comments below), and the port's FID finite (each side has its own random
    Inception tower; the JAX run's is left out for time)."""
    folder = _png_folder(tmp_path / "png")
    config = _tiny_reference_config(folder, tmp_path / "work")
    run = workloads.VAEGANRun(json.loads(json.dumps(config)), device="cpu")
    init = run._init_state
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state = run.fit(max_steps=1)
        scores = run.validate(max_batches=1)
    assert state.step == 1 and run.workdir.endswith("vae_latent_mlp_layernorm_cos_lr5e-5_stage2")

    # the JAX run: the same tiny model, weights and LPIPS tower
    first = workloads.VAEGANRun(json.loads(json.dumps(config)), device="cpu")
    s0 = init.__func__(first)
    sd = numpy_state(s0.vae)
    gen0 = convert_vae_encoder(sd)
    gen0["decoder"] = dcae_bridge.dcae_decoder_params_from_torch(
        {k[8:]: v for k, v in sd.items() if k.startswith("decoder.")})
    disc0 = convert_discriminator(numpy_state(s0.disc))
    from deco_tpu.config import registry as jregistry

    monkeypatch.setattr(jregistry, "_make_vae_model",
                        lambda stochastic, **kw: jax_vae(stochastic))
    # the JAX run hands the YAML 1.1 string '2e-4' to optax, which fails at
    # its first update (the port's optimizer nodes read it as a number)
    jconfig = json.loads(json.dumps(config))
    for key in ("optimizer", "discriminator_optimizer"):
        args = jconfig["model"][key]["init_args"]
        args["lr"] = float(args["lr"])
    for cb in jconfig["trainer"]["callbacks"]:  # its random Inception tower costs ~1 min here
        if cb["class_path"].endswith("ComputeMetricsHook"):
            cb["init_args"]["compute_fid"] = False
    from deco_tpu.train import hooks as jhooks

    logger_init = jhooks.ScalarLogger.__init__  # TensorBoard's import takes ~18 s here
    monkeypatch.setattr(jhooks.ScalarLogger, "__init__", lambda self, *a, **kw: logger_init(
        self, *a, **{**kw, "use_tensorboard": False}))
    jrun = jworkloads.VAEGANRun(jconfig, workdir=str(tmp_path / "jax_work"))

    def init_from_port(batch, res):
        """``VAEGANRun._init_state`` with the port's weights in place of a
        Flax init (whose eager initializers take ~20 s here)."""
        make = lambda spec: optax.adamw(jschedules.cosine_with_min_lr(spec[0], 0, 200000, 0.0),
                                        b1=spec[2][0], b2=spec[2][1], weight_decay=spec[1])
        # jitted: the optimizers' zero moments in one compile, not one per leaf shape
        return jrun._place(jax.jit(lambda g, d: jstep.VAEGANTrainState.create(
            g, d, make(jrun.gen_opt), make(jrun.disc_opt), ema=jrun.use_ema))(gen0, disc0))

    jrun._init_state = init_from_port
    jrun._step_fn = fast_jit(jrun._make_step())  # its step compiled as the fixture's is
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jrun.fit(max_steps=1)
        jscores = jrun.validate(max_batches=1)

    def lines(path):
        return [json.loads(line) for line in open(os.path.join(path, "metrics.jsonl"))]

    (ours,), (ref,) = lines(run.workdir), lines(jrun.workdir)
    assert ours["step"] == ref["step"] == 0
    # d_weight reads the GAN gradient of the decoder's conv_out through the
    # discriminator's GroupNorms, whose E[x^2] - E[x]^2 variance (Flax's, on
    # both sides) cancels in fp32: at these weights that gradient's norm is
    # 2.8e-4 off its fp64 value on the port's side alone, so d_weight is held
    # to 1e-3
    for k in ("total_loss", "reconstruction_loss", "perceptual_loss", "gan_loss", "d_weight",
              "gen_grad_norm", "discriminator_loss", "lecam_loss"):
        rtol = 1e-3 if k == "d_weight" else RTOL
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, atol=1e-7, err_msg=k)
    # the scores follow one AdamW update at optax's eps of 1e-8, where fp32
    # noise in gradients near eps moves parameters by a few percent of lr
    # (test_two_steps_match_jax holds the parameters at 1e-5 with eps 1e-4):
    # PSNR is held to 1e-4; SSIM of a random reconstruction is ~1e-2, so it
    # is held absolutely
    np.testing.assert_allclose(scores["metrics/psnr"], jscores["metrics/psnr"], rtol=1e-4)
    np.testing.assert_allclose(scores["metrics/ssim"], jscores["metrics/ssim"], atol=1e-5)
    assert np.isfinite(scores["metrics/fid"])
    written = json.load(open(os.path.join(run.workdir, "validate_metrics.json")))
    assert written == pytest.approx(scores)
    assert sorted(os.listdir(os.path.join(run.workdir, "checkpoints"))) == ["1.pt"]


def test_fit_resumes_from_its_checkpoint(tmp_path):
    """2 steps, then a run over the same workdir resumes at step 2 and takes a
    third: every parameter, moment, EMA and the LeCam state come back."""
    folder = _png_folder(tmp_path / "png")
    config = _tiny_reference_config(folder, tmp_path / "work")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = workloads.VAEGANRun(json.loads(json.dumps(config)), device="cpu")
        state = run.fit(max_steps=2)
        saved = run._payload(state)
        again = workloads.VAEGANRun(json.loads(json.dumps(config)), device="cpu")
        resumed = again._restore(workloads.CheckpointManager(
            os.path.join(again.workdir, "checkpoints")), again._init_state())
    assert resumed.step == 2
    back = again._payload(resumed)
    for k, v in saved["state_dict"].items():
        assert torch.equal(back["state_dict"][k], v), k
    for k, m in saved["optimizer"].items():
        assert all(torch.equal(back["optimizer"][k][n], m[n]) for n in m), k
    assert torch.equal(back["lecam"]["ema_real"], saved["lecam"]["ema_real"])


def test_flat_schema_fits(tmp_path):
    """configs/vae_training_flat.yaml's schema: the model from ``model.vit``,
    the discriminator and loss sections, ``train_root``."""
    folder = _png_folder(tmp_path / "png")
    config = registry.load_yaml(os.path.join(REPO, "configs/vae_training_flat.yaml"))
    config["model"].update(vit=VIT, llm_hidden_size=48, gen_select_layer=1,
                           decoder_channels=list(DECODER["decoder_channels"]),
                           decoder_layers=list(DECODER["decoder_layers"]))
    config["discriminator"].update(hidden_channels=32, num_stages=2)
    config["loss"]["perceptual_model"] = "lpips"
    config["data"].update(train_root=folder, resolution=SIZE, batch_size=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = workloads.VAEGANRun(config, workdir=str(tmp_path / "w"), device="cpu")
        state = run.fit(max_steps=1)
    assert state.step == 1 and run.loss_cfg.distillation_loss_type == "cosine"
    assert run.loss_cfg.discriminator_iter_start == 20000
    assert os.path.exists(tmp_path / "w" / "checkpoints" / "1.pt")


def test_validate_pads_to_the_patch_canvas_and_crops_back(tmp_path):
    """64 px images pad to 84 px (a multiple of 2 x 14) with -1, and the
    reconstruction is cropped back to 64 px before scoring (vae_val_256px's
    path at a tiny size)."""
    folder = _png_folder(tmp_path / "png", size=64)
    config = _tiny_reference_config(folder, tmp_path / "work")
    config["data"]["eval_dataset"]["init_args"]["resolution"] = 64
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = workloads.VAEGANRun(config, device="cpu")
        forward = run.vae.forward
        run.vae.forward = lambda x, **kw: seen.append(x.clone()) or forward(x, **kw)
        scores = run.validate(max_batches=1)
    (x,) = seen
    assert x.shape == (2, 84, 84, 3)
    assert bool((x[:, :10] == -1).all()) and bool((x[:, -10:] == -1).all())
    assert np.isfinite(scores["metrics/psnr"])
    panels = os.listdir(os.path.join(run.workdir, "images"))
    assert len(panels) == 2


# ---- the configs and the CLI ----

@pytest.mark.parametrize("name", VAE_CONFIGS)
def test_every_vae_config_builds_its_model_and_loss_nodes(name):
    """The model (full width, on the meta device), the discriminator and the
    loss settings of each VAE config, against the JAX run's reading."""
    config = registry.load_yaml(os.path.join(REPO, "configs", name))
    run = workloads.VAEGANRun(config, workdir="/tmp/unused_vae_workdir", device="meta")
    jcfg = jworkloads._TrainerSection(config)
    assert (run.trainer.max_steps, run.trainer.grad_clip, run.trainer.ckpt_every) == (
        jcfg.max_steps, jcfg.grad_clip, jcfg.ckpt_every)
    assert run.vae.vit.hidden_size == 1024 and len(run.vae.vision_model.encoder.layers) == 24
    assert run.vae.vision_model.encoder.select_layer == 18
    n_params = sum(p.numel() for p in run.vae.parameters())
    assert n_params == _jax_vae_params_count(run.vae.stochastic), name
    m = config["model"]
    if "loss_module" in m:
        args = m["loss_module"]["init_args"]
        assert run.loss_cfg.discriminator_iter_start == args["discriminator_start"]
        assert run.perceptual_spec == args["perceptual_loss"]
        assert run.freeze_encoder == m.get("freeze_encoder", False)
        assert run.use_ema == ("ema_tracker" in m)
        lr, wd, betas = jworkloads._opt_args(m.get("optimizer"), 1e-4)
        assert run.gen_opt == (float(lr), float(wd), tuple(float(b) for b in betas))
    assert sum(p.numel() for p in run.disc.parameters()) > 0


_COUNTS: dict = {}


def _jax_vae_params_count(stochastic: bool) -> int:
    if stochastic not in _COUNTS:
        model = jvae.VAEModel(stochastic=stochastic)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 224, 224, 3)))
        _COUNTS[stochastic] = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    return _COUNTS[stochastic]


@pytest.mark.parametrize("name", JSONL_CONFIGS)
def test_jsonl_trained_configs_read_through_their_data_node(name, tmp_path):
    """Their model and loss nodes build, and their PixMultiJSONLDataset node
    (which raised before the reader was ported) builds from the config's
    arguments over a JSON source list of PNGs and reads an item at the
    config's resolution, as ``VAEGANRun`` loads it."""
    from deco_tpu_torch.utils import png

    config = registry.load_yaml(os.path.join(REPO, "configs", name))
    workloads.VAEGANRun(config, workdir=str(tmp_path / "w"), device="meta")
    rng = np.random.default_rng(0)
    png.write(str(tmp_path / "a.png"), rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
    (tmp_path / "ann.jsonl").write_text(json.dumps({"target_image": "a.png"}) + "\n")
    (tmp_path / "sources.json").write_text(json.dumps({"src": {
        "root": str(tmp_path), "annotation": str(tmp_path / "ann.jsonl"), "repeat_time": 2}}))
    node = config["data"]["train_dataset"]
    node["init_args"]["config_path"] = str(tmp_path / "sources.json")
    data = config["data"]
    dataset = workloads._make_dataset(data, "train_dataset", 224)
    assert len(dataset) == 2 and data["train_batch_size"] > 0
    x, label, meta = dataset[0]
    res = node["init_args"]["resolution"]
    assert x.shape == (res, res, 3) and label == 0 and meta["raw_image"].shape == x.shape


@pytest.mark.parametrize("path,kind,sub", [
    ("configs/vae_training_stage2_224.yaml", "vae_gan", "fit"),
    ("configs/vae_val_224px.yaml", "vae_gan", "validate"),
    ("configs/vae_val_256px.yaml", "vae_gan", "validate"),
    ("configs_flow/dcae_decoder_eval.yaml", "dcae_eval", "validate"),
])
def test_cli_routes_vae_and_dcae_configs(monkeypatch, path, kind, sub):
    calls = []
    monkeypatch.setattr(workloads, "run_vae_gan", lambda config, **kw: calls.append(
        ("vae_gan", kw)) or "ran")
    monkeypatch.setattr(workloads, "run_dcae_eval", lambda config, **kw: calls.append(
        ("dcae_eval", kw)) or "ran")
    assert cli.main([sub, "-c", os.path.join(REPO, path), "--device", "cpu",
                     "--max_batches", "1"]) == "ran"
    ((got, kw),) = calls
    assert got == kind and kw["device"] == "cpu" and kw["max_batches"] == 1
    if kind == "vae_gan":
        assert kw["subcommand"] == sub


def test_dcae_eval_reads_the_config_as_jax_does(monkeypatch):
    from deco_tpu import eval_dcae as jeval

    seen = {}
    config = registry.load_yaml(os.path.join(REPO, "configs_flow/dcae_decoder_eval.yaml"))
    monkeypatch.setattr(eval_dcae, "evaluate", lambda **kw: seen.setdefault("ours", kw))
    monkeypatch.setattr(jeval, "evaluate", lambda **kw: seen.setdefault("jax", kw))
    workloads.run_dcae_eval(config, max_batches=2, device="cpu")
    jworkloads.run_dcae_eval(config, max_batches=2)
    assert seen["ours"].pop("device") == "cpu"
    assert seen["ours"] == seen["jax"]


def test_eval_dcae_scores_a_folder(tmp_path, capsys):
    """``evaluate`` on a PNG folder with small networks: the top-left crop of
    each 64 px output to the 56 px input, finite PSNR and SSIM, one JSON line."""
    folder = _png_folder(tmp_path / "png")
    enc = vae_models.init_like_jax_(internvl.InternVLVision(
        ViTConfig(**VIT), llm_hidden_size=48, dtype=torch.float32, device="cpu"), 0)
    dec = vae_models.init_like_jax_(vae_models.DCAEDecoderEval(
        llm_hidden_size=48, dtype=torch.float32, device="cpu", **DECODER), 1)
    out = eval_dcae.evaluate(folder, resolution=SIZE, batch_size=2, max_batches=2,
                             device="cpu", encoder=enc, decoder=dec)
    assert out["num_batches"] == 2 and np.isfinite(out["psnr"]) and np.isfinite(out["ssim"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
