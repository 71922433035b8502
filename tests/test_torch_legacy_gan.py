"""The port's legacy TiTok losses (``models/gan/legacy_losses.py``) and
adversarial heads (``models/gan/adv_head.py``) against the JAX package's, on
the CPU, fp32.

``TiTokLoss``: the generator's and the discriminator's objectives and every
metric, across the three stages, both quantize modes, l1 and l2, before
and after the discriminator starts, with LeCam on, within 1e-5 relative.
The heads: each of the three on the JAX head's weights, converted by
``convert.adv_head_state_dict_from_jax``, within 1e-5. The registry: the
three reference class paths build ``TiTokLoss`` as the JAX registry builds
it (ROADMAP §C 16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.config import registry as jregistry
from deco_tpu.models.gan import adv_head as jadv
from deco_tpu.models.gan import legacy_losses as jlegacy
from deco_tpu.models.gan.vae_loss import LeCamState as JLeCamState
from deco_tpu_torch import convert
from deco_tpu_torch.config import registry
from deco_tpu_torch.models.gan import adv_head, legacy_losses
from deco_tpu_torch.models.gan.vae_loss import LeCamState

CASES = [(0, "vq", "l2"), (1, "vq", "l1"), (1, "vae", "l2"), (2, "vq", "l2"), (2, "vae", "l1")]


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (4, 8, 8, 3)).astype(np.float32)
    r = np.tanh(rng.normal(0, 1, (4, 8, 8, 3))).astype(np.float32)
    extra = dict(quantizer_loss=np.float32(0.37), commitment_loss=np.float32(0.11),
                 codebook_loss=np.float32(0.26), kl=np.float32(41.5),
                 distill_feat=rng.normal(0, 1, (4, 5)).astype(np.float32))
    return x, r, extra


def _disc(mod, w=0.7):
    """A discriminator of images: w * tanh of each image's mean, a logit per image."""
    return lambda x: mod.tanh(x.mean(axis=(1, 2, 3)) * 3.0) * w


def _perceptual(mod):
    return lambda a, b: mod.abs(a - b).mean(axis=(1, 2, 3)) * 2.0


def _distill(a, feat):
    return ((a.mean(axis=(1, 2, 3))[:, None] - feat) ** 2).mean()


def _close(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k in ref:
        a, b = float(ours[k]), float(np.asarray(ref[k]))
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (k, a, b)


@pytest.mark.parametrize("stage,mode,rec", CASES, ids=[f"s{s}-{m}-{r}" for s, m, r in CASES])
@pytest.mark.parametrize("step", [3, 10], ids=["before_disc", "after_disc"])
def test_titok_loss_matches_jax(stage, mode, rec, step):
    kw = dict(stage=stage, quantize_mode=mode, reconstruction_loss=rec, discriminator_start=5,
              lecam_regularization_weight=0.1, lecam_ema_decay=0.9, kl_weight=1e-3,
              logvar_init=0.3, distill_weight=0.5, perceptual_weight=1.1)
    x, r, extra = _arrays(stage)
    jl, ours = jlegacy.TiTokLoss(**kw), legacy_losses.TiTokLoss(**kw)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: torch.from_numpy(np.asarray(v)) for k, v in extra.items()}
    jtotal, jm = jl.generator_loss(lambda p, im: _disc(jnp)(im), None, jnp.asarray(x),
                                   jnp.asarray(r), jextra, step, _perceptual(jnp), _distill)
    total, m = ours.generator_loss(_disc(torch), torch.from_numpy(x), torch.from_numpy(r),
                                   textra, step, _perceptual(torch), _distill)
    _close(m, jm)
    _close({"t": total}, {"t": jtotal})
    lecam = JLeCamState(ema_real=jnp.float32(0.2), ema_fake=jnp.float32(-0.1))
    jd, jlecam, jdm = jl.discriminator_loss(lambda p, im: _disc(jnp)(im), None, jnp.asarray(x),
                                            jnp.asarray(r), step, lecam)
    d, tlecam, dm = ours.discriminator_loss(
        _disc(torch), torch.from_numpy(x), torch.from_numpy(r), step,
        LeCamState(torch.tensor(0.2), torch.tensor(-0.1)))
    _close(dm, jdm)
    _close({"d": d, "real": tlecam.ema_real, "fake": tlecam.ema_fake},
           {"d": jd, "real": jlecam.ema_real, "fake": jlecam.ema_fake})


def test_titok_base_stage_refuses_vae_as_jax():
    for cls in (jlegacy.TiTokLoss, legacy_losses.TiTokLoss):
        with pytest.raises(ValueError, match="Base stage"):
            cls(stage=0, quantize_mode="vae")


@pytest.mark.parametrize("name", ["ReconstructionLoss_Base", "ReconstructionLoss_Stage1",
                                  "ReconstructionLoss_Stage2"])
def test_legacy_loss_class_paths_build_titok_loss_as_jax(name):
    node = {"class_path": f"src.models.modules.losses.{name}",
            "init_args": {"quantize_mode": "vq", "discriminator_weight": 0.2}}
    ours, ref = registry.instantiate(node), jregistry.instantiate(node)
    assert isinstance(ours, legacy_losses.TiTokLoss)
    assert isinstance(ref, jlegacy.TiTokLoss)
    assert vars(ours) == vars(ref)
    assert ours.stage == 1  # the JAX mapping's default, whatever the class path says


def _head_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (2, 64, 48)).astype(np.float32),
            rng.normal(0, 1, (2, 40)).astype(np.float32),
            rng.normal(0, 1, (2, 64, 24)).astype(np.float32))


@pytest.mark.parametrize("head", ["ConvHead", "ConvLinearMMHead", "ConvMMHead"])
def test_adv_heads_match_jax_with_converted_weights(head):
    im, vec, grid = _head_inputs()
    second = {"ConvHead": None, "ConvLinearMMHead": vec, "ConvMMHead": grid}[head]
    jhead = getattr(jadv, head)(hidden_size=32)
    args = (jnp.asarray(im),) + (() if second is None else (jnp.asarray(second),))
    params = jax.jit(jhead.init)(jax.random.PRNGKey(3), *args)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape), params)
    ref = np.asarray(jax.jit(jhead.apply)(params, *args))
    kw = {} if second is None else {"mm_channels": second.shape[-1]}
    ours = getattr(adv_head, head)(32, in_channels=im.shape[-1], **kw)
    ours.load_state_dict(convert.adv_head_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        out = ours(torch.from_numpy(im), *(() if second is None else (torch.from_numpy(second),)))
    assert out.shape == ref.shape == (2, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert ((out >= 0.01) & (out <= 0.99)).all()


def test_adv_head_refuses_a_token_count_that_is_no_square():
    with pytest.raises(ValueError, match="square"):
        adv_head.ConvHead(32)(torch.zeros(1, 10, 32))
