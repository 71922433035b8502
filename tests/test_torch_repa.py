"""The port's REPA objectives and their wiring (``deco_tpu_torch.diffusion.
training``: ``REPATrainer``, ``JiTTrainer``, ``VPTrainer``, ``DDPMTrainer``;
``train.state``/``train_step``/``checkpoint``/``loop``) against the JAX
package's, in fp32 on the CPU.

Both sides get the same weights (the tiny DeCoC2I of torch_port_util, its
trunk tapped at block 1, through the weight bridge) and the same draws: the
port takes them as ``draws``, the JAX side's ``jax.random`` is patched to
return them. Tolerances: losses rtol 1e-5; gradients, the projection's
included, rtol 1e-3 plus atol 1e-5 of each tensor's largest value (fp32
backward in another order); post-step parameters and EMA within 1e-4 per
element and 1e-7 on average (tests/test_torch_training.py gives the reason).
One exception: the DDPM objective feeds the network integer timesteps up
to 1,000, where the fp32 sinusoidal embedding (exp of the frequencies, then
cos and sin of arguments in the hundreds) differs between XLA and PyTorch
by an ulp of the argument, so the gradient of ``t_embedder.mlp.0.weight``,
the one layer that reads it, is held at atol 1e-4 of its largest value
there (its loss still at rtol 1e-5).
"""

import itertools
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deco_tpu.diffusion import scheduling as jsched
from deco_tpu.diffusion import training as jtraining
from deco_tpu.models.dit_c2i_deco import DeCoC2I as JDeCoC2I
from deco_tpu.train.state import TrainState as JTrainState
from deco_tpu.train.train_step import make_train_step as jmake_train_step
from deco_tpu_torch import convert
from deco_tpu_torch.diffusion import scheduling as tsched
from deco_tpu_torch.diffusion import training as ttraining
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
from deco_tpu_torch.train import hooks
from deco_tpu_torch.train.checkpoint import CheckpointManager
from deco_tpu_torch.train.state import TrainState
from deco_tpu_torch.train.train_step import make_train_step
from torch_port_util import TINY_C2I, TINY_IMAGE, all_cores, fast_jit, tiny_jax_c2i

HID, ENC, N = TINY_C2I["hidden_size"], 24, 4
PROJ = dict(proj_denoiser_dim=HID, proj_hidden_dim=32, proj_encoder_dim=ENC)
LR, WD, EMA = 1e-3, 0.05, 0.999


def _batch(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, TINY_IMAGE, TINY_IMAGE, 3)).astype(np.float32),
            (np.arange(n) % 10).astype(np.int32), np.full((n,), 10, np.int32))


def _draws(n=N, seed=1, t_normal=None):
    rng = np.random.default_rng(seed)
    return dict(drop_u=rng.uniform(size=n).astype(np.float32),
                t_normal=(rng.standard_normal(n) if t_normal is None
                          else np.asarray(t_normal)).astype(np.float32),
                t_uniform=rng.uniform(size=n).astype(np.float32),
                t_int=rng.integers(0, 1000, n).astype(np.int32),
                noise=rng.standard_normal((n, TINY_IMAGE, TINY_IMAGE, 3)).astype(np.float32))


def _patched(d, uniform_t: bool = False):
    """jax.random returning the draws ``d`` in the JAX trainers' call order:
    the uniforms are the label drop's, then t's when ``uniform_t``."""
    uniforms = itertools.cycle([d["drop_u"], d["t_uniform"]] if uniform_t else [d["drop_u"]])
    n = d["drop_u"].shape[0]
    normal = lambda key, shape=None, dtype=jnp.float32: jnp.asarray(  # noqa: E731
        d["t_normal"] if tuple(shape) == (n,) else d["noise"])
    return (mock.patch.object(jax.random, "normal", side_effect=normal),
            mock.patch.object(jax.random, "uniform",
                              side_effect=lambda key, shape=None, **k: jnp.asarray(next(uniforms))),
            mock.patch.object(jax.random, "randint",
                              side_effect=lambda key, shape, lo, hi, **k: jnp.asarray(d["t_int"])))


def _jencoder(raw):
    """A frozen stand-in encoder, (B, 16, 16, 3) -> (B, 12, 24): 4 x 4 pooled
    colours tiled to 24, the first 12 tokens (fewer than the tap's 16, so
    the src tokens are cut to 12)."""
    b = raw.shape[0]
    pooled = raw.reshape(b, 4, 4, 4, 4, 3).mean(axis=(2, 4)).reshape(b, 16, 3)
    return jnp.tile(pooled, (1, 1, 8))[:, :12]


def _tencoder(raw):
    b = raw.shape[0]
    pooled = raw.reshape(b, 4, 4, 4, 4, 3).mean(dim=(2, 4)).reshape(b, 16, 3)
    return pooled.repeat(1, 1, 8)[:, :12]


def _raw(seed=2, n=N):
    return np.random.default_rng(seed).uniform(0, 1, (n, TINY_IMAGE, TINY_IMAGE, 3)).astype(
        np.float32)


def _trainers(name):
    """(port trainer, JAX trainer, JAX proj params or None) of one kind."""
    if name in ("repa", "jit", "jit_clamp"):
        kw = dict(PROJ, encoder=None, align_layer=1, null_condition_p=0.5, timeshift=2.0)
        if name == "repa":
            t = ttraining.REPATrainer(tsched.LinearScheduler(), lognorm_t=True, **kw)
            j = jtraining.REPATrainer(jsched.LinearScheduler(), lognorm_t=True, **kw)
        else:
            t = ttraining.JiTTrainer(tsched.LinearScheduler(), lognorm_t=name == "jit_clamp", **kw)
            j = jtraining.JiTTrainer(jsched.LinearScheduler(), lognorm_t=name == "jit_clamp", **kw)
        t.encoder, j.encoder = _tencoder, _jencoder
        proj = j.init_params(jax.random.PRNGKey(1))
        t.proj_module.load_state_dict(convert.repa_proj_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, proj)))
        return t, j, proj
    if name == "vp":
        return (ttraining.VPTrainer(tsched.VPScheduler(), lognorm_t=True, null_condition_p=0.5),
                jtraining.VPTrainer(jsched.VPScheduler(), lognorm_t=True, null_condition_p=0.5),
                None)
    return (ttraining.DDPMTrainer(tsched.DDPMScheduler(), null_condition_p=0.5),
            jtraining.DDPMTrainer(jsched.DDPMScheduler(), null_condition_p=0.5), None)


def _port_model(params, align_layer=1):
    model = DeCoC2I(**TINY_C2I, dtype=torch.float32, align_layer=align_layer, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                      patch_size=4))
    return model


def _grads_close(got: dict, want: dict, embedding_atol: float = 1e-5):
    for name, g in got.items():
        w = np.asarray(want[name])
        rel = embedding_atol if name == "t_embedder.mlp.0.weight" else 1e-5
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=rel * np.abs(w).max() + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["repa", "jit", "jit_clamp", "vp", "ddpm"])
def test_trainer_loss_and_gradients_match_jax(name):
    """Losses and every gradient (model and projection) with shared draws;
    ``jit_clamp`` draws t = sigmoid(3.3) ~ 0.964 for a row, where 1 - t <
    t_eps and the clamp acts."""
    jmodel, params = tiny_jax_c2i(seed=2)
    jmodel = JDeCoC2I(**TINY_C2I, dtype=jnp.float32, align_layer=1)
    x, y, uy = _batch()
    d = _draws(t_normal=[3.3, -0.7, 0.2, 1.1] if name == "jit_clamp" else None)
    meta = {"raw_image": _raw()}
    tt, jt, proj = _trainers(name)
    model = _port_model(params)
    losses = tt(model, *(torch.from_numpy(a) for a in (x, y, uy)), draws=d,
                metadata={"raw_image": torch.from_numpy(meta["raw_image"])})
    losses["loss"].backward()

    def jloss(p, pp):
        net = lambda xt, t, yy, **kw: jmodel.apply(p, xt, t, yy, **kw)  # noqa: E731
        out = jt(jax.random.PRNGKey(0), net, *(jnp.asarray(a) for a in (x, y, uy)),
                 {"raw_image": jnp.asarray(meta["raw_image"])}, params=pp)
        return out["loss"], out

    patches = _patched(d, uniform_t=name == "jit")
    # vp's losses sit within the ulps that XLA:CPU's LLVM passes move (7.2e-8
    # against 6.8e-8 under fast_jit): it keeps the default compile
    jit = jax.jit if name == "vp" else fast_jit
    with patches[0], patches[1], patches[2]:
        (_, want), (gm, gp) = jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
            params, proj)
    assert sorted(losses) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(losses[key].detach()), float(want[key]), rtol=1e-5,
                                   err_msg=key)
    if "cos_loss" in want:
        assert float(want["cos_loss"]) > 1e-3
    want_model = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gm), patch_size=4)
    _grads_close({n: p.grad for n, p in model.named_parameters()}, want_model,
                 embedding_atol=1e-4 if name == "ddpm" else 1e-5)
    if proj is not None:
        _grads_close({n: p.grad for n, p in tt.proj_module.named_parameters()},
                     convert.repa_proj_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp)))


def test_cos_loss_takes_precomputed_features_and_cuts_src_tokens():
    proj = ttraining.REPAProjection(8, 16, 4)
    feat = torch.randn(2, 6, 8)
    dst = torch.randn(2, 3, 4)
    got = ttraining._cos_align_loss(proj, feat, {"repa_features": dst}, encoder=None)
    src = proj(feat)[:, :3]
    want = (1 - torch.nn.functional.cosine_similarity(src, dst, dim=-1, eps=0)).mean()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert float(ttraining._cos_align_loss(proj, feat, None, encoder=_tencoder)) == 0.0


def test_cos_loss_of_an_all_zero_tap_has_a_finite_gradient():
    """The safe norms (+1e-24 under the root, 1e-8 below): a zero tap, as
    when align_layer lies past the trunk, gives loss 1 and no NaN."""
    proj = ttraining.REPAProjection(8, 16, 4)
    with torch.no_grad():
        for p in proj.parameters():
            p.zero_()
    feat = torch.zeros(2, 3, 8, requires_grad=True)
    loss = ttraining._cos_align_loss(proj, feat, {"repa_features": torch.randn(2, 3, 4)}, None)
    loss.backward()
    assert float(loss.detach()) == 1.0
    assert all(torch.isfinite(p.grad).all() for p in proj.parameters())


def test_projection_names_follow_the_reference_trainer():
    """The reference trainer's proj is nn.Sequential(nn.Sequential(L, SiLU,
    L, SiLU, L)) (tests/test_trainer_parity.py reads 0.{0,2,4}), so its keys
    are proj.0.0, proj.0.2 and proj.0.4."""
    names = [n for n, _ in ttraining.REPAProjection(8, 16, 4).named_parameters()]
    assert names == [f"proj.0.{i}.{w}" for i in (0, 2, 4) for w in ("weight", "bias")]


@pytest.mark.parametrize("opts", [dict(), dict(accumulate_grad_batches=2, diffusion_batch_mul=2,
                                                grad_clip=0.5)])
@all_cores()
def test_train_step_trains_the_projection_like_jax(opts):
    """One REPA step over the combined {"model", "trainer"} state with the
    raw images in the metadata: post-step parameters, projection and EMA
    against make_train_step + optax.adamw. With diffusion_batch_mul the port
    encodes each microbatch once and repeats the features, the JAX step
    repeats the images and encodes them all: the same numbers."""
    _, params = tiny_jax_c2i(seed=3)
    jmodel = JDeCoC2I(**TINY_C2I, dtype=jnp.float32, align_layer=1)
    tt, jt, proj = _trainers("repa")
    x, y, uy = _batch(seed=4)
    k, mul = opts.get("accumulate_grad_batches", 1), opts.get("diffusion_batch_mul", 1)
    d = _draws(N // k * mul, seed=5)
    raw = _raw(seed=6)
    jstate = jax.jit(lambda p: JTrainState.create(p, optax.adamw(LR, weight_decay=WD)))(
        {"model": params, "trainer": proj})  # one compile, not one per leaf shape
    jstep = jmake_train_step(lambda p, *a, **kw: jmodel.apply(p, *a, **kw), jt, ema_decay=EMA,
                             donate=False, **opts)
    patches = _patched(d)
    with patches[0], patches[1], patches[2]:
        jstate, jmetrics = jstep(jstate, {"x": jnp.asarray(x), "condition": jnp.asarray(y),
                                          "uncondition": jnp.asarray(uy),
                                          "metadata": {"raw_image": jnp.asarray(raw)}},
                                 jax.random.PRNGKey(0))
    model = _port_model(params).train()
    state = TrainState.create(model, lr=LR, weight_decay=WD, trainer_module=tt.proj_module)
    step = make_train_step(tt, ema_decay=EMA, **opts)
    metrics = step(state, {"x": torch.from_numpy(x), "condition": torch.from_numpy(y),
                           "uncondition": torch.from_numpy(uy),
                           "metadata": {"raw_image": torch.from_numpy(raw)}}, draws=[d] * k)
    for key in ("loss", "fm_loss", "cos_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5)
    ckpt = convert.train_checkpoint_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.ema_params),
        jax.tree_util.tree_map(np.asarray, jstate.opt_state[0].mu),
        jax.tree_util.tree_map(np.asarray, jstate.opt_state[0].nu),
        jstate.opt_state[0].count, int(jstate.step), patch_size=4)
    names = [n for n, _ in state.named_parameters()]
    assert sum(n.startswith("diffusion_trainer.proj.0.") for n in names) == 6
    for prefix, values in (("", state.parameters()), ("ema_", state.ema_params)):
        for name, got in zip(names, values):
            key = prefix + (name if name.startswith("diffusion_trainer.") else "denoiser." + name)
            err = np.abs(got.detach().numpy() - ckpt["state_dict"][key].numpy())
            assert err.max() < 1e-4 and err.mean() < 1e-7, (key, err.max(), err.mean())


def test_jax_combined_state_resumes_in_the_port(tmp_path):
    """train_checkpoint_from_jax on a combined JAX state: the port restores
    the model, the projection, both EMAs and every AdamW moment."""
    _, params = tiny_jax_c2i(seed=7)
    _, jt, proj = _trainers("repa")
    rng = np.random.default_rng(8)
    tree = jax.tree_util.tree_map(np.asarray, {"model": params, "trainer": proj})
    noisy = jax.tree_util.tree_map(lambda a: a + rng.standard_normal(a.shape).astype(np.float32),
                                   tree)
    ckpt = convert.train_checkpoint_from_jax(tree, noisy, noisy, tree, count=5, step=5,
                                             patch_size=4)
    CheckpointManager(str(tmp_path)).save(ckpt, 5)
    tt, _, _ = _trainers("repa")
    model = DeCoC2I(**TINY_C2I, dtype=torch.float32, device="cpu")
    state = TrainState.create(model, trainer_module=tt.proj_module)
    CheckpointManager(str(tmp_path)).restore(state)
    assert state.step == 5
    for (name, p), e in zip(state.named_parameters(), state.ema_params):
        key = name if name.startswith("diffusion_trainer.") else "denoiser." + name
        assert torch.equal(p.detach(), ckpt["state_dict"][key])
        assert torch.equal(e, ckpt["state_dict"]["ema_" + key])
        m = state.optimizer.state[p]
        assert torch.equal(m["exp_avg"], ckpt["optimizer"][name]["exp_avg"])
        assert float(m["step"]) == 5


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """TensorBoard's import pulls in TensorFlow (~18 s); not what is checked."""
    monkeypatch.setattr(hooks, "_tensorboard", lambda logdir: None)


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    from deco_tpu_torch.utils import png

    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.RandomState(0)
    for cls in ("a", "b"):
        (root / cls).mkdir()
        for i in range(4):
            png.write(str(root / cls / f"{i}.png"), rng.randint(0, 255, (36, 36, 3), np.uint8))
    return str(root)


def _repa_config(root_dir, png_root, trainer="training_repa.REPATrainer"):
    """tests/test_repa.py's tiny REPA config: Baseline_DiT.yaml's trainer
    surface (a REPA trainer with a random 1-layer DINOv2), diffusion_batch_mul 2."""
    return {
        "tags": {"exp": "tiny_repa_fit"},
        "seed": 3,
        "trainer": {"default_root_dir": root_dir, "max_steps": 3, "log_every_n_steps": 1},
        "model": {
            "vae": {"class_path": "src.models.autoencoder.pixel.PixelAE"},
            "denoiser": {"class_path": "src.models.transformer.dit_c2i_baseline.FlattenDiT",
                         "init_args": {"in_channels": 3, "patch_size": 4, "num_groups": 2,
                                       "hidden_size": 128, "num_blocks": 3, "num_classes": 2,
                                       "dtype": "float32"}},
            "conditioner": {"class_path": "src.models.conditioner.class_label.LabelConditioner",
                            "init_args": {"num_classes": 2}},
            "diffusion_trainer": {
                "class_path": f"src.diffusion.flow_matching.{trainer}",
                "init_args": {"lognorm_t": True, "null_condition_p": 0.2, "align_layer": 2,
                              "proj_denoiser_dim": 128, "proj_hidden_dim": 16,
                              "proj_encoder_dim": 128,
                              "scheduler": "src.diffusion.flow_matching.scheduling.LinearScheduler",
                              "encoder": {"class_path": "src.models.encoder.DINOv2",
                                          "init_args": {"weight_path": None, "hidden_size": 128,
                                                        "num_layers": 1, "num_heads": 2}}}},
            "diffusion_sampler": {
                "class_path": "src.diffusion.flow_matching.sampling.EulerSampler",
                "init_args": {"num_steps": 2, "guidance": 1.0,
                              "scheduler": "src.diffusion.flow_matching.scheduling.LinearScheduler",
                              "guidance_fn": "src.diffusion.base.guidance.simple_guidance_fn",
                              "step_fn": "src.diffusion.flow_matching.sampling.ode_step_fn"}},
            "ema_tracker": {"class_path": "src.callbacks.simple_ema.SimpleEMA",
                            "init_args": {"decay": 0.9}},
            "optimizer": {"class_path": "torch.optim.AdamW", "init_args": {"lr": 1e-3}},
            "diffusion_batch_mul": 2,
        },
        "data": {"train_dataset": {"class_path": "src.data.dataset.imagenet.PixImageNet",
                                   "init_args": {"root": png_root, "resolution": 16}},
                 "train_batch_size": 4, "train_num_workers": 1},
    }


def test_repa_fit_trains_the_projection_and_resumes(tmp_path, png_root):
    """The port of tests/test_repa.py's fit test: Experiment.fit forwards
    raw_image, so cos_loss is logged and non-zero; the model taps at the
    trainer's align layer; the projection is in the optimizer, the EMA and
    the checkpoint; 2 steps and a resume to 3 equal 3 uninterrupted steps
    bit for bit."""
    from deco_tpu_torch.train.loop import Experiment

    exp = Experiment(_repa_config(str(tmp_path / "a"), png_root), device="cpu")
    assert exp.model.align_layer == 2
    proj0 = [p.detach().clone() for p in exp.trainer.proj_module.parameters()]
    state = exp.fit()
    rows = [json.loads(line) for line in open(os.path.join(exp.workdir, "metrics.jsonl"))]
    cos = [r["cos_loss"] for r in rows]
    assert len(cos) == 3 and all(np.isfinite(cos)) and min(cos) > 1e-4, cos
    proj = list(exp.trainer.proj_module.parameters())
    assert all(p in state.optimizer.state for p in proj)
    assert not any(torch.equal(a, b) for a, b in zip(proj0, proj))
    ema_proj = state.ema_params[-len(proj):]
    assert not any(torch.equal(a, b) for a, b in zip(proj0, ema_proj))
    saved = torch.load(os.path.join(exp.workdir, "checkpoints", "3.pt"), weights_only=True)
    for key in ("diffusion_trainer.proj.0.0.weight", "ema_diffusion_trainer.proj.0.4.bias"):
        assert key in saved["state_dict"], key
    assert "diffusion_trainer.proj.0.2.weight" in saved["optimizer"]

    part = Experiment(_repa_config(str(tmp_path / "b"), png_root), device="cpu")
    part.fit(max_steps=2)
    resumed = Experiment(_repa_config(str(tmp_path / "b"), png_root), device="cpu", resume=True)
    again = resumed.fit()
    assert again.step == 3
    for a, b in zip(state.parameters() + state.ema_params, again.parameters() + again.ema_params):
        assert torch.equal(a, b)


def test_jit_fit_through_the_loop(tmp_path, png_root):
    """The JiT trainer node through Experiment.fit: the tap is wired and the
    REPA term is live, as upstream's Baseline_DiT_JiT.yaml has it."""
    from deco_tpu_torch.train.loop import Experiment

    config = _repa_config(str(tmp_path), png_root, trainer="training_repa_JiT.REPATrainer")
    exp = Experiment(config, device="cpu")
    assert isinstance(exp.trainer, ttraining.JiTTrainer) and exp.model.align_layer == 2
    exp.fit(max_steps=1)
    row = json.loads(open(os.path.join(exp.workdir, "metrics.jsonl")).readline())
    assert np.isfinite(row["fm_loss"]) and row["cos_loss"] > 1e-4
