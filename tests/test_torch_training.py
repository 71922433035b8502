"""The port's training path (deco_tpu_torch.diffusion.training, .train)
against the JAX package's, on the CPU in fp32.

Both sides get the same weights (the tiny config, unit-scale, through the
port's weight bridge) and the same draws: the port takes them as ``draws``,
and the JAX side's ``jax.random.normal``/``uniform`` are patched to return
them, as tests/test_trainer_parity.py does. Tolerances: losses rtol 1e-5;
gradients atol 1e-5 of each tensor's largest value plus rtol 1e-3 (fp32
backward in another order). Post-step parameters and EMA, at lr 1e-3:
every element within 1e-4 and the mean within 1e-7. AdamW's first step
moves a parameter by lr * g / (|g| + eps), about lr, so a wrong sign or
scale of the update shows at 1e-3, and a systematic error (coupled weight
decay: lr * wd * p) in the mean; but where |g| is near eps (1e-8) the ratio
magnifies fp32 rounding of g, and single elements were seen 1e-5 and
4.3e-5 apart.
"""

import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deco_tpu.diffusion import training as jtraining
from deco_tpu.diffusion.scheduling import LinearScheduler as JLinear
from deco_tpu.train.schedules import cosine_with_min_lr as jcosine
from deco_tpu.train.state import TrainState as JTrainState
from deco_tpu.train.state import ema_decay_schedule as jema_schedule
from deco_tpu.train.train_step import make_train_step as jmake_train_step
from deco_tpu_torch.convert import state_dict_from_jax
from deco_tpu_torch.diffusion import training as ttraining
from deco_tpu_torch.diffusion.scheduling import LinearScheduler, bcast_right
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
from deco_tpu_torch.train.schedules import cosine_with_min_lr
from deco_tpu_torch.train.state import TrainState, ema_decay_schedule
from deco_tpu_torch.train.train_step import make_train_step
from torch_port_util import (TINY_C2I, TINY_IMAGE, all_cores,
                             fast_jit, port_c2i_from_jax, tiny_jax_c2i)

TRAINER_KW = dict(lognorm_t=True, null_condition_p=0.5, enable_freq_loss=True)
LR, WD, EMA = 1e-3, 0.05, 0.999


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, TINY_IMAGE, TINY_IMAGE, 3)).astype(np.float32)
    return x, (np.arange(n) % 10).astype(np.int32), np.full((n,), 10, np.int32)


def _draws(n, seed=1):
    rng = np.random.default_rng(seed)
    return dict(drop_u=rng.uniform(size=n).astype(np.float32),
                t_normal=rng.standard_normal(n).astype(np.float32),
                t_uniform=rng.uniform(size=n).astype(np.float32),
                mix_u=np.linspace(0.0, 1.0, n).astype(np.float32),  # both t branches
                noise=rng.standard_normal((n, TINY_IMAGE, TINY_IMAGE, 3)).astype(np.float32))


def _patched_jax_draws(d):
    """Patch jax.random so the JAX trainer draws ``d`` (in its call order)."""
    uniforms = itertools.cycle([d["drop_u"], d["t_uniform"], d["mix_u"]])
    n = d["drop_u"].shape[0]

    def normal(key, shape=None, dtype=jnp.float32):
        return jnp.asarray(d["t_normal"] if tuple(shape) == (n,) else d["noise"])

    return (mock.patch.object(jax.random, "normal", side_effect=normal),
            mock.patch.object(jax.random, "uniform",
                              side_effect=lambda key, shape=None, **k: jnp.asarray(next(uniforms))))


def _state_dict(params):
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             patch_size=TINY_C2I["patch_size"])
    return {k: v.numpy() for k, v in sd.items()}


def test_weight_fns_time_shift_and_coeffs():
    a, s = np.array([0.3, 0.9], np.float32), np.array([0.7, 0.1], np.float32)
    for name, fn in ttraining.LOSS_WEIGHT_FNS.items():
        got = fn(torch.from_numpy(a), torch.from_numpy(s))
        want = jtraining.LOSS_WEIGHT_FNS[name](jnp.asarray(a), jnp.asarray(s))
        np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want), rtol=1e-6)
    t = np.array([0.1, 0.5, 0.8], np.float32)
    np.testing.assert_allclose(ttraining.time_shift_fn(torch.from_numpy(t), 3.0).numpy(),
                               np.asarray(jtraining.time_shift_fn(jnp.asarray(t), 3.0)), rtol=1e-6)
    for got, want in zip(LinearScheduler().isotropic_coeffs(torch.from_numpy(t)),
                         JLinear().isotropic_coeffs(jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert bcast_right(torch.from_numpy(t), 4).shape == (3, 1, 1, 1)


@pytest.mark.parametrize("name", ["deco", "deco_no_freq", "flow_matching"])
def test_trainer_losses_match_jax(name):
    jmodel, params = tiny_jax_c2i(seed=2)
    model = port_c2i_from_jax(params)
    x, y, uy = _batch(4)
    d = _draws(4)
    kw = dict(TRAINER_KW, enable_freq_loss=name == "deco")
    if name == "flow_matching":
        del kw["enable_freq_loss"]
        tt = ttraining.FlowMatchingTrainer(LinearScheduler(), **kw)
        jt = jtraining.FlowMatchingTrainer(JLinear(), **kw)
    else:
        tt, jt = ttraining.DeCoTrainer(LinearScheduler(), **kw), jtraining.DeCoTrainer(JLinear(), **kw)
    with torch.no_grad():
        got = tt(model, *(torch.from_numpy(a) for a in (x, y, uy)), draws=d)
    normal, uniform = _patched_jax_draws(d)
    with normal, uniform:  # jitted: one compile, not an eager dispatch per op
        want = fast_jit(lambda p: jt(jax.random.PRNGKey(0), lambda *a: jmodel.apply(p, *a),
                                    *(jnp.asarray(a) for a in (x, y, uy))))(params)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(accumulate_grad_batches=2, diffusion_batch_mul=2, grad_clip=0.5),
])
@all_cores()
def test_train_step_matches_jax(opts):
    """One whole step: loss, gradients (without accumulation), post-step
    parameters and EMA, against make_train_step + optax.adamw."""
    jmodel, params = tiny_jax_c2i(seed=3)
    model = port_c2i_from_jax(params).train()
    x, y, uy = _batch(4, seed=4)
    k, mul = opts.get("accumulate_grad_batches", 1), opts.get("diffusion_batch_mul", 1)
    d = _draws(4 // k * mul, seed=5)
    jtrainer = jtraining.DeCoTrainer(JLinear(), **TRAINER_KW)
    jstate = jax.jit(lambda p: JTrainState.create(p, optax.adamw(LR, weight_decay=WD)))(
        params)  # one compile, not one per leaf shape
    jstep = jmake_train_step(lambda p, *a, **kw: jmodel.apply(p, *a, **kw), jtrainer,
                             ema_decay=EMA, donate=False, **opts)
    batch = dict(x=x, condition=y, uncondition=uy)
    normal, uniform = _patched_jax_draws(d)
    with normal, uniform:
        jstate, jmetrics = jstep(jstate, {k_: jnp.asarray(v) for k_, v in batch.items()},
                                 jax.random.PRNGKey(0))
        if k == 1:  # jitted: one compile, not an eager dispatch per op (~10 s here)
            grads = fast_jit(jax.grad(lambda p: jtrainer(
                jax.random.PRNGKey(0), lambda *a: jmodel.apply(p, *a),
                *(jnp.asarray(a) for a in (x, y, uy)))["loss"]))(params)

    state = TrainState.create(model, lr=LR, weight_decay=WD)
    step = make_train_step(ttraining.DeCoTrainer(LinearScheduler(), **TRAINER_KW),
                           ema_decay=EMA, **opts)
    metrics = step(state, {k_: torch.from_numpy(v) for k_, v in batch.items()}, draws=[d] * k)
    for key in ("loss", "fm_loss", "fm_loss_freq"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5)
    if "grad_clip" in opts:
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                                   rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    if k == 1:
        want = _state_dict(grads)
        for name, p in model.named_parameters():
            scale = np.abs(want[name]).max()
            np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-3,
                                       atol=1e-5 * scale + 1e-12, err_msg=name)
    for got, want in ((dict(model.named_parameters()), _state_dict(jstate.params)),
                      (dict(zip(names, state.ema_params)), _state_dict(jstate.ema_params))):
        for name in names:
            err = np.abs(got[name].detach().numpy() - want[name])
            assert err.max() < 1e-4 and err.mean() < 1e-7, (name, err.max(), err.mean())
    assert state.step == int(jstate.step) == 1


@pytest.mark.parametrize("remat", [dict(grad_checkpoint=True),
                                   dict(grad_checkpoint=True, trunk_remat_policy="none")])
def test_remat_gives_the_same_gradients(remat):
    _, params = tiny_jax_c2i(seed=6)
    x, y, uy = (torch.from_numpy(a) for a in _batch(2, seed=7))
    d = _draws(2, seed=8)
    trainer = ttraining.DeCoTrainer(LinearScheduler(), **TRAINER_KW)
    grads = []
    for kw in (dict(), remat):
        model = port_c2i_from_jax(params)
        sd = model.state_dict()
        model = DeCoC2I(**TINY_C2I, **kw, dtype=torch.float32, device="cpu")
        model.load_state_dict(sd)
        trainer(model, x, y, uy, draws=d)["loss"].backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy", ["dots", "attn"])
def test_unported_remat_policies_raise(policy):
    """Every policy of the JAX package is ported now (tests/test_torch_remat.py);
    a name it does not know raises."""
    assert DeCoC2I(**TINY_C2I, grad_checkpoint=True, trunk_remat_policy=policy,
                   device="cpu").trunk_checkpoint
    with pytest.raises(ValueError, match="trunk_remat_policy"):
        DeCoC2I(**TINY_C2I, grad_checkpoint=True, trunk_remat_policy=policy.upper(),
                device="cpu")


def test_param_dtype_keeps_fp32_master_weights():
    model = DeCoC2I(**TINY_C2I, dtype=torch.bfloat16, param_dtype=torch.float32, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.blocks[0].attn.qkv.compute_dtype == torch.bfloat16
    with pytest.raises(TypeError, match="float32"):
        TrainState.create(DeCoC2I(**TINY_C2I, dtype=torch.bfloat16, device="cpu"))


@pytest.mark.parametrize("kw", [dict(), dict(use_ema_warmup=True, update_after_step=3),
                                dict(update_every=4, min_decay=0.5)])
def test_schedules_match_jax(kw):
    for step in (0, 1, 2, 5, 17, 1000):
        np.testing.assert_allclose(ema_decay_schedule(step, **kw),
                                   float(jema_schedule(step, **kw)), rtol=1e-6)
    ours, theirs = cosine_with_min_lr(1e-3, 10, 100, 1e-5), jcosine(1e-3, 10, 100, 1e-5)
    for step in (0, 5, 10, 50, 100, 200):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-5)
