"""The port's opt-in extras against the JAX package, on the CPU: the
Adafactor optimizer node (``optax.adafactor`` / ``transformers.Adafactor``,
``deco_tpu_torch/train/state.Adafactor``), MSDCN (``ops/msdcn.py``),
``utils/image.py`` and ``utils/profiling.py``.

Tolerances (fp32 throughout):
- Adafactor against ``optax.adafactor`` over 5 steps: rtol 1e-5 (the means
  of the second moments and the block RMS sum in another order);
- MSDCN's output and parameter gradients against JAX's: atol 1e-5 of the
  reference's largest magnitude (an einsum over 9 points and 4 corners).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deco_tpu.config import registry as jax_registry
from deco_tpu.ops import msdcn as jax_msdcn
from deco_tpu.utils import image as jax_image
from deco_tpu_torch.config import registry
from deco_tpu_torch.ops import msdcn
from deco_tpu_torch.train.checkpoint import CheckpointManager
from deco_tpu_torch.train.state import Adafactor, TrainState
from deco_tpu_torch.utils import image, profiling
from torch_port_util import redraw

ADAFACTOR_RTOL = 1e-5
MSDCN_ATOL = 1e-5
SHAPES = {"matrix": (256, 384), "vector": (1152,), "kernel": (3, 3, 8, 16)}


# ---- Adafactor ----

def _grads(step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-2, 1)).astype(np.float32)
            for k, s in SHAPES.items()}


def _params() -> dict:
    rng = np.random.default_rng(0)
    # the vector near zero: its block RMS under 1e-3 takes optax's floor
    return {k: (rng.standard_normal(s) * (1e-4 if k == "vector" else 0.1)).astype(np.float32)
            for k, s in SHAPES.items()}


def test_adafactor_matches_optax_over_five_steps():
    lr = 3e-3
    tx = optax.adafactor(lr)
    jparams = {k: jnp.asarray(v) for k, v in _params().items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in _params().items()}
    opt = Adafactor(list(tparams.values()), lr=lr)
    for step in range(5):
        grads = _grads(step)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=ADAFACTOR_RTOL, atol=1e-9, err_msg=f"{k} {step}")
    state = opt.state[tparams["matrix"]]
    assert state["v_row"].shape == (256,) and state["v_col"].shape == (384,)
    assert "v" in opt.state[tparams["kernel"]] and "v" in opt.state[tparams["vector"]]
    np.testing.assert_allclose(state["v_row"].numpy(), np.asarray(jstate[0].v_row["matrix"]),
                               rtol=ADAFACTOR_RTOL)
    assert float(state["step"]) == 5 and int(jstate[0].count) == 5


@pytest.mark.parametrize("class_path", ["optax.adafactor", "transformers.Adafactor"])
def test_adafactor_nodes_build_the_optimizer(class_path):
    node = registry.instantiate({"class_path": class_path, "init_args": {"lr": "3e-4"}})
    assert node.lr == 3e-4
    model = torch.nn.Linear(4, 3)
    state = node.create_state(model)
    assert isinstance(state.optimizer, Adafactor) and state.ema_params is not None
    assert state.optimizer.param_groups[0]["lr"] == 3e-4


def test_adafactor_node_rejects_unhonorable_args():
    """tests/test_configs.py's cases, port and JAX side by side: the
    transformers knobs at their defaults pass, weight decay and unknown
    arguments raise TypeError naming them."""
    for reg in (registry, jax_registry):
        reg.instantiate({"class_path": "transformers.Adafactor",
                         "init_args": {"lr": 3e-4, "scale_parameter": False}})
        with pytest.raises(TypeError, match="weight_decay"):
            reg.instantiate({"class_path": "transformers.Adafactor",
                             "init_args": {"lr": 3e-4, "weight_decay": 0.01}})
        with pytest.raises(TypeError, match="beta1"):
            reg.instantiate({"class_path": "optax.adafactor",
                             "init_args": {"lr": 3e-4, "beta1": 0.9}})


def _adafactor_state(seed: int):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(160, 192), torch.nn.Linear(192, 8))
    return TrainState.create(model, optimizer=lambda params: Adafactor(params, lr=1e-2))


def _step(state, seed: int):
    g = torch.Generator().manual_seed(seed)
    for p in state.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    state.optimizer.step()
    state.step += 1


def test_adafactor_state_round_trips_through_a_checkpoint(tmp_path):
    """The factored state (step, v_row, v_col; v for the vectors) saves and
    restores by parameter name; the next step is bit-equal after it."""
    a = _adafactor_state(0)
    _step(a, 1)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.maybe_save(a, force=True)
    saved = torch.load(ckpt.path(1), weights_only=True)["optimizer"]
    assert set(saved["0.weight"]) == {"step", "v_row", "v_col"}
    assert set(saved["1.weight"]) == {"step", "v"} and set(saved["0.bias"]) == {"step", "v"}
    b = _adafactor_state(5)
    ckpt.restore(b)
    assert b.step == 1
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
        for key, value in a.optimizer.state[p].items():
            assert torch.equal(value, b.optimizer.state[q][key]), key
    _step(a, 2)
    _step(b, 2)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


# ---- MSDCN ----

DCN = dict(groups=2, channels=8, kernels=9, max_scale=6.0)
DIM = 12


def _dcn_params():
    jm = jax_msdcn.MultiScaleDCN(**DCN)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 6, 5, DIM)))
    return jm, jax.tree_util.tree_map(np.asarray, redraw(shapes, seed=3))


def _port_dcn(params) -> msdcn.MultiScaleDCN:
    """The weight mapping: each Dense kernel (in, out) is the Linear's
    weight transposed, biases as they are, the prior scale as it is."""
    m = msdcn.MultiScaleDCN(DIM, **DCN)
    p = params["params"]
    with torch.no_grad():
        for name in ("v", "qk_deformables", "qk_scales", "qk_weights", "out"):
            lin = getattr(m, name)
            lin.weight.copy_(torch.from_numpy(np.array(p[name]["kernel"]).T))
            if lin.bias is not None:
                lin.bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
        m.deformables_scale.copy_(torch.from_numpy(np.array(p["deformables_scale"])))
    return m


def test_msdcn_forward_and_gradients_match_jax():
    jm, params = _dcn_params()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5, DIM)).astype(np.float32)
    r = rng.standard_normal((2, 6, 5, DIM)).astype(np.float32)
    loss = lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * r)  # noqa: E731
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    jgrads = jax.grad(loss)(params)["params"]
    m = _port_dcn(params)
    out = m(torch.from_numpy(x))
    atol = MSDCN_ATOL * np.abs(ref).max()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=atol)
    (out * torch.from_numpy(r)).sum().backward()
    for name in ("v", "qk_deformables", "qk_scales", "qk_weights", "out"):
        lin = getattr(m, name)
        want = np.asarray(jgrads[name]["kernel"]).T
        np.testing.assert_allclose(lin.weight.grad.numpy(), want, rtol=0,
                                   atol=MSDCN_ATOL * np.abs(want).max(), err_msg=name)
        if lin.bias is not None:
            want = np.asarray(jgrads[name]["bias"])
            np.testing.assert_allclose(lin.bias.grad.numpy(), want, rtol=0,
                                       atol=MSDCN_ATOL * np.abs(want).max(), err_msg=name)
    want = np.asarray(jgrads["deformables_scale"])
    np.testing.assert_allclose(m.deformables_scale.grad.numpy(), want, rtol=0,
                               atol=MSDCN_ATOL * np.abs(want).max())


def test_deformable_sample_is_zero_outside_and_exact_on_the_grid():
    """Offsets of whole pixels read the grid exactly; a point off the image
    reads zero, as in the JAX op."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal((1, 4, 5, 2, 3)).astype(np.float32)
    deform = np.zeros((1, 4, 5, 2, 2, 2), np.float32)
    deform[..., 1, 0] = 1.0  # the second point one pixel to the right
    deform[0, :, 4, :, 1, 0] = 1.0  # past the right edge there
    w = np.ones((1, 4, 5, 2, 2), np.float32)
    out = msdcn.deformable_sample(*map(torch.from_numpy, (v, deform, w))).numpy()
    ref = np.asarray(jax_msdcn.deformable_sample(*map(jnp.asarray, (v, deform, w))))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[0, :, :4], v[0, :, :4] + v[0, :, 1:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[0, :, 4], v[0, :, 4], rtol=0, atol=1e-6)


def test_msdcn_starts_at_the_prior_grid():
    """Zero-initialised projections: the offsets are the 3 x 3 prior grid
    times sigmoid(group prior) * max_scale; the output moves with x."""
    m = msdcn.MultiScaleDCN(DIM, **DCN)
    assert m.prior[0, 0, 0, 0, :, 0].tolist() == [-1, 0, 1] * 3
    assert not m.qk_deformables.weight.any() and not m.qk_weights.bias.any()
    np.testing.assert_allclose(torch.sigmoid(m.deformables_scale).reshape(-1).detach().numpy(),
                               [0.5 - 1e-4, 1 - 1e-4], rtol=1e-5)


# ---- utils/image and utils/profiling ----

def test_image_conversions_match_jax():
    rng = np.random.default_rng(6)
    x01 = rng.uniform(-0.1, 1.1, (2, 5, 4, 3)).astype(np.float32)
    t = torch.from_numpy(x01)
    for name in ("normalize_to_neg1_to_1", "normalize_from_neg1_to_1", "normalize_imagenet",
                 "to_uint8"):
        np.testing.assert_array_equal(getattr(image, name)(t).numpy(),
                                      np.asarray(getattr(jax_image, name)(jnp.asarray(x01))),
                                      err_msg=name)
    for clamp in (True, False):
        np.testing.assert_array_equal(
            image.denormalize_imagenet(t, clamp=clamp).numpy(),
            np.asarray(jax_image.denormalize_imagenet(jnp.asarray(x01), clamp=clamp)))
    assert image.to_uint8(t).dtype == torch.uint8


def test_step_timer_with_a_patched_clock(monkeypatch):
    clock = iter([10.0, 10.5, 11.5, 11.75])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(batch_size=8, ema_decay=0.5)
    assert timer.tick() == {}
    assert timer.tick() == {"step_time_s": 0.5, "step_time_ema_s": 0.5, "images_per_sec": 16.0}
    assert timer.tick() == {"step_time_s": 1.0, "step_time_ema_s": 0.75,
                            "images_per_sec": 8 / 0.75}
    out = timer.tick()
    assert out["step_time_s"] == 0.25 and out["step_time_ema_s"] == 0.5


def test_trace_writes_a_trace_with_the_annotated_range(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("deco_range"):
            torch.ones(8).sum()
    assert "deco_range" in {e.key for e in prof.key_averages()}
    files = glob.glob(os.path.join(str(tmp_path), "*.json*"))
    assert files and os.path.getsize(files[0]) > 0
