"""The port's W8A8 int8 serving mode (deco_tpu_torch/ops/quant.py,
models/layers.Int8Linear) against the JAX package's (deco_tpu/ops/quant.py,
layers.Int8Dense), on the CPU. Each case of tests/test_quant.py has its
counterpart here, with numpy-seeded inputs.

Tolerances:
- ``Int8Linear`` against ``Int8Dense`` on the same bf16 input: the same int8
  codes and scales and the same output bits (0 codes may differ: a code
  could only differ at a rounding tie, and both sides round half to even on
  the same fp32 quotient).
- The tiny DeCoC2I and DeCoT2I in int8 against JAX's int8 apply, in fp32
  compute: max |port - JAX| at most 4x the same model's exact-path gap,
  measured in the same test (both ~1e-6 of max |JAX|: no code flips at this
  size), while int8 moves the output from the exact one by ~1e-2.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deco_tpu.models import dit_t2i as jax_t2i
from deco_tpu.models.dit_c2i_deco import DeCoC2I as JaxDeCoC2I
from deco_tpu.models.layers import Int8Dense, SwiGLU as JaxSwiGLU
from deco_tpu.ops import quant as jax_quant
from deco_tpu.train.loop import Experiment as JaxExperiment
from deco_tpu_torch import convert, serve
from deco_tpu_torch.config import _yaml, registry
from deco_tpu_torch.models import dit_t2i, layers
from deco_tpu_torch.models.autoencoders import PixelAE
from deco_tpu_torch.models.conditioners import Qwen3TextEncoder
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
from deco_tpu_torch.models.layers import Int8Linear, StaleQuantCacheError, verify_quant_cache
from deco_tpu_torch.ops import quant
from deco_tpu_torch.train import hooks
from deco_tpu_torch.train.checkpoint import CheckpointManager, payload
from deco_tpu_torch.train.loop import Experiment
from deco_tpu_torch.train.state import TrainState
from torch_port_util import TINY_C2I, TINY_IMAGE, TINY_T2I, fast_jit, redraw

GAP_FACTOR = 4.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rng(seed):
    return np.random.default_rng(seed)


def _np(t):
    return t.detach().float().numpy()


# ---- the ops ----

def test_int8_matmul_approximates():
    rng = _rng(0)
    x = rng.standard_normal((32, 48)).astype(np.float32)
    w = (rng.standard_normal((24, 48)) * 0.05).astype(np.float32)  # (N, K)
    y = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    ref = x @ w.T
    # per-row / per-channel symmetric int8: ~1% relative error budget
    assert np.abs(y - ref).max() < 0.02 * np.abs(ref).max()
    np.testing.assert_array_equal(
        y, np.asarray(jax_quant.int8_matmul(jnp.asarray(x), jnp.asarray(w.T))))


def test_prequant_matches_fly():
    rng = _rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((12, 16)).astype(np.float32))
    wq, ws = quant.quantize_weight(w)
    assert wq.dtype == torch.int8 and wq.shape == (12, 16) and wq.is_contiguous()
    assert ws.dtype == torch.float32 and ws.shape == (12,)
    assert torch.equal(quant.int8_matmul_prequant(x, wq, ws), quant.int8_matmul(x, w))


def test_zero_rows_safe():
    w = torch.from_numpy(_rng(4).standard_normal((12, 16)).astype(np.float32))
    y = quant.int8_matmul(torch.zeros(4, 16), w)
    assert not torch.isnan(y).any() and not y.any()


@pytest.mark.parametrize("rows", [3, 16, 17])
def test_few_rows_are_padded_and_cut_off(rows):
    """Up to 16 rows pad to 32 with zero rows (CUDA's int8 GEMM refuses
    them); the result is the int32 product of the real rows alone."""
    rng = _rng(rows)
    a = torch.from_numpy(rng.integers(-127, 128, (rows, 64)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (40, 64)).astype(np.int8))
    out = quant.int8_mm(a, wq)
    assert out.shape == (rows, 40) and out.dtype == torch.int32
    assert torch.equal(out, a.int() @ wq.int().t())
    x = torch.from_numpy(rng.standard_normal((rows, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    np.testing.assert_array_equal(
        quant.int8_matmul(x, w).numpy(),
        np.asarray(jax_quant.int8_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy().T))))


def test_rounding_ties_go_to_even_as_in_jax():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0]], np.float32)
    q, s = quant.quantize_rowwise(torch.from_numpy(x))
    jq, js = jax_quant.quantize_rowwise(jnp.asarray(x))
    assert q.tolist() == [[0, 2, 2, 0, -2, -2, 126, 127]]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_env_bad_mode_raises(monkeypatch):
    for bad in ("int4", "INT8"):
        monkeypatch.setenv("DECO_QUANT", bad)
        with pytest.raises(ValueError, match="DECO_QUANT"):
            quant.env_quant_mode()
        with pytest.raises(ValueError, match="DECO_QUANT"):
            jax_quant.env_quant_mode()
    monkeypatch.setenv("DECO_QUANT", "")
    assert quant.env_quant_mode() is None
    monkeypatch.delenv("DECO_QUANT")
    assert quant.env_quant_mode() is None


# ---- the layers ----

def test_int8_linear_matches_int8_dense_bit_for_bit():
    rng = _rng(0)
    x = jnp.asarray(rng.standard_normal((2, 40, 64)).astype(np.float32)).astype(jnp.bfloat16)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    ref = Int8Dense(96).apply({"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}, x)
    lin = Int8Linear(64, 96, dtype=torch.bfloat16, param_dtype=torch.float32)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    # the codes and scales
    (q, s), (jq, js) = quant.quantize_rowwise(xt), jax_quant.quantize_rowwise(x)
    assert int((q.numpy() != np.asarray(jq)).sum()) == 0
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    (wq, ws), (jwq, jws) = quant.quantize_weight(lin.weight), jax_quant.quantize_weight(w)
    assert int((wq.numpy() != np.asarray(jwq).T).sum()) == 0
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws).reshape(-1))
    # the output bits, on the fly and from the cache
    with torch.no_grad():
        fly = lin(xt)
        quant.refresh_quant_cache(lin)
        cached = lin(xt)
    assert fly.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(fly), np.asarray(ref.astype(jnp.float32)))
    assert torch.equal(cached, fly)
    assert set(lin.state_dict()) == {"weight", "bias"}  # the cache is no parameter


def test_fused_swiglu_matches_jax_and_fingerprints_the_concatenation():
    """The c2i SwiGLU's int8 path: one activation quantisation for the
    concatenated w13, then w2. In fp32 compute it matches JAX's fused int8
    SwiGLU within 1e-5 of max |JAX| (the silu rounds differently in the two
    frameworks, by an fp32 ulp), and it equals the port's unfused product
    of w1 and w3 through int8 bit for bit (the activation quantisation is
    per row and the weight's per output channel, so the fusion changes no
    number). The w13 cache's fingerprint is the sum of w1's and w3's (JAX's
    verify rule)."""
    dim, hidden = 64, 96  # width int(2 * 96 / 3) = 64
    x = jnp.asarray(_rng(1).standard_normal((2, 24, dim)).astype(np.float32))
    jm = JaxSwiGLU(hidden_dim=hidden, dtype=jnp.float32, quantize=True)
    params = {"params": redraw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"], 2)}
    ref = np.asarray(jm.apply(params, x))
    m = layers.SwiGLU(dim, hidden, quantize=True)
    p = params["params"]
    with torch.no_grad():
        for name in ("w1", "w3", "w2"):
            getattr(m, name).weight.copy_(torch.from_numpy(np.array(p[name]["kernel"]).T))
        xt = torch.from_numpy(np.array(x))
        fly = m(xt)
        np.testing.assert_allclose(_np(fly), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
        h1, h3 = (quant.int8_matmul(xt, w.weight) for w in (m.w1, m.w3))
        assert torch.equal(fly, m.w2(torch.nn.functional.silu(h1) * h3))
        quant.refresh_quant_cache(m)
        assert torch.equal(m(xt), fly)
    fp = (layers._weight_fingerprint(m.w1.weight) + layers._weight_fingerprint(m.w3.weight))
    torch.testing.assert_close(m.w13_fp, fp, rtol=1e-6, atol=0)
    assert m.w13_q.shape == (2 * 64, dim) and m.w2.weight_q.shape == (dim, 64)


# ---- the models ----

def _c2i_inputs():
    rng = _rng(3)
    return (rng.standard_normal((2, TINY_IMAGE, TINY_IMAGE, 3)).astype(np.float32),
            rng.uniform(0, 1, (2,)).astype(np.float32),
            np.array([1, TINY_C2I["num_classes"]], np.int32))


def _c2i_params(seed):
    shapes = jax.eval_shape(JaxDeCoC2I(**TINY_C2I).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, TINY_IMAGE, TINY_IMAGE, 3)), jnp.zeros((1,)),
                            jnp.zeros((1,), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, redraw(shapes, seed))


def _port_c2i(params, quantize=None, dtype=torch.float32):
    model = DeCoC2I(**TINY_C2I, dtype=dtype, param_dtype=torch.float32, quantize=quantize,
                    device="cpu").eval()
    model.load_state_dict(convert.state_dict_from_jax(params, patch_size=TINY_C2I["patch_size"]),
                          strict=True)
    return model


def _run(model, *inputs):
    with torch.no_grad():
        return _np(model(*(torch.from_numpy(a) for a in inputs[:2]),
                         torch.from_numpy(inputs[2]).long() if inputs[2].dtype == np.int32
                         else torch.from_numpy(inputs[2])))


def test_param_tree_identical_and_cache_not_in_the_state_dict():
    exact = DeCoC2I(**TINY_C2I, device="cpu")
    int8 = DeCoC2I(**TINY_C2I, quantize="int8", device="cpu")
    assert list(exact.state_dict()) == list(int8.state_dict())
    assert not quant.quant_modules(exact) and len(quant.quant_modules(int8)) == 4 * TINY_C2I["num_cond_blocks"]
    quant.refresh_quant_cache(int8)
    assert list(exact.state_dict()) == list(int8.state_dict())
    qkv = int8.blocks[0].attn.qkv
    assert qkv.weight_q.dtype == torch.int8 and qkv.weight_scale.dtype == torch.float32
    assert int8.quantize == "int8" and exact.quantize is None


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_c2i_matches_jax_int8(seed):
    params = _c2i_params(seed)
    x, t, y = _c2i_inputs()
    gaps, outs = {}, {}
    for mode in (None, "int8"):
        jm = JaxDeCoC2I(**TINY_C2I, dtype=jnp.float32, quantize=mode)
        ref = np.asarray(fast_jit(jm.apply)(params, *map(jnp.asarray, (x, t, y))))
        model = quant.refresh_quant_cache(_port_c2i(params, mode))
        outs[mode] = _run(model, x, t, y)
        gaps[mode] = np.abs(outs[mode] - ref).max()
    scale = np.abs(outs[None]).max()
    assert gaps["int8"] <= GAP_FACTOR * gaps[None], gaps
    assert np.abs(outs["int8"] - outs[None]).max() > 100 * gaps["int8"]
    assert gaps["int8"] < 1e-5 * scale


def test_cached_equals_fly_and_approximates_exact():
    params = _c2i_params(2)
    x, t, y = _c2i_inputs()
    exact = _run(_port_c2i(params, dtype=torch.bfloat16), x, t, y)
    model = _port_c2i(params, "int8", dtype=torch.bfloat16)
    fly = _run(model, x, t, y)
    cached = _run(quant.refresh_quant_cache(model), x, t, y)
    np.testing.assert_array_equal(cached, fly)
    rel = np.abs(cached - exact).max() / np.abs(exact).max()
    assert 0 < rel < 0.5


def test_env_override_activates(monkeypatch):
    monkeypatch.setenv("DECO_QUANT", "int8")
    model = DeCoC2I(**TINY_C2I, device="cpu")
    assert model.quantize == "int8" and quant.quant_modules(model)
    assert quant.model_quant_active(model)


def test_bad_mode_raises():
    with pytest.raises(ValueError, match="quantize"):
        DeCoC2I(**TINY_C2I, quantize="fp4", device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        dit_t2i.DeCoT2I(**TINY_T2I, quantize="fp4", device="cpu")


def test_int8_under_trunk_parallel_raises():
    """int8 under a parallel executor raises JAX's ValueError (the
    executors read the weights themselves and would drop the int8 path)."""
    with pytest.raises(ValueError, match="not available under trunk_parallel"):
        DeCoC2I(**TINY_C2I, quantize="int8", trunk_parallel="tp", device="cpu")


def _t2i_params(cls_name, seed=0):
    jm = getattr(jax_t2i, cls_name)(**TINY_T2I)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                            jnp.zeros((1,)), jnp.zeros((1, 6, 16)))
    return jax.tree_util.tree_map(np.asarray, redraw(shapes, seed))


def _port_t2i(cls_name, params, quantize=None, dtype=torch.float32):
    to_sd = {"DeCoT2I": convert.state_dict_from_jax_t2i,
             "PixNerdT2I": convert.state_dict_from_jax_pixnerd_t2i}[cls_name]
    model = getattr(dit_t2i, cls_name)(**TINY_T2I, dtype=dtype, param_dtype=torch.float32,
                                       quantize=quantize, device="cpu").eval()
    model.load_state_dict(to_sd(params, patch_size=TINY_T2I["patch_size"]), strict=True)
    return model


def _t2i_inputs():
    rng = _rng(4)
    return (rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
            np.array([0.3, 0.7], np.float32),
            rng.standard_normal((2, 6, 16)).astype(np.float32))


@pytest.mark.parametrize("cls_name", ["DeCoT2I", "PixNerdT2I"])
def test_t2i_family(cls_name):
    """Both t2i families: the same parameters in either mode, the cache
    bit-equal to on the fly, close to (and not equal to) the exact path, and
    the int8 apply of JAX within 4x the exact path's gap."""
    params = _t2i_params(cls_name)
    x, t, y = _t2i_inputs()
    exact_model = _port_t2i(cls_name, params)
    model = _port_t2i(cls_name, params, "int8")
    assert list(model.state_dict()) == list(exact_model.state_dict())
    # every product of the text-refine (4) and joint (5) blocks is int8
    n_blocks = TINY_T2I["num_text_blocks"] + TINY_T2I["num_encoder_blocks"]
    assert sum(isinstance(m, Int8Linear) for m in model.modules()) == 5 * n_blocks - \
        TINY_T2I["num_text_blocks"]
    fly = _run(model, x, t, y)
    cached = _run(quant.refresh_quant_cache(model), x, t, y)
    np.testing.assert_array_equal(cached, fly)
    exact = _run(exact_model, x, t, y)
    rel = np.abs(cached - exact).max() / np.abs(exact).max()
    assert 0 < rel < 0.5
    gaps = {}
    for mode, out in ((None, exact), ("int8", cached)):
        jm = getattr(jax_t2i, cls_name)(**TINY_T2I, dtype=jnp.float32, quantize=mode)
        ref = np.asarray(fast_jit(jm.apply)(params, *map(jnp.asarray, (x, t, y))))
        gaps[mode] = np.abs(out - ref).max()
    assert gaps["int8"] <= GAP_FACTOR * max(gaps[None], 1e-7 * np.abs(exact).max()), gaps


# ---- the cache's safety ----

def test_verify_detects_stale_cache_and_refresh_repairs_it():
    model = _port_c2i(_c2i_params(0), "int8")
    verify_quant_cache(model)  # no cache built: on the fly, nothing to check
    quant.refresh_quant_cache(model)
    verify_quant_cache(model)
    model.load_state_dict(convert.state_dict_from_jax(_c2i_params(1), patch_size=4))
    with pytest.raises(StaleQuantCacheError, match="fingerprint"):
        verify_quant_cache(model)
    quant.refresh_quant_cache(model)
    verify_quant_cache(model)
    quant.clear_quant_cache(model)
    assert model.blocks[0].attn.qkv.weight_q is None
    verify_quant_cache(model)


def _t2i_pipeline_parts():
    model = _port_t2i("DeCoT2I", _t2i_params("DeCoT2I", 0), "int8")
    return PixelAE(), model, Qwen3TextEncoder(embed_dim=16, max_length=6)


def test_pipeline_ctor_rejects_stale_cache():
    vae, model, conditioner = _t2i_pipeline_parts()
    quant.refresh_quant_cache(model)
    serve.Pipeline(vae, model, conditioner, base_resolution=32)
    # a cache built before a weight load must fail loudly
    restored = convert.state_dict_from_jax_t2i(_t2i_params("DeCoT2I", 7), patch_size=4)
    model.load_state_dict(restored)
    with pytest.raises(StaleQuantCacheError):
        serve.Pipeline(vae, model, conditioner, base_resolution=32)
    quant.refresh_quant_cache(model)
    pipe = serve.Pipeline(vae, model, conditioner, base_resolution=32)
    images = pipe(["a red cube"], height=32, width=32, num_steps=2)
    assert images[0].shape == (32, 32, 3) and images[0].dtype == np.uint8


def test_load_pipeline_int8_restores_and_refreshes(tmp_path, monkeypatch):
    """serve.load_pipeline under DECO_QUANT=int8 with a step checkpoint of
    the exact path: the weights are the restored ones, and the cache is
    built from them (not from the init)."""
    config = registry.load_yaml(os.path.join(REPO, "configs_t2i/sft_res512.yaml"))
    config["model"]["denoiser"]["init_args"].update(TINY_T2I, dtype="float32")
    config["model"]["conditioner"]["init_args"].update(embed_dim=16, max_length=6)
    trained = convert.state_dict_from_jax_t2i(_t2i_params("DeCoT2I", 9), patch_size=4)
    CheckpointManager(str(tmp_path / "ckpt")).save(payload(trained, None, {}, 3), 3)
    monkeypatch.setenv("DECO_QUANT", "int8")
    pipe = serve.load_pipeline(config, str(tmp_path / "ckpt"), use_ema=False, device="cpu")
    model = pipe.denoiser
    assert quant.quant_modules(model) and model.blocks[0].attn.qkv_x.weight_q is not None
    verify_quant_cache(model)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in trained.items())
    wq, _ = quant.quantize_weight(trained["blocks.0.attn.qkv_x.weight"])
    assert torch.equal(model.blocks[0].attn.qkv_x.weight_q, wq)


def test_fit_refuses_int8(tmp_path, monkeypatch):
    """The int8 trunk passes no gradient to its weights: fit (and any
    TrainState) refuses it with JAX's ValueError, under the field and under
    DECO_QUANT=int8 alike."""
    monkeypatch.setattr(hooks, "_tensorboard", lambda logdir: None)
    with pytest.raises(ValueError, match="inference-only"):
        TrainState.create(DeCoC2I(**TINY_C2I, quantize="int8", param_dtype=torch.float32,
                                  device="cpu"))
    root = tmp_path / "images" / "class_a"
    root.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(_rng(i).integers(0, 255, (20, 20, 3), np.uint8)).save(root / f"{i}.png")
    config = _yaml.load(os.path.join(REPO, "configs_c2i/DeCo_XL_freq.yaml"))
    config["trainer"]["default_root_dir"] = str(tmp_path / "runs")
    config["model"]["denoiser"]["init_args"].update(TINY_C2I, dtype="float32")
    config["data"].update(train_batch_size=2, train_num_workers=1)
    config["data"]["train_dataset"]["init_args"].update(root=str(tmp_path / "images"),
                                                        resolution=TINY_IMAGE)
    monkeypatch.setenv("DECO_QUANT", "int8")
    with pytest.raises(ValueError, match="inference-only"):
        Experiment(config, device="cpu").fit(max_steps=1)


def test_cli_predict_int8_matches_jax_int8_predict(tmp_path):
    """cli predict with the int8 override from the JAX params: output.npz
    within 1 LSB of the JAX predict in int8 (which builds its cache from the
    params it serves, as the port's predict does), and not equal to the
    exact path's images."""
    from deco_tpu.train.state import TrainState as JaxTrainState
    import optax

    from test_torch_loop import tiny_config

    from deco_tpu_torch import cli

    config = tiny_config(str(tmp_path / "jax"))
    config["data"]["pred_dataset"]["init_args"].update(max_num_instances=2, num_classes=2)
    config["model"]["denoiser"]["init_args"]["quantize"] = "int8"
    params = _c2i_params(5)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), optax.adamw(1e-3))
    ref = np.load(JaxExperiment(copy.deepcopy(config)).predict(state=state, use_ema=False))["arr_0"]

    sd = convert.state_dict_from_jax(params, patch_size=TINY_C2I["patch_size"])
    ckpt = tmp_path / "port_ckpt"
    CheckpointManager(str(ckpt)).save(payload(sd, sd, {}, 1), 1)
    del config["model"]["denoiser"]["init_args"]["quantize"]
    config["trainer"]["default_root_dir"] = str(tmp_path / "port")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(_yaml.dump(config))
    out = np.load(cli.main(["predict", "-c", str(cfg_path), "--device", "cpu",
                            f"--ckpt_path={ckpt}",
                            "--model.denoiser.init_args.quantize=int8"]))["arr_0"]
    assert out.shape == (2, TINY_IMAGE, TINY_IMAGE, 3) and out.std() > 0
    assert np.abs(out.astype(int) - ref[:2]).max() <= 1
    config["trainer"]["default_root_dir"] = str(tmp_path / "exact")
    cfg_path.write_text(_yaml.dump(config))
    exact = np.load(cli.main(["predict", "-c", str(cfg_path), "--device", "cpu",
                              f"--ckpt_path={ckpt}"]))["arr_0"]
    assert np.abs(exact.astype(int) - out).max() > 1
