"""The port's UniFlow training (train.uniflow_loop, adamw_with_groups,
train.workloads.UniFlowRun, the CLI) and its data readers (data.webdataset,
data.jsonl) against the JAX package, on the CPU.

The model is tests/test_torch_uniflow.py's tiny one, fp32. The JAX train
step is compiled once: ``test_two_train_steps_match_jax`` runs two steps of
the jitted JAX step and of the port's on the same weights, images and
draws, with the vision towers frozen and ``mlp1`` in the lower-rate group,
and its checks read them (one test, so that the suite's parallel workers
never compile the step twice). The readers are numpy on both sides (the JAX ones
decode with PIL), held exactly.

Tolerances: losses and the gradient norm within 1e-4 relative; parameters
after AdamW within 1e-5 relative plus 1e-2 x lr absolute. AdamW's eps of
1e-8 turns fp32 noise in a gradient near eps into a few percent of lr (4
of the semantic head's 524,288 output weights moved 1.4e-2 x lr apart after
one step here), so the two-step fixture takes eps 1e-4 on both sides, as
tests/test_torch_vae_gan.py does, and the update follows g smoothly.
"""

import functools
import io
import json
import os
import shutil
import tarfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deco_tpu.convert.uniflow_bridge import uniflow_params_from_torch
from deco_tpu.data import jsonl as jjsonl
from deco_tpu.data import native as jnative
from deco_tpu.data import webdataset as jwebdataset
from deco_tpu.models.uniflow import UniFlowConfig as JaxUniFlowConfig
from deco_tpu.train import schedules as jschedules
from deco_tpu.train import uniflow_loop as juniflow
from deco_tpu_torch import cli, convert
from deco_tpu_torch.config import registry
from deco_tpu_torch.data import jsonl, native, webdataset
from deco_tpu_torch.models.uniflow.model import UniFlowConfig
from deco_tpu_torch.train import hooks, uniflow_loop, workloads
from deco_tpu_torch.utils import png
from torch_port_util import FAST_COMPILE, fast_jit, numpy_state, randomize_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vit_hidden_size=64, llm_hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, patch_size=4, image_size=32, global_blocks_depth=1,
            num_decoder_layers=1, num_sampling_steps=2)
LR, VISION_LR = 1e-3, 3e-4
TRAIN = dict(lr=LR, vision_lr=VISION_LR, warmup_steps=0, total_steps=10, min_lr=1e-5,
             betas=(0.9, 0.95), ema_decay=0.9, frozen_encoder=True, frozen_mlp=False,
             grad_clip=0.5)
RTOL = 1e-4
EPS = 1e-4


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """Importing torch.utils.tensorboard pulls TensorFlow in (~18 s)."""
    monkeypatch.setattr(hooks, "_tensorboard", lambda workdir: None)


@pytest.fixture(autouse=True)
def _drop_work_files(tmp_path):
    """A fit here can write ~1.2 GB checkpoints (the semantic head is 2,048
    wide at any size): freed after the test, not when pytest rotates its
    temporary directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _flat(tree) -> dict:
    return {k: v.numpy() for k, v in convert.state_dict_from_jax_uniflow(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@fast_jit
def _jax_draws(key) -> dict:
    out = {}
    for name, r, n, c in zip(("sem", "pix"), jax.random.split(key), (16, 64), (256, 48)):
        r_nt, r_mix, r_u, r_x0 = jax.random.split(r, 4)
        out[name] = dict(t_normal=jax.random.normal(r_nt, (2, n)),
                         t_mix=jax.random.uniform(r_mix, (2, n)),
                         t_uniform=jax.random.uniform(r_u, (2, n)),
                         x0=jax.random.normal(r_x0, (2, n, c)))
    return out


def _draws(key) -> dict:
    """The JAX step's draws under ``key`` (``forward_loss``: the semantic
    head's on the first split, the pixel head's on the second), from one
    program compiled once, not one eager op compile per draw."""
    return jax.tree_util.tree_map(np.asarray, _jax_draws(key))


def _two_steps() -> dict:
    """Two steps of the jitted JAX UniFlow step and of the port's from the
    same weights: (JAX metrics, params, EMA) and (port metrics, state dict,
    EMA) after each."""
    jexp = juniflow.UniFlowExperiment(JaxUniFlowConfig(**TINY),
                                      juniflow.UniFlowTrainConfig(**TRAIN), dtype=jnp.float32)
    x = [np.random.default_rng(10 + i).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
         for i in range(2)]
    exp = uniflow_loop.UniFlowExperiment(UniFlowConfig(**TINY),
                                         uniflow_loop.UniFlowTrainConfig(**TRAIN),
                                         dtype=torch.float32, device="cpu")
    # the port's weights drawn from a seed (no parameter zero), handed to JAX
    # through the JAX package's own torch bridge
    randomize_(exp.model, 11, scale=0.5)
    params = {"params": uniflow_params_from_torch(numpy_state(exp.model))}
    # init_state with the drawn tree in place of a compiled init: the tree
    # goes in through the rng argument, so the optimizer's zero moments and
    # the EMA copy are one jitted program, not one eager op per leaf shape
    jexp._init_fn = lambda tree, v: tree
    adamw = jschedules.optax.adamw
    jschedules.optax.adamw = functools.partial(adamw, eps=EPS)
    try:
        jstate = jax.jit(jexp.init_state)(params, jnp.asarray(x[0]))
    finally:
        jschedules.optax.adamw = adamw
    batch0 = {"x": jnp.asarray(x[0])}
    step = jexp.make_train_step(donate=False).lower(
        jstate, batch0, jax.random.PRNGKey(0)).compile(FAST_COMPILE)

    start = {k: v.detach().clone() for k, v in exp.model.state_dict().items()}
    state = exp.init_state(seed=None)
    for group in state.optimizer.param_groups:
        group["eps"] = EPS
    results = []
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        jstate, jmetrics = step(jstate, {"x": jnp.asarray(x[i])}, key)
        metrics = exp.train_step(state, torch.from_numpy(x[i]), draws=_draws(key))
        results.append(dict(jmetrics=jax.device_get(jmetrics), jparams=_flat(jstate.params),
                            metrics={k: float(v) for k, v in metrics.items()},
                            params={k: v.detach().clone().numpy()
                                    for k, v in exp.model.state_dict().items()},
                            lrs=[g["lr"] for g in state.optimizer.param_groups]))
    jema = _flat(jstate.ema_params)
    ema = {n: e.numpy() for (n, _), e in zip(exp.model.named_parameters(), state.ema_params)}
    return dict(results=results, start=start, jema=jema, ema=ema, exp=exp, state=state)


def _assert_allclose(actual, desired, rtol: float, atol: float, err_msg: str):
    """``np.testing.assert_allclose`` (the same |a - d| <= atol + rtol |d|,
    NaNs equal), decided by torch's threaded ``isclose`` over the ~0.1B
    parameters; numpy's assertion reports a failure."""
    assert actual.shape == desired.shape, (err_msg, actual.shape, desired.shape)
    if not bool(torch.isclose(torch.tensor(actual), torch.tensor(desired), rtol=rtol, atol=atol,
                              equal_nan=True).all()):
        np.testing.assert_allclose(actual, desired, rtol=rtol, atol=atol, err_msg=err_msg)


def _check_step(two_steps, step):
    """A step's loss terms and gradient norm, and every parameter after it."""
    r = two_steps["results"][step]
    for k in ("loss", "distill_loss", "vit_distill_loss", "sem_mse_loss", "flow_loss",
              "lpips_loss", "grad_norm"):
        np.testing.assert_allclose(r["metrics"][k], float(r["jmetrics"][k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    assert r["metrics"]["grad_norm"] > TRAIN["grad_clip"]  # the clip scaled the update
    assert r["params"].keys() == r["jparams"].keys()
    for k, ref in r["jparams"].items():
        _assert_allclose(r["params"][k], ref, rtol=1e-5, atol=1e-2 * LR, err_msg=k)


def _check_frozen_and_grouped_learning_rates(two_steps):
    """``frozen_encoder``: both ViTs keep their values and stay out of the
    optimizer; ``mlp1`` takes ``vision_lr`` and the rest ``lr``, each on its
    cosine at the shared step (0, then 1 of 10)."""
    exp, state, start = two_steps["exp"], two_steps["state"], two_steps["start"]
    final, jfinal = two_steps["results"][-1]["params"], two_steps["results"][-1]["jparams"]
    for k, v in start.items():
        moved = not np.array_equal(final[k], v.numpy())
        if k.split(".")[0] in uniflow_loop.FROZEN_ENCODER:
            assert not moved and np.array_equal(jfinal[k], v.numpy()), k
        else:  # mlp1's output bias cancels in the distillation difference: no gradient
            assert moved == (not np.array_equal(jfinal[k], v.numpy())), k
    groups = {g["group"]: g for g in state.optimizer.param_groups}
    names = {p: n for n, p in exp.model.named_parameters()}
    assert {names[p].split(".")[0] for p in groups["group"]["params"]} == {"mlp1"}
    assert not any(names[p].startswith("shallow_") for g in groups.values() for p in g["params"])
    sched = [juniflow.cosine_with_min_lr(lr, 0, 10, 1e-5) for lr in (LR, VISION_LR)]
    for step, r in enumerate(two_steps["results"]):
        np.testing.assert_allclose(r["lrs"], [float(f(step)) for f in sched], rtol=1e-6)


def _check_ema(two_steps):
    """The EMA of every parameter, frozen ones included (e d + p (1 - d))."""
    ema, jema = two_steps["ema"], two_steps["jema"]
    assert ema.keys() == jema.keys()
    for k, ref in jema.items():
        _assert_allclose(ema[k], ref, rtol=1e-5, atol=1e-3 * LR, err_msg=k)


def test_two_train_steps_match_jax():
    """Two train steps against the JAX step, every check reading one JAX
    program compiled once (one test, so that the suite's parallel workers
    never compile it twice): each step's losses, gradient norm and
    parameters, the frozen and grouped learning rates, the EMA."""
    two_steps = _two_steps()
    for step in (0, 1):
        _check_step(two_steps, step)
    _check_frozen_and_grouped_learning_rates(two_steps)
    _check_ema(two_steps)


# ---- the workload and the CLI ----

def _png_folder(root, count=4, size=32):
    rng = np.random.default_rng(0)
    for c in range(2):
        os.makedirs(os.path.join(root, f"class_{c}"), exist_ok=True)
        for i in range(count // 2):
            png.write(os.path.join(root, f"class_{c}", f"{i}.png"),
                      rng.integers(0, 256, (size + 4 * i, size + 6, 3), dtype=np.uint8))
    return str(root)


def _write_config(path, config: dict) -> str:
    with open(path, "w") as f:  # JSON is YAML
        json.dump(config, f)
    return str(path)


def test_cli_fit_then_validate_a_flat_schema_yaml(tmp_path):
    """``uniflow_internvit.yaml``'s schema at the tiny width: ``cli fit`` two
    steps from ``train_root`` (a checkpoint on exit, ``metrics.jsonl`` with
    the pixel branch's loss terms), then ``cli validate`` of an
    ``eval_dataset`` node from it: PSNR, SSIM and FID, panels and
    ``validate_metrics.json``. The semantic branch is off here: its flow
    head is 2,048 wide at any size, and ``test_two_train_steps_match_jax``
    trains it."""
    folder = _png_folder(tmp_path / "png")
    config = registry.load_yaml(os.path.join(REPO, "configs_flow/uniflow_internvit.yaml"))
    config["model"].update(TINY, enable_semantic_branch=False)
    config["train"].update(warmup_steps=0, total_steps=10)
    config["trainer"] = {"log_every_n_steps": 1, "callbacks": [{  # FID at 64 features
        "class_path": "src.callbacks.compute_metrics.ComputeMetricsHook",
        "init_args": {"compute_fid": True, "fid_feature_dim": 64}}]}
    config["data"].update(train_root=folder, resolution=32, batch_size=2, pred_batch_size=2,
                          eval_dataset={"class_path": "src.data.dataset.imagenet.PixImageNet",
                                        "init_args": {"root": folder, "resolution": 32}})
    path = _write_config(tmp_path / "flat.yaml", config)
    work = str(tmp_path / "work")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state = cli.main(["fit", "-c", path, "--device", "cpu", "--max_steps", "2",
                          f"--workdir={work}"])
        scores = cli.main(["validate", "-c", path, "--device", "cpu", "--max_batches", "1",
                           f"--workdir={work}"])
    assert state.step == 2 and os.listdir(os.path.join(work, "checkpoints")) == ["2.pt"]
    lines = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    assert [line["step"] for line in lines] == [0, 1]
    for k in ("flow_loss", "lpips_loss", "loss", "grad_norm"):
        assert all(np.isfinite(line[k]) for line in lines), k
    assert "sem_mse_loss" not in lines[0]
    assert all(np.isfinite(v) for v in scores.values()) and "metrics/fid" in scores
    assert json.load(open(os.path.join(work, "validate_metrics.json"))) == pytest.approx(scores)
    assert len(os.listdir(os.path.join(work, "images"))) == 2  # one panel an image
    del config["data"]["eval_dataset"]
    with pytest.raises(ValueError, match="eval_dataset"):  # as JAX: the shipped file has none
        cli.main(["validate", "-c", _write_config(tmp_path / "bare.yaml", config), "--device",
                  "cpu", f"--workdir={work}"])


def _tar_of_pngs(path, count=4, size=40):
    rng = np.random.default_rng(1)
    with tarfile.open(path, "w") as tf:
        for i in range(count):
            for name, data in ((f"s{i:03d}.png", png.encode(rng.integers(
                    0, 256, (size, size + 8 * i, 3), dtype=np.uint8))), (f"s{i:03d}.cls",
                                                                        str(i % 2).encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return str(path)


def test_reference_schema_fit_from_a_webdataset_and_a_warm_start(tmp_path):
    """A shipped reference-schema config (EMA, frozen encoder, ``distill``)
    with a tiny ``config_path``, fitting from a ``PixWebDataset`` node over
    a PNG tar (random crop and flip, as shipped): a step without teacher
    weights, the ``model.`` / ``ema_model.`` checkpoint, and
    ``pretrain_model_path``: a directory warm-starts from it at step 0, a
    ``.ckpt`` file is never read. The tiny ``config.json`` turns the
    semantic branch off (its flow head is 2,048 wide at any size)."""
    tiny_json = _write_config(tmp_path / "config.json", {
        **TINY, "num_sampling_steps": "2", "enable_semantic_branch": False})
    config = registry.load_yaml(os.path.join(
        REPO, "configs_flow/uniflow_internvit_2b_blip3o_stage2.yaml"))
    config["model"].update(config_path=tiny_json, pretrain_model_path="missing/epoch=1.ckpt")
    config["data"]["train_dataset"]["init_args"].update(
        data_files=_tar_of_pngs(tmp_path / "shard-0.tar"), resolution=32)
    config["data"].update(train_batch_size=2, train_num_workers=1)
    config["trainer"].update(default_root_dir=str(tmp_path / "root"), log_every_n_steps=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = workloads.UniFlowRun(json.loads(json.dumps(config)), device="cpu")
        state = run.fit(max_steps=1)
    assert run.distill and run.exp.teacher_fn is None and run.train_cfg.frozen_encoder
    assert run.train_cfg.use_ema and run.train_cfg.ema_decay == 0.9999
    assert state.step == 1 and run.workdir.endswith("sem_layer4_r14_mlp_c32_c256_norm_448px_stage2_1e-5")
    saved = torch.load(os.path.join(run.workdir, "checkpoints", "1.pt"), weights_only=True)
    params = dict(run.exp.model.named_parameters())
    assert {k[len("model."):] for k in saved["state_dict"] if k.startswith("model.")} == set(params)
    assert {k for k in saved["state_dict"] if k.startswith("ema_model.")}
    assert not any(k.startswith(("embeddings.", "shallow_")) for k in saved["optimizer"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        config["trainer"]["default_root_dir"] = str(tmp_path / "other")
        config["model"]["pretrain_model_path"] = os.path.join(run.workdir, "checkpoints")
        warm = workloads.UniFlowRun(json.loads(json.dumps(config)), device="cpu")
        restored, restore = [], warm._restore
        warm._restore = lambda m, s, step=None: restored.append(m.directory) or restore(m, s, step)
        started = warm.fit(max_steps=1)
    assert restored == [config["model"]["pretrain_model_path"]]
    assert started.step == 1  # warm-started from step 1, the step reset to 0 and one taken


def test_teacher_weights_directory_raises_and_a_missing_one_warns(tmp_path):
    config = registry.load_yaml(os.path.join(REPO, "configs_flow/uniflow_internvit_2b_distill.yaml"))
    config["model"]["teacher_model_path"] = str(tmp_path / "absent")
    with pytest.warns(UserWarning, match="self-distillation"):
        run = workloads.UniFlowRun(json.loads(json.dumps(config)), workdir=str(tmp_path),
                                   device="meta")
    assert run.exp.teacher_fn is None
    config["model"]["teacher_model_path"] = str(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP §A 5"):
        workloads.UniFlowRun(config, workdir=str(tmp_path), device="meta")


# ---- the readers ----

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two tar shards of PNG samples with classes, a corrupt member, and one
    of JPEG samples."""
    root = tmp_path_factory.mktemp("wds")
    rng = np.random.default_rng(2)

    def write(path, members):
        with tarfile.open(path, "w") as tf:
            for name, data in members:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        return str(path)

    pngs = []
    for s in range(2):
        members = []
        for i in range(5):
            img = rng.integers(0, 256, (36 + 4 * i, 40 + 6 * s, 3), dtype=np.uint8)
            members += [(f"s{s}_{i:03d}.png", png.encode(img)),
                        (f"s{s}_{i:03d}.cls", str(i + 5 * s).encode())]
        members.append(("s_bad.png", png.SIGNATURE + b"corrupt"))
        pngs.append(write(root / f"png-{s}.tar", members))
    jpegs = []
    for i in range(3):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)).save(buf, "JPEG")
        jpegs += [(f"j{i:03d}.jpg", buf.getvalue()), (f"j{i:03d}.cls", str(i).encode())]
    return pngs, write(root / "jpeg-0.tar", jpegs)


def _items(dataset):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return list(dataset)


def _same_items(ours, ref):
    assert len(ours) == len(ref)
    for (x, c, m), (rx, rc, rm) in zip(ours, ref):
        assert c == rc == m["class"] == rm["class"]
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(m["raw_image"], rm["raw_image"])


@pytest.mark.parametrize("crop", ["center", "random"])
@pytest.mark.parametrize("rank", [0, 1])
def test_pix_webdataset_matches_jax_on_png(shards, crop, rank):
    """Two PNG shards, shuffled as training shuffles them (shard order, a
    4-sample buffer), the center or random crop with flips, and the shard
    of process ``rank`` of 2: the same items in the same order; the corrupt
    member is skipped on both sides."""
    kw = dict(resolution=24, random_crop=crop == "random", random_flip=True, buffer_size=4,
              process_index=rank, process_count=2)
    ours = _items(webdataset.PixWebDataset(shards[0], **kw))
    ref = _items(jwebdataset.PixWebDataset(shards[0], **kw))
    assert len(ours) >= 4
    _same_items(ours, ref)


def test_pix_webdataset_jpeg_through_the_adm_path(shards):
    """JPEG members: the native decode-and-crop without ``random_crop`` (the
    JAX reader's native path, or PIL within one level where the library is
    not built on its side); with ``random_crop`` the port raises naming
    ROADMAP §A 2 (no full-size JPEG decode)."""
    if not os.path.exists(native.LIB_PATH):
        pytest.skip("native/libdataplane.so is not built (scripts/build_native.sh)")
    kw = dict(resolution=24, random_flip=True, is_train=False, process_index=0, process_count=1)
    ours = _items(webdataset.PixWebDataset(shards[1], **kw))
    ref = _items(jwebdataset.PixWebDataset(shards[1], **kw))
    assert len(ours) == len(ref) == 3
    exact = jnative.available()
    for (x, c, _), (rx, rc, _) in zip(ours, ref):
        assert c == rc and x.shape == (24, 24, 3)
        assert np.abs(x - rx).max() <= (0.0 if exact else 2.0 / 255 + 1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP §A 2"):
        next(iter(webdataset.PixWebDataset(shards[1], random_crop=True, **kw)))


@pytest.fixture(scope="module")
def jsonl_sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("jsonl")
    rng = np.random.default_rng(3)
    anns = []
    for s in range(2):
        os.makedirs(root / f"src{s}")
        lines = []
        for i in range(4):
            png.write(str(root / f"src{s}" / f"{i}.png"),
                      rng.integers(0, 256, (30 + 5 * i, 34 + 3 * s, 3), dtype=np.uint8))
            lines.append(json.dumps({"target_image": f"{i}.png", "caption": "x"}))
        lines.append(json.dumps({"no_target": 1}))
        (root / f"src{s}.jsonl").write_text("\n".join(lines) + "\n")
        anns.append(str(root / f"src{s}.jsonl"))
    config = {f"src{s}": {"root": str(root / f"src{s}"), "annotation": anns[s],
                          "repeat_time": s + 1} for s in range(2)}
    (root / "multi.json").write_text(json.dumps(config))
    return str(root), anns, str(root / "multi.json")


@pytest.mark.parametrize("crop", ["center", "random"])
def test_jsonl_readers_match_jax_on_png(jsonl_sources, crop):
    """``PixJSONLDataset`` and ``PixMultiJSONLDataset`` (repeat times, the
    seeded subset): the same samples, crops and flips, item by item."""
    root, anns, multi = jsonl_sources
    kw = dict(resolution=24, random_crop=crop == "random", random_flip=True)
    pairs = [(jsonl.PixJSONLDataset(os.path.join(root, "src0"), anns[0], **kw),
              jjsonl.PixJSONLDataset(os.path.join(root, "src0"), anns[0], **kw)),
             (jsonl.PixMultiJSONLDataset(multi, max_num_samples=10, **kw),
              jjsonl.PixMultiJSONLDataset(multi, max_num_samples=10, **kw))]
    for ours, ref in pairs:
        assert len(ours) == len(ref) and ours.samples == ref.samples
        _same_items([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])


def test_jsonl_retries_a_bad_sample_and_refuses_a_random_crop_jpeg(jsonl_sources, tmp_path):
    """A missing file is retried at a random index, as in JAX; a JPEG under
    ``random_crop`` raises at once naming ROADMAP §A 2."""
    root, _, _ = jsonl_sources
    ann = tmp_path / "ann.jsonl"
    ann.write_text("\n".join(json.dumps({"target_image": n}) for n in ("missing.png", "0.png")))
    for cls in (jsonl.PixJSONLDataset, jjsonl.PixJSONLDataset):
        ds = cls(os.path.join(root, "src0"), str(ann), resolution=24, seed=1)
        assert ds[0][0].shape == (24, 24, 3)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(buf, "JPEG")
    (tmp_path / "a.jpg").write_bytes(buf.getvalue())
    ann.write_text(json.dumps({"target_image": "a.jpg"}))
    with pytest.raises(NotImplementedError, match="ROADMAP §A 2"):
        jsonl.PixJSONLDataset(str(tmp_path), str(ann), resolution=24, random_crop=True)[0]
