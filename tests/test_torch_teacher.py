"""The port's InternVL distillation teacher (``models/uniflow/teacher.py``)
and InternVL folder reader and writer (``convert_vit.py``) against the JAX
package's ``convert/vit_bridge.py``, on the CPU, and the teacher inside a
one-step ``UniFlowRun`` fit.

The folders are written here from seeded weights (no InternVL3-2B weights
are in the repository): a tiny tower (2 layers, hidden 64, 4 heads) and
``mlp1``, as a ``.bin``, as fp32 ``.safetensors``, in two shards, as a bare
export and with the release's ``vision_model.`` / ``mlp1.`` /
``language_model.`` keys. Tolerances: the teacher's features within 1e-5
relative of JAX's at fp32; the fit's loss terms within 1e-4 relative (the
tolerance of ``test_torch_uniflow_train.py``); a bf16 folder (ROADMAP §C
15: the JAX reader refuses bf16 unless JAX is imported, and JAX's teacher
then runs ``mlp1`` in bf16) gives exactly the fp32 folder's features on the
bf16-rounded weights.
"""

import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.convert import vit_bridge
from deco_tpu.convert.uniflow_bridge import uniflow_params_from_torch
from deco_tpu.models.uniflow import UniFlowConfig as JaxUniFlowConfig
from deco_tpu.train import uniflow_loop as juniflow
from deco_tpu_torch import convert, convert_vit
from deco_tpu_torch.config import registry
from deco_tpu_torch.models.uniflow import teacher as teacher_lib
from deco_tpu_torch.models.uniflow.vit import VisionModel
from deco_tpu_torch.train import hooks, uniflow_loop, workloads
from torch_port_util import FAST_COMPILE, numpy_state, randomize_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VISION = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
              patch_size=4, image_size=32, qkv_bias=True, qk_normalization=False,
              norm_type="layer_norm")
LLM = 24  # mlp1's width


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """Importing torch.utils.tensorboard pulls TensorFlow in (~18 s)."""
    monkeypatch.setattr(hooks, "_tensorboard", lambda workdir: None)


def _weights(seed: int = 3):
    """The tiny tower's and ``mlp1``'s state dicts, every value drawn."""
    tower = VisionModel(convert_vit.vit_config_from_json(VISION), dtype=torch.float32)
    randomize_(tower, seed, scale=0.7)
    gen = torch.Generator().manual_seed(seed + 1)
    w = 4 * VISION["hidden_size"]
    mlp1 = {"0.weight": 1 + 0.1 * torch.randn(w, generator=gen),
            "0.bias": 0.1 * torch.randn(w, generator=gen),
            "1.weight": torch.randn(LLM, w, generator=gen) / w ** 0.5,
            "1.bias": 0.1 * torch.randn(LLM, generator=gen),
            "3.weight": torch.randn(LLM, LLM, generator=gen) / LLM ** 0.5,
            "3.bias": 0.1 * torch.randn(LLM, generator=gen)}
    return {k: v.detach().clone() for k, v in tower.state_dict().items()}, mlp1


def write_folder(root, vision, mlp1, layout: str, dtype=torch.float32) -> str:
    """An InternVL folder of ``layout``: "bin", "safetensors", "sharded",
    "bare" (an InternVisionModel export's keys, as ``export_internvl_folder``
    writes them) or "pt" (a ``.pt`` holding ``{"state_dict": ...}``)."""
    os.makedirs(root, exist_ok=True)
    prefixed = layout != "bare"
    sd = {("vision_model." if prefixed else "") + k: v.to(dtype) for k, v in vision.items()}
    sd.update({"mlp1." + k: v.to(dtype) for k, v in mlp1.items()})
    if prefixed:
        sd["language_model.model.embed_tokens.weight"] = torch.ones(5, 3, dtype=dtype)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"vision_config": VISION, "model_type": "internvl_chat"}, f)
    torch.save({"lr": 1.0}, os.path.join(root, "training_args.bin"))  # skipped, as in JAX
    if layout in ("bin", "bare"):
        torch.save(sd, os.path.join(root, "pytorch_model.bin"))
    elif layout == "pt":
        torch.save({"state_dict": sd, "epoch": 3}, os.path.join(root, "model.pt"))
    elif layout == "safetensors":
        convert_vit.write_safetensors(os.path.join(root, "model.safetensors"), sd)
    else:
        keys = sorted(sd)
        for i, part in enumerate((keys[::2], keys[1::2])):
            convert_vit.write_safetensors(
                os.path.join(root, f"model-0000{i + 1}-of-00002.safetensors"),
                {k: sd[k] for k in part})
    return str(root)


def _images(n=2, size=32, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _port(folder, x, dtype=torch.float32):
    fn = teacher_lib.load_teacher_feature_fn(folder, device="cpu", dtype=dtype)
    return {k: v.float().numpy() for k, v in fn(torch.from_numpy(x)).items()}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    vision, mlp1 = _weights()
    root = tmp_path_factory.mktemp("teachers")
    return {layout: write_folder(root / layout, vision, mlp1, layout)
            for layout in ("bin", "safetensors", "sharded", "bare", "pt")}


@pytest.mark.parametrize("size", [32, 48])
def test_teacher_features_match_jax_on_every_layout(folders, size):
    """JAX's ``load_teacher_feature_fn`` on the ``.bin`` and the sharded
    fp32 ``.safetensors`` folders; the port on all five layouts (48 px
    resizes the position embedding)."""
    x = _images(size=size)
    ref = {k: np.asarray(v) for k, v in
           vit_bridge.load_teacher_feature_fn(folders["bin"], dtype=jnp.float32)(x).items()}
    ref_st = vit_bridge.load_teacher_feature_fn(folders["sharded"], dtype=jnp.float32)(x)
    np.testing.assert_array_equal(np.asarray(ref_st["vit_embeds"]), ref["vit_embeds"])
    grid = size // VISION["patch_size"] // 2
    assert ref["vit_embeds"].shape == (2, grid * grid, 4 * VISION["hidden_size"])
    assert ref["vit_embeds_mlp"].shape == (2, grid * grid, LLM)
    for layout, folder in folders.items():
        ours = _port(folder, x)
        for k in ref:
            assert _rel(ours[k], ref[k]) <= 1e-5, (layout, k, _rel(ours[k], ref[k]))


def test_teacher_dtypes_follow_jax(folders):
    """bf16 tower: ``vit_embeds`` bf16, ``vit_embeds_mlp`` fp32 (the fp32
    linears), as JAX's promotion gives them; within bf16 rounding of JAX's
    own bf16 teacher."""
    x = _images()
    fn = teacher_lib.load_teacher_feature_fn(folders["bin"], device="cpu")
    ours = fn(torch.from_numpy(x))
    assert ours["vit_embeds"].dtype == torch.bfloat16
    assert ours["vit_embeds_mlp"].dtype == torch.float32
    assert not any(p.requires_grad for p in fn.parameters()) and not fn.training
    ref = vit_bridge.load_teacher_feature_fn(folders["bin"])(x)
    assert ref["vit_embeds"].dtype == jnp.bfloat16 and ref["vit_embeds_mlp"].dtype == jnp.float32
    for k in ref:
        assert _rel(ours[k].float().numpy(), np.asarray(ref[k], np.float32)) <= 3e-2


def test_bf16_safetensors_load_in_the_port_where_jax_raises(tmp_path):
    """ROADMAP §C 15. The port's reader gives the fp32 folder's features on
    the bf16-rounded weights, exactly, and JAX's fp32 teacher's within
    1e-5. The JAX reader (``torch_to_flax.load_torch_ckpt``, through
    ``safetensors.numpy``) raises ``TypeError`` on bf16 in a process that
    has not imported JAX (run in a subprocess here); JAX's teacher imports
    JAX first, whose ``ml_dtypes`` teaches numpy bf16, and then keeps
    ``mlp1``'s weights in bf16, so its bf16 teacher's ``vit_embeds_mlp`` is
    bf16 on such a folder and fp32 on a ``.bin`` one. The port's is fp32 on
    both."""
    import subprocess
    import sys

    vision, mlp1 = _weights(seed=5)
    rounded = ({k: v.to(torch.bfloat16).float() for k, v in vision.items()},
               {k: v.to(torch.bfloat16).float() for k, v in mlp1.items()})
    bf16 = write_folder(tmp_path / "bf16", vision, mlp1, "sharded", dtype=torch.bfloat16)
    fp32 = write_folder(tmp_path / "fp32", *rounded, "safetensors")
    shard = os.path.join(bf16, "model-00001-of-00002.safetensors")
    assert {v.dtype for v in convert_vit.read_safetensors(shard).values()} == {torch.bfloat16}
    x = _images(seed=1)
    ours, want = _port(bf16, x), _port(fp32, x)
    for k in want:
        np.testing.assert_array_equal(ours[k], want[k])
    ref = vit_bridge.load_teacher_feature_fn(bf16, dtype=jnp.float32)(x)
    for k in ours:
        assert _rel(ours[k], np.asarray(ref[k], np.float32)) <= 1e-5
    assert vit_bridge.load_teacher_feature_fn(bf16)(x)["vit_embeds_mlp"].dtype == jnp.bfloat16
    port_bf16 = teacher_lib.load_teacher_feature_fn(bf16, device="cpu")(torch.from_numpy(x))
    assert port_bf16["vit_embeds_mlp"].dtype == torch.float32
    probe = ("import sys; from deco_tpu.convert.torch_to_flax import load_torch_ckpt\n"
             "assert 'jax' not in sys.modules\n"
             "try:\n    load_torch_ckpt(sys.argv[1])\n"
             "except TypeError as e:\n    print('TypeError', e)\n")
    out = subprocess.run([sys.executable, "-c", probe, shard], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert "TypeError data type 'bfloat16' not understood" in out.stdout, out.stderr


def test_safetensors_round_trip_every_dtype(tmp_path):
    tensors = {"a": torch.randn(3, 4), "b": torch.randn(5).to(torch.bfloat16),
               "c": torch.randn(2, 2).to(torch.float16), "d": torch.arange(6).reshape(2, 3),
               "e": torch.zeros(0, 3), "f": torch.tensor(2.5)}
    path = str(tmp_path / "t.safetensors")
    convert_vit.write_safetensors(path, tensors)
    back = convert_vit.read_safetensors(path)
    from safetensors.torch import load_file  # the reference reader, on this host

    for ref in (back, load_file(path)):
        assert set(ref) == set(tensors)
        for k, v in tensors.items():
            assert ref[k].dtype == v.dtype and torch.equal(ref[k], v)


def test_export_matches_jax_key_for_key_and_each_loads_the_other(tmp_path):
    """The port's ``export_internvl_folder`` of a tower state dict writes
    what JAX's writes from the same weights as Flax params: the same keys,
    arrays and ``config.json``; each package's teacher reads the other's
    folder to the same features."""
    vision, mlp1 = _weights(seed=7)
    flax_params = {"params": vit_bridge.vit_params_from_torch(
        {k: v.numpy() for k, v in vision.items()}, VISION["num_hidden_layers"])}
    assert set(convert.vit_state_dict_from_jax(flax_params)) == set(vision)
    mlp1_np = {k: v.numpy() for k, v in mlp1.items()}
    vit_bridge.export_internvl_folder(flax_params, str(tmp_path / "jax"), VISION, mlp1_np)
    convert_vit.export_internvl_folder(vision, str(tmp_path / "port"), VISION, mlp1)
    jsd = torch.load(str(tmp_path / "jax" / "pytorch_model.bin"))["state_dict"]
    psd = torch.load(str(tmp_path / "port" / "pytorch_model.bin"))["state_dict"]
    assert set(jsd) == set(psd)
    for k in jsd:
        assert jsd[k].dtype == psd[k].dtype and torch.equal(jsd[k], psd[k]), k
    for name in ("jax", "port"):
        with open(tmp_path / name / "config.json") as f:
            assert json.load(f) == {"vision_config": VISION, "model_type": "internvl_chat"}
    x = _images(seed=2)
    ours = _port(str(tmp_path / "jax"), x)
    ref = vit_bridge.load_teacher_feature_fn(str(tmp_path / "port"), dtype=jnp.float32)(x)
    for k in ours:
        assert _rel(ours[k], np.asarray(ref[k])) <= 1e-5


def test_a_broken_folder_raises_at_load_naming_the_fault(tmp_path, folders):
    vision, mlp1 = _weights()
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(json.dumps({"vision_config": VISION}))
    with pytest.raises(FileNotFoundError, match="no checkpoint files"):
        teacher_lib.load_teacher_weights(str(empty))
    no_mlp1 = write_folder(tmp_path / "no_mlp1", vision, {}, "bin")
    with pytest.raises(KeyError, match="mlp1"):
        teacher_lib.load_teacher_weights(no_mlp1)
    wide = write_folder(tmp_path / "wide", vision, mlp1, "bin")
    with open(os.path.join(wide, "config.json"), "w") as f:
        json.dump({"vision_config": {**VISION, "hidden_size": 128}}, f)
    with pytest.raises(ValueError, match="shape"):
        teacher_lib.load_teacher_weights(wide)
    with pytest.raises(RuntimeError, match="CUDA"):
        teacher_lib.build_teacher(teacher_lib.load_teacher_weights(folders["bin"]))


# ---- the teacher in a UniFlowRun fit ----

TINY = dict(vit_hidden_size=64, llm_hidden_size=LLM, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, patch_size=4, image_size=32, global_blocks_depth=1,
            num_decoder_layers=1, num_sampling_steps=2, enable_pixel_branch=False)


@jax.jit
def _jax_draws(key) -> dict:
    """``forward_loss``'s semantic-head draws under ``key`` (its first split)."""
    r_nt, r_mix, r_u, r_x0 = jax.random.split(jax.random.split(key)[0], 4)
    return dict(t_normal=jax.random.normal(r_nt, (2, 16)), t_mix=jax.random.uniform(r_mix, (2, 16)),
                t_uniform=jax.random.uniform(r_u, (2, 16)),
                x0=jax.random.normal(r_x0, (2, 16, 256)))


def _distill_run(tmp_path, teacher_path, monkeypatch, dtype=torch.float32):
    """``uniflow_internvit_2b_distill.yaml`` as shipped but for a tiny
    ``config_path``, a PixImageNet node over a PNG folder and
    ``teacher_model_path``, built as ``cli fit`` builds it, in ``dtype``."""
    from deco_tpu_torch.utils import png

    folder = tmp_path / "images" / "n0"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(4)
    for i in range(2):
        png.write(str(folder / f"{i}.png"), rng.integers(0, 256, (40, 44, 3), dtype=np.uint8))
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    config = registry.load_yaml(os.path.join(REPO, "configs_flow/uniflow_internvit_2b_distill.yaml"))
    config["model"].update(config_path=str(tmp_path / "config.json"),
                           teacher_model_path=teacher_path)
    config["data"].update(train_batch_size=2, train_num_workers=1, train_dataset={
        "class_path": "src.data.dataset.imagenet.PixImageNet",
        "init_args": {"root": str(tmp_path / "images"), "resolution": 32}})
    config["trainer"].update(default_root_dir=str(tmp_path / "root"), log_every_n_steps=1)
    monkeypatch.setattr(uniflow_loop, "UniFlowExperiment",
                        functools.partial(uniflow_loop.UniFlowExperiment, dtype=dtype))
    monkeypatch.setattr(teacher_lib, "build_teacher",
                        functools.partial(teacher_lib.build_teacher, dtype=dtype))
    monkeypatch.setattr(workloads.CheckpointManager, "save", lambda *a, **k: None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return workloads.UniFlowRun(json.loads(json.dumps(config)), device="cpu")


def test_distill_fit_with_a_teacher_folder_matches_jax_loss_terms(tmp_path, folders,
                                                                  monkeypatch):
    """One step of the distill config's fit with ``teacher_model_path``: the
    teacher built from the folder feeds ``forward_loss``, whose terms
    (``vit_distill_loss`` non-zero: 0 in self-distillation) equal JAX's
    ``forward_loss`` with JAX's teacher, on the same weights, images and
    draws."""
    run = _distill_run(tmp_path, folders["bin"], monkeypatch)
    assert isinstance(run.exp.teacher_fn, teacher_lib.InternVLTeacher)
    key = jax.random.PRNGKey(5)
    seen, step = {}, run.exp.train_step

    def train_step(state, x, generator=None, teacher_feat=None):
        seen.update(x=x.numpy().copy(), params=numpy_state(run.exp.model),
                    teacher={k: v.numpy().copy() for k, v in teacher_feat.items()})
        draws = {"sem": {k: np.asarray(v) for k, v in _jax_draws(key).items()}}
        seen["metrics"] = {k: float(v) for k, v in step(state, x, draws=draws,
                                                        teacher_feat=teacher_feat).items()}
        return seen["metrics"]

    run.exp.train_step = train_step
    run.fit(max_steps=1)
    ours = seen["metrics"]
    assert ours["vit_distill_loss"] > 0 and np.isfinite(list(ours.values())).all()

    jteacher = vit_bridge.load_teacher_feature_fn(folders["bin"], dtype=jnp.float32)
    jfeat = jteacher(seen["x"])
    for k in jfeat:
        assert _rel(seen["teacher"][k], np.asarray(jfeat[k])) <= 1e-5
    jmodel = juniflow.UniFlowExperiment(JaxUniFlowConfig(**TINY), juniflow.UniFlowTrainConfig(),
                                        dtype=jnp.float32).model
    params = {"params": uniflow_params_from_torch(seen["params"])}
    fn = jax.jit(lambda p, x, k, tf: jmodel.apply(p, x, k, teacher_feat=tf,
                                                  method=jmodel.forward_loss))
    ref = fn.lower(params, seen["x"], key, jfeat).compile(FAST_COMPILE)(
        params, seen["x"], key, jfeat)
    for k in ("distill_loss", "vit_distill_loss", "sem_mse_loss", "loss"):
        np.testing.assert_allclose(ours[k], float(ref[k]), rtol=1e-4, err_msg=k)
