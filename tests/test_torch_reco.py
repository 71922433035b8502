"""ReCo in the port (deco_tpu_torch.models.reco, .uniflow.components, the
registry's ReCo branch, PixHFDataset, the loop's reconstruction path, the
W&B gate and the converter) against the JAX package, on the CPU.

The tiny model is built by both registries from a synthesized InternVL
``config.json`` (tests/test_reco_forward_parity.py's pattern): a ViT of
width 48, 4 heads, 3 layers cut to 2 by ``select_layer``, patch 14 and a
position table for 112 px (so 56 px images resize it, as 224 px images do
the 448 px table of the shipped tower); a decoder of width 64 over 4 heads
with 2 blocks, ``hidden_size_x`` 16 and 2 res blocks. The JAX parameters
are redrawn at scale 0.5 (tests/torch_port_util.redraw) and reach the port
through ``convert.state_dict_from_jax_reco``. One jitted JAX program gives
every reference output (a module fixture whose result the run's pytest-xdist
workers share through a file-locked cache), so the run costs one compile.

Tolerances: fp32 forwards atol 1e-5 x the reference's largest value (sums
in another order through 2 + 2 attention layers; seen at ~5e-7); the loss
rtol 1e-5; token resampling and the converter's round trip exact; dataset
items equal as uint8 (PNG and JPEG), and JPEG within 1 LSB of the JAX
native data plane where that is built.
"""

import dataclasses
import glob
import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deco_tpu.config import registry as jax_registry
from deco_tpu.convert.torch_to_flax import convert_reco
from deco_tpu.data import imagenet as jax_imagenet
from deco_tpu.diffusion import training as jtraining
from deco_tpu.diffusion.scheduling import LinearScheduler as JLinear
from deco_tpu.models import patching as jax_patching
from deco_tpu.models.uniflow import components as jax_components
from deco_tpu_torch.config import registry
from deco_tpu_torch.convert import state_dict_from_jax_reco
from deco_tpu_torch.data import imagenet
from deco_tpu_torch.diffusion import training as ttraining
from deco_tpu_torch.diffusion.scheduling import LinearScheduler
from deco_tpu_torch.models import layers as tl
from deco_tpu_torch.models.reco import ReCoModel
from deco_tpu_torch.models.uniflow import components
from deco_tpu_torch.train import hooks
from deco_tpu_torch.train.loop import Experiment
from torch_port_util import (fast_jit, jax_decodes_with_pil, jax_native_data_plane, redraw,
                             shared_across_workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENOISER = "src.models.transformer.dit_t2i_DeCo.PixNerDiT"
VISION = dict(hidden_size=48, num_attention_heads=4, intermediate_size=96, patch_size=14,
              image_size=112, num_hidden_layers=3, qk_normalization=True, norm_type="rms_norm",
              qkv_bias=False)
TINY = dict(in_channels=3, patch_size=16, num_groups=4, hidden_size=64, hidden_size_x=16,
            num_encoder_blocks=2, num_decoder_blocks=2, select_layer=2, llm_hidden_size=40)
SIZE = 56  # a 4 x 4 token grid at patch 14
FWD_ATOL = 1e-5  # x the reference's largest value
RECO_CONFIGS = sorted(p for p in glob.glob(os.path.join(REPO, "configs*", "*.yaml"))
                      if "dit_t2i_DeCo.PixNerDiT" in open(p).read()
                      and "config_path" in open(p).read())


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_internvl")
    with open(root / "config.json", "w") as f:
        json.dump({"model_type": "internvl_chat", "vision_config": VISION}, f)
    return str(root)


def _inputs(seed=0, n=2):
    rng = np.random.default_rng(seed)
    image = rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
    x_t = rng.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)
    return image, x_t, np.array([0.3, 0.8][:n], np.float32)


def _loss_draws(n=2, seed=1):
    rng = np.random.default_rng(seed)
    return dict(t_normal=rng.standard_normal(n).astype(np.float32),
                t_uniform=rng.uniform(size=n).astype(np.float32),
                mix_u=np.linspace(0.0, 1.0, n).astype(np.float32),  # both t branches
                noise=rng.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32))


def _jax_reference(model) -> tuple:
    """(redrawn params, every reference output) of the JAX ReCoModel, as
    numpy, from one jitted program."""
    x = jnp.zeros((1, SIZE, SIZE, 3))
    shapes = jax.eval_shape(lambda r: model.init(r, x, jnp.zeros((1,)), method=model.init_all),
                            jax.random.PRNGKey(0))
    params = redraw(shapes, seed=3, scale=0.5)
    image, x_t, t = _inputs()
    d = _loss_draws()
    uniforms = iter([d["t_uniform"], d["mix_u"]])  # DeCoTrainer's call order (no label drop)
    trainer = jtraining.DeCoTrainer(JLinear(), lognorm_t=True, null_condition_p=0.0)

    def outputs(p):
        net = lambda *a: model.apply(p, *a)  # noqa: E731
        with mock.patch.object(jax.random, "normal", side_effect=lambda key, shape, *a: (
                jnp.asarray(d["t_normal"] if tuple(shape) == (2,) else d["noise"]))), \
                mock.patch.object(jax.random, "uniform",
                                  side_effect=lambda *a, **k: jnp.asarray(next(uniforms))):
            loss = trainer(jax.random.PRNGKey(0), net, jnp.asarray(image), jnp.asarray(image),
                           jnp.zeros_like(image))["loss"]
        return {"call_4d": net(x_t, t, image),
                "forward_condition": model.apply(p, image, method=model.forward_condition),
                "extract_feature": model.apply(p, image, method=model.extract_feature),
                "loss": loss}

    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, fast_jit(outputs)(params)))


@pytest.fixture(scope="module")
def jax_reco(config_path, tmp_path_factory):
    """(JAX ReCoModel, redrawn params, every reference output), fp32; the
    reference computed once for the whole run (one JAX compile however many
    pytest-xdist workers draw its tests)."""
    model = jax_registry._dit_t2i_deco_dispatch(**TINY, config_path=config_path,
                                                dtype=jnp.float32)
    params, outputs = shared_across_workers(tmp_path_factory, "reco_jax_reference",
                                            lambda: _jax_reference(model))
    return model, params, outputs


@pytest.fixture(scope="module")
def port_reco(jax_reco, config_path):
    _, params, _ = jax_reco
    model = registry.instantiate({"class_path": DENOISER, "init_args": dict(
        TINY, config_path=config_path, dtype="float32", device="cpu")})
    model.load_state_dict(state_dict_from_jax_reco(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("scale", [0.5, 2])
def test_resample_tokens_matches_jax(scale):
    tokens = np.random.default_rng(2).standard_normal((2, 16, 48)).astype(np.float32)
    got = components.resample_tokens(torch.from_numpy(tokens), scale).numpy()
    want = np.asarray(jax_components.resample_tokens(jnp.asarray(tokens), scale))
    assert got.shape == want.shape == (2, int(16 * scale**2), int(48 / scale**2))
    np.testing.assert_array_equal(got, want)


def test_plain_dit_block_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    cos, sin = tl.precompute_rope_2d(16, 4, 5, scale=1.0, extrapolate=True)
    block = jax_components.PlainDiTBlock(num_heads=4, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: block.init(r, jnp.asarray(x), (cos, sin)),
                            jax.random.PRNGKey(0))
    params = redraw(shapes, seed=5)
    want = np.asarray(fast_jit(lambda p: block.apply(p, x, (cos, sin)))(params))
    ours = components.PlainDiTBlock(64, 4)
    p = params["params"]
    sd = {"norm1.weight": p["norm1"]["weight"], "norm2.weight": p["norm2"]["weight"],
          "attn.qkv.weight": np.asarray(p["attn"]["qkv"]["kernel"]).T,
          "attn.q_norm.weight": p["attn"]["q_norm"]["weight"],
          "attn.k_norm.weight": p["attn"]["k_norm"]["weight"],
          "attn.proj.weight": np.asarray(p["attn"]["proj"]["kernel"]).T,
          "attn.proj.bias": p["attn"]["proj"]["bias"],
          "mlp.w12.weight": np.concatenate([np.asarray(p["mlp"]["w1"]["kernel"]).T,
                                            np.asarray(p["mlp"]["w3"]["kernel"]).T]),
          "mlp.w3.weight": np.asarray(p["mlp"]["w2"]["kernel"]).T}
    ours.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = ours(torch.from_numpy(x), (torch.from_numpy(cos), torch.from_numpy(sin))).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL * np.abs(want).max(), rtol=0)


def test_dispatch_reads_the_internvl_config_like_jax(jax_reco, port_reco):
    model, _, _ = jax_reco
    assert type(port_reco) is ReCoModel
    assert dataclasses.asdict(port_reco.vit) == dataclasses.asdict(
        dataclasses.replace(model.vit, num_layers=TINY["select_layer"]))
    assert len(port_reco.vision_model.encoder.layers) == TINY["select_layer"]
    assert port_reco.pixel_decoder.patch_size == VISION["patch_size"]  # not the dead 16


@pytest.mark.parametrize("name", ["call_4d", "forward_condition", "extract_feature"])
def test_reco_matches_jax(jax_reco, port_reco, name):
    want = jax_reco[2][name]
    image, x_t, t = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        got = {"call_4d": lambda: port_reco(x_t, t, image),
               "forward_condition": lambda: port_reco.forward_condition(image),
               "extract_feature": lambda: port_reco.extract_feature(image)}[name]().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FWD_ATOL * np.abs(want).max(), rtol=0)


def test_deco_trainer_loss_on_reco_matches_jax(jax_reco, port_reco):
    """The ReCo configs' objective (DeCoTrainer, lognorm t, no label drop),
    the image as condition and zeros as uncondition, the same draws."""
    image, _, _ = _inputs()
    trainer = ttraining.DeCoTrainer(LinearScheduler(), lognorm_t=True, null_condition_p=0.0)
    cond = torch.from_numpy(image)
    with torch.no_grad():
        got = trainer(port_reco, cond, cond, torch.zeros_like(cond), draws=_loss_draws())
    np.testing.assert_allclose(float(got["loss"]), float(jax_reco[2]["loss"]), rtol=1e-5)


def test_state_dict_round_trips_through_convert_reco(jax_reco, port_reco):
    """The port's state dict, as numpy, read by the JAX converter gives back
    the JAX tree exactly."""
    _, params, _ = jax_reco
    back = convert_reco({k: v.numpy() for k, v in port_reco.state_dict().items()})
    want = jax.tree_util.tree_map(np.asarray, params)["params"]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_back.keys() == flat_want.keys()
    for path, value in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), value, err_msg=str(path))


def test_a_size_the_patch_does_not_divide_raises_like_jax(port_reco):
    """ReCo_large_stage3_val.yaml validates at 256 px, which patch 14 does
    not divide: the JAX patchify raises ValueError there, and so does the port."""
    with pytest.raises(ValueError, match="not divisible by patch_size=14"):
        jax_patching.patchify(jnp.zeros((1, 64, 64, 3)), 14)
    x = torch.zeros(1, 64, 64, 3)
    with torch.no_grad(), pytest.raises(ValueError, match="not divisible by patch_size=14"):
        port_reco(x, torch.zeros(1), x)


@pytest.mark.parametrize("path", RECO_CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_reco_configs_build_the_tower_jax_builds(path, tmp_path):
    """Each ReCo config's Experiment (the denoiser on the meta device: no
    full-width weights drawn) builds ReCoModel with the JAX dispatch's
    tower depth, ImageConditioner and the W&B node read."""
    assert len(RECO_CONFIGS) == 17
    config = registry.load_yaml(path)
    args = config["model"]["denoiser"]["init_args"]
    want = jax_registry._dit_t2i_deco_dispatch(**args)
    exp = Experiment(config, workdir=str(tmp_path), device="meta")
    model = exp.model
    assert type(model) is ReCoModel and type(exp.conditioner).__name__ == "ImageConditioner"
    depth = want.select_layer if want.select_layer > 0 else want.vit.num_layers
    assert len(model.vision_model.encoder.layers) == depth == args.get("select_layer", 24)
    assert len(model.pixel_decoder.blocks) == want.num_encoder_blocks
    assert len(model.pixel_decoder.dec_net.res_blocks) == want.num_decoder_blocks
    assert model.pixel_decoder.hidden_size == want.hidden_size == 1024
    assert exp.wandb_project == config["tags"]["exp"]
    assert type(exp.trainer).__name__ == "DeCoTrainer" and not exp.trainer.enable_freq_loss


# ---- PixHFDataset ----

def _smooth_image(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h, (xx + yy) * 127.0 / (h + w)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """An image-folder dataset: train (PNG) and validation (JPEG) splits."""
    root = tmp_path_factory.mktemp("hf_images")
    rng = np.random.default_rng(9)
    for split, ext, sizes in (("train", "png", [(70, 84), (84, 60), (56, 56)]),
                              ("validation", "jpg", [(130, 100), (90, 150)])):
        for c in ("n01", "n02"):
            os.makedirs(root / split / c)
            for i, hw in enumerate(sizes):
                Image.fromarray(_smooth_image(rng, *hw)).save(root / split / c / f"{i}.{ext}",
                                                              quality=90)
    return str(root)


@pytest.fixture
def hf_offline(tmp_path, monkeypatch):
    datasets = pytest.importorskip("datasets")
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", str(tmp_path / "hf_cache"))
    monkeypatch.setattr(datasets.config, "HF_DATASETS_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_HUB_OFFLINE", True)
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")


@pytest.mark.parametrize("num", [None, 4])
def test_pix_hf_dataset_matches_jax_on_png(image_folder, hf_offline, num):
    ours = imagenet.PixHFDataset(root=image_folder, split="train", resolution=56,
                                 max_num_samples=num, seed=3)
    ref = jax_imagenet.PixHFDataset(dataset_name=image_folder, split="train", resolution=56,
                                    num_samples=num, seed=3)
    assert len(ours) == len(ref) == (num or 6)
    for i in range(len(ref)):
        x, y, md = ours[i]
        rx, ry, rmd = ref[i]
        assert y == ry and x.shape == rx.shape == (56, 56, 3)
        np.testing.assert_array_equal(np.round(md["raw_image"] * 255),
                                      np.round(rmd["raw_image"] * 255))


def test_pix_hf_dataset_jpeg_takes_the_native_path(image_folder, hf_offline, monkeypatch):
    """JPEG bytes through the port's own decoder: equal byte for byte to the
    JAX ``PixHFDataset`` (PIL, through ``datasets``) and to the JAX
    ``PixImageNet`` on its PIL path, center crop and ``random_crop`` (which
    once raised naming ROADMAP §A 2); within one level of the JAX native
    data plane where that is built."""
    ours = imagenet.PixHFDataset(root=image_folder, split="validation", resolution=64)
    items = [ours[i] for i in range(len(ours))]
    ref = jax_imagenet.PixHFDataset(dataset_name=image_folder, split="validation",
                                    resolution=64)
    jax_decodes_with_pil(monkeypatch)
    folder = os.path.join(image_folder, "validation")
    pil = jax_imagenet.PixImageNet(folder, resolution=64)
    assert len(items) == len(ref) == len(pil) == 4
    for i in range(len(ref)):
        x, y, _ = items[i]
        assert y == ref[i][1] == pil[i][1]
        np.testing.assert_array_equal(x, ref[i][0])
        np.testing.assert_array_equal(x, pil[i][0])
    ours = imagenet.PixHFDataset(root=image_folder, split="validation", resolution=64,
                                 random_crop=True, seed=2)
    pil = jax_imagenet.PixImageNet(folder, resolution=64, random_crop=True, seed=2)
    for i in range(len(pil)):
        np.testing.assert_array_equal(ours[i][0], pil[i][0])
    if jax_native_data_plane(monkeypatch):
        native = jax_imagenet.PixImageNet(folder, resolution=64)
        for i in range(len(native)):
            assert np.abs(items[i][0] - native[i][0]).max() <= 2.0 / 255 + 1e-6


def test_pix_hf_dataset_without_datasets_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="'datasets'"):
        imagenet.PixHFDataset(root="imagenet-1k")


# ---- the W&B gate and the loop ----

@pytest.fixture
def no_wandb_no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # absent, as on the card host
    monkeypatch.setattr(hooks, "_tensorboard", lambda logdir: None)  # TensorFlow takes ~18 s


def test_wandb_logger_node_logs_to_jsonl_without_wandb(tmp_path, no_wandb_no_tensorboard):
    config = registry.load_yaml(os.path.join(REPO, "configs_c2i/ReCo_large.yaml"))
    assert config["trainer"]["logger"]["class_path"].endswith("WandbLogger")
    exp = Experiment(config, workdir=str(tmp_path), device="meta")
    assert exp.wandb_project == "internvit_layer_24"  # the node's name
    assert hooks._maybe_wandb(str(tmp_path), exp.wandb_project, config) is None
    logger = hooks.ScalarLogger(str(tmp_path), log_every_n_steps=1,
                                wandb_project=exp.wandb_project, run_config=config)
    logger.log(0, {"loss": torch.tensor(0.5)})
    logger.close()
    assert [json.loads(line)["loss"] for line in open(tmp_path / "metrics.jsonl")] == [0.5]


def test_tiny_reco_experiment_fits_and_validates(config_path, image_folder, hf_offline, tmp_path,
                                                 no_wandb_no_tensorboard):
    """ReCo_large.yaml at tiny widths (its PixHFDataset nodes on the image
    folder, its W&B node, ComputeMetricsHook with FID at 64 features) fits 2
    steps and validates one batch of 4 sampler steps on the CPU."""
    config = registry.load_yaml(os.path.join(REPO, "configs_c2i/ReCo_large.yaml"))
    config["model"]["denoiser"]["init_args"].update(TINY, config_path=config_path)
    config["model"]["diffusion_sampler"]["init_args"]["num_steps"] = 4
    config["trainer"]["log_every_n_steps"] = 1
    metrics_cb = config["trainer"]["callbacks"][1]["init_args"]
    assert metrics_cb == {"compute_fid": True, "fid_feature_dim": 2048}
    metrics_cb["fid_feature_dim"] = 64  # the tower's first block: 2048 costs ~15 s here
    data = config["data"]
    data.update(train_batch_size=2, pred_batch_size=2, train_num_workers=2)
    for key, split in (("train_dataset", "train"), ("eval_dataset", "train")):
        data[key]["init_args"].update(root=image_folder, resolution=56, split=split)
    exp = Experiment(config, workdir=str(tmp_path / "work"), device="cpu")
    state = exp.fit(max_steps=2)
    records = [json.loads(line) for line in open(tmp_path / "work" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in records)
    assert state.step == 2 and exp.diffusion_batch_mul == 4
    exp.predict(state=state, max_batches=1, dataset_key="eval_dataset")
    scores = json.load(open(tmp_path / "work" / "predict_metrics.json"))
    assert sorted(scores) == ["metrics/fid", "metrics/psnr", "metrics/ssim"]
    assert all(np.isfinite(v) for v in scores.values())
    panels = sorted(os.listdir(tmp_path / "work" / "images"))
    assert panels == ["reconstruction_step2_000.png", "reconstruction_step2_001.png"]
    from deco_tpu_torch.utils import png

    assert png.read(str(tmp_path / "work" / "images" / panels[0])).shape == (56, 112, 3)
