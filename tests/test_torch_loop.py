"""The port's run loop (deco_tpu_torch.train.loop, checkpoint, hooks, cli)
against the JAX package's: predict parity from the same weights, a resumed
fit that equals an uninterrupted one, the workdir guard, the JAX-to-port
training checkpoint, and the CLI in a process without JAX, PyYAML or PIL."""

import copy
import functools
import json
import os
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from deco_tpu.models.dit_c2i_deco import DeCoC2I as JaxDeCoC2I
from deco_tpu.train.loop import Experiment as JaxExperiment
from deco_tpu.train.state import TrainState as JaxTrainState
from deco_tpu_torch import cli, convert
from deco_tpu_torch.config import _yaml
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
from deco_tpu_torch.train import hooks
from deco_tpu_torch.train.checkpoint import CheckpointManager
from deco_tpu_torch.train.loop import Experiment, step_seed
from deco_tpu_torch.train.state import TrainState
from deco_tpu_torch.utils.pipeline import pipelined_map
from deco_tpu_torch.utils.preemption import PreemptionGuard
from deco_tpu_torch.utils.png import read as png_read
from torch_port_util import TINY_C2I, TINY_IMAGE, TINY_T2I, fast_jit, redraw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_init_args():
    return (jax.random.PRNGKey(0), jnp.zeros((1, TINY_IMAGE, TINY_IMAGE, 3)), jnp.zeros((1,)),
            jnp.zeros((1,), jnp.int32))


@functools.lru_cache(maxsize=1)
def _jax_zeros():
    shapes = jax.eval_shape(JaxDeCoC2I(**TINY_C2I, dtype=jnp.float32).init, *jax_init_args())
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


def jax_params(seed: int, scale: float = 1.0):
    """The tiny JAX DeCoC2I's parameter tree drawn by ``redraw``; the tree
    comes from ``eval_shape``, which skips the (slow, eager) init."""
    return redraw(_jax_zeros(), seed, scale)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """Importing TensorBoard can take ~20 s (where it pulls in TensorFlow),
    and it is not what these tests check."""
    monkeypatch.setattr(hooks, "_tensorboard", lambda logdir: None)


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.RandomState(0)
    for cls in ("class_a", "class_b"):
        (root / cls).mkdir()
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (20, 24, 3), np.uint8)).save(root / cls / f"{i}.png")
    return str(root)


def tiny_config(root_dir: str, image_root: str = "/nonexistent", num_classes: int = 10) -> dict:
    """configs_c2i/DeCo_XL_freq.yaml's structure at the tiny test widths, in fp32."""
    return {
        "tags": {"exp": "tiny"},
        "trainer": {
            "default_root_dir": root_dir, "max_steps": 4, "log_every_n_steps": 1,
            "callbacks": [
                {"class_path": "src.callbacks.model_checkpoint.CheckpointHook",
                 "init_args": {"every_n_train_steps": 1000}},
                {"class_path": "src.callbacks.save_images.SaveImagesHook",
                 "init_args": {"save_dir": "val", "save_compressed": True,
                               "max_save_images": 3}},
            ],
        },
        "model": {
            "diffusion_batch_mul": 2,
            "vae": {"class_path": "src.models.autoencoder.pixel.PixelAE",
                    "init_args": {"scale": 1.0}},
            "denoiser": {"class_path": "src.models.transformer.dit_c2i_DeCo.PixNerDiT",
                         "init_args": {**TINY_C2I, "num_classes": num_classes,
                                       "grad_checkpointing": True, "dtype": "float32"}},
            "conditioner": {"class_path": "src.models.conditioner.class_label.LabelConditioner",
                            "init_args": {"num_classes": num_classes}},
            "diffusion_trainer": {
                "class_path": "src.diffusion.flow_matching.training_repa_DeCo.REPATrainer",
                "init_args": {"lognorm_t": True, "null_condition_p": 0.2,
                              "enable_freq_loss": True,
                              "scheduler": "src.diffusion.flow_matching.scheduling.LinearScheduler"}},
            "diffusion_sampler": {
                "class_path": "src.diffusion.flow_matching.sampling.EulerSampler",
                "init_args": {"num_steps": 3, "guidance": 3.2, "guidance_interval_min": 0.1,
                              "guidance_interval_max": 1.0,
                              "scheduler": "src.diffusion.flow_matching.scheduling.LinearScheduler",
                              "w_scheduler": "src.diffusion.flow_matching.scheduling.LinearScheduler",
                              "guidance_fn": "src.diffusion.base.guidance.simple_guidance_fn",
                              "step_fn": "src.diffusion.flow_matching.sampling.ode_step_fn"}},
            "ema_tracker": {"class_path": "src.callbacks.simple_ema.SimpleEMA",
                            "init_args": {"decay": 0.9}},
            "optimizer": {"class_path": "torch.optim.AdamW",
                          "init_args": {"lr": "1e-3", "weight_decay": 0.01}},
        },
        "data": {
            "train_dataset": {"class_path": "src.data.dataset.imagenet.PixImageNet",
                              "init_args": {"root": image_root, "resolution": TINY_IMAGE}},
            "pred_dataset": {"class_path": "src.data.dataset.randn.ClassLabelRandomNDataset",
                             "init_args": {"num_classes": num_classes, "max_num_instances": 20,
                                           "latent_shape": [3, TINY_IMAGE, TINY_IMAGE]}},
            "train_batch_size": 2, "train_num_workers": 2, "pred_batch_size": 1,
            "pred_num_workers": 1,
        },
    }


# ---- predict parity with the JAX package ----

def test_cli_predict_matches_jax_predict_from_the_same_weights(tmp_path):
    """JAX TrainState (random params, another random EMA) -> the JAX predict;
    the same state through train_checkpoint_from_jax -> the port's CLI
    predict on the CPU. output.npz agrees within 1 LSB, image for image,
    with the FID protocol's file names."""
    config = tiny_config(str(tmp_path / "jax"))
    config["data"]["pred_dataset"]["init_args"]["max_num_instances"] = 4  # 2 seeds a class
    config["data"]["pred_dataset"]["init_args"]["num_classes"] = 2
    jexp = JaxExperiment(copy.deepcopy(config))
    params, ema = jax_params(0), jax_params(1)
    # jitted: the zero moments in one compile, not one per leaf shape
    state = jax.jit(lambda p: JaxTrainState.create(p, optax.adamw(1e-3)))(params).replace(
        ema_params=ema)
    ref = np.load(jexp.predict(state=state))["arr_0"]

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    adam = state.opt_state[0]
    obj = convert.train_checkpoint_from_jax(to_np(params), to_np(ema), to_np(adam.mu),
                                            to_np(adam.nu), adam.count, step=5,
                                            patch_size=TINY_C2I["patch_size"])
    ckpt_dir = tmp_path / "port_ckpt"
    CheckpointManager(str(ckpt_dir)).save(obj, 5)
    cfg_path = tmp_path / "tiny.yaml"
    config["trainer"]["default_root_dir"] = str(tmp_path / "port")
    cfg_path.write_text(_yaml.dump(config))
    out = cli.main(["predict", "-c", str(cfg_path), "--device", "cpu",
                    f"--ckpt_path={ckpt_dir}"])
    ours = np.load(out)["arr_0"]
    assert ours.shape == (4, TINY_IMAGE, TINY_IMAGE, 3) and ours.dtype == np.uint8
    assert ours.std() > 0
    # the JAX loader pads the batch to its 8 virtual devices; items 0-3 lead
    assert np.abs(ours.astype(int) - ref[:4]).max() <= 1
    names = sorted(os.listdir(os.path.dirname(out)))
    assert names == ["0_0.png", "0_1.png", "1_0.png", "output.npz"]  # max_save_images 3
    np.testing.assert_array_equal(np.array(Image.open(os.path.join(os.path.dirname(out),
                                                                   "1_0.png"))), ours[2])


def tiny_t2i_config(root_dir: str, prompt_dir: str) -> dict:
    """configs_t2i/sft_res512.yaml at the tiny t2i widths, in fp32: predict
    on the DPG prompts in ``prompt_dir``, 2 seeds a prompt, 32 px, 3 steps."""
    config = _yaml.load(os.path.join(REPO, "configs_t2i/sft_res512.yaml"))
    config["trainer"]["default_root_dir"] = root_dir
    config["trainer"]["callbacks"][1]["init_args"].update(save_compressed=True,
                                                          max_save_images=8)
    m = config["model"]
    m["denoiser"]["init_args"].update(TINY_T2I, dtype="float32")
    m["conditioner"]["init_args"].update(embed_dim=TINY_T2I["txt_embed_dim"],
                                         max_length=TINY_T2I["txt_max_length"])
    m["diffusion_sampler"]["init_args"]["num_steps"] = 3
    config["data"]["pred_dataset"]["init_args"].update(
        prompt_path=prompt_dir, num_samples_per_instance=2, latent_shape=[3, 32, 32])
    config["data"]["pred_batch_size"] = 1
    return config


@pytest.mark.parametrize("dataset_key", ["pred_dataset", "eval_dataset"])
def test_t2i_predict_writes_the_files_of_the_jax_predict(tmp_path, dataset_key):
    """configs_t2i/sft_res512.yaml's predict (2 DPG prompts) and validate (2
    GenEval prompts) with the hash text encoder and AdamLM at CFG 4, from
    the same weights: the JAX loop from a TrainState, the port's from a
    step checkpoint of the converted weights. Images within 1 LSB, the DPG
    files named ``<prompt file>_<seed>.png``, and GenEval's
    ``metadata.jsonl`` equal to the JAX loop's, ``valid_length_y`` (which
    the text encoder writes into the batch metadata) included."""
    from deco_tpu_torch.train.checkpoint import payload
    from torch_port_util import tiny_jax_t2i

    prompts = tmp_path / "prompts"
    prompts.mkdir()
    (prompts / "a.txt").write_text("A red cube on a wooden table.\nsecond line\n")
    (prompts / "b.txt").write_text("Two cats asleep in the sun.\n")
    geneval = tmp_path / "geneval.jsonl"
    with open(os.path.join(REPO, "evaluations/geneval/evaluation_metadata.jsonl")) as f:
        lines = f.readlines()
    geneval.write_text(lines[0] + lines[-1])  # the last one has an "exclude" list
    config = tiny_t2i_config(str(tmp_path / "jax"), str(prompts))
    config["data"]["eval_dataset"]["init_args"].update(
        meta_json_path=str(geneval), num_samples_per_instance=2, latent_shape=[3, 32, 32])
    _, params = tiny_jax_t2i(0)
    state = jax.jit(lambda p: JaxTrainState.create(p, optax.adamw(1e-3)))(params).replace(
        ema_params=params)
    ref_npz = JaxExperiment(copy.deepcopy(config)).predict(state=state, dataset_key=dataset_key)
    ref = np.load(ref_npz)["arr_0"]

    sd = convert.state_dict_from_jax_t2i(jax.tree_util.tree_map(np.asarray, params),
                                         patch_size=TINY_T2I["patch_size"])
    CheckpointManager(str(tmp_path / "ckpt")).save(payload(sd, sd, {}, 3), 3)
    config["trainer"]["default_root_dir"] = str(tmp_path / "port")
    out = Experiment(config, device="cpu").predict(ckpt_path=str(tmp_path / "ckpt"),
                                                   dataset_key=dataset_key)
    ours = np.load(out)["arr_0"]
    assert ours.shape == (4, 32, 32, 3) and ours.dtype == np.uint8 and ours.std() > 0
    # the JAX loader pads the batch to its 8 virtual devices; items 0-3 lead
    assert np.abs(ours.astype(int) - ref[:4]).max() <= 1
    root, ref_root = os.path.dirname(out), os.path.dirname(ref_npz)
    if dataset_key == "pred_dataset":
        assert sorted(os.listdir(root)) == ["a_0.png", "a_1.png", "b_0.png", "b_1.png",
                                            "output.npz"]
        np.testing.assert_array_equal(png_read(os.path.join(root, "b_0.png")), ours[2])
        return
    assert sorted(os.listdir(root)) == ["0", "1", "2", "3", "output.npz"]
    for idx in range(4):
        with open(os.path.join(root, str(idx), "metadata.jsonl")) as f:
            text = f.read()
        with open(os.path.join(ref_root, str(idx), "metadata.jsonl")) as f:
            assert text == f.read()
        meta = json.loads(text)
        assert meta["valid_length_y"] == min(len(meta["prompt"].split()),
                                             TINY_T2I["txt_max_length"])
        np.testing.assert_array_equal(
            png_read(os.path.join(root, str(idx), "samples", f"{idx % 2}.png")), ours[idx])


# ---- fit: resume equals an uninterrupted run ----

def _fit(config, max_steps, resume=False):
    exp = Experiment(copy.deepcopy(config), resume=resume, device="cpu")
    exp.fit(max_steps=max_steps)
    return exp


def test_resumed_fit_is_bit_equal_to_an_uninterrupted_fit(tmp_path, image_root):
    """4 steps in one run against 2 + 2 with a resume between: parameters,
    EMA and AdamW moments bit-equal on the CPU (6 images in batches of 2,
    so the runs cross an epoch), and the logged steps contiguous."""
    straight = _fit(tiny_config(str(tmp_path / "a"), image_root), 4)
    split_cfg = tiny_config(str(tmp_path / "b"), image_root)
    _fit(split_cfg, 2)
    resumed = _fit(split_cfg, 4, resume=True)
    a = CheckpointManager(os.path.join(straight.workdir, "checkpoints")).load()
    b = CheckpointManager(os.path.join(resumed.workdir, "checkpoints")).load()
    assert a["step"] == b["step"] == 4
    assert a["state_dict"].keys() == b["state_dict"].keys()
    assert any(k.startswith("ema_denoiser.") for k in a["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    assert a["optimizer"].keys() == b["optimizer"].keys()
    for name, moments in a["optimizer"].items():
        for k, v in moments.items():
            assert torch.equal(v, b["optimizer"][name][k]), (name, k)
    steps = [json.loads(line)["step"] for line in
             open(os.path.join(resumed.workdir, "metrics.jsonl"))]
    assert steps == [0, 1, 2, 3]
    assert sorted(os.listdir(os.path.join(resumed.workdir, "checkpoints"))) == ["2.pt", "4.pt"]


def test_init_follows_the_jax_initializers():
    """Zeros, ones and the spread of every parameter as the JAX model's
    initializers give them (the values differ: another generator)."""
    from deco_tpu_torch.models.dit_c2i_deco import init_like_jax_

    model = DeCoC2I(**TINY_C2I, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    init_like_jax_(model, seed=0)
    ref = jax.jit(JaxDeCoC2I(**TINY_C2I, dtype=jnp.float32).init)(*jax_init_args())
    ref = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref),
                                      patch_size=TINY_C2I["patch_size"])
    ours = dict(model.named_parameters())
    assert ours.keys() == ref.keys()
    for name, want in ref.items():
        got = ours[name].detach()
        if not want.any() or bool((want == 1).all()):
            assert torch.equal(got, want), name
        else:
            assert want.numel() >= 256, name
            assert abs(got.std().item() / want.std().item() - 1) < 0.15, name
            assert got.abs().max() <= 2.01 * want.abs().max(), name
    again = init_like_jax_(DeCoC2I(**TINY_C2I, dtype=torch.float32, device="cpu"), seed=0)
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))


def test_step_generators_depend_on_seed_and_step_only():
    assert step_seed(0, 3) == step_seed(0, 3)
    assert len({step_seed(s, t) for s in range(3) for t in range(50)}) == 150


# ---- workdir guard ----

def test_workdir_guard_refuses_a_used_workdir_unless_resuming(tmp_path):
    config = tiny_config(str(tmp_path))
    workdir = tmp_path / "tiny"
    workdir.mkdir()
    (workdir / "metrics.jsonl").write_text("")
    with pytest.raises(FileExistsError):
        Experiment(copy.deepcopy(config), device="cpu")
    exp = Experiment(copy.deepcopy(config), resume=True, device="cpu")
    assert exp.workdir == str(workdir)
    assert _yaml.load(str(workdir / "config.yaml")) == config  # the snapshot


def test_unported_callbacks_and_loggers_raise(tmp_path):
    """ComputeMetricsHook is ported now (tests/test_torch_metrics.py); a
    callback the port does not know raises. The W&B logger no longer does:
    its node names the project (``deco`` without ``project`` or ``name``, as
    in the JAX loop), which logs only where ``wandb`` imports
    (tests/test_torch_reco.py)."""
    config = tiny_config(str(tmp_path))
    config["trainer"]["callbacks"].append(
        {"class_path": "src.callbacks.compute_metrics.ComputeMetricsHook",
         "init_args": {"compute_fid": True, "fid_feature_dim": 2048}})
    assert Experiment(config, device="cpu").metrics_hook_cfg == {
        "compute_fid": True, "fid_feature_dim": 2048}
    config = tiny_config(str(tmp_path / "unknown"))
    config["trainer"]["callbacks"].append({"class_path": "src.callbacks.grad.GradientMonitor"})
    with pytest.raises(ValueError, match="GradientMonitor"):
        Experiment(config, device="cpu")
    config = tiny_config(str(tmp_path))
    config["trainer"]["logger"] = {"class_path": "lightning.pytorch.loggers.WandbLogger"}
    assert Experiment(config, resume=True, device="cpu").wandb_project == "deco"


def test_predict_scores_raw_images_into_predict_metrics_json(tmp_path, image_root):
    """A ComputeMetricsHook callback and a predict dataset whose metadata
    carry ``raw_image`` (an image folder): predict scores its output
    against the originals, as the JAX loop does, and writes the scores to
    ``predict_metrics.json``; they equal the hook run on output.npz and the
    dataset's images."""
    from deco_tpu_torch.data.imagenet import PixImageNet
    from deco_tpu_torch.models.inception import random_inception

    config = tiny_config(str(tmp_path), image_root)
    config["trainer"]["callbacks"].append(
        {"class_path": "src.callbacks.compute_metrics.ComputeMetricsHook",
         "init_args": {"compute_fid": True, "fid_feature_dim": 64}})
    config["data"]["pred_dataset"] = copy.deepcopy(config["data"]["train_dataset"])
    config["data"]["pred_batch_size"] = 3
    exp = Experiment(config, device="cpu")
    out = exp.predict(max_batches=1)
    with open(os.path.join(exp.workdir, "predict_metrics.json")) as f:
        scores = json.load(f)
    assert sorted(scores) == ["metrics/fid", "metrics/psnr", "metrics/ssim"]
    dataset = PixImageNet(root=image_root, resolution=TINY_IMAGE)
    raw = np.stack([dataset[i][2]["raw_image"] for i in range(3)])
    hook = hooks.ComputeMetricsHook(fid_feature_dim=64, device="cpu",
                                    inception=random_inception(0, device="cpu", feature_dim=64))
    hook.on_batch_end(np.load(out)["arr_0"], np.clip(raw * 255.0, 0, 255).astype(np.uint8))
    want = hook.on_epoch_end()
    for key, value in want.items():
        assert scores[key] == pytest.approx(value, rel=1e-9), key


# ---- checkpoints ----

def test_jax_training_state_resumes_in_the_port(tmp_path):
    """A JAX TrainState with nonzero AdamW moments becomes a port
    checkpoint; restored into the port's TrainState, one AdamW step from the
    same gradient gives the update optax gives. optax takes the bias
    corrections 1 - b^t in fp32, where 1 - 0.999^8 keeps ~5 digits, torch in
    fp64: rtol 2e-5 on the update, plus 4 fp32 ulps of the parameter."""
    params, mu, nu, grads = jax_params(2), jax_params(3, 0.01), jax_params(4, 0.01), jax_params(5)
    nu = jax.tree_util.tree_map(lambda x: x * x, nu)  # second moments are >= 0
    tx = optax.adamw(1e-3, weight_decay=0.01)
    jstate = jax.jit(lambda p: JaxTrainState.create(p, tx))(params)  # one compile
    adam = jstate.opt_state[0]._replace(count=np.int32(7), mu=mu, nu=nu)
    opt_state = (adam,) + tuple(jstate.opt_state[1:])
    # jitted: one compile, not an eager dispatch per leaf and op
    expected = fast_jit(lambda g, o, p: optax.apply_updates(p, tx.update(g, o, p)[0]))(
        grads, opt_state, params)

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    obj = convert.train_checkpoint_from_jax(to_np(params), to_np(params), to_np(mu), to_np(nu),
                                            adam.count, step=7, patch_size=TINY_C2I["patch_size"])
    CheckpointManager(str(tmp_path)).save(obj, 7)
    assert os.listdir(tmp_path) == ["7.pt"]  # no temporary file left behind
    torch.load(tmp_path / "7.pt", weights_only=True)
    model = DeCoC2I(**TINY_C2I, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    state = TrainState.create(model, lr=1e-3, weight_decay=0.01)
    CheckpointManager(str(tmp_path)).restore(state)
    assert state.step == 7
    grad_sd = convert.state_dict_from_jax(to_np(grads), patch_size=TINY_C2I["patch_size"])
    for name, p in model.named_parameters():
        p.grad = grad_sd[name].clone()
    before = {name: p.detach().clone() for name, p in model.named_parameters()}
    state.optimizer.step()
    want = convert.state_dict_from_jax(to_np(expected), patch_size=TINY_C2I["patch_size"])
    for name, p in model.named_parameters():
        ulp = before[name].abs().max().item() * 2.0**-23
        torch.testing.assert_close(p.detach() - before[name], want[name] - before[name],
                                   rtol=2e-5, atol=4 * ulp, msg=name)
    # convert.load_checkpoint reads the port's checkpoint file, EMA first
    sd = convert.load_checkpoint(str(tmp_path / "7.pt"))
    assert sd.keys() == dict(model.named_parameters()).keys()


# ---- host utilities ----

def test_pipelined_map_keeps_order_and_drains_on_error():
    events = []
    n = pipelined_map(range(5), lambda b: events.append(("d", b)) or b * 10,
                      lambda out, b: events.append(("c", b, out)), depth=2)
    assert n == 5 and [e for e in events if e[0] == "c"] == [("c", b, b * 10) for b in range(5)]
    assert events.index(("d", 2)) < events.index(("c", 0, 0))  # two batches in flight

    def batches():
        yield 0
        yield 1
        raise KeyError("source failed")

    done = []
    with pytest.raises(KeyError):
        pipelined_map(batches(), lambda b: b, lambda out, b: done.append(b), depth=3)
    assert done == [0, 1]


def test_preemption_guard_turns_sigterm_into_a_stop_request():
    """The handler sets the flag (called directly: a real SIGTERM would end a
    test worker that does not run tests on its main thread)."""
    previous = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        if threading.current_thread() is threading.main_thread():
            assert signal.getsignal(signal.SIGTERM) == guard._handler
        assert not guard.requested
        guard._handler(signal.SIGTERM, None)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) is previous


# ---- the CLI as a user runs it ----

BLOCKER = """
import runpy, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "deco_tpu", "tensorboard"}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is not importable in this test")
sys.meta_path.insert(0, Block())
sys.argv = ["deco_tpu_torch.cli"] + sys.argv[1:]
runpy.run_module("deco_tpu_torch.cli", run_name="__main__", alter_sys=True)
"""
TINY_OVERRIDES = ["--model.denoiser.init_args.hidden_size=32",
                  "--model.denoiser.init_args.num_groups=2",
                  "--model.denoiser.init_args.hidden_size_x=8",
                  "--model.denoiser.init_args.num_blocks=3",
                  "--model.denoiser.init_args.num_cond_blocks=2"]


def test_cli_fit_then_predict_in_a_process_without_jax_yaml_or_pil(tmp_path, image_root):
    """``python -m deco_tpu_torch.cli`` on configs_c2i/DeCo_XL_freq.yaml with
    tiny widths, 2 steps on the CPU, then predict from its checkpoint."""
    common = ["-c", os.path.join(REPO, "configs_c2i/DeCo_XL_freq.yaml"), "--device", "cpu",
              *TINY_OVERRIDES, f"--trainer.default_root_dir={tmp_path}"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO

    def run(*args):
        proc = subprocess.run([sys.executable, "-c", BLOCKER, *args], env=env, cwd=str(tmp_path),
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]

    run("fit", *common, "--max_steps", "2", f"--data.train_dataset.init_args.root={image_root}",
        "--data.train_batch_size=2", "--data.train_num_workers=1",
        "--trainer.log_every_n_steps=1")
    workdir = tmp_path / "DeCo_256_XL_freq"
    records = [json.loads(line) for line in open(workdir / "metrics.jsonl")]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["fm_loss_freq"]) for r in records)
    assert os.listdir(workdir / "checkpoints") == ["2.pt"]
    run("predict", *common, f"--ckpt_path={workdir / 'checkpoints'}", "--max_batches", "1",
        "--data.pred_batch_size=2", "--model.diffusion_sampler.init_args.num_steps=2")
    out = np.load(workdir / "val_ode100_cfg3.2_interval0.1_seed0" / "iter_2" / "output.npz")
    assert out["arr_0"].shape == (2, 256, 256, 3) and out["arr_0"].dtype == np.uint8
