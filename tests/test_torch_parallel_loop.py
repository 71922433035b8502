"""Data parallel and fsdp through the port's CLI on gloo ranks on the CPU
(deco_tpu_torch/cli.py, train/loop.py, data/loader.py, train/hooks.py,
train/checkpoint.py, train/workloads.py), each held to the world-1 run of
the same global batch in this process:

- a 2-rank DP fit (DDP, two microbatches a step) of a tiny
  configs_c2i/DeCo_large_cpu.yaml against the world-1 fit with the same
  global batch: the logged losses and norms, and every parameter, EMA and
  moment of the rank-0 checkpoint;
- a 2 x 2 fsdp + sequence-parallel fit (``mesh_model_axis=2``, FSDP2,
  ``trunk_parallel=sp``) against the world-1 fit: the same, its checkpoint
  gathered from the shards by rank 0 and loaded at world 1, and each block
  an FSDP2 unit of its own, gathered only while it runs;
- a 2-rank predict from the world-1 checkpoint: every file the world-1
  predict writes, by name and by byte;
- a 2-rank VAE-GAN fit step (``VAEGANRun``) against world 1, ``d_weight``
  included;
- a 2-rank UniFlow fit and validate (``UniFlowRun``, the flat schema at a
  tiny width) against world 1: the losses, the validate scores gathered
  over the ranks, the panels' names.

Two spawns (tests/torch_parallel_ranks.py, no JAX), of 2 and 4 ranks, each
with its own time limit. Tolerances: losses, norms and d_weight within
1e-5 relative, UniFlow's validate scores 1e-4 relative or 1e-5 absolute;
the diffusion fits' parameters within 1e-6 absolute (fp32,
three AdamW steps at lr 1e-4); the VAE-GAN's within 5% of its one AdamW
step (lr 2e-4): a first AdamW step is about lr x sign(g), so where a
gradient is near zero an fp32 rounding difference in it (the world mean
sums in another order) moves the update by a part of a step.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from deco_tpu_torch import cli
from deco_tpu_torch.config import _yaml, registry
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
from deco_tpu_torch.train import hooks
from deco_tpu_torch.train.checkpoint import CheckpointManager
from deco_tpu_torch.utils import png
from torch_parallel_ranks import Ranks
from torch_port_util import shared_across_workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model.denoiser.init_args.hidden_size=48", "--model.denoiser.init_args.num_groups=4",
        "--model.denoiser.init_args.hidden_size_x=8", "--model.denoiser.init_args.num_blocks=3",
        "--model.denoiser.init_args.num_cond_blocks=2",
        "--model.denoiser.init_args.dtype=float32",
        "--data.train_dataset.init_args.resolution=32", "--data.train_num_workers=1",
        "--trainer.log_every_n_steps=1"]
VIT = dict(hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, patch_size=14,
           image_size=56, qk_normalization=True, norm_type="rms_norm", initializer_factor=0.1)
UNIFLOW = dict(vit_hidden_size=64, llm_hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, patch_size=4, image_size=32, global_blocks_depth=1,
               num_decoder_layers=1, num_sampling_steps=2, enable_semantic_branch=False)


def _folder(root, size=40, per_class=4):
    rng = np.random.default_rng(0)
    for c in range(2):
        os.makedirs(os.path.join(root, f"class_{c}"), exist_ok=True)
        for i in range(per_class):
            png.write(os.path.join(root, f"class_{c}", f"{i}.png"),
                      rng.integers(0, 256, (size + 4 * i, size, 3), dtype=np.uint8))
    return root


def _vae_config(folder, path):
    """configs/vae_training_stage2_224.yaml at tiny widths, deterministic
    encoder, no perceptual towers, an image folder."""
    config = registry.load_yaml(os.path.join(REPO, "configs/vae_training_stage2_224.yaml"))
    node = config["model"]["vae_model"]
    node["class_path"] = "src.models.transformer.encoder_ae_sim.VAEModel"
    node["init_args"].update({f"vit_{k}": v for k, v in VIT.items()}, llm_hidden_size=48,
                             gen_select_layer=1, decoder_channels="8,16,32,32,64,64",
                             decoder_layers=1, dtype="float32")
    config["model"]["loss_module"]["init_args"]["perceptual_loss"] = None
    image = {"class_path": "src.data.dataset.imagenet.PixImageNet",
             "init_args": {"root": folder, "resolution": 56}}
    config["data"].update(train_dataset=image, eval_dataset=image, train_batch_size=2,
                          train_num_workers=1)
    config["trainer"].update(log_every_n_steps=1)
    with open(path, "w") as f:
        f.write(_yaml.dump(config))
    return path


def _uniflow_config(folder, path):
    """configs_flow/uniflow_internvit.yaml (the flat schema) at a tiny width,
    its semantic branch off (that flow head is 2,048 wide at any size), FID
    at 64 features, an eval dataset node."""
    config = registry.load_yaml(os.path.join(REPO, "configs_flow/uniflow_internvit.yaml"))
    config["model"].update(UNIFLOW)
    config["train"].update(warmup_steps=0, total_steps=10)
    config["trainer"] = {"log_every_n_steps": 1, "callbacks": [{
        "class_path": "src.callbacks.compute_metrics.ComputeMetricsHook",
        "init_args": {"compute_fid": True, "fid_feature_dim": 64}}]}
    config["data"].update(train_root=folder, resolution=32, batch_size=4, pred_batch_size=4,
                          eval_dataset={"class_path": "src.data.dataset.imagenet.PixImageNet",
                                        "init_args": {"root": folder, "resolution": 32}})
    with open(path, "w") as f:
        f.write(_yaml.dump(config))
    return path


def _compute(root):
    hooks._tensorboard = lambda logdir: None  # its import is slow and not checked here
    folder = _folder(os.path.join(root, "png"))
    c2i = ["-c", os.path.join(REPO, "configs_c2i/DeCo_large_cpu.yaml"), "--device", "cpu",
           "--max_steps", "3", f"--data.train_dataset.init_args.root={folder}", *TINY]
    w = {k: os.path.join(root, k) for k in ("w1_dp", "dp", "w1_fs", "fs", "w1_pred", "pred",
                                            "w1_vae", "vae", "w1_uniflow", "uniflow")}
    uniflow = ["-c", _uniflow_config(folder, os.path.join(root, "uniflow.yaml")), "--device",
               "cpu"]
    uniflow_fit = ["fit", *uniflow, "--max_steps", "2"]
    uniflow_val = ["validate", *uniflow, "--max_batches", "1"]
    half = ["--data.batch_size=2", "--data.pred_batch_size=2"]
    vae = ["-c", _vae_config(folder, os.path.join(root, "vae.yaml")), "--device", "cpu",
           "--max_steps", "1"]
    fs = ["fit", *c2i, "--workdir", w["fs"], "--data.train_batch_size=2", "--mesh_model_axis=2",
          "--model.denoiser.init_args.trunk_parallel=sp"]
    # then a resume to step 4: the sharded state restored from the whole checkpoint
    fsdp = Ranks("cli", 4, {"runs": [fs, [*fs, "--resume", "--max_steps", "4"]],
                            "probe_fsdp_units": True}, os.path.join(root, "ranks_fs"))
    try:
        cli.main(["fit", *c2i, "--workdir", w["w1_dp"], "--data.train_batch_size=2",
                  "--trainer.accumulate_grad_batches=2"])
        predict = ["predict", *c2i, f"--ckpt_path={w['w1_dp']}/checkpoints", "--max_batches", "2",
                   "--model.diffusion_sampler.init_args.num_steps=2"]
        dp = Ranks("cli", 2, {"runs": [
            ["fit", *c2i, "--workdir", w["dp"], "--data.train_batch_size=1",
             "--trainer.accumulate_grad_batches=2"],
            [*predict, "--workdir", w["pred"], "--data.pred_batch_size=1"],
            ["fit", *vae, "--workdir", w["vae"], "--data.train_batch_size=1"],
            [*uniflow_fit, f"--workdir={w['uniflow']}", *half],
            [*uniflow_val, f"--workdir={w['uniflow']}", *half]]},
            os.path.join(root, "ranks_dp"))
        try:
            w1_fs = ["fit", *c2i, "--workdir", w["w1_fs"], "--data.train_batch_size=4"]
            cli.main(w1_fs)
            cli.main([*w1_fs, "--resume", "--max_steps", "4"])
            cli.main([*predict, "--workdir", w["w1_pred"], "--data.pred_batch_size=2"])
            cli.main(["fit", *vae, "--workdir", w["w1_vae"]])
            cli.main([*uniflow_fit, f"--workdir={w['w1_uniflow']}"])
            cli.main([*uniflow_val, f"--workdir={w['w1_uniflow']}"])
        finally:
            dp.wait()
    finally:
        fsdp_ranks = fsdp.wait()
    out = {"fsdp_units": [r["fsdp_units"] for r in fsdp_ranks]}
    for k, d in w.items():
        files = {}
        for base, _, names in os.walk(d):
            for n in names:
                if n != "config.yaml":
                    with open(os.path.join(base, n), "rb") as f:
                        files[os.path.relpath(os.path.join(base, n), d)] = f.read()
        out[k] = files
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    def compute():
        try:
            return _compute(str(tmp_path_factory.mktemp("parallel_loop")))
        except Exception:  # kept, so that no other worker runs the ranks again
            import traceback

            return dict(error=traceback.format_exc())

    out = shared_across_workers(tmp_path_factory, "torch_parallel_loop", compute)
    if "error" in out:
        pytest.fail(out["error"])
    return out


def _metrics(files):
    return [json.loads(line) for line in files["metrics.jsonl"].decode().splitlines()]


def _checkpoint(files, step):
    return torch.load(io.BytesIO(files[f"checkpoints/{step}.pt"]), weights_only=True)


@pytest.mark.parametrize("pair", [("w1_dp", "dp"), ("w1_fs", "fs")], ids=["dp", "fsdp_sp"])
def test_fit_logs_the_world_1_losses(runs, pair):
    ref, ours = (_metrics(runs[k]) for k in pair)
    assert [r["step"] for r in ours] == [r["step"] for r in ref]
    assert [r["step"] for r in ours][:3] == [0, 1, 2]
    for a, b in zip(ours, ref):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]), (key, a, b)


@pytest.mark.parametrize("pair,step", [(("w1_dp", "dp"), 3), (("w1_fs", "fs"), 3),
                                       (("w1_fs", "fs"), 4)],
                         ids=["dp", "fsdp_sp", "fsdp_sp_resumed"])
def test_rank_0_checkpoint_equals_the_world_1_checkpoint(runs, pair, step):
    """Parameters, EMA and AdamW moments by name, gathered whole from the
    FSDP2 shards; only rank 0 wrote (one file a step). Step 4 resumed from
    step 3's checkpoint: each rank took its shard of the whole file."""
    ref, ours = (_checkpoint(runs[k], step) for k in pair)
    assert sorted(n for n in runs[pair[1]] if n.startswith("checkpoints/")) == sorted(
        n for n in runs[pair[0]] if n.startswith("checkpoints/"))
    assert ours["step"] == ref["step"] == step
    assert set(ours["state_dict"]) == set(ref["state_dict"])
    for k, v in ref["state_dict"].items():
        assert ours["state_dict"][k].shape == v.shape, k
        assert (ours["state_dict"][k] - v).abs().max() <= 1e-6, k
    assert set(ours["optimizer"]) == set(ref["optimizer"])
    for name, moments in ref["optimizer"].items():
        for m, v in moments.items():
            assert (ours["optimizer"][name][m] - v).abs().max() <= 1e-6 * max(1.0, v.abs().max())


def test_fsdp_checkpoint_loads_at_world_1(runs, tmp_path):
    obj = _checkpoint(runs["fs"], 3)
    CheckpointManager(str(tmp_path)).save(obj, 3)
    model = DeCoC2I(in_channels=3, patch_size=16, num_groups=4, hidden_size=48, hidden_size_x=8,
                    num_blocks=3, num_cond_blocks=2, num_classes=1000, dtype=torch.float32,
                    device="cpu")
    assert CheckpointManager(str(tmp_path), 0).restore_params(model) == 3


def test_fsdp_gathers_each_block_only_for_its_own_forward(runs):
    """Every trunk and decoder block is an FSDP2 unit of its own: while a
    trunk block runs, its weights are whole and every other trunk block's
    are still this rank's shard."""
    for probes in runs["fsdp_units"]:
        assert [p["block"] for p in probes] == [0, 1]
        for p in probes:
            assert all(p["units"]) and all(p["decoder_units"]), p
            assert p["sharded"] == [i != p["block"] for i in range(len(p["sharded"]))], p


def test_a_stream_reads_the_shard_of_its_loader_data_rank(tmp_path):
    """A stream takes the data rank the loader gives (the model axis's ranks
    of one data rank read the same stream), unless its config fixed a shard."""
    from deco_tpu_torch.data import packed, webdataset
    from deco_tpu_torch.data.loader import make_loader

    tars = [str(tmp_path / f"{i}.tar") for i in range(5)]
    for t in tars:
        open(t, "wb").close()
    ds = packed.WebDatasetPacked(str(tmp_path), seed=3)
    assert ds._tars == tars
    make_loader(ds, 2, process_index=1, process_count=2)
    assert ds._tars == tars[1::2]
    fixed = packed.WebDatasetPacked(str(tmp_path), shard_index=0, shard_count=3)
    make_loader(fixed, 2, process_index=1, process_count=2)
    assert fixed._tars == tars[::3]
    pix = webdataset.PixWebDataset(tars)
    make_loader(pix, 2, process_index=1, process_count=2)
    assert (pix.rank, pix.world) == (1, 2)


def test_predict_on_two_ranks_writes_the_world_1_files(runs):
    ref, ours = runs["w1_pred"], runs["pred"]
    assert sorted(ours) == sorted(ref)
    assert any(n.endswith("output.npz") for n in ref) and len(ref) >= 6
    for name, data in ref.items():
        assert ours[name] == data, name


def test_vae_gan_step_on_two_ranks_equals_world_1(runs):
    """The adaptive GAN weight from the last-layer gradients of the global
    batch, the clip after the mean, and the updated parameters."""
    ref, ours = _metrics(runs["w1_vae"])[0], _metrics(runs["vae"])[0]
    for key in ("d_weight", "total_loss", "reconstruction_loss", "gan_loss",
                "discriminator_loss", "gen_grad_norm", "disc_grad_norm"):
        assert abs(ours[key] - ref[key]) <= 1e-5 * max(abs(ref[key]), 1e-6), (key, ours, ref)
    name = [n for n in runs["w1_vae"] if n.startswith("checkpoints/")][0]
    a, b = (torch.load(io.BytesIO(runs[k][name]), weights_only=True) for k in ("vae", "w1_vae"))
    for k, v in b["state_dict"].items():
        assert (a["state_dict"][k] - v).abs().max() <= 0.05 * 2e-4, k


def test_uniflow_fit_and_validate_on_two_ranks_equal_world_1(runs):
    """The losses of the global batch, the validate scores summed over the
    data ranks (PSNR, SSIM, FID), and the world-1 files by name. Scores
    within 1e-4 relative or 1e-5 absolute: SSIM sits near 0 on these
    images, and two sign-like AdamW steps carry the gradients' rounding
    (the world mean sums in another order) into the weights."""
    ref, ours = _metrics(runs["w1_uniflow"]), _metrics(runs["uniflow"])
    assert [r["step"] for r in ours] == [r["step"] for r in ref] == [0, 1]
    for a, b in zip(ours, ref):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
    ref_scores, our_scores = (json.loads(runs[k]["validate_metrics.json"])
                              for k in ("w1_uniflow", "uniflow"))
    assert set(our_scores) == set(ref_scores) >= {"metrics/psnr", "metrics/ssim", "metrics/fid"}
    for k, v in ref_scores.items():
        assert abs(our_scores[k] - v) <= 1e-4 * abs(v) + 1e-5, (k, our_scores, ref_scores)
    assert sorted(runs["uniflow"]) == sorted(runs["w1_uniflow"])


# ---- the pieces, in one process ----

def test_a_key_the_run_does_not_read_raises(tmp_path):
    """The diffusion loop reads ``mesh_model_axis`` and refuses ``mesh:``;
    the workloads read ``mesh:`` and refuse ``mesh_model_axis``; a model
    axis that does not divide the world raises, as in JAX."""
    from deco_tpu_torch.parallel import mesh as mesh_lib
    from deco_tpu_torch.train import workloads
    from deco_tpu_torch.train.loop import Experiment

    config = registry.load_yaml(os.path.join(REPO, "configs_c2i/DeCo_large_cpu.yaml"))
    with pytest.raises(ValueError, match="mesh_model_axis"):
        Experiment({**config, "mesh": {"data": 1}}, workdir=str(tmp_path / "a"), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        Experiment({**config, "mesh_model_axis": 2}, workdir=str(tmp_path / "b"), device="cpu")
    with pytest.raises(ValueError, match="mesh: {data, model}"):
        workloads._make_mesh({"mesh_model_axis": 1})
    with pytest.raises(ValueError, match="mesh 2x1"):
        workloads._make_mesh({"mesh": {"data": 2}})
    assert mesh_lib.make_mesh() is None  # one process: the 1 x 1 grid


@pytest.mark.parametrize("microbatches", [1, 2])
def test_data_ranks_load_the_rows_of_the_world_1_batch(microbatches):
    """Two data ranks' batches, interleaved per microbatch, are the world-1
    loader's global batches, over an epoch boundary and after a resume."""
    from deco_tpu_torch.data.loader import ShardedLoader

    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return np.full((1,), i, np.float32), i, {}

    def batches(loader, n):
        it = iter(loader)
        return [next(it)[1] for _ in range(n)]

    kw = dict(shuffle=True, seed=3, num_workers=1, infinite=True, microbatches=microbatches)
    whole = ShardedLoader(Items(), 8, **kw)
    parts = [ShardedLoader(Items(), 4, process_index=r, process_count=2, **kw) for r in (0, 1)]
    m = 4 // microbatches

    def joined(got, b):
        return np.concatenate([np.concatenate([got[r][b][i * m:(i + 1) * m] for r in (0, 1)])
                               for i in range(microbatches)])

    ref = batches(whole, 4)
    got = [batches(p, 4) for p in parts]
    for b in range(4):
        np.testing.assert_array_equal(joined(got, b), ref[b])
    for loader in (whole, *parts):
        loader.set_position(3)
    np.testing.assert_array_equal(joined([batches(p, 1) for p in parts], 0), batches(whole, 1)[0])
    assert len(whole) == len(parts[0]) == 1


def test_row_draws_are_the_world_1_draws_cut_to_the_rank():
    """A rank's draws are its rows of what one process draws for the global
    batch, repeats (diffusion_batch_mul) included."""
    from deco_tpu_torch.parallel.mesh import RowDraws, rank_rows, sample, sample_int

    whole = torch.Generator().manual_seed(7)
    ref = (torch.randn((8, 3), generator=whole), torch.rand((8,), generator=whole),
           torch.randint(0, 10, (8,), generator=whole))
    for r in (0, 1):
        own = rank_rows(r, 2, 2)
        rows = np.concatenate([own, 4 + own])  # two repeats of a global microbatch of 4
        g = RowDraws(torch.Generator().manual_seed(7), rows, 8)
        got = (sample(g, (4, 3), "cpu"), sample(g, (4,), "cpu", normal=False),
               sample_int(g, 10, (4,), "cpu"))
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b[torch.as_tensor(rows)], rtol=0, atol=0)


def test_save_hook_saves_the_first_images_of_the_whole_predict(tmp_path):
    """With ``first_index`` a data rank saves the images whose global index
    is under ``max_save_images``, and no others."""
    saved = []
    hook = hooks.SaveImagesHook(save_dir="val", max_save_images=3)
    hook.on_predict_start(str(tmp_path), 0, process_index=1, process_count=2)
    fn = lambda img, md, root: saved.append(int(img[0, 0, 0]))  # noqa: E731
    for first in (2, 6):  # rank 1's rows of two global batches of 4
        imgs = np.stack([np.full((2, 2, 3), first + i, np.uint8) for i in range(2)])
        hook.on_predict_batch_end(imgs, {"save_fn": [fn, fn]}, first_index=first)
    hook.on_predict_end()
    assert sorted(saved) == [2]


def test_initialize_starts_no_group_without_torchrun_and_refuses_half_an_environment(
        monkeypatch):
    from deco_tpu_torch.parallel import distributed

    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    distributed.initialize(device="cpu")
    assert not distributed.is_initialized() and distributed.world_size() == 1
    np.testing.assert_array_equal(distributed.process_allgather(np.arange(3)), np.arange(3))
    distributed.barrier()  # a no-op in one process
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed.initialize(device="cpu")
    assert not distributed.is_initialized()
