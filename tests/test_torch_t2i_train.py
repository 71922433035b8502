"""t2i training in the port (DeCoT2I under DeCoTrainer, grad_checkpoint, the
CLI fit on configs_t2i/sft_res512.yaml, the JAX t2i training checkpoint)
against the JAX package, on the CPU in fp32.

Both sides get the same weights (numpy draws through the port's weight
bridge), the same batch and the same draws (the port's ``draws``; the JAX
side's ``jax.random`` patched to return them, as tests/test_torch_training.py
does). Tolerances, as for the c2i step: the loss rtol 1e-5; each gradient
atol 1e-5 of its largest value plus rtol 1e-3 (an fp32 backward summed in
another order). Remat recomputes the same fp32 forward, so the port's
gradients with and without it agree to rtol 1e-6, atol 1e-7.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deco_tpu.diffusion import training as jtraining
from deco_tpu.diffusion.scheduling import LinearScheduler as JLinear
from deco_tpu.models.dit_t2i import DeCoT2I as JaxDeCoT2I
from deco_tpu.train.state import TrainState as JaxTrainState
from deco_tpu_torch import cli, convert
from deco_tpu_torch.config import _yaml
from deco_tpu_torch.diffusion import training as ttraining
from deco_tpu_torch.diffusion.scheduling import LinearScheduler
from deco_tpu_torch.models.dit_t2i import DeCoT2I
from deco_tpu_torch.ops import flash_attention as fa
from deco_tpu_torch.train import hooks
from deco_tpu_torch.train.checkpoint import CheckpointManager
from deco_tpu_torch.train.state import TrainState
from deco_tpu_torch.utils import png
from test_torch_training import _patched_jax_draws
from torch_port_util import fast_jit, redraw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2 heads of 64 (the DeCo-XXL head width), 2 joint and 1 text blocks, patch 8
TINY = dict(in_channels=3, patch_size=8, num_groups=2, hidden_size=128, decoder_hidden_size=8,
            num_encoder_blocks=2, num_decoder_blocks=1, num_text_blocks=1, txt_embed_dim=16,
            txt_max_length=6)
# sft_res512.yaml's trainer, with more label dropout so the draws drop one
TRAINER_KW = dict(lognorm_t=True, timeshift=4.0, null_condition_p=0.5)
# the parameters that only the text half of the joint attention's dK/dV reaches
TEXT_SIDE = ("attn.kv_y", "text_refine_blocks.", "y_embedder.", "y_pos_embedding")


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(hooks, "_tensorboard", lambda logdir: None)


@functools.lru_cache(maxsize=1)
def _jax_zeros():
    model = JaxDeCoT2I(**TINY, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                            jnp.zeros((1,)), jnp.zeros((1, TINY["txt_max_length"],
                                                        TINY["txt_embed_dim"])))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _params(seed: int):
    return jax.tree_util.tree_map(np.asarray, redraw(_jax_zeros(), seed))


def _state_dict(tree):
    return {k: v.numpy() for k, v in
            convert.state_dict_from_jax_t2i(tree, patch_size=TINY["patch_size"]).items()}


def _port(params, **kw) -> DeCoT2I:
    model = DeCoT2I(**TINY, **kw, dtype=torch.float32, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax_t2i(params, patch_size=TINY["patch_size"]))
    return model.train()


def _batch(h: int, w: int, n: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    shape = (n, TINY["txt_max_length"], TINY["txt_embed_dim"])
    return x, rng.standard_normal(shape).astype(np.float32), \
        rng.standard_normal(shape).astype(np.float32) * 0.1


def _draws(h: int, w: int, n: int = 2, seed: int = 1):
    rng = np.random.default_rng(seed)
    return dict(drop_u=np.array([0.9, 0.1], np.float32)[:n],  # the second row dropped
                t_normal=rng.standard_normal(n).astype(np.float32),
                t_uniform=rng.uniform(size=n).astype(np.float32),
                mix_u=np.array([0.5, 0.95], np.float32)[:n],  # both t branches
                noise=rng.standard_normal((n, h, w, 3)).astype(np.float32))


def _jax_loss_and_grads(params, batch, draws, grad_checkpoint: bool):
    jmodel = JaxDeCoT2I(**TINY, dtype=jnp.float32, grad_checkpoint=grad_checkpoint)
    jtrainer = jtraining.DeCoTrainer(JLinear(), **TRAINER_KW)
    normal, uniform = _patched_jax_draws(draws)
    with normal, uniform:  # the patched draws are constants of the traced step
        out, grads = fast_jit(jax.value_and_grad(lambda p: jtrainer(
            jax.random.PRNGKey(0), lambda *a: jmodel.apply(p, *a),
            *(jnp.asarray(a) for a in batch))["loss"]))(params)
    return float(out), jax.tree_util.tree_map(np.asarray, grads)


def _port_loss_and_grads(model, batch, draws):
    trainer = ttraining.DeCoTrainer(LinearScheduler(), **TRAINER_KW)
    loss = trainer(model, *(torch.from_numpy(a) for a in batch), draws=draws)["loss"]
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("grad_checkpoint", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("hw", [(32, 32), (40, 24)], ids=["square", "ragged"])
def test_t2i_train_step_matches_jax(hw, grad_checkpoint):
    """The loss and every gradient of one DeCoTrainer step, the port's
    ``DeCoT2I(grad_checkpoint)`` against the JAX one's; the text-side
    gradients are named and non-zero."""
    params = _params(seed=hw[1])
    batch, draws = _batch(*hw), _draws(*hw)
    want_loss, want = _jax_loss_and_grads(params, batch, draws, grad_checkpoint)
    loss, got = _port_loss_and_grads(_port(params, grad_checkpoint=grad_checkpoint), batch, draws)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    want = _state_dict(want)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(g, want[name], rtol=1e-3, atol=1e-5 * scale + 1e-12,
                                   err_msg=name)
    text = [n for n in got if any(key in n for key in TEXT_SIDE)]
    assert {n.split(".")[0] for n in text} == {"blocks", "text_refine_blocks", "y_embedder",
                                               "y_pos_embedding"}
    for name in text:
        assert np.abs(got[name]).max() > 0, name


def test_grad_checkpoint_gives_the_gradients_without_it():
    """In the port alone: the same step with and without remat (trunk blocks
    and decoder res blocks recomputed), and with remat over a chunked
    decoder (the chunks recomputed whole)."""
    params = _params(seed=5)
    batch, draws = _batch(40, 24, seed=6), _draws(40, 24, seed=7)
    _, ref = _port_loss_and_grads(_port(params), batch, draws)
    for kw in (dict(grad_checkpoint=True), dict(grad_checkpoint=True, decoder_chunks=3)):
        model = _port(params, **kw)
        assert model.dec_net.grad_checkpoint
        _, got = _port_loss_and_grads(model, batch, draws)
        for name in ref:
            torch.testing.assert_close(torch.from_numpy(got[name]), torch.from_numpy(ref[name]),
                                       rtol=1e-6, atol=1e-7, msg=name)


def test_grad_checkpoint_recomputes_each_block_once(monkeypatch):
    """Under remat each trunk block's forward runs twice in a step (once
    more in the backward), as ``nn.remat`` over the scan cells does; the
    recompute runs the attention forward with logsumexp again (the custom
    op, whose plain version is counted here)."""
    params = _params(seed=8)
    batch, draws = _batch(32, 32, seed=9), _draws(32, 32, seed=10)
    counts = {}
    for gc in (False, True):
        model = _port(params, grad_checkpoint=gc)
        calls = []
        for block in [*model.blocks, *model.text_refine_blocks]:
            # a pre-hook: the recompute stops once it has what the backward needs,
            # before the block returns
            block.register_forward_pre_hook(lambda *_: calls.append(1))
        ops = []
        with monkeypatch.context() as patch:
            plain = fa.flash_attention_fwd_lse_plain
            patch.setattr(fa, "flash_attention_fwd_lse_plain",
                          lambda *a: ops.append(1) or plain(*a))
            _port_loss_and_grads(model, batch, draws)
        counts[gc] = (len(calls), len(ops))
    assert counts == {False: (3, 3), True: (6, 6)}


# ---- the CLI fit on configs_t2i/sft_res512.yaml ----

TINY_OVERRIDES = [f"--model.denoiser.init_args.{k}={v}" for k, v in dict(
    hidden_size=32, num_groups=2, num_encoder_blocks=2, num_text_blocks=1,
    decoder_hidden_size=8, num_decoder_blocks=1, txt_embed_dim=16, txt_max_length=6).items()] + [
    "--model.conditioner.init_args.embed_dim=16", "--model.conditioner.init_args.max_length=6",
    "--model.denoiser.init_args.dtype=float32"]


@pytest.fixture(scope="module")
def caption_root(tmp_path_factory):
    """6 seeded PNG + caption pairs of non-square sizes above 32 px, and one
    image without a caption, which the dataset leaves out."""
    root = tmp_path_factory.mktemp("blip3o")
    rng = np.random.default_rng(0)
    for i in range(6):
        h, w = ((40, 48), (56, 40), (32, 36))[i % 3]
        png.write(str(root / f"{i:02d}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        (root / f"{i:02d}.txt").write_text(f"a red cube number {i} on a table")
    png.write(str(root / "no_caption.png"), np.zeros((40, 40, 3), np.uint8))
    return str(root)


def test_cli_fit_resume_and_predict_on_sft_res512(tmp_path, caption_root):
    """``cli fit -c configs_t2i/sft_res512.yaml`` at tiny widths (patch 16 on
    32 px crops, batch 1 x accumulation 4) for 2 steps, resumed to step 3,
    equals 3 uninterrupted steps bit for bit (the ImageText folder resumes
    its shuffled order); ``predict`` from the resumed checkpoint writes the
    first DPG image at 512 px."""
    common = ["-c", os.path.join(REPO, "configs_t2i/sft_res512.yaml"), "--device", "cpu",
              *TINY_OVERRIDES, f"--data.train_dataset.init_args.root={caption_root}",
              "--data.train_dataset.init_args.resolution=32", "--data.train_batch_size=1",
              "--data.train_num_workers=2", "--trainer.log_every_n_steps=1"]
    whole = cli.main(["fit", *common, f"--trainer.default_root_dir={tmp_path / 'whole'}",
                      "--max_steps", "3"])
    root = tmp_path / "parts"
    cli.main(["fit", *common, f"--trainer.default_root_dir={root}", "--max_steps", "2"])
    workdir = root / "sftpix512ema"
    assert os.listdir(workdir / "checkpoints") == ["2.pt"]
    resumed = cli.main(["fit", *common, f"--trainer.default_root_dir={root}", "--max_steps", "3",
                        "--resume"])
    assert resumed.step == whole.step == 3
    assert len(whole.model.blocks) == 2 and whole.model.hidden_size == 32
    for (name, a), b in zip(whole.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), name
    records = [json.loads(line) for line in open(workdir / "metrics.jsonl")]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in records)
    assert sorted(os.listdir(workdir / "checkpoints")) == ["2.pt", "3.pt"]

    cli.main(["predict", *common, f"--trainer.default_root_dir={root}",
              f"--ckpt_path={workdir / 'checkpoints'}", "--max_batches", "1",
              "--data.pred_batch_size=1", "--model.diffusion_sampler.init_args.num_steps=2",
              f"--data.pred_dataset.init_args.prompt_path={REPO}/evaluations/dpg/prompts"])
    out_dir = workdir / "val_200k" / "iter_3"
    names = sorted(os.listdir(out_dir))
    first = sorted(os.listdir(os.path.join(REPO, "evaluations/dpg/prompts")))[0]
    assert names == [f"{os.path.splitext(first)[0]}_0.png"]
    image = png.read(str(out_dir / names[0]))
    assert image.shape == (512, 512, 3) and image.std() > 0


# ---- a JAX t2i training state resumes in the port ----

def test_jax_t2i_training_state_resumes_in_the_port(tmp_path):
    """A JAX DeCoT2I TrainState with nonzero AdamW moments becomes a port
    step checkpoint: restored into the port's TrainState, its parameters,
    EMA and moments are the JAX ones through the t2i bridge, and one AdamW
    step from the same gradient gives optax's update (optax takes the bias
    corrections in fp32, torch in fp64: rtol 2e-5 of the update plus 4 fp32
    ulps of the parameter, as for c2i)."""
    params, ema, mu, nu, grads = (_params(s) for s in (11, 12, 13, 14, 15))
    mu = jax.tree_util.tree_map(lambda x: x * 0.01, mu)
    nu = jax.tree_util.tree_map(lambda x: (x * 0.01) ** 2, nu)
    tx = optax.adamw(1e-3, weight_decay=0.01)
    jstate = jax.jit(lambda p: JaxTrainState.create(p, tx))(params)  # one compile
    adam = jstate.opt_state[0]._replace(count=np.int32(7), mu=mu, nu=nu)
    opt_state = (adam,) + tuple(jstate.opt_state[1:])
    expected = jax.tree_util.tree_map(np.asarray, fast_jit(
        lambda g, s, p: optax.apply_updates(p, tx.update(g, s, p)[0]))(grads, opt_state, params))

    obj = convert.train_checkpoint_from_jax(params, ema, mu, nu, adam.count, step=7,
                                            patch_size=TINY["patch_size"])
    CheckpointManager(str(tmp_path)).save(obj, 7)
    model = DeCoT2I(**TINY, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    state = TrainState.create(model, lr=1e-3, weight_decay=0.01)
    CheckpointManager(str(tmp_path)).restore(state)
    assert state.step == 7
    names = [n for n, _ in model.named_parameters()]
    for tree, got in ((params, dict(model.named_parameters())),
                      (ema, dict(zip(names, state.ema_params)))):
        want = _state_dict(tree)
        for name in names:
            np.testing.assert_array_equal(got[name].detach().numpy(), want[name], err_msg=name)
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        want = _state_dict(tree)
        for name, p in model.named_parameters():
            moment = state.optimizer.state[p]
            np.testing.assert_array_equal(moment[key].numpy(), want[name], err_msg=name)
            assert float(moment["step"]) == 7
    grad_sd = _state_dict(grads)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grad_sd[name].copy())
    before = {name: p.detach().clone() for name, p in model.named_parameters()}
    state.optimizer.step()
    want = _state_dict(expected)
    for name, p in model.named_parameters():
        ulp = before[name].abs().max().item() * 2.0**-23
        torch.testing.assert_close(p.detach() - before[name],
                                   torch.from_numpy(want[name]) - before[name],
                                   rtol=2e-5, atol=4 * ulp, msg=name)


def test_config_loads_the_t2i_training_nodes_like_jax():
    """sft_res512.yaml's trainer node is the port's DeCoTrainer with the JAX
    node's arguments (the reference's training_repa_DeCo.REPATrainer maps to
    DeCoTrainer in both registries), and grad_checkpoint on the denoiser is
    a JAX field the port now takes."""
    from deco_tpu.config import registry as jax_registry
    from deco_tpu_torch.config import registry

    config = _yaml.load(os.path.join(REPO, "configs_t2i/sft_res512.yaml"))
    node = config["model"]["diffusion_trainer"]
    ours, theirs = registry.instantiate(copy.deepcopy(node)), jax_registry.instantiate(node)
    assert type(ours).__name__ == type(theirs).__name__ == "DeCoTrainer"
    for key in ("lognorm_t", "timeshift", "null_condition_p", "enable_freq_loss"):
        assert getattr(ours, key) == getattr(theirs, key), key
    denoiser = copy.deepcopy(config["model"]["denoiser"])
    denoiser["init_args"].update({k: v for k, v in TINY.items() if k != "patch_size"},
                                 grad_checkpoint=True, device="cpu")
    model = registry.instantiate(denoiser)
    assert model.grad_checkpoint and model.dec_net.grad_checkpoint
