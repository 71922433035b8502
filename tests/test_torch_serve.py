"""The port's serving path (deco_tpu_torch.serve) against the JAX package's
``deco_tpu.serve`` on the tiny t2i model, on the CPU.

``Pipeline.run`` is compared with the JAX ``run`` given the same weights
(through ``convert.state_dict_from_jax_t2i``), noise and conditions: the
images and every trajectory frame within atol = 1e-4 * max|ref| (a chained
sampler, as the c2i sampler tests). The pipelines draw their noise from
different generators (a CPU ``torch.Generator`` in the port), so whole
``__call__`` results are compared only within the port.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.convert.flax_to_torch import export_checkpoint, save_torch_checkpoint
from deco_tpu.models.autoencoders import PixelAE as JaxPixelAE
from deco_tpu.models.conditioners import Qwen3TextEncoder as JaxQwen3TextEncoder
from deco_tpu.serve import Pipeline as JaxPipeline
from deco_tpu_torch import convert, serve
from deco_tpu_torch.config import registry
from deco_tpu_torch.diffusion.adam_sampling import AdamLMSampler
from deco_tpu_torch.diffusion.sampling import EulerSampler, HeunSampler
from deco_tpu_torch.diffusion.scheduling import LinearScheduler
from deco_tpu_torch.models.autoencoders import PixelAE
from deco_tpu_torch.models.conditioners import Qwen3TextEncoder
from deco_tpu_torch.models.dit_t2i import DeCoT2I
from deco_tpu_torch.train.checkpoint import CheckpointManager, payload
from deco_tpu_torch.utils import png
from torch_port_util import TINY_T2I, tiny_jax_t2i

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLER_ATOL = 1e-4
TEXT = dict(embed_dim=TINY_T2I["txt_embed_dim"], max_length=TINY_T2I["txt_max_length"])


@functools.lru_cache(maxsize=1)
def _jax():
    model, params = tiny_jax_t2i(0)
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params):
    model = DeCoT2I(**TINY_T2I, dtype=torch.float32, device="cpu").eval()
    model.load_state_dict(convert.state_dict_from_jax_t2i(params, patch_size=4), strict=True)
    return model


@pytest.fixture(scope="module")
def pipeline():
    return serve.Pipeline(PixelAE(), _port_model(_jax()[1]), Qwen3TextEncoder(**TEXT),
                          base_resolution=32)


@pytest.mark.parametrize("height,width", [(32, 32), (32, 64)])
def test_run_matches_jax_run_with_every_trajectory_frame(pipeline, height, width):
    jmodel, params = _jax()
    jpipe = JaxPipeline(JaxPixelAE(), jmodel, JaxQwen3TextEncoder(**TEXT), params,
                        base_resolution=32)
    prompts = ["a photo of a cat", "two dogs"]
    cond, uncond = pipeline.conditioner(prompts, {"negative_prompt": "blurry"})
    jcond, juncond = jpipe.conditioner(prompts, {"negative_prompt": "blurry"})
    np.testing.assert_array_equal(cond.float().numpy(), np.asarray(jcond, np.float32))
    noise = np.random.default_rng(5).standard_normal((2, height, width, 3)).astype(np.float32)
    args = (height, width, 4, 2, 3.0, 3.0)  # 4 steps, order 2, CFG 3, time shift 3
    ref, ref_trajs = jpipe._get_sampler_fn(*args)(params, jnp.asarray(noise), jcond, juncond,
                                                  jax.random.PRNGKey(1))
    out, trajs = pipeline._get_sampler_fn(*args)(torch.from_numpy(noise), cond, uncond)
    ref_trajs = np.asarray(ref_trajs)
    assert tuple(trajs.shape) == ref_trajs.shape == (5, 2, height, width, 3)
    atol = SAMPLER_ATOL * np.abs(ref_trajs).max()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=atol)
    np.testing.assert_allclose(trajs.numpy(), ref_trajs, rtol=0, atol=atol)


def test_call_rounds_sizes_and_returns_uint8_images_and_frames(pipeline):
    imgs = pipeline(["x"], height=45, width=70, num_steps=2, cfg=1.5)
    assert len(imgs) == 1 and imgs[0].shape == (32, 64, 3) and imgs[0].dtype == np.uint8
    imgs, trajs = pipeline(["a cat", "a dog"], height=32, width=32, num_steps=3, cfg=2.0,
                           return_trajectories=True)
    assert len(trajs) == 2 and len(trajs[0]) == 4  # the noise and 3 steps
    np.testing.assert_array_equal(trajs[1][-1], imgs[1])
    # the noise comes from a CPU generator seeded with `seed`
    np.testing.assert_array_equal(
        trajs[0][0], serve.fp_to_uint8(torch.clamp(torch.randn(
            (2, 32, 32, 3), generator=torch.Generator().manual_seed(0)), -1, 1))[0].numpy())


def test_negative_prompt_and_seed_change_the_images(pipeline):
    a = pipeline(["a cat"], height=32, width=32, num_steps=2, cfg=3.0)
    b = pipeline(["a cat"], negative_prompt="blurry", height=32, width=32, num_steps=2, cfg=3.0)
    c = pipeline(["a cat"], height=32, width=32, num_steps=2, cfg=3.0, seed=1)
    again = pipeline(["a cat"], height=32, width=32, num_steps=2, cfg=3.0)
    assert not np.array_equal(a[0], b[0]) and not np.array_equal(a[0], c[0])
    np.testing.assert_array_equal(a[0], again[0])


def test_dispatch_chunks_are_bit_equal_and_refuse_trajectories(pipeline):
    a = pipeline(["a cat"], height=32, width=32, num_steps=5, cfg=2.0)
    b = pipeline(["a cat"], height=32, width=32, num_steps=5, cfg=2.0, dispatch_chunks=3)
    np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(ValueError, match="trajectories"):
        pipeline(["a cat"], height=32, width=32, num_steps=2, dispatch_chunks=2,
                 return_trajectories=True)


@pytest.mark.parametrize("make", [
    lambda: AdamLMSampler(scheduler=LinearScheduler(), order=3, num_steps=7, guidance=2.0,
                          timeshift=3.0, guidance_interval_min=0.2),
    lambda: EulerSampler(scheduler=LinearScheduler(), w_scheduler=LinearScheduler(),
                         num_steps=7, guidance=2.5, guidance_interval_min=0.1,
                         guidance_interval_max=0.8, step_fn="sde"),
])
def test_sample_chunked_equals_the_unsegmented_loop_bit_for_bit(make):
    """Each segment continues the last one's state (x, the AdamLM history,
    the generator), so 1, 2 and 7 segments give the same bits."""
    torch.manual_seed(0)
    weight = torch.randn(3, 3)

    def net(x, t, y):
        return torch.tanh(x @ weight) * (1 - t[:, None, None, None]) + y[:, None, None, None]

    noise = torch.randn(2, 4, 5, 3)
    cond, uncond = torch.tensor([0.5, -0.5]), torch.tensor([0.0, 0.0])
    ref = make()(net, noise, cond, uncond, generator=torch.Generator().manual_seed(3))
    for n in (1, 2, 7):
        out = make().sample_chunked(net, noise, cond, uncond,
                                    generator=torch.Generator().manual_seed(3), num_dispatches=n)
        assert torch.equal(out, ref), n
    with pytest.raises(ValueError):
        make().sample_chunked(net, noise, cond, uncond, num_dispatches=0)
    with pytest.raises(NotImplementedError):
        HeunSampler(scheduler=LinearScheduler(), num_steps=3).sample_chunked(
            net, noise, cond, uncond)


def test_sampler_cache_is_a_bounded_fifo(pipeline):
    pipeline._sampler_cache.clear()
    for i in range(pipeline._SAMPLER_CACHE_MAX + 4):
        pipeline._get_sampler_fn(32, 32, 2, 1, 1.0 + i, 3.0)
    assert len(pipeline._sampler_cache) == pipeline._SAMPLER_CACHE_MAX
    assert min(key[4] for key in pipeline._sampler_cache) == 5.0  # the first 4 went first
    pipeline._sampler_cache.clear()


def _tiny_config():
    config = registry.load_yaml(os.path.join(REPO, "configs_t2i/sft_res512.yaml"))
    config["model"]["denoiser"]["init_args"].update(TINY_T2I, dtype="float32")
    config["model"]["conditioner"]["init_args"].update(TEXT)
    return config


def test_load_pipeline_reads_a_reference_ckpt_and_a_step_checkpoint(tmp_path):
    """A reference-layout .ckpt (denoiser.* and ema_denoiser.*) loads its EMA
    by default and its raw weights with use_ema=False; a directory of the
    port's step checkpoints loads the same way; neither draws the init."""
    jmodel, params = _jax()
    ema = jax.tree_util.tree_map(lambda a: a * 0.5, params)
    path = str(tmp_path / "last.ckpt")
    save_torch_checkpoint(export_checkpoint(params, ema, model_kind="deco_t2i", patch_size=4),
                          path)
    want_ema = convert.state_dict_from_jax_t2i(ema, patch_size=4)
    want_raw = convert.state_dict_from_jax_t2i(params, patch_size=4)
    for ckpt, use_ema, want in ((path, True, want_ema), (path, False, want_raw)):
        pipe = serve.load_pipeline(_tiny_config(), ckpt, use_ema=use_ema, device="cpu")
        got = pipe.denoiser.state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.items())
    CheckpointManager(str(tmp_path / "steps")).save(payload(want_raw, want_ema, {}, 7), 7)
    pipe = serve.load_pipeline(_tiny_config(), str(tmp_path / "steps"), device="cpu")
    assert all(torch.equal(pipe.denoiser.state_dict()[k], v) for k, v in want_ema.items())
    fresh = serve.load_pipeline(_tiny_config(), device="cpu").denoiser
    assert fresh.y_pos_embedding.std() > 0.5 and not fresh.dec_net.final_layer.linear.weight.any()


def test_main_writes_the_png_and_the_apng_on_the_cpu(tmp_path):
    """``python -m deco_tpu_torch.serve`` at a tiny override: sample_{i}.png
    and traj_{i}.png, an animated PNG of steps + 1 frames, 100 ms each, that
    ends on the sample."""
    out_dir = str(tmp_path / "out")
    over = [f"--model.denoiser.init_args.{k}={v}" for k, v in TINY_T2I.items()
            if k not in ("txt_embed_dim", "txt_max_length")]
    paths = serve.main(["--config", os.path.join(REPO, "configs_t2i/sft_res512.yaml"),
                        "--device", "cpu", "--prompt", "a red cube", "--prompt", "a cat",
                        "--height", "32", "--width", "64", "--num_steps", "3",
                        "--out_dir", out_dir, *over])
    assert sorted(os.listdir(out_dir)) == ["sample_0.png", "sample_1.png", "traj_0.png",
                                           "traj_1.png"]
    assert paths == [os.path.join(out_dir, f"sample_{i}.png") for i in range(2)]
    for i in range(2):
        sample = png.read(os.path.join(out_dir, f"sample_{i}.png"))
        frames, delays = png.read_apng(os.path.join(out_dir, f"traj_{i}.png"))
        assert sample.shape == (32, 64, 3) and len(frames) == 4 and delays == [100.0] * 4
        np.testing.assert_array_equal(frames[-1], sample)


def test_serve_gradio_without_gradio_raises(pipeline, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_gradio(name, *args, **kwargs):
        if name == "gradio":
            raise ImportError("No module named 'gradio'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_gradio)
    with pytest.raises(RuntimeError, match="gradio is not installed"):
        serve.serve_gradio(pipeline)


def test_cuda_is_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.load_pipeline(_tiny_config())
