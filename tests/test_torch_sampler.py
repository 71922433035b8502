"""The port's sampling stack (deco_tpu_torch.diffusion, data.randn,
utils.flops, models.conditioners/autoencoders) against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.data.randn import seeded_noise as jax_seeded_noise
from deco_tpu.diffusion import guidance as jg
from deco_tpu.diffusion.sampling import EulerSampler as JaxEuler
from deco_tpu.diffusion.scheduling import LinearScheduler as JaxLinear
from deco_tpu.models.autoencoders import fp_to_uint8 as jax_fp_to_uint8
from deco_tpu.utils import flops as jflops
from deco_tpu_torch.data.randn import seeded_noise
from deco_tpu_torch.diffusion import guidance as tg
from deco_tpu_torch.diffusion.sampling import EulerSampler
from deco_tpu_torch.diffusion.scheduling import LinearScheduler
from deco_tpu_torch.models.autoencoders import fp_to_uint8
from deco_tpu_torch.models.conditioners import LabelConditioner
from deco_tpu_torch.utils import flops as tflops
from torch_port_util import TINY_C2I, TINY_IMAGE, fast_jit, port_c2i_from_jax, tiny_jax_c2i


def _samplers(**kw):
    jax_kw = dict(kw, scheduler=JaxLinear(), w_scheduler=JaxLinear())
    port_kw = dict(kw, scheduler=LinearScheduler(), w_scheduler=LinearScheduler())
    return JaxEuler(**jax_kw), EulerSampler(**port_kw)


@pytest.mark.parametrize("kw", [
    dict(num_steps=8, guidance=3.2, guidance_interval_min=0.1),
    dict(num_steps=50, guidance=3.2, guidance_interval_min=0.1, guidance_interval_max=1.0),
    dict(num_steps=25, guidance=4.0, timeshift=3.0, guidance_interval_max=0.7,
         step_fn="sde", last_step=0.02),
])
def test_step_tables_equal_jax(kw):
    js, ts = _samplers(**kw)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    assert sorted(ts._steps) == sorted(js._steps)
    for key, value in js._steps.items():
        np.testing.assert_array_equal(ts._steps[key], value, err_msg=key)
    assert ts._segment_table() == js._segment_table()


def test_fifty_step_segments_are_6_skip_44_cfg():
    _, ts = _samplers(num_steps=50, guidance=3.2, guidance_interval_min=0.1)
    assert ts._segment_table() == [(0, 6, "skip"), (6, 50, "cfg"), (50, 50, "skip")]


def test_eight_step_cfg_sample_matches_jax():
    """Same weights, same seeded noise, same labels: the final images agree
    at atol = 1e-4 * max|ref| (fp32 sums over 8 chained network calls)."""
    jmodel, params = tiny_jax_c2i(seed=2)
    model = port_c2i_from_jax(params)
    js, ts = _samplers(num_steps=8, guidance=3.2, guidance_interval_min=0.1)
    noise = np.stack([seeded_noise(s, (3, TINY_IMAGE, TINY_IMAGE)) for s in (0, 1)])
    cond, uncond = LabelConditioner(TINY_C2I["num_classes"])([3, 7])

    ref = fast_jit(lambda n, c, u: js(lambda x, t, y: jmodel.apply(params, x, t, y), n, c, u))(
        jnp.asarray(noise), jnp.asarray(cond.numpy(), jnp.int32),
        jnp.asarray(uncond.numpy(), jnp.int32))
    out = ts(model, torch.from_numpy(noise), cond, uncond).numpy()
    ref = np.array(ref)
    assert np.abs(ref - noise).max() > 0.1  # the network moved the sample
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(fp_to_uint8(torch.from_numpy(ref)).numpy(),
                                  np.asarray(jax_fp_to_uint8(jnp.asarray(ref))))


def test_trajectories_have_the_jax_layout():
    net = lambda x, t, y: -x * t[:, None, None, None]  # noqa: E731
    _, ts = _samplers(num_steps=4, guidance=2.0, guidance_interval_min=0.3)
    noise = torch.ones(2, 4, 4, 3)
    cond, uncond = LabelConditioner(5)([0, 1])
    final, xs, vs = ts(net, noise, cond, uncond, return_x_trajs=True, return_v_trajs=True)
    assert xs.shape == vs.shape == (5, 2, 4, 4, 3)
    torch.testing.assert_close(xs[0], noise)
    torch.testing.assert_close(xs[-1], final)
    assert torch.all(vs[-1] == 0)


def test_sde_steps_need_a_generator():
    _, ts = _samplers(num_steps=4, step_fn="sde")
    net = lambda x, t, y: torch.zeros_like(x)  # noqa: E731
    cond, uncond = LabelConditioner(5)([0])
    with pytest.raises(ValueError, match="torch.Generator"):
        ts(net, torch.zeros(1, 4, 4, 3), cond, uncond)
    out = ts(net, torch.zeros(1, 4, 4, 3), cond, uncond,
             generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all() and out.abs().max() > 0


@pytest.mark.parametrize("name", ["simple_guidance_fn", "guidance_fn_with_rescale",
                                  "c3_guidance_fn"])
def test_guidance_fns_match_jax(name):
    out = np.random.default_rng(0).standard_normal((4, 4, 4, 5)).astype(np.float32)
    ref = getattr(jg, name)(jnp.asarray(out), 3.2)
    np.testing.assert_allclose(getattr(tg, name)(torch.from_numpy(out), 3.2).numpy(),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_seeded_noise_is_bit_equal():
    for seed in (0, 7, 123456):
        np.testing.assert_array_equal(seeded_noise(seed, (3, 8, 16)),
                                      jax_seeded_noise(seed, (3, 8, 16)))


def test_flops_match_jax_and_h100_peaks():
    assert tflops.deco_c2i_flops() == jflops.deco_c2i_flops()
    kw = dict(image_size=64, patch=4, hidden=144, num_cond_blocks=2, num_blocks=4, hidden_x=16)
    assert tflops.deco_c2i_flops(**kw) == jflops.deco_c2i_flops(**kw)
    assert tflops.sampler_flops_per_image(1e9, 50, 1.88) == jflops.sampler_flops_per_image(
        1e9, 50, 1.88)
    assert tflops.card_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert tflops.card_peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    with pytest.raises(ValueError):
        tflops.card_peaks("NVIDIA A100-SXM4-80GB")


def test_generate_pairs_classes_and_seeds_as_the_fid_protocol():
    """``sample.generate`` image i is item i of the JAX package's
    ClassLabelRandomNDataset: class i // num_seeds, noise seed i % num_seeds
    (here 2 seeds a class, so images 0-4 are classes 0, 0, 1, 1, 2)."""
    from deco_tpu.data.randn import ClassLabelRandomNDataset as JaxProtocol
    from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I, init_random_
    from deco_tpu_torch.sample import generate

    model = init_random_(DeCoC2I(**TINY_C2I, dtype=torch.float32, device="cpu").eval(), 3)
    _, ts = _samplers(num_steps=2, guidance=3.2, guidance_interval_min=0.1)
    chw = (3, TINY_IMAGE, TINY_IMAGE)
    images = generate(model, ts, 5, 2, TINY_IMAGE, device="cpu",
                      max_num_instances=2 * TINY_C2I["num_classes"])
    ref = JaxProtocol(latent_shape=chw, num_classes=TINY_C2I["num_classes"],
                      max_num_instances=2 * TINY_C2I["num_classes"])
    conditioner = LabelConditioner(TINY_C2I["num_classes"])
    expected = []
    for batch in ([0, 1], [2, 3], [4]):  # generate's batches of 2
        noise = torch.from_numpy(np.stack([ref[i][0] for i in batch]))
        cond, uncond = conditioner([ref[i][1] for i in batch])
        with torch.no_grad():
            expected.append(ts(model, noise, cond, uncond))
    assert [ref[i][1] for i in range(5)] == [0, 0, 1, 1, 2]
    torch.testing.assert_close(images, torch.cat(expected), rtol=0, atol=0)
