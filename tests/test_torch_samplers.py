"""The port's schedulers, samplers and Lagrange integrals against the JAX
package's, on the CPU in fp32.

Schedulers: alpha, sigma, dalpha, dsigma and w on 64 values of t, at rtol
1e-6 (float32 transcendentals in two libraries); where the JAX scheduler
raises (an undefined derivative) the port raises too. The VP and DDPM
sigma is sqrt(1 - a) with a near 1 at small t: one float32 ulp of a
(2^-24 near 1, where exp or the cumulative product round differently in
the two libraries) moves sigma by up to 2^-24 / (2 sigma), so sigma is
held to that bound as well. Samplers: the same
noise and conditions through a fixed closed-form network and through the
tiny DeCoC2I (weights carried over from JAX), deterministic step types,
final images at atol 1e-5 * max|ref| (fp32 updates in another order; the
port runs the conditional half alone where the guidance scale is 1, where
JAX computes uncond + 1 * (cond - uncond)). Lagrange integrals at 1e-10
(float64 arithmetic, same formulas).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.diffusion import adam_sampling as jadam
from deco_tpu.diffusion import ddpm_sampling as jddpm
from deco_tpu.diffusion import pre_integral as jpre
from deco_tpu.diffusion import sampling as jsampling
from deco_tpu.diffusion import scheduling as jsched
from deco_tpu_torch.diffusion import adam_sampling, ddpm_sampling, pre_integral, sampling
from deco_tpu_torch.diffusion import scheduling as sched
from torch_port_util import TINY_C2I, TINY_IMAGE, fast_jit, port_c2i_from_jax, tiny_jax_c2i

SCHEDULERS = {
    "GVPScheduler": (np.linspace(0, 1, 64), {}),
    "ConstScheduler": (np.linspace(0, 1, 64), {}),
    "VPScheduler": (np.linspace(0, 1, 64), dict(beta_min=0.1, beta_max=20.0)),
    "VPBetaScheduler": (np.linspace(0, 1, 64), dict(beta_min=0.2, beta_max=10.0)),
    "DDPMScheduler": (np.linspace(0, 999, 64), {}),
}
METHODS = ("alpha", "sigma", "dalpha", "dsigma", "w")


def _call(fn, t):
    try:
        return np.asarray(fn(t), np.float32)
    except NotImplementedError:
        return NotImplementedError


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax(name):
    t, kw = SCHEDULERS[name]
    t = t.astype(np.float32)
    port, ref = getattr(sched, name)(**kw), getattr(jsched, name)(**kw)
    defined = 0
    for method in METHODS:
        want = _call(getattr(ref, method), jnp.asarray(t))
        for arg in (t, torch.from_numpy(t)):  # numpy tables and torch tensors alike
            got = _call(getattr(port, method), arg)
            if want is NotImplementedError:
                assert got is NotImplementedError, (name, method)
                continue
            cancels = name in ("VPScheduler", "VPBetaScheduler", "DDPMScheduler") and (
                method == "sigma" or (method == "w" and name != "VPBetaScheduler"))  # w = sigma
            atol = 2.0**-24 / (2 * want.min()) if cancels else 1e-7
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol, err_msg=method)
        defined += want is not NotImplementedError
    assert defined >= 1


# ---- samplers ----

B = 2


# bounded and smooth in x, so rounding differences are not amplified, and it
# takes the DDPM samplers' table timesteps (up to 999) as well as t in [0, 1]
def _jax_net(x, t, y):
    t = (t / (1 + jnp.abs(t)))[:, None, None, None]
    return jnp.tanh(x) * (1 + t) - 0.3 * x + 0.25 * y[:, None, None, None]


def _port_net(x, t, y):
    t = (t / (1 + torch.abs(t)))[:, None, None, None]
    return torch.tanh(x) * (1 + t) - 0.3 * x + 0.25 * y[:, None, None, None]


def _sampler_pairs():
    lin = dict(guidance=2.0, guidance_interval_min=0.2, guidance_interval_max=0.8, timeshift=2.0)
    pairs = {
        "euler_jit": (sampling.EulerSamplerJiT, jsampling.EulerSamplerJiT, "Linear",
                      dict(num_steps=7, **lin)),
        "heun": (sampling.HeunSampler, jsampling.HeunSampler, "Linear", dict(num_steps=6, **lin)),
        "heun_exact": (sampling.HeunSampler, jsampling.HeunSampler, "Linear",
                       dict(num_steps=5, exact_heun=True, **lin)),
        "ddim": (ddpm_sampling.DDIMSampler, jddpm.DDIMSampler, "DDPM",
                 dict(num_steps=6, guidance=1.5)),
        "vp_euler": (ddpm_sampling.VPEulerSampler, jddpm.VPEulerSampler, "VP",
                     dict(num_steps=6, guidance=1.5)),
    }
    for order, transform in zip((1, 2, 3, 4), ("nop", "snr", "logsnr", "isnr")):
        pairs[f"adam_lm_{order}"] = (adam_sampling.AdamLMSampler, jadam.AdamLMSampler, "Linear",
                                     dict(num_steps=8, order=order, lms_transform_fn=transform,
                                          guidance=2.0, guidance_interval_min=0.2,
                                          guidance_interval_max=0.8))
    return pairs


PAIRS = _sampler_pairs()


def _build(name):
    port_cls, jax_cls, scheduler, kw = PAIRS[name]
    return (port_cls(scheduler=getattr(sched, scheduler + "Scheduler")(), **kw),
            jax_cls(scheduler=getattr(jsched, scheduler + "Scheduler")(), **kw))


def _noise(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_sampler_matches_jax_on_a_closed_form_net(name):
    port, ref = _build(name)
    noise = _noise(0, (B, 4, 4, 3))
    cond, uncond = np.array([1.0, -2.0], np.float32), np.zeros(B, np.float32)
    want = fast_jit(lambda n, c, u: ref(_jax_net, n, c, u))(*map(jnp.asarray, (noise, cond, uncond)))
    got = port(_port_net, *map(torch.from_numpy, (noise, cond, uncond)))
    _close(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _tiny():
    jmodel, params = tiny_jax_c2i(seed=5)
    return jmodel, params, port_c2i_from_jax(params)


@pytest.mark.parametrize("name", ["euler_jit", "heun", "adam_lm_2", "ddim", "vp_euler"])
def test_sampler_matches_jax_on_the_tiny_model(name):
    jmodel, params, model = _tiny()
    port, ref = _build(name)
    noise = _noise(1, (B, TINY_IMAGE, TINY_IMAGE, 3))
    cond = np.array([2, 7], np.int32)
    uncond = np.full(B, TINY_C2I["num_classes"], np.int32)
    want = fast_jit(lambda n, c, u: ref(lambda *a: jmodel.apply(params, *a), n, c, u))(
        *map(jnp.asarray, (noise, cond, uncond)))
    with torch.no_grad():
        got = port(model, torch.from_numpy(noise), torch.from_numpy(cond).long(),
                   torch.from_numpy(uncond).long())
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["heun", "adam_lm_3", "ddim"])
def test_sampler_trajectories_match_jax(name):
    port, ref = _build(name)
    noise = _noise(2, (B, 4, 4, 3))
    cond, uncond = np.array([0.5, 1.5], np.float32), np.zeros(B, np.float32)
    args = [jnp.asarray(a) for a in (noise, cond, uncond)]
    want = ref(_jax_net, *args, return_x_trajs=True, return_v_trajs=True)
    got = port(_port_net, *map(torch.from_numpy, (noise, cond, uncond)),
               return_x_trajs=True, return_v_trajs=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w)


@pytest.mark.parametrize("cls, kw", [
    (sampling.HeunSampler, dict(step_fn="sde", scheduler=sched.LinearScheduler(),
                                w_scheduler=sched.LinearScheduler())),
    (ddpm_sampling.VPEulerSampler, dict(step_fn="sde", scheduler=sched.VPScheduler())),
])
def test_sde_steps_draw_from_the_generator(cls, kw):
    sampler = cls(num_steps=4, **kw)
    noise = torch.from_numpy(_noise(3, (B, 4, 4, 3)))
    cond, uncond = torch.ones(B), torch.zeros(B)
    with pytest.raises(ValueError, match="Generator"):
        sampler(_port_net, noise, cond, uncond)
    runs = [sampler(_port_net, noise, cond, uncond, generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_adam_lm_coefficients_match_jax():
    for order, transform in ((1, "nop"), (2, "snr"), (3, "logsnr"), (4, "isnr")):
        kw = dict(num_steps=12, order=order, lms_transform_fn=transform, timeshift=1.5)
        port = adam_sampling.AdamLMSampler(scheduler=sched.LinearScheduler(), **kw)
        ref = jadam.AdamLMSampler(scheduler=jsched.LinearScheduler(), **kw)
        np.testing.assert_array_equal(port.solver_coeffs, ref.solver_coeffs)
        np.testing.assert_array_equal(port._cfg_array(), ref._cfg_array())


def test_pre_integral_matches_jax():
    rng = np.random.default_rng(4)
    ts = sorted(rng.uniform(0, 1, 4).tolist())
    vs = rng.standard_normal(4).tolist()
    for order in (1, 2, 3, 4):
        start, end = rng.uniform(0, 1, 2).tolist()
        got = pre_integral.lagrange_preint(order, vs, ts, start, end)
        want = jpre.lagrange_preint(order, vs, ts, start, end)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-10)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-10)
        assert abs(sum(got[1]) - 1.0) < 1e-10
    coeffs = rng.standard_normal(5).tolist()
    np.testing.assert_allclose(pre_integral.polynomial_integral(coeffs, 0.2, 0.9),
                               jpre.polynomial_integral(coeffs, 0.2, 0.9), rtol=1e-10)
    with pytest.raises(ValueError):
        pre_integral.lagrange_preint(5, vs + [0.0], ts + [1.0], 0.0, 1.0)
