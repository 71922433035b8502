"""The port's metrics (train/metrics.py), ``ComputeMetricsHook`` and
``eval_fid`` against the JAX package's, on the CPU.

Inputs are seeded uint8 image batches. Tolerances:

- ``psnr`` and ``ssim`` (per image and mean): rtol 1e-6 (fp32 means and
  convolutions in another order);
- ``squared_error_stats``: the port sums in float64, exactly for uint8
  values, where the JAX package sums N squares in float32 (~sqrt(N) 2^-24
  relative, 4e-6 at N = 5184): rtol 1e-5, and the pooled PSNR computed from
  it at the 10 log10(1 + 1e-5) = 4.4e-5 dB that follows;
- ``FIDStats`` and ``frechet_distance`` on the same activations: rtol 1e-9
  (float64 moments and eigendecompositions, the same formulas);
- FIDs through the Inception tower (``fid_from_images``, ``eval_fid``, the
  hook): the two towers' features agree to ~1e-5 of their largest value
  (tests/test_torch_inception.py holds them to 1e-4), and the FID of a few
  images weighs each feature's difference by O(1) coefficients, so the
  scores are held to rtol 1e-4 (3.4e-6 seen) and the features' statistics to atol 1e-4
  of their largest value.

The towers share one seeded pytorch-fid-layout state dict (a ``.pt`` for
the command lines) and read the 64-d tap (after the first max pool): the
CPU forward to pool3 takes ~1 s an image alone and minutes under a loaded
test run, and tests/test_torch_inception.py holds every tap, so here the
JAX entry points build their tower at that tap (their ``InceptionV3Features``
and the port's ``load_inception`` patched for the test) and the code
around the tower is what is compared.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu import eval_fid as jax_eval_fid
from deco_tpu.models import inception as jinception
from deco_tpu.train import hooks as jhooks
from deco_tpu.train import metrics as jmetrics
from deco_tpu_torch import eval_fid
from deco_tpu_torch.models import inception
from deco_tpu_torch.train import hooks, metrics
from torch_port_util import inception_state_dict

FID_RTOL = 1e-4


def _batch(seed, n=3, size=24):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_variables():
    return jinception.inception_params_from_torch(
        {k: v.numpy() for k, v in inception_state_dict().items()})


TAP = 64


@pytest.fixture
def tap64(monkeypatch):
    """Both packages' FID entry points build their tower at the 64-d tap."""
    monkeypatch.setattr(jinception, "InceptionV3Features",
                        functools.partial(jinception.InceptionV3Features, feature_dim=TAP))
    monkeypatch.setattr(eval_fid, "load_inception",
                        functools.partial(inception.load_inception, feature_dim=TAP))


def _tower(feature_dim=TAP):
    tower = inception.InceptionV3Features(feature_dim=feature_dim)
    tower.load_state_dict(inception.inception_state_dict(inception_state_dict()))
    return tower.eval()


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tower") / "pt_inception.pt"
    torch.save(inception_state_dict(), path)
    return str(path)


def test_psnr_and_squared_error_match_jax():
    a, b = _batch(0), _batch(1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(metrics.psnr(ta, tb)),
                               float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    sse, n = metrics.squared_error_stats(ta, tb)
    ref_sse, ref_n = jmetrics.squared_error_stats(a, b)
    assert sse == float(((a.astype(np.int64) - b.astype(np.int64)) ** 2).sum())  # exact
    np.testing.assert_allclose(sse, ref_sse, rtol=1e-5)
    assert n == ref_n
    assert metrics.psnr_from_stats(sse, n) == pytest.approx(jmetrics.psnr_from_stats(sse, n),
                                                            rel=1e-12)
    assert metrics.psnr_from_stats(0.0, n) == jmetrics.psnr_from_stats(0.0, n) == float("inf")


@pytest.mark.parametrize("per_image", [False, True])
def test_ssim_matches_jax(per_image):
    a, b = _batch(2, n=4, size=32), _batch(3, n=4, size=32)
    b[:2] = a[:2] // 2 + b[:2] // 4  # similar pairs as well as unrelated ones
    got = metrics.ssim(torch.from_numpy(a), torch.from_numpy(b), per_image=per_image)
    want = jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), per_image=per_image)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _moments(seed, n, d=16):
    acts = np.random.default_rng(seed).standard_normal((n, d)) @ np.diag(np.linspace(0.5, 2, d))
    return acts.astype(np.float32)


def test_fid_stats_and_frechet_distance_match_jax():
    stats = []
    for module in (metrics, jmetrics):
        s, t = module.FIDStats(16), module.FIDStats(16)
        s.update(_moments(0, 40))
        s.update(_moments(1, 30))
        other = module.FIDStats(16)
        other.update(_moments(2, 50))
        t.merge(other)
        stats.append((*s.finalize(), *t.finalize()))
    for got, want in zip(*stats):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    fid = metrics.frechet_distance(*stats[0])
    assert fid > 0.1
    np.testing.assert_allclose(fid, jmetrics.frechet_distance(*stats[1]), rtol=1e-9)
    mu, cov = stats[0][:2]
    assert abs(metrics.frechet_distance(mu, cov, mu, cov)) < 1e-9


def test_fid_from_images_matches_jax(tap64):
    a, b = _batch(4, n=3), _batch(5, n=3)
    got = metrics.fid_from_images(a, b, tower=_tower())
    want = jmetrics.fid_from_images(a, b, inception_variables=_jax_variables())
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(got, want, rtol=FID_RTOL)


def test_compute_metrics_hook_matches_jax():
    """Two batches, the 64-d tap: PSNR (one pooled squared error), SSIM
    (per-image means) and FID against the JAX hook on the same weights."""
    hook = hooks.ComputeMetricsHook(fid_feature_dim=TAP, inception=_tower(), device="cpu")
    ref = jhooks.ComputeMetricsHook(fid_feature_dim=TAP, inception_variables=_jax_variables())
    for seed in (6, 8):
        pred, orig = _batch(seed, n=3, size=32), _batch(seed + 1, n=3, size=32)
        pred[0] = orig[0]  # one reconstruction close to its original
        for h in (hook, ref):
            h.on_batch_end(pred, orig)
    assert hook.has_updates
    real, fake = hook._real.finalize(), hook._fake.finalize()
    for got, want in zip((*real, *fake), (*ref._real.finalize(), *ref._fake.finalize())):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    got, want = hook.on_epoch_end(), ref.on_epoch_end()
    assert sorted(got) == sorted(want) == ["metrics/fid", "metrics/psnr", "metrics/ssim"]
    np.testing.assert_allclose(got["metrics/psnr"], want["metrics/psnr"], rtol=0, atol=4.4e-5)
    np.testing.assert_allclose(got["metrics/ssim"], want["metrics/ssim"], rtol=1e-6)
    np.testing.assert_allclose(got["metrics/fid"], want["metrics/fid"], rtol=FID_RTOL)
    assert not hook.has_updates  # on_epoch_end resets


@pytest.fixture
def eval_fid_runs(tmp_path, weights_file, tap64):
    """Each package's eval_fid on two image npz files, writing the samples'
    statistics; returns the paths and both scores."""
    root = tmp_path
    samples, reference = root / "samples.npz", root / "reference.npz"
    np.savez(samples, arr_0=_batch(10, n=3))
    np.savez(reference, arr_0=_batch(11, n=3))
    out = {"samples": str(samples), "reference": str(reference)}
    for name, main in (("port", eval_fid.main), ("jax", jax_eval_fid.main)):
        stats = str(root / f"stats_{name}.npz")
        args = [str(samples), str(reference), "--inception", weights_file, "--stats-out", stats]
        out[name] = main(args + (["--device", "cpu"] if name == "port" else []))
        out[name + "_stats"] = stats
    return out


def test_eval_fid_matches_jax_on_image_batches(eval_fid_runs, capsys):
    got, want = eval_fid_runs["port"], eval_fid_runs["jax"]
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(got, want, rtol=FID_RTOL)
    with np.load(eval_fid_runs["port_stats"]) as ours, np.load(eval_fid_runs["jax_stats"]) as ref:
        for key in ("mu", "sigma"):
            np.testing.assert_allclose(ours[key], ref[key], rtol=0,
                                       atol=1e-4 * np.abs(ref[key]).max())


def test_eval_fid_matches_jax_on_a_stats_file(eval_fid_runs, weights_file, capsys):
    """The reference as mu/sigma: the samples' statistics written above,
    scored against the reference images' batch."""
    got = eval_fid.main([eval_fid_runs["reference"], eval_fid_runs["port_stats"],
                         "--inception", weights_file, "--device", "cpu"])
    assert capsys.readouterr().out.strip() == f"FID: {got:.4f}"
    want = jax_eval_fid.main([eval_fid_runs["reference"], eval_fid_runs["jax_stats"],
                              "--inception", weights_file])
    np.testing.assert_allclose(got, want, rtol=FID_RTOL)
    np.testing.assert_allclose(got, eval_fid_runs["port"], rtol=1e-6)  # the same pair of sets


def test_eval_fid_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_fid.main(["a.npz", "b.npz"])
