"""The port's InceptionV3 FID tower against the JAX tower, on the CPU in fp32.

One seeded random state dict in the pytorch-fid layout (with the
``AuxLogits.*``/``fc.*`` heads and ``num_batches_tracked`` a real file
carries) goes to the port through ``load_inception`` and to JAX through
``inception_params_from_torch``. Two 64x64 images; the features at every
tap (64, 192, 768, 2048) under both ``fid_variant`` values agree at rtol
1e-4 of the largest feature (fp32 convolutions summed in another order,
~95 layers deep). Each variant's four taps come from one JAX compile.
``tf1_bilinear_resize`` at 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.models import inception as jinception
from deco_tpu_torch.models import inception
from torch_port_util import fast_jit, inception_state_dict as _state_dict

TAPS = inception.FEATURE_DIMS


def _images():
    return np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_taps(fid_variant: bool):
    """{tap: features} from one jitted function over the four taps."""
    variables = jinception.inception_params_from_torch(
        {k: v.numpy() for k, v in _state_dict().items()})

    def taps(v, x):
        return [jinception.InceptionV3Features(fid_variant=fid_variant, feature_dim=d).apply(v, x)
                for d in TAPS]

    return dict(zip(TAPS, map(np.asarray, fast_jit(taps)(variables, jnp.asarray(_images())))))


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("inception") / "pt_inception.pt"
    torch.save(_state_dict(), path)
    return str(path)


@pytest.fixture(scope="module")
def towers(weights_file):
    """One loaded tower per variant; a test sets the tap it reads."""
    return {v: inception.load_inception(weights_file, device="cpu", fid_variant=v)
            for v in (True, False)}


@pytest.mark.parametrize("fid_variant", [True, False])
@pytest.mark.parametrize("tap", TAPS)
def test_features_match_jax(fid_variant, tap, towers):
    tower = towers[fid_variant]
    tower.feature_dim = tap
    with torch.no_grad():
        got = tower(torch.from_numpy(_images())).numpy()
    want = _jax_taps(fid_variant)[tap]
    assert got.shape == want.shape == (2, tap)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_the_variants_differ():
    """The parity above sees the variant: the two towers' pool3 features differ."""
    assert np.abs(_jax_taps(True)[2048] - _jax_taps(False)[2048]).max() > 1e-3


def test_compute_fid_features_batches_like_one_call(towers):
    tower = towers[True]
    tower.feature_dim = 192
    images = np.concatenate([_images(), _images()[::-1]])
    np.testing.assert_allclose(inception.compute_fid_features(images, tower, batch_size=3),
                               inception.compute_fid_features(images, tower, batch_size=4),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(299, 299), (17, 40)])
def test_tf1_bilinear_resize_matches_jax(out_hw):
    x = np.random.default_rng(2).uniform(0, 1, (2, 23, 31, 3)).astype(np.float32)
    got = inception.tf1_bilinear_resize(torch.from_numpy(x), *out_hw).numpy()
    want = np.asarray(jinception.tf1_bilinear_resize(jnp.asarray(x), *out_hw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_loader_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(ValueError, match="state dict"):
        inception.load_inception(str(tmp_path / "tower.msgpack"), device="cpu")
    sd = dict(_state_dict())
    del sd["Mixed_7c.branch_pool.bn.running_mean"]
    torch.save(sd, tmp_path / "partial.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        inception.load_inception(str(tmp_path / "partial.pt"), device="cpu")
    with pytest.raises(ValueError, match="FID tap"):
        inception.InceptionV3Features(feature_dim=1000)


def test_random_tower_is_seeded():
    with pytest.warns(UserWarning, match="randomly drawn"):
        a, b, c = (inception.random_inception(s, device="cpu").state_dict() for s in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv2d_1a_3x3.conv.weight"], c["Conv2d_1a_3x3.conv.weight"])
    w = a["Mixed_7c.branch_pool.conv.weight"]  # He-normal: std sqrt(2 / fan_in)
    assert abs(w.std().item() / (2.0 / w[0].numel()) ** 0.5 - 1) < 0.05
