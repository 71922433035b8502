"""The port's block-DCT ops and frequency-weighted MSE
(deco_tpu_torch.ops.block_dct) against the JAX package's.

The forward is compared with the Pallas ``_freq_mse_kernel`` run in
interpret mode and with the XLA path, at rtol 1e-5 (fp32 sums in another
order); the gradient (the port's autograd Function against ``jax.grad`` of
``frequency_weighted_mse``) at rtol 1e-4, atol 1e-9. The CUDA kernel is
tested on the card in tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.ops import block_dct as jdct
from deco_tpu_torch.ops import block_dct as tdct


def _diff(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(quality=40, mode="inv"), dict(gamma=2.0)])
def test_tables_equal_jax(kw):
    np.testing.assert_array_equal(tdct.dct_matrix(), jdct.dct_matrix())
    np.testing.assert_array_equal(tdct.dct_kron_matrix(), jdct.dct_kron_matrix())
    np.testing.assert_array_equal(tdct.RGB2YCBCR, jdct.RGB2YCBCR)
    np.testing.assert_array_equal(tdct.build_freq_weight(**kw), jdct.build_freq_weight(**kw))


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 13, 21, 3)])
def test_block_dct_and_inverse_match_jax(shape):
    x = _diff(shape, seed=1)
    f = tdct.block_dct_8x8(tdct.rgb_to_ycbcr(torch.from_numpy(x)))
    f_ref = jdct.block_dct_8x8(jdct.rgb_to_ycbcr(jnp.asarray(x)))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-5, atol=1e-5)
    back = tdct.block_idct_8x8(f)
    np.testing.assert_allclose(back.numpy(), np.asarray(jdct.block_idct_8x8(f_ref)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 16, 2048, 3)])
def test_freq_mse_forward_matches_jax_pallas(shape):
    from jax.experimental.pallas import tpu as pltpu

    x, w = _diff(shape, seed=2), jdct.build_freq_weight()
    with pltpu.force_tpu_interpret_mode():
        ref = jdct.frequency_weighted_mse_pallas(jnp.asarray(x), w, interpret=True)
    before = tdct.freq_mse.launches
    got = tdct.frequency_weighted_mse(torch.from_numpy(x), w)
    assert tdct.freq_mse.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(jdct.frequency_weighted_mse_xla(x, w)), rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 13, 21, 3)])
def test_freq_mse_gradient_matches_jax(shape):
    x, w = _diff(shape, seed=3), jdct.build_freq_weight()
    ref = jax.grad(lambda d: 3.0 * jdct.frequency_weighted_mse(d, w))(jnp.asarray(x))
    leaf = torch.from_numpy(x).requires_grad_(True)
    (3.0 * tdct.frequency_weighted_mse(leaf, w)).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-9)
