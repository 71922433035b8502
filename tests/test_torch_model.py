"""The port's DeCoC2I forward against the JAX DeCoC2I, in fp32 on the CPU.

Weights are the JAX params redrawn at unit scale (every leaf, so the
zero-initialised heads carry signal; small weights once hid a wrong RoPE
table, see ``torch_port_util.redraw``) and carried over through ``convert.state_dict_from_jax``. The
tolerance is atol = 1e-5 * max|ref|: fp32 sums over a 2-block trunk and a
2-block decoder in two frameworks' orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
from torch_port_util import TINY_C2I, TINY_IMAGE, fast_jit, port_c2i_from_jax, tiny_jax_c2i


def _inputs(batch=2, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, TINY_IMAGE, TINY_IMAGE, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (batch,)).astype(np.float32)
    y = np.array([1, TINY_C2I["num_classes"]] * (batch // 2), np.int32)
    return x, t, y


def _port(model, x, t, y):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long()).numpy()


def _close(out, ref):
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 1e-2  # the redrawn heads make the output non-trivial
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_forward_matches_jax():
    jmodel, params = tiny_jax_c2i(seed=0)
    x, t, y = _inputs()
    ref = fast_jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    out = _port(port_c2i_from_jax(params), x, t, y)
    assert out.shape == (2, TINY_IMAGE, TINY_IMAGE, 3) and out.dtype == np.float32
    _close(out, ref)


def test_forward_matches_jax_pallas_flash(monkeypatch):
    """The JAX side runs its Pallas flash kernel (interpret mode), so the
    kernel the port replaces is on the compared path."""
    jmodel, params = tiny_jax_c2i(seed=1)
    x, t, y = _inputs(seed=4)
    monkeypatch.setenv("DECO_ATTN_IMPL", "flash")
    with pltpu.force_tpu_interpret_mode():
        ref = fast_jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    monkeypatch.delenv("DECO_ATTN_IMPL")
    _close(_port(port_c2i_from_jax(params), x, t, y), ref)


def test_trunk_output_reaches_the_image():
    """Dropping attention changes the output far beyond the tolerance, so the
    parity above does see the trunk."""
    _, params = tiny_jax_c2i(seed=0)
    model = port_c2i_from_jax(params)
    x, t, y = _inputs()
    full = _port(model, x, t, y)
    with torch.no_grad():
        for block in model.blocks:
            block.attn.proj.weight.zero_()
            block.attn.proj.bias.zero_()
    assert np.abs(_port(model, x, t, y) - full).max() > 1e-2 * np.abs(full).max()


@pytest.mark.parametrize("kwarg", [  # decoder_chunks, the remat policies and align_layer are ported
    dict(trunk_parallel="tp"), dict(quantize=True), dict(quantize="fp4"),
    dict(trunk_parallel="sp"),
])
def test_unported_options_raise(kwarg):
    """trunk_parallel is ported: "sp" and "tp" build, and raise JAX's
    ValueError with int8 (the executors read the weights themselves) or at
    an unknown mode; quantize is ported, and a mode other than None or
    "int8" raises JAX's ValueError (tests/test_torch_quant.py holds the
    int8 mode against JAX)."""
    if "trunk_parallel" in kwarg:
        assert DeCoC2I(**TINY_C2I, **kwarg, device="cpu").trunk_parallel == kwarg["trunk_parallel"]
        with pytest.raises(ValueError, match="trunk_parallel"):
            DeCoC2I(**TINY_C2I, **kwarg, quantize="int8", device="cpu")
        with pytest.raises(ValueError, match="trunk_parallel"):
            DeCoC2I(**TINY_C2I, trunk_parallel="pp", device="cpu")
        return
    with pytest.raises(ValueError, match=next(iter(kwarg))):
        DeCoC2I(**TINY_C2I, **kwarg, device="cpu")


def test_repa_outputs_raise():
    """The REPA outputs are ported: no longer raising, they come in the JAX
    order (image, s, features), with the features after block align_layer
    and zeros when it is 0 (tests/test_torch_c2i_families.py holds them
    against JAX)."""
    model = DeCoC2I(**TINY_C2I, dtype=torch.float32, device="cpu")
    x, t, y = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        img, s, feat = model(x, t, y.long(), return_s=True, return_features=True)
        model.align_layer = 1
        tapped = model(x, t, y.long(), return_features=True)[1]
    assert s.shape == (2, 4, 4, TINY_C2I["hidden_size"]) and not feat.any()
    assert tapped.shape == (2, 16, TINY_C2I["hidden_size"]) and tapped.abs().max() > 0
