"""The port's ``decoder_chunks`` and trunk remat policies against the JAX
``DeCoC2I``, on the CPU in fp32.

A tiny model (2 trunk blocks, 2 decoder blocks, hidden 144 over 2 heads,
32x32 images, patch 8: 16 patches) with the JAX params redrawn at unit
scale and carried over through ``convert.state_dict_from_jax``. The loss is
``sum(out * w)`` for a fixed random ``w``. Tolerances:

- against JAX, forward and parameter gradients at atol = 1e-5 * max|ref|
  (the rule of tests/test_torch_model.py: fp32 sums in two frameworks'
  orders);
- in the port, the chunked forward equals the unchunked one exactly (each
  patch is decoded on its own, with the same operations); the chunked
  parameter gradients add one partial sum per chunk, so they differ from
  the unchunked ones by fp32 rounding: atol 1e-6 * max|ref|;
- the four remat policies give the same loss and gradients exactly: a
  recompute runs the same operations on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.models.dit_c2i_deco import DeCoC2I as JaxDeCoC2I
from deco_tpu_torch.convert import state_dict_from_jax
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
from deco_tpu_torch.ops import flash_attention as fa
from torch_port_util import fast_jit, redrawn_init

CFG = dict(in_channels=3, patch_size=8, num_groups=2, hidden_size=144, hidden_size_x=16,
           num_blocks=4, num_cond_blocks=2, num_classes=10)
IMAGE = 32
POLICIES = ("full", "dots", "attn", "none")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (2,)).astype(np.float32)
    y = np.array([3, CFG["num_classes"]], np.int32)
    w = rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    return x, t, y, w


_PARAMS = {}


def _jax_params():
    if not _PARAMS:
        model = JaxDeCoC2I(**CFG, dtype=jnp.float32)
        x = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
        _PARAMS["params"] = redrawn_init(model, x, jnp.zeros((1,)), jnp.zeros((1,), jnp.int32),
                                         seed=11)
    return _PARAMS["params"]


def _state_dict(tree):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                               in_channels=CFG["in_channels"], patch_size=CFG["patch_size"])


def _port(**kw):
    model = DeCoC2I(**CFG, dtype=torch.float32, device="cpu", **kw).train()
    model.load_state_dict(_state_dict(_jax_params()), strict=True)
    return model


def _port_run(model, seed=0):
    """(output, loss, {name: grad}) of one forward and backward."""
    x, t, y, w = (torch.from_numpy(a) for a in _inputs(seed))
    out = model(x, t, y.long())
    loss = (out * w).sum()
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return out.detach().numpy(), loss.item(), grads


def _jax_run(seed=0, **kw):
    model = JaxDeCoC2I(**CFG, dtype=jnp.float32, **kw)
    x, t, y, w = (jnp.asarray(a) for a in _inputs(seed))

    def loss_fn(params):
        out = model.apply(params, x, t, y)
        return jnp.sum(out * w), out

    (loss, out), grads = fast_jit(jax.value_and_grad(loss_fn, has_aux=True))(_jax_params())
    sd = _state_dict(grads)
    return np.asarray(out), float(loss), {k: v.numpy() for k, v in sd.items()}


def _close_to_jax(got, want):
    out, _, grads = got
    ref, _, ref_grads = want
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        scale = np.abs(ref_grads[name]).max()
        assert scale > 0, name  # every parameter reaches the loss
        np.testing.assert_allclose(g, ref_grads[name], rtol=0, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("chunks, policy", [(0, "full"), (2, "attn"), (4, "dots")])
def test_decoder_chunks_and_remat_policy_match_jax(chunks, policy):
    """Each JAX compile takes ~3 s, so the three chunk counts and the two
    policies that differ from the port's earlier "full" share three runs."""
    kw = dict(grad_checkpoint=True, decoder_chunks=chunks, trunk_remat_policy=policy)
    _close_to_jax(_port_run(_port(**kw), seed=chunks), _jax_run(seed=chunks, **kw))


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_decoder_equals_unchunked(chunks):
    out, loss, grads = _port_run(_port(decoder_chunks=chunks))
    ref, ref_loss, ref_grads = _port_run(_port())
    np.testing.assert_array_equal(out, ref)
    for name, g in grads.items():
        scale = np.abs(ref_grads[name]).max()
        np.testing.assert_allclose(g, ref_grads[name], rtol=0, atol=1e-6 * scale, err_msg=name)


def test_chunked_decoder_loads_unchunked_weights():
    """One state dict for both: chunking adds and renames no parameter."""
    assert _port(decoder_chunks=4).state_dict().keys() == _port().state_dict().keys()


def test_decoder_chunks_that_do_not_divide_the_grid_raise():
    model = _port(decoder_chunks=3)  # 16 patches
    x, t, y, _ = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="does not divide the 16-patch grid"):
        model(x, t, y.long())


def test_remat_policies_give_the_same_loss_and_gradients():
    runs = {p: _port_run(_port(grad_checkpoint=True, trunk_remat_policy=p)) for p in POLICIES}
    _, ref_loss, ref_grads = _port_run(_port())
    for policy, (_, loss, grads) in runs.items():
        assert loss == ref_loss, policy
        for name, g in grads.items():
            np.testing.assert_array_equal(g, ref_grads[name], err_msg=f"{policy} {name}")


@pytest.mark.parametrize("policy, per_block", [("full", 2), ("dots", 2), ("attn", 1),
                                               ("none", 1)])
def test_forward_with_lse_runs_per_block_as_the_policy_says(policy, per_block, monkeypatch):
    """Under "attn" the backward's recompute takes the kept (o, lse), so the
    forward with logsumexp runs once per block; "full" and "dots" run it
    again in the recompute."""
    calls = []
    plain = fa.flash_attention_fwd_lse_plain
    monkeypatch.setattr(fa, "flash_attention_fwd_lse_plain",
                        lambda *a: calls.append(1) or plain(*a))
    _port_run(_port(grad_checkpoint=True, trunk_remat_policy=policy))
    assert len(calls) == per_block * CFG["num_cond_blocks"]


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="trunk_remat_policy"):
        DeCoC2I(**CFG, grad_checkpoint=True, trunk_remat_policy="dot", device="cpu")
