"""The port's parallel executors (deco_tpu_torch/parallel/, models/moe.py)
against the JAX package, on four gloo ranks on the CPU.

One spawn of four rank processes (tests/torch_parallel_ranks.py, no JAX)
runs every check on two meshes of the four ranks: (data 2, model 2), so
S = 2 with two data rows, and (1, 4), S = 4. The references are computed
once a run (``shared_across_workers``), in fp32, while the ranks run:

- ring attention: the JAX dense attention (``layers.sdpa(impl="einsum")``,
  the function the JAX ring computes) with and without the text keys;
- the four trunk executors: the JAX executors (``sp_trunk``, ``tp_trunk``)
  on a (1, 4) mesh of the virtual CPU devices, with remat;
- DeCoC2I and DeCoT2I with ``trunk_parallel`` "sp" and "tp": the JAX
  sequential models (which the JAX executors equal, tests/test_sp_trunk.py);
- the pipeline: the JAX ``pipeline_apply`` at M = 4 on four stages;
- MoE: the JAX ``MoEMLP`` and its ``dispatch_tensors``.

The ranks' gradients are summed over the data ranks and averaged over the
model group (what DDP's world mean gives), the executors' contract.
Tolerances: outputs within 1e-5 x max|ref|, gradients within 1e-4 x
max|ref| of each tensor; the MoE dispatch and drops equal, the EP routing
equal to the dense module's bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deco_tpu.models import layers as jlayers
from deco_tpu.models import moe as jmoe
from deco_tpu.models.dit_c2i_deco import DeCoC2I as JaxDeCoC2I
from deco_tpu.models.dit_t2i import DeCoT2I as JaxDeCoT2I
from deco_tpu.parallel import mesh as jmesh
from deco_tpu.parallel import pipeline as jpipeline
from deco_tpu.parallel import sp_trunk as jsp
from deco_tpu.parallel import tp_trunk as jtp
from deco_tpu_torch import convert
from torch_parallel_ranks import Ranks
from torch_port_util import fast_jit, redraw, redrawn_init, shared_across_workers

C2I = dict(in_channels=3, patch_size=4, num_groups=4, hidden_size=48, hidden_size_x=16,
           num_blocks=6, num_cond_blocks=4, num_classes=10)
T2I = dict(in_channels=3, patch_size=4, num_groups=4, hidden_size=32, decoder_hidden_size=8,
           num_encoder_blocks=2, num_decoder_blocks=1, num_text_blocks=1, txt_embed_dim=16,
           txt_max_length=6)
MESHES = [(2, 2), (1, 4)]
MOE_DIMS, MOE_CF = (16, 4, 32), (1.25, 0.5)  # d, E, m; the second drops tokens
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(4, 32, 32, 3), t=rng.random(4).astype(np.float32),
        y=rng.integers(0, 10, 4).astype(np.int64), cot_img=f(4, 32, 32, 3),
        x2=f(4, 16, 16, 3), t2=rng.random(4).astype(np.float32), y2=f(4, 6, 16),
        cot2=f(4, 16, 16, 3),
        xs=f(4, 64, 48), cs=f(4, 1, 48), cot_s=f(4, 64, 48),
        xj=f(4, 16, 32), yj=f(4, 6, 32), cj=f(4, 1, 32), cot_j=f(4, 16, 32),
        q=f(4, 16, 2, 8), k=f(4, 16, 2, 8), v=f(4, 16, 2, 8), ek=f(4, 6, 2, 8),
        ev=f(4, 6, 2, 8), ring_cot=f(4, 16, 2, 8), xm=f(2, 16, 16))


def _params():
    c2i = JaxDeCoC2I(**C2I, dtype=jnp.float32)
    t2i = JaxDeCoT2I(**T2I, dtype=jnp.float32)
    pc = redrawn_init(c2i, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)),
                      jnp.zeros((1,), jnp.int32), seed=1)
    pt = redrawn_init(t2i, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)), jnp.zeros((1, 6, 16)),
                      seed=2)
    moe = jmoe.MoEMLP(num_experts=MOE_DIMS[1], mlp_dim=MOE_DIMS[2], dtype=jnp.float32)
    shapes = jax.eval_shape(moe.init, jax.random.PRNGKey(0), jnp.zeros((2, 16, MOE_DIMS[0])))
    pm = {"params": redraw(shapes["params"], seed=3)}
    return [jax.tree_util.tree_map(np.asarray, p) for p in (pc, pt, pm)]


def _c2i_sd(tree):
    return {k: v.numpy() for k, v in convert.state_dict_from_jax(
        tree, in_channels=3, patch_size=4).items()}


def _t2i_sd(tree):
    return {k: v.numpy() for k, v in convert.state_dict_from_jax_t2i(
        tree, in_channels=3, patch_size=4).items()}


def _blocks_only(sd, prefix="blocks."):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _with_stacked(tree, stacked, path):
    """``tree`` with zeros everywhere but ``stacked`` at ``path``: a gradient
    of the trunk alone in the model's layout, for the converters."""
    out = jax.tree_util.tree_map(np.zeros_like, tree)
    node = out["params"]
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = stacked
    return out


def _jax_references(pc, pt, pm, inp):
    refs = {}
    # ring attention: the dense function, forward and VJP
    def attn(q, k, v, ek=None, ev=None):
        extra = None if ek is None else (ek, ev)
        return jlayers.sdpa(q, k, v, dtype=jnp.float32, impl="einsum", extra_kv=extra)

    for extra in (False, True):
        args = [inp[n] for n in ("q", "k", "v")] + ([inp["ek"], inp["ev"]] if extra else [])
        out, vjp = jax.vjp(attn, *args)
        refs[f"ring_extra{int(extra)}"] = [np.asarray(out)] + [
            np.asarray(g) for g in vjp(jnp.asarray(inp["ring_cot"]))]

    mesh = jmesh.make_mesh(data=1, model=4, devices=jax.devices()[:4])
    c2i_rope = jlayers.precompute_rope_2d(12, 8, 8, scale=16.0)
    t2i_rope = jlayers.precompute_rope_2d(8, 4, 4, scale=(1.0, 1.0), extrapolate=True)
    cs, ts = pc["params"]["blocks"]["block"], pt["params"]["trunk"]["blocks"]["block"]
    with jax.set_mesh(mesh):
        for name, fn, stacked, args, rope, cot in (
                ("sp", jsp.sequence_parallel_trunk, cs, ("xs", "cs"), c2i_rope, "cot_s"),
                ("tp", jtp.tensor_parallel_trunk, cs, ("xs", "cs"), c2i_rope, "cot_s"),
                ("sp_joint", jsp.sequence_parallel_joint_trunk, ts, ("xj", "yj", "cj"),
                 t2i_rope, "cot_j"),
                ("tp_joint", jtp.tensor_parallel_joint_trunk, ts, ("xj", "yj", "cj"),
                 t2i_rope, "cot_j")):
            def loss(p, *a, fn=fn, rope=rope, cot=cot):
                out = fn(p, *a, rope, mesh=mesh, num_heads=4, dtype=jnp.float32, remat=True)
                return jnp.sum(out * inp[cot]), out

            grad = fast_jit(jax.grad(loss, argnums=tuple(range(len(args) + 1)), has_aux=True))
            grads, out = grad(stacked, *(inp[a] for a in args))
            refs[name] = dict(out=np.asarray(out), stacked=jax.tree_util.tree_map(np.asarray,
                                                                                   grads[0]),
                              inputs=[np.asarray(g) for g in grads[1:]])

        block = jlayers.FlattenDiTBlock(num_heads=4, dtype=jnp.float32)

        def pipe_loss(p, x):
            out = jpipeline.pipeline_apply(jpipeline.dit_block_apply(block), p, x, (inp["cs"],),
                                           (c2i_rope,), mesh=mesh, num_microbatches=4)
            return jnp.sum(out * inp["cot_s"]), out

        (g_p, g_x), out = fast_jit(jax.grad(pipe_loss, argnums=(0, 1), has_aux=True))(
            cs, inp["xs"])
        refs["pipeline"] = dict(out=np.asarray(out), x=np.asarray(g_x),
                                stacked=jax.tree_util.tree_map(np.asarray, g_p))

    # the sequential models, forward and every parameter's gradient
    for kind, model, params, img, t, cond, cot in (
            ("c2i", JaxDeCoC2I(**C2I, dtype=jnp.float32), pc, "x", "t", "y", "cot_img"),
            ("t2i", JaxDeCoT2I(**T2I, dtype=jnp.float32), pt, "x2", "t2", "y2", "cot2")):
        def mloss(p, model=model, img=img, t=t, cond=cond, cot=cot):
            out = model.apply(p, inp[img], inp[t], inp[cond].astype(
                np.int32) if cond == "y" else inp[cond])
            return jnp.sum(out * inp[cot]), out

        g, out = fast_jit(jax.grad(mloss, has_aux=True))(params)
        refs[kind] = dict(out=np.asarray(out), grads=jax.tree_util.tree_map(np.asarray, g))

    # MoE: the dense module's output, aux and routing
    for cf in MOE_CF:
        mod = jmoe.MoEMLP(num_experts=MOE_DIMS[1], mlp_dim=MOE_DIMS[2], capacity_factor=cf,
                          dtype=jnp.float32)
        y, state = mod.apply(pm, inp["xm"], mutable=["aux_loss"])
        cap = int(-(-cf * 16 * 2 // MOE_DIMS[1]))
        probs = jax.nn.softmax(jnp.asarray(inp["xm"]) @ pm["params"]["router"], axis=-1)
        routing = [jmoe.dispatch_tensors(p, 2, cap)[:2] for p in probs]
        refs[f"moe_{cf}"] = dict(y=np.asarray(y), cap=cap,
                                 aux=float(jax.tree_util.tree_leaves(state)[0]),
                                 dispatch=[np.asarray(d) for d, _ in routing],
                                 combine=[np.asarray(c) for _, c in routing])
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    def compute():
        try:
            return _compute()
        except Exception:  # kept, so that no other worker runs the ranks again
            import traceback

            return dict(error=traceback.format_exc())

    def _compute():
        pc, pt, pm = _params()
        inp = _inputs()
        caps = {str(cf): int(-(-cf * 16 * 2 // MOE_DIMS[1])) for cf in MOE_CF}
        payload = dict(inp, c2i_kw=C2I, t2i_kw=T2I, c2i_sd=_c2i_sd(pc), t2i_sd=_t2i_sd(pt),
                       c2i_grid=(8, 8), t2i_grid=(4, 4), meshes=MESHES, moe_dims=MOE_DIMS,
                       moe_capacity_factors=MOE_CF, moe_capacity=caps,
                       moe_sd={k: v.numpy() for k, v in
                               convert.moe_state_dict_from_jax(pm["params"]).items()})
        ranks = Ranks("executors", 4, payload,
                      str(tmp_path_factory.mktemp("parallel_executors")), timeout=120)
        try:
            refs = _jax_references(pc, pt, pm, inp)  # while the ranks run
        finally:
            out = ranks.wait()
        return dict(refs=refs, ranks=out[0], pc=pc, pt=pt)

    out = shared_across_workers(tmp_path_factory, "torch_parallel_executors", compute)
    if "error" in out:
        pytest.fail(out["error"])
    return out


def _close(ours, ref, tol, what):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err, scale = np.abs(ours - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max |diff| {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("mesh", MESHES, ids=["S2", "S4"])
@pytest.mark.parametrize("extra", [False, True], ids=["image", "with_text"])
def test_ring_attention_forward_and_gradients(run, mesh, extra):
    """Each rank's chunk of the output and of dQ, dK, dV, and the text
    keys' dK/dV summed over the group, against the JAX dense attention."""
    key = f"ring_extra{int(extra)}"
    ours, ref = run["ranks"][mesh][key], run["refs"][key]
    names = ["out", "dq", "dk", "dv"] + (["dek", "dev"] if extra else [])
    for i, name in enumerate(names):
        _close(ours[name], ref[i], FWD_TOL if name == "out" else GRAD_TOL, name)


@pytest.mark.parametrize("mesh", MESHES, ids=["S2", "S4"])
def test_standalone_ring_attention_gathers_the_whole_sequence(run, mesh):
    _close(run["ranks"][mesh]["ring_standalone"], run["refs"]["ring_extra0"][0], FWD_TOL, "out")


@pytest.mark.parametrize("mesh", MESHES, ids=["S2", "S4"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("name", ["sp", "tp", "sp_joint", "tp_joint"])
def test_trunk_executors_match_the_jax_executors(run, name, remat, mesh):
    """Output, the inputs' gradients and every block parameter's gradient."""
    ours, ref = run["ranks"][mesh][f"{name}_remat{int(remat)}"], run["refs"][name]
    _close(ours["out"], ref["out"], FWD_TOL, "out")
    for i, g in enumerate(ours["inputs"]):
        _close(g, ref["inputs"][i], GRAD_TOL, f"input {i}")
    if "joint" in name:
        sd = _blocks_only(_t2i_sd(_with_stacked(run["pt"], ref["stacked"],
                                                ("trunk", "blocks", "block"))))
    else:
        sd = _blocks_only(_c2i_sd(_with_stacked(run["pc"], ref["stacked"], ("blocks", "block"))))
    assert set(ours["params"]) == set(sd)
    for key, g in ours["params"].items():
        _close(g, sd[key], GRAD_TOL, key)


@pytest.mark.parametrize("mesh", MESHES, ids=["S2", "S4"])
@pytest.mark.parametrize("mode", ["sp", "tp"])
@pytest.mark.parametrize("kind", ["c2i", "t2i"])
def test_models_with_trunk_parallel_match_the_jax_models(run, kind, mode, mesh):
    """DeCoC2I / DeCoT2I with trunk_parallel: the image and every
    parameter's gradient against the JAX sequential model."""
    ours, ref = run["ranks"][mesh][f"{kind}_{mode}"], run["refs"][kind]
    _close(ours["out"], ref["out"], FWD_TOL, "out")
    sd = (_c2i_sd if kind == "c2i" else _t2i_sd)(ref["grads"])
    assert set(ours["params"]) == set(sd)
    for key, g in ours["params"].items():
        _close(g, sd[key], GRAD_TOL, key)


@pytest.mark.parametrize("mesh,mb", [((2, 2), 2), ((1, 4), 2), ((1, 4), 4)],
                         ids=["S2-M2", "S4-M2", "S4-M4"])
def test_pipeline_matches_the_jax_pipeline(run, mesh, mb):
    ours, ref = run["ranks"][mesh][f"pipeline_m{mb}"], run["refs"]["pipeline"]
    _close(ours["out"], ref["out"], FWD_TOL, "out")
    _close(ours["x"], ref["x"], GRAD_TOL, "dx")
    sd = _blocks_only(_c2i_sd(_with_stacked(run["pc"], ref["stacked"], ("blocks", "block"))))
    for key, g in ours["params"].items():
        _close(g, sd[key], GRAD_TOL, key)


@pytest.mark.parametrize("mesh", MESHES, ids=["S2", "S4"])
@pytest.mark.parametrize("cf", MOE_CF, ids=["roomy", "dropping"])
def test_moe_routing_matches_jax_and_expert_parallelism_matches_dense(run, mesh, cf):
    """The port's dense dispatch equals JAX's and its drops too; its combine
    and output agree; expert parallelism routes each rank's tokens exactly
    as the dense module does, with the same aux."""
    ours, ref = run["ranks"][mesh][f"moe_{cf}"], run["refs"][f"moe_{cf}"]
    for d, rd in zip(ours["dispatch"], ref["dispatch"]):
        np.testing.assert_array_equal(d, rd)
    for c, rc in zip(ours["combine"], ref["combine"]):
        _close(c, rc, FWD_TOL, "combine")
    assert ours["routing_equal"]
    _close(ours["dense"], ref["y"], FWD_TOL, "dense output")
    if ours["ep"] is not None:
        _close(ours["ep"], ours["dense"], FWD_TOL, "EP output")
    assert abs(ours["aux_dense"] - ref["aux"]) <= 1e-5 * abs(ref["aux"])
    assert abs(ours["aux_ep"] - ours["aux_dense"]) <= 1e-6 * abs(ref["aux"])
    if cf < 1:
        assert sum(ours["drops"]) > 0  # the tight capacity drops tokens


@pytest.mark.parametrize("what", ["tokens", "heads", "layers", "microbatches", "experts",
                                  "mesh"])
def test_an_axis_that_does_not_divide_raises(run, what):
    """As in JAX: the sequence, the heads and SwiGLU width, the layers, the
    rank's microbatches, the experts and the world itself."""
    assert run["ranks"][(1, 4)]["refusals"][what]


def test_port_refuses_int8_the_repa_tap_and_a_mask_under_trunk_parallel():
    from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
    from deco_tpu_torch.models.dit_t2i import DeCoT2I

    with pytest.raises(ValueError, match="not available under trunk_parallel"):
        DeCoC2I(**C2I, quantize="int8", trunk_parallel="sp", device="cpu")
    with pytest.raises(ValueError, match="not available under trunk_parallel"):
        DeCoT2I(**T2I, quantize="int8", trunk_parallel="tp", device="cpu")
    model = DeCoC2I(**C2I, trunk_parallel="sp", align_layer=1, dtype=torch.float32, device="cpu")
    x, t, y = torch.zeros(1, 32, 32, 3), torch.zeros(1), torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="REPA"):
        model(x, t, y, return_features=True)
    with pytest.raises(ValueError, match="unmasked"):
        model(x, t, y, mask=torch.ones(64, 64, dtype=torch.bool))
    t2i = DeCoT2I(**T2I, trunk_parallel="sp", align_layer=1, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="REPA"):
        t2i(torch.zeros(1, 16, 16, 3), t, torch.zeros(1, 6, 16), return_features=True)
    from deco_tpu_torch.models.layers import sdpa

    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="unmasked"):
        sdpa(q, q, q, mask=torch.ones(4, 4, dtype=torch.bool), impl="ring")
