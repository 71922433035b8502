"""Parity of the port's other c2i families and the REPA taps with the JAX
package's, in fp32 on the CPU: ``NerfBlock``, ``BaselineDiT``,
``PixNerdC2I``, ``PixNerdT2I``, the feature tap of ``DeCoC2I`` and
``DeCoT2I`` (``return_features``/``return_s``), their weight bridges, the
registry nodes of the six REPA configs and the latent codecs.

Sizes are tiny (hidden 128, 2 heads of 64, 2-3 blocks, patch 4, 32 x 32
images); weights are drawn with numpy at unit scale (``redraw``) and cross
over through ``deco_tpu_torch.convert``. Tolerance: every output and every
tapped feature within rtol 1e-4 plus atol 1e-6 x max|ref| (fp32 sums in
another order, a few blocks deep).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deco_tpu.convert import torch_to_flax as jconv
from deco_tpu.models import layers as jl
from deco_tpu.models.dit_c2i_baseline import BaselineDiT as JBaselineDiT
from deco_tpu.models.dit_c2i_deco import DeCoC2I as JDeCoC2I
from deco_tpu.models.dit_c2i_pixnerd import PixNerdC2I as JPixNerdC2I
from deco_tpu.models.dit_t2i import DeCoT2I as JDeCoT2I
from deco_tpu.models.dit_t2i import PixNerdT2I as JPixNerdT2I
from deco_tpu_torch import convert
from deco_tpu_torch.config import registry
from deco_tpu_torch.models import autoencoders, layers
from deco_tpu_torch.models.dit_c2i_baseline import BaselineDiT
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I, init_like_jax_
from deco_tpu_torch.models.dit_c2i_pixnerd import PixNerdC2I
from deco_tpu_torch.models.dit_t2i import DeCoT2I, PixNerdT2I
from deco_tpu_torch.utils import flops
from torch_port_util import redrawn_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
BASE = dict(in_channels=3, patch_size=4, num_groups=2, hidden_size=128, num_classes=10)
BASELINE = dict(BASE, num_blocks=3)
PIXNERD = dict(BASE, hidden_size_x=16, nerf_mlpratio=2, num_blocks=3, num_cond_blocks=2)
DECO = dict(BASE, hidden_size_x=16, num_blocks=4, num_cond_blocks=3)
T2I = dict(in_channels=3, patch_size=4, num_groups=2, hidden_size=128, decoder_hidden_size=16,
           num_encoder_blocks=3, num_text_blocks=1, txt_embed_dim=16, txt_max_length=6)
PIXNERD_T2I = dict(T2I, num_decoder_blocks=2, nerf_mlpratio=2)
DECO_T2I = dict(T2I, num_decoder_blocks=1)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6 * np.abs(ref).max())


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _c2i_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32),
            np.array([0.3, 0.8], np.float32), np.array([1, 7], np.int32))


def _t2i_inputs(seed=3):
    x, t, _ = _c2i_inputs(seed)
    y = np.random.default_rng(seed + 1).standard_normal(
        (2, T2I["txt_max_length"], T2I["txt_embed_dim"])).astype(np.float32)
    return x, t, y


_JAX_RUNS: dict = {}


def _jax(model, inputs, seed=0, **kw):
    """(numpy params redrawn at unit scale, the JAX output of ``inputs``),
    computed once per model, inputs, seed and options."""
    key = (repr(model), tuple(a.tobytes() for a in inputs), seed, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        args = [jnp.asarray(a) for a in inputs]
        params = redrawn_init(model, *args, seed=seed)
        out = jax.jit(functools.partial(model.apply, **kw))(params, *args)
        _JAX_RUNS[key] = (jax.tree_util.tree_map(np.asarray, params),
                          jax.tree_util.tree_map(np.asarray, out))
    return _JAX_RUNS[key]


def _port(cls, kw, sd, **extra):
    model = cls(**kw, dtype=torch.float32, device="cpu", **extra).eval()
    model.load_state_dict(sd, strict=True)
    return model


def _run(model, inputs, **kw):
    x, t, y = inputs
    y = torch.from_numpy(y).long() if y.dtype == np.int32 else _t(y)
    with torch.no_grad():
        return model(_t(x), _t(t), y, **kw)


# ---- NerfBlock ----

@pytest.mark.parametrize("normalize_fc2", [False, True])
def test_nerf_block_matches_jax(normalize_fc2):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16, 16)).astype(np.float32)
    s = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jblock = jl.NerfBlock(mlp_ratio=2, normalize_fc2=normalize_fc2, dtype=jnp.float32)
    params = redrawn_init(jblock, x, s, seed=1)
    ref = jblock.apply(params, x, s)
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    block = layers.NerfBlock(16, 128, 2, normalize_fc2=normalize_fc2)
    block.load_state_dict({"param_generator1.0.weight": _t(p["param_generator1"]["kernel"].T),
                           "param_generator1.0.bias": _t(p["param_generator1"]["bias"]),
                           "norm.weight": _t(p["norm"]["weight"])})
    with torch.no_grad():
        _close(block(_t(x), _t(s)), ref)


def test_nerf_block_floors_a_zero_column():
    """A generated column of zeros stays zero (the 1e-12 floor), not NaN."""
    block = layers.NerfBlock(4, 8, 2, normalize_fc2=True)
    with torch.no_grad():
        block.param_generator1[0].weight.zero_()
        block.param_generator1[0].bias.zero_()
        out = block(torch.ones(1, 2, 4, 4), torch.ones(1, 2, 8))
    assert torch.equal(out, torch.ones(1, 2, 4, 4))


# ---- BaselineDiT ----

@pytest.mark.parametrize("align_layer", [0, 2])
def test_baseline_dit_forward_and_tap_match_jax(align_layer):
    inputs = _c2i_inputs()
    jmodel = JBaselineDiT(**BASELINE, dtype=jnp.float32, align_layer=align_layer)
    params, (ref, feat) = _jax(jmodel, inputs, return_features=True)
    model = _port(BaselineDiT, BASELINE, convert.state_dict_from_jax_baseline(params, 3, 4),
                  align_layer=align_layer)
    out, tap = _run(model, inputs, return_features=True)
    _close(out, ref)
    _close(tap, feat)
    if not align_layer:
        assert not tap.any()
    _close(_run(model, inputs), ref)


def test_baseline_state_dict_is_the_reference_layout():
    """convert_baseline_dit, the JAX reader of the reference FlattenDiT
    state dict, reads the port's state dict back into the same params."""
    params, _ = _jax(JBaselineDiT(**BASELINE, dtype=jnp.float32, align_layer=2), _c2i_inputs(),
                     return_features=True)
    sd = {k: v.numpy() for k, v in convert.state_dict_from_jax_baseline(params, 3, 4).items()}
    back = jconv.convert_baseline_dit(sd, in_channels=3, patch_size=4)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params["params"])


def test_baseline_init_follows_the_jax_initializers():
    model = init_like_jax_(BaselineDiT(**BASELINE, param_dtype=torch.float32, device="cpu"), 0)
    sd = model.state_dict()
    for key in ("final_layer.linear.weight", "final_layer.linear.bias",
                "final_layer.adaLN_modulation.0.weight", "blocks.0.attn.proj.bias"):
        assert not sd[key].any(), key
    bound = (6.0 / (128 + 48)) ** 0.5  # xavier-uniform patch embed
    w = sd["x_embedder.proj.weight"]
    assert w.abs().max() <= bound and w.std() > bound / 3
    assert torch.equal(sd["blocks.1.norm1.weight"], torch.ones(128))


# ---- PixNerdC2I ----

@pytest.mark.parametrize("align_layer", [1, 2])
def test_pixnerd_forward_and_tap_match_jax(align_layer):
    inputs = _c2i_inputs(4)
    jmodel = JPixNerdC2I(**PIXNERD, dtype=jnp.float32, align_layer=align_layer)
    params, (ref, feat) = _jax(jmodel, inputs, seed=1, return_features=True)
    model = _port(PixNerdC2I, PIXNERD, convert.state_dict_from_jax_pixnerd(params, 3, 4),
                  align_layer=align_layer)
    out, tap = _run(model, inputs, return_features=True)
    _close(out, ref)
    _close(tap, feat)
    _close(_run(model, inputs), ref)


def test_pixnerd_state_dict_is_the_reference_layout():
    params, _ = _jax(JPixNerdC2I(**PIXNERD, dtype=jnp.float32, align_layer=1), _c2i_inputs(4),
                     seed=1, return_features=True)
    sd = {k: v.numpy() for k, v in convert.state_dict_from_jax_pixnerd(params, 3, 4).items()}
    assert "blocks.2.param_generator1.0.weight" in sd and "final_layer.norm.weight" in sd
    back = jconv.convert_pixnerd_c2i(sd, in_channels=3, patch_size=4)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params["params"])


def test_pixnerd_decoder_reads_the_trunk():
    """Zeroing the NerfBlocks' weight generators moves the image: the
    hyper-network path carries the trunk's tokens to the pixels."""
    params, _ = _jax(JPixNerdC2I(**PIXNERD, dtype=jnp.float32, align_layer=1), _c2i_inputs(4),
                     seed=1, return_features=True)
    model = _port(PixNerdC2I, PIXNERD, convert.state_dict_from_jax_pixnerd(params, 3, 4))
    inputs = _c2i_inputs()
    full = _run(model, inputs)
    with torch.no_grad():
        model.blocks[2].param_generator1[0].weight.zero_()
    assert (full - _run(model, inputs)).abs().max() > 1e-2 * full.abs().max()


# ---- the DeCo taps ----

@pytest.mark.parametrize("return_s,return_features", [(True, False), (False, True), (True, True)])
def test_deco_c2i_repa_outputs_match_jax(return_s, return_features):
    inputs = _c2i_inputs(5)
    jmodel = JDeCoC2I(**DECO, dtype=jnp.float32, align_layer=2)
    params, ref = _jax(jmodel, inputs, seed=2, return_s=return_s,
                       return_features=return_features)
    model = _port(DeCoC2I, DECO, convert.state_dict_from_jax(params, 3, 4), align_layer=2)
    out = _run(model, inputs, return_s=return_s, return_features=return_features)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        _close(a, b)


@pytest.mark.parametrize("policy", ["full", "dots", "attn", "none"])
def test_deco_c2i_tap_under_each_remat_policy(policy):
    """The tap and the gradient it carries back are those of the run
    without remat, under every trunk remat policy."""
    inputs = _c2i_inputs(5)
    params, _ = _jax(JDeCoC2I(**DECO, dtype=jnp.float32, align_layer=2), inputs, seed=2,
                     return_s=True, return_features=True)
    sd = convert.state_dict_from_jax(params, 3, 4)
    x, t, y = _t(inputs[0]), _t(inputs[1]), torch.from_numpy(inputs[2]).long()
    runs = []
    for remat in (False, True):
        model = _port(DeCoC2I, DECO, sd, align_layer=2, grad_checkpoint=remat,
                      trunk_remat_policy=policy).train()
        out, feat = model(x, t, y, return_features=True)
        (out.square().mean() + feat.square().mean()).backward()
        runs.append((feat.detach(), [p.grad.clone() for p in model.parameters()]))
    (feat0, grads0), (feat1, grads1) = runs
    _close(feat1, feat0.numpy())
    for g1, g0 in zip(grads1, grads0):
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(g0.abs().max()) + 1e-12)


@pytest.mark.parametrize("align_layer", [1, 3])
def test_deco_t2i_tap_matches_jax(align_layer):
    inputs = _t2i_inputs()
    jmodel = JDeCoT2I(**DECO_T2I, dtype=jnp.float32, align_layer=align_layer)
    params, (ref, feat) = _jax(jmodel, inputs, return_features=True)
    model = _port(DeCoT2I, DECO_T2I, convert.state_dict_from_jax_t2i(params, 3, 4),
                  align_layer=align_layer)
    out, tap = _run(model, inputs, return_features=True)
    _close(out, ref)
    _close(tap, feat)


# ---- PixNerdT2I ----

def test_pixnerd_t2i_matches_jax():
    inputs = _t2i_inputs(7)
    jmodel = JPixNerdT2I(**PIXNERD_T2I, dtype=jnp.float32, align_layer=2)
    params, (ref, feat) = _jax(jmodel, inputs, seed=4, return_features=True)
    model = _port(PixNerdT2I, PIXNERD_T2I, convert.state_dict_from_jax_pixnerd_t2i(params, 3, 4),
                  align_layer=2)
    out, tap = _run(model, inputs, return_features=True)
    _close(out, ref)
    _close(tap, feat)
    _close(_run(model, inputs), ref)


def test_pixnerd_t2i_state_dict_is_the_reference_layout():
    params, _ = _jax(JPixNerdT2I(**PIXNERD_T2I, dtype=jnp.float32, align_layer=2), _t2i_inputs(7),
                     seed=4, return_features=True)
    sd = {k: v.numpy() for k, v in convert.state_dict_from_jax_pixnerd_t2i(params, 3, 4).items()}
    back = jconv.convert_deco_t2i(sd, in_channels=3, patch_size=4, num_encoder_blocks=3,
                                  num_text_blocks=1, pixnerd=True)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params["params"])


# ---- the registry, the codecs, the FLOPs ----

TINY_NODES = {
    "dit_c2i_baseline.FlattenDiT": dict(hidden_size=128, num_groups=2, num_blocks=3,
                                        patch_size=4),
    "dit_c2i_pixnerd.PixNerDiT": dict(hidden_size=128, num_groups=2, num_blocks=3,
                                      num_cond_blocks=2, hidden_size_x=16, patch_size=4),
    "dit_c2i_DeCo.PixNerDiT": dict(hidden_size=128, num_groups=2, num_blocks=3,
                                   num_cond_blocks=2, hidden_size_x=16, patch_size=4),
    "dit_t2i_DeCo.PixNerDiT": dict(hidden_size=128, num_groups=2, num_encoder_blocks=2,
                                   num_text_blocks=1, decoder_hidden_size=8,
                                   num_decoder_blocks=1, txt_embed_dim=16, txt_max_length=6,
                                   patch_size=4),
}


@pytest.mark.parametrize("path,trainer_cls,align", [
    ("configs_c2i/Baseline_DiT.yaml", "REPATrainer", 8),
    ("configs_c2i/Baseline_DiT_JiT.yaml", "JiTTrainer", 8),
    ("configs_c2i/Baseline_PixNerd.yaml", "REPATrainer", 8),
    ("configs_c2i/DeCo_large.yaml", "DeCoTrainer", 8),
    ("configs_t2i/pretraining_res256.yaml", "DeCoTrainer", 6),
    ("configs_t2i/pretraining_res512.yaml", "DeCoTrainer", 6),
])
def test_repa_configs_build_through_the_registry(path, trainer_cls, align):
    """Each config's denoiser (at a tiny width) and trainer nodes build; the
    trainer keeps its DINOv2 node (weight_path null: a random 1-layer tower
    on the CPU), built with it for the REPA trainers, which own a projection
    to 768, and at its first call for the DeCo trainer, which never runs it."""
    config = registry.load_yaml(os.path.join(REPO, path))
    node = config["model"]["denoiser"]
    kind = node["class_path"].split("transformer.")[1]
    model = registry.instantiate({**node, "init_args": {**node["init_args"],
                                                        **TINY_NODES[kind], "device": "cpu"}})
    assert model.hidden_size == 128
    tnode = config["model"]["diffusion_trainer"]
    enc = tnode["init_args"]["encoder"]
    assert enc["class_path"] == "src.models.encoder.DINOv2"
    enc["init_args"].update(weight_path=None, num_layers=1, device="cpu")
    if trainer_cls == "DeCoTrainer":
        trainer = registry.instantiate(tnode)
        assert isinstance(trainer.encoder, registry.Deferred) and trainer.encoder.built is None
        with pytest.warns(UserWarning, match="random weights"):
            encoder = trainer.encoder.build()
    else:
        with pytest.warns(UserWarning, match="random weights"):
            trainer = registry.instantiate(tnode)
        encoder = trainer.encoder
    assert type(trainer).__name__ == trainer_cls and trainer.align_layer == align
    assert type(encoder).__name__ == "DINOv2"
    assert not any(p.requires_grad for p in encoder.parameters())
    if trainer_cls == "DeCoTrainer":
        assert trainer.proj_module is None and trainer.metadata_keys == ()
    else:
        assert trainer.proj_module.proj[0][4].out_features == 768
        assert trainer.metadata_keys == ("repa_features", "raw_image")


def test_shipped_dinov2_weight_path_is_read_not_dropped():
    """The encoder node keeps weight_path (the registry drops it elsewhere):
    the shipped path, absent here, raises naming the file."""
    config = registry.load_yaml(os.path.join(REPO, "configs_c2i/Baseline_DiT.yaml"))
    enc = config["model"]["diffusion_trainer"]["init_args"]["encoder"]
    with pytest.raises(FileNotFoundError, match="dinov2_vitb14_pretrain.pth"):
        registry.instantiate({**enc, "init_args": {**enc["init_args"], "device": "cpu"}})


def test_latent_codecs_wrap_injected_functions():
    ae = registry.instantiate({"class_path": "src.models.autoencoder.latent.LatentAE",
                               "init_args": {}})
    with pytest.raises(NotImplementedError, match="encode_fn"):
        ae.encode(torch.zeros(1))
    ae = autoencoders.LatentAE(encode_fn=lambda x: x + 1, decode_fn=lambda z: z * 2,
                               scale=0.5, shift=0.25)
    x = torch.tensor([1.0, 3.0])
    assert torch.equal(ae.encode(x), (x + 1) * 0.5 + 0.25)
    assert torch.equal(ae.decode(x), (x - 0.25) / 0.5 * 2)
    pre = autoencoders.DCLatentAE(precompute=True)
    assert pre.scale == 0.41407 and torch.allclose(pre.encode(x), x * 0.41407)
    # the DC-AE network is ported (tests/test_torch_dcae.py): an empty state
    # dict now raises naming the keys it lacks
    with pytest.raises(ValueError, match="encoder"):
        autoencoders.DCLatentAE.from_torch_state({}, device="cpu")


def test_flops_of_the_new_families():
    """The baseline's FLOPs are its trunk plus its embed and final layer;
    PixNerd's decoder and the ViT-B/14 forward at 224 px are counted."""
    trunk = 24 * flops.dit_block_flops(256, 1024, int(2 / 3 * 4 * 1024))
    embed = 2 * 256 * 768 * 1024
    final = 2 * 1024 * 2048 + 2 * 256 * 1024 * 768
    assert flops.baseline_dit_flops() == pytest.approx(trunk + embed + final)
    assert flops.pixnerd_c2i_flops() > 22 / 24 * trunk
    assert flops.vit_flops() == pytest.approx(2 * 86e6 * 257, rel=0.1)  # ~2 x params x tokens
