"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Inputs and parameters are drawn with numpy from a seed and handed to both
the JAX package and the port as numpy arrays.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deco_tpu.models.dit_c2i_deco import DeCoC2I as JaxDeCoC2I
from deco_tpu.models.dit_t2i import DeCoT2I as JaxDeCoT2I
from deco_tpu_torch.convert import state_dict_from_jax
from deco_tpu_torch.models import inception
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I

# hidden 144 over 2 heads: head_dim 72, the DeCo-XL head width
TINY_C2I = dict(in_channels=3, patch_size=4, num_groups=2, hidden_size=144,
                hidden_size_x=16, num_blocks=4, num_cond_blocks=2, num_classes=10)
TINY_IMAGE = 16
# tests/test_serve.py's tiny t2i model: hidden 32 over 2 heads, 2 joint and
# 1 text blocks, patch 4, 6 text tokens of 16
TINY_T2I = dict(in_channels=3, patch_size=4, num_groups=2, hidden_size=32,
                decoder_hidden_size=8, num_encoder_blocks=2, num_decoder_blocks=1,
                num_text_blocks=1, txt_embed_dim=16, txt_max_length=6)

# Under pytest-xdist every worker would start one torch thread per core: six
# workers on eight cores run ~48 compute threads, and each big CPU product
# waits on threads that the other workers hold. A worker takes its share.
_ALL_CORES = torch.get_num_threads()
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


@contextlib.contextmanager
def all_cores():
    """Torch on every core inside, as in a one-process run. For the parity
    tests whose tolerances hold only at that thread count's summation order:
    with fewer threads the port's side moves past them (one thread: a VAE-GAN
    step's metric 8.1e-5 relative against its 1e-5, a train step's parameter
    1.05e-4 against 1e-4; two and four threads fail the latter too)."""
    capped = torch.get_num_threads()
    torch.set_num_threads(_ALL_CORES)
    try:
        yield
    finally:
        torch.set_num_threads(capped)


# XLA:CPU without its LLVM optimisations: a test's program compiles in ~60%
# of the time and runs the same fp32 operations (tests/test_torch_uniflow.py
# measured 7.7 s -> 4.8 s on a UniFlow train step)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def fast_jit(fn, **jit_kwargs):
    """``jax.jit(fn)`` whose programs compile with :data:`FAST_COMPILE`, one
    executable per pytree structure and leaf shape/dtype of the arguments."""
    jitted = jax.jit(fn, **jit_kwargs)
    compiled = {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(FAST_COMPILE)
        return compiled[key](*args)

    return call


def redraw(params, seed: int, scale: float = 1.0):
    """Every leaf of a Flax param tree redrawn from ``seed`` (numpy).

    Kernels (..., in, out) get normal * scale / sqrt(in); other leaves
    normal * scale / sqrt(width), plus 1 for norm scales (``weight`` of
    RMSNorm, ``scale`` of LayerNorm). No leaf stays zero, so zero-initialised
    heads carry signal. At scale 1 attention moves the tiny model's output
    by ~18%; at 0.2 its share fell to ~4e-6, under the fp32 tolerance, and a
    parity test could not have seen it.
    """
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        fan_in = shape[-2] if name == "kernel" else shape[-1]
        r = rng.standard_normal(shape).astype(np.float32) * scale / np.sqrt(fan_in)
        if name in ("weight", "scale"):
            r += 1.0
        return jnp.asarray(r)

    return jax.tree_util.tree_map_with_path(draw, params)


def redrawn_init(module, *args, seed: int = 0, scale: float = 1.0):
    """``redraw`` of ``module.init(PRNGKey(0), *args)``'s tree. Every leaf is
    redrawn, so only the tree's shapes are needed: they come from
    ``jax.eval_shape`` (~0.3 s), not from a compiled init (2-4 s each)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return redraw(shapes, seed, scale)


def tiny_jax_c2i(seed: int = 0, dtype=jnp.float32):
    """(JAX DeCoC2I module, redrawn params) at the tiny config."""
    model = JaxDeCoC2I(**TINY_C2I, dtype=dtype)
    x = jnp.zeros((1, TINY_IMAGE, TINY_IMAGE, 3), jnp.float32)
    return model, redrawn_init(model, x, jnp.zeros((1,)), jnp.zeros((1,), jnp.int32), seed=seed)


def tiny_jax_t2i(seed: int = 0, dtype=jnp.float32):
    """(JAX DeCoT2I module, redrawn params) at the tiny t2i config."""
    model = JaxDeCoT2I(**TINY_T2I, dtype=dtype)
    return model, redrawn_init(
        model, jnp.zeros((1, TINY_IMAGE, TINY_IMAGE, 3), jnp.float32), jnp.zeros((1,)),
        jnp.zeros((1, TINY_T2I["txt_max_length"], TINY_T2I["txt_embed_dim"])), seed=seed)


def port_c2i_from_jax(params, dtype=torch.float32) -> DeCoC2I:
    """The port's DeCoC2I on the CPU, loaded from JAX params through convert."""
    model = DeCoC2I(**TINY_C2I, dtype=dtype, device="cpu").eval()
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             in_channels=TINY_C2I["in_channels"],
                             patch_size=TINY_C2I["patch_size"])
    model.load_state_dict(sd, strict=True)
    return model


@functools.lru_cache(maxsize=None)
def inception_state_dict():
    """An InceptionV3 state dict in the pytorch-fid / torchvision layout from a
    numpy seed: He-normal convs, BatchNorm statistics and affines away from
    the identity, ``num_batches_tracked``, and the ``AuxLogits``/``fc``
    heads a real file carries (the JAX converter reads ``AuxLogits`` too)."""
    rng = np.random.default_rng(0)
    sd = {}
    for key, value in inception.InceptionV3Features().state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("conv.weight"):
            arr = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif key.endswith("running_var"):
            arr = 1.0 + 0.2 * np.abs(rng.standard_normal(shape))
        elif key.endswith("bn.weight"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:  # bn.bias, running_mean
            arr = 0.1 * rng.standard_normal(shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))
        if key.endswith("running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                       ("running_var", 1.0)):
        sd[f"AuxLogits.conv0.bn.{name}"] = torch.full((128,), fill)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    return sd


def randomize_(module, seed: int, scale: float = 1.0):
    """Every parameter drawn from ``seed``: weights normal x scale /
    sqrt(fan in), norm weights 1 + 0.1 normal, biases 0.1 normal."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if p.dim() >= 2:
                p.copy_(r * scale / p[0].numel() ** 0.5)
            elif name.endswith("weight") and "norm" in name:
                p.copy_(1.0 + 0.1 * r)
            else:
                p.copy_(0.1 * r)
    return module


def numpy_state(module) -> dict:
    """A copy of the state dict as numpy arrays (not views of the parameters)."""
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
