"""DeCo class-to-image model (``deco_tpu/models/dit_c2i_deco.py`` ``DeCoC2I``).

A DiT trunk of ``num_cond_blocks`` adaLN blocks (RoPE + qk-RMSNorm attention,
SwiGLU) over patch tokens, followed by a per-patch pixel decoder
(``SimpleMLPAdaLN``, ``num_blocks - num_cond_blocks`` res blocks). The trunk
is a Python loop over an ``nn.ModuleList``; its state-dict keys are those of
the reference torch model, so ``convert.state_dict_from_jax`` output and
reference-layout checkpoints load with ``strict=True``.

``grad_checkpoint`` recomputes each trunk block and each decoder res block
in the backward, as ``nn.remat`` does in ``run_dit_blocks`` and
``SimpleMLPAdaLN``. ``trunk_remat_policy`` says what a trunk block keeps:
"full" nothing, "dots" its matmul outputs, "attn" its attention's output and
logsumexp, "none" everything (no trunk remat). ``decoder_chunks > 1`` runs
the pixel decoder over that many patch chunks, each recomputed whole
(``layers.run_pixel_decoder``). ``param_dtype`` (default: ``dtype``) is the
storage type of the parameters: fp32 for training, the compute dtype for
sampling.

The REPA outputs: ``return_features`` also returns the trunk's tokens after
block ``align_layer`` (1-based; zeros when it is 0 or past the trunk), the
tap of ``run_dit_blocks``, which works under every remat policy since a
block's output is kept as the next block's input; ``return_s`` also returns
the decoder's condition s, (B, H/p, W/p, hidden). With both, the order is
(image, s, features), as in the JAX model.

Not ported, and rejected when asked for: ``quantize`` and ``trunk_parallel``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import layers
from deco_tpu_torch.models.patching import patchify, unpatchify

# constructor fields of the JAX model that the port does not implement,
# with the value that means "off"
_UNPORTED = {
    "trunk_parallel": "none",
    "quantize": None,
}


def channel_major(x_patches, patch_size: int, in_channels: int):
    """Pixel-major patches (B, L, P*P*C) in the channel-major order of torch
    ``unfold``, (B, L, C*P*P): the input order of the reference embedders'
    weights."""
    b, n, _ = x_patches.shape
    return x_patches.reshape(b, n, patch_size * patch_size, in_channels).transpose(2, 3) \
        .reshape(b, n, -1)


def _rope_tables(self, grid_h: int, grid_w: int, device):
    """The trunk's RoPE (cos, sin) for a grid, cached on ``device``; a method
    of the c2i models, whose ``hidden_size``, ``num_groups`` and
    ``rope_scale`` it reads."""
    key = (grid_h, grid_w, device)
    if key not in self._rope_cache:
        cos, sin = layers.precompute_rope_2d(
            self.hidden_size // self.num_groups, grid_h, grid_w, scale=self.rope_scale)
        self._rope_cache[key] = (torch.from_numpy(cos).to(device),
                                 torch.from_numpy(sin).to(device))
    return self._rope_cache[key]


def run_dit_blocks(blocks, x, c, rope, mask=None, *, align_layer=None,
                   enabled: bool = False, policy: str = "full"):
    """The trunk (``run_dit_blocks``): each block under
    :func:`layers.run_checkpointed` (``enabled``, ``policy``); returns
    (x, feat), feat the output of block ``align_layer`` (1-based), zeros when
    ``align_layer`` is 0 or past the trunk, and None when it is None (no tap)."""
    feat = None
    for i, block in enumerate(blocks):
        x = layers.run_checkpointed(block, x, c, rope, mask, enabled=enabled, policy=policy)
        if align_layer is not None and i == align_layer - 1:
            feat = x
    if align_layer is not None and feat is None:
        feat = torch.zeros_like(x)
    return x, feat


class DeCoC2I(nn.Module):
    """Frequency-decoupled pixel-diffusion DiT (c2i).

    DeCo-XL/16: in_channels=3, patch_size=16, num_groups=16, hidden_size=1152,
    hidden_size_x=32, num_blocks=31, num_cond_blocks=28. ``dtype`` is the
    compute dtype, ``param_dtype`` the parameters' (default ``dtype``);
    ``device`` defaults to CUDA and raises where there is none.
    """

    def __init__(self, in_channels: int = 3, patch_size: int = 16,
                 num_groups: int = 12, hidden_size: int = 1152,
                 hidden_size_x: int = 64, nerf_mlpratio: int = 4,
                 num_blocks: int = 18, num_cond_blocks: int = 4,
                 num_classes: int = 1000, max_freqs: int = 8,
                 dtype=torch.bfloat16, rope_scale: float = 16.0,
                 param_dtype=None, grad_checkpoint: bool = False,
                 trunk_remat_policy: str = "full", decoder_chunks: int = 0,
                 align_layer: int = 0, device="cuda", **unported):
        super().__init__()
        if trunk_remat_policy not in (*layers.REMAT_POLICIES, "none"):
            raise ValueError(
                f"DeCoC2I: trunk_remat_policy={trunk_remat_policy!r}; expected one of "
                f"{sorted((*layers.REMAT_POLICIES, 'none'))}")
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"DeCoC2I: unexpected argument {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"DeCoC2I: {name}={value!r} is not ported to deco_tpu_torch")
        del nerf_mlpratio  # accepted for config parity, unused by this decoder
        dev = resolve_device(device)
        self.in_channels = in_channels
        self.patch_size = patch_size
        self.num_groups = num_groups
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.rope_scale = rope_scale
        self.trunk_checkpoint = grad_checkpoint and trunk_remat_policy != "none"
        self.trunk_remat_policy = trunk_remat_policy
        self.decoder_chunks = decoder_chunks
        self.align_layer = align_layer
        self._rope_cache: dict = {}
        p2c = patch_size * patch_size * in_channels
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        with dev:
            self.s_embedder = layers.Embed(p2c, hidden_size, **kw)
            self.t_embedder = layers.TimestepEmbedder(hidden_size, **kw)
            self.y_embedder = layers.LabelEmbedder(num_classes + 1, hidden_size, **kw)
            self.blocks = nn.ModuleList(
                layers.FlattenDiTBlock(hidden_size, num_groups, **kw)
                for _ in range(num_cond_blocks))
            self.x_embedder = layers.NerfEmbedder(
                in_channels, hidden_size_x, patch_size, max_freqs=max_freqs, **kw)
            self.dec_net = layers.SimpleMLPAdaLN(
                in_channels=hidden_size_x, model_channels=hidden_size_x,
                out_channels=in_channels, z_channels=hidden_size,
                num_res_blocks=num_blocks - num_cond_blocks, patch_size=patch_size,
                grad_checkpoint=grad_checkpoint, **kw)
        self.to(dev)  # buffers made from numpy start on the CPU

    _rope = _rope_tables

    def forward(self, x, t, y, s=None, mask=None, return_s: bool = False,
                return_features: bool = False):
        """x: (B, H, W, C) NHWC; t: (B,) in [0, 1]; y: (B,) int class labels.

        Returns the (B, H, W, C) float32 network output, followed by s and
        the tapped features when asked for (see the module docstring; the
        features are None when ``s`` is given).
        """
        b, h, w, _ = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x_patches = patchify(x, p).to(self.dtype)  # (B, L, P*P*C), pixel-major

        t_emb = self.t_embedder(t.reshape(-1)).reshape(b, 1, self.hidden_size)
        y_emb = self.y_embedder(y).reshape(b, 1, self.hidden_size)
        c = F.silu(t_emb + y_emb)

        feat = None
        if s is None:
            s = self.s_embedder(channel_major(x_patches, p, self.in_channels))
            s, feat = run_dit_blocks(self.blocks, s, c, self._rope(gh, gw, x.device), mask,
                                     align_layer=self.align_layer if return_features else None,
                                     enabled=self.trunk_checkpoint,
                                     policy=self.trunk_remat_policy)
            s = F.silu(t_emb + s)

        x_pix = x_patches.reshape(b, gh * gw, p * p, self.in_channels)
        out = layers.run_pixel_decoder(self.dec_net, self.x_embedder(x_pix), s,
                                       self.decoder_chunks)
        out = out.reshape(b, gh * gw, p * p * self.in_channels)
        img = unpatchify(out.float(), gh, gw, p)
        extra = ((s.reshape(b, gh, gw, self.hidden_size),) if return_s else ()) + (
            (feat,) if return_features else ())
        return (img, *extra) if extra else img


def init_random_(model: nn.Module, seed: int, scale: float = 1.0) -> nn.Module:
    """Overwrite every parameter with seeded random values, in place.

    Weights get ``normal * scale / sqrt(fan_in)``, biases
    ``normal * scale / sqrt(width)``, and norm scales ``1 + normal * scale /
    sqrt(width)``. No parameter stays zero, so the zero-initialised heads
    (the decoder's final linear and adaLN modulations) carry signal; at
    scale 1 the trunk's attention visibly moves the output, where at 0.2 its
    share falls under an fp32 tolerance. The numbers are drawn on the CPU
    from ``seed``, so a model on any device gets the same values.
    """
    gen = torch.Generator().manual_seed(seed)
    norms = {m for m in model.modules() if isinstance(m, (layers.RMSNorm, layers.LayerNorm))}
    with torch.no_grad():
        for module in model.modules():
            for name, param in module.named_parameters(recurse=False):
                r = torch.randn(param.shape, generator=gen) * scale / param.shape[-1] ** 0.5
                if module in norms and name == "weight":
                    r += 1.0
                param.copy_(r)
    return model


# parameters whose JAX initializer is xavier_uniform / normal(0.02) /
# normal(1.0) / zeros, in DeCoC2I, DeCoT2I, BaselineDiT and PixNerdC2I;
# every other weight is a
# default nn.Dense kernel (lecun_normal), every bias is zero and every norm
# scale one
_XAVIER = ("s_embedder.proj.weight", "y_embedder.proj.weight", "x_embedder.embedder.0.weight",
           "x_embedder.proj.weight",
           "dec_net.input_proj.weight", "dec_net.cond_embed.weight", ".mlp.0.weight",
           ".mlp.2.weight")
_NORMAL_002 = ("y_embedder.embedding_table.weight", "t_embedder.mlp.0.weight",
               "t_embedder.mlp.2.weight")
_NORMAL_1 = ("y_pos_embedding",)
_ZEROS = (".adaLN_modulation.1.weight", "final_layer.linear.weight",
          "final_layer.adaLN_modulation.0.weight")


def init_like_jax_(model: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of a ``DeCoC2I``, ``DeCoT2I``, ``BaselineDiT``
    or ``PixNerdC2I`` from the distribution the JAX model's initializers use
    for it (the reference model's): lecun-normal (truncated) trunk kernels
    and NerfBlock weight generators, xavier-uniform embedders and decoder
    MLPs, normal(0.02) label table and timestep MLP, normal(1.0) text
    position table, zero biases, zero decoder modulations, zero final
    linears and final adaLN modulation, unit norm scales. The values come from a CPU generator
    seeded with ``seed``, so they do not depend on the device; they are not
    the JAX package's values (another generator)."""
    gen = torch.Generator().manual_seed(seed)
    norms = {m for m in model.modules() if isinstance(m, (layers.RMSNorm, layers.LayerNorm))}
    with torch.no_grad():
        for module_name, module in model.named_modules():
            for pname, param in module.named_parameters(recurse=False):
                name = f"{module_name}.{pname}"
                r = torch.empty(param.shape, dtype=torch.float32)
                if module in norms and pname == "weight":
                    r.fill_(1.0)
                elif pname == "bias" or name.endswith(_ZEROS):
                    r.zero_()
                elif name.endswith(_NORMAL_002):
                    r.normal_(0.0, 0.02, generator=gen)
                elif name.endswith(_NORMAL_1):
                    r.normal_(0.0, 1.0, generator=gen)
                elif name.endswith(_XAVIER):
                    fan_out, fan_in = param.shape
                    bound = (6.0 / (fan_in + fan_out)) ** 0.5
                    r.uniform_(-bound, bound, generator=gen)
                else:  # flax lecun_normal: truncated at 2 std, rescaled to unit variance
                    std = (1.0 / param.shape[1]) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(r, 0.0, std, -2 * std, 2 * std, generator=gen)
                param.copy_(r)
    return model

