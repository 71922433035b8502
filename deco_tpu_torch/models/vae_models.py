"""The VAE-GAN's generator, InternViT encoder -> DC-AE decoder, and the DC-AE
decoder eval model (``deco_tpu/models/vae_models.py``).

- :class:`DCDownsampleMLP`: a channel projection with the group-mean
  shortcut and a residual LayerNorm-GELU MLP;
- :class:`LatentConnectorModule`: three RMSNorm-SiLU residual MLP blocks and
  a final projection;
- :class:`VAEModel`: the ViT's layer-18 tap, the x0.5 token shuffle,
  ``gen_mlp1``, the latent projector (with ``stochastic`` a diagonal
  Gaussian posterior and its KL), the 32-channel latent grid, the DC-AE
  decoder and the 14/16 bilinear resize; the last hidden state through
  ``mlp1`` gives the student features of the distillation term;
- :class:`DCAEDecoderEval`: frozen-encoder features (``models/internvl.py``
  ``InternVLVision``) -> three LayerNorm-GELU residual blocks -> a
  32-channel MLP -> the DC-AE decoder.

Parameter names are the reference torch layout that the JAX package's
``convert_vae_encoder`` reads (``vision_model.*``, ``mlp1.{0,1,3}``,
``gen_mlp1.channel_proj``, ``gen_mlp1.mlp.{0,1,3}``,
``latent_projector.mlp_blocks.{i}.norm``/``.mlp.{0,2}``,
``latent_projector.final_proj``) and the diffusers layout of the decoder
(``models/dcae.py``). Parameters are fp32 and the compute runs in ``dtype``
(bf16 by default), as the Flax modules' ``dtype`` with fp32 parameters.

:func:`resize_bilinear` is ``jax.image.resize(..., "bilinear")``: a
triangle kernel at half-pixel centres, widened by the scale on a downscale
(antialiasing), weights normalised per output sample, applied as two
products with weights in the input's dtype.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import layers as L
from deco_tpu_torch.models.dcae import DCAEDecoder, DCRMSNorm
from deco_tpu_torch.models.internvl import INTERNVIT, mlp1_connector
from deco_tpu_torch.models.uniflow import vit as vit_lib
from deco_tpu_torch.models.uniflow.components import resample_tokens
from deco_tpu_torch.parallel import mesh as mesh_lib

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
DECODER_CHANNELS = (128, 256, 512, 512, 1024, 1024)


@functools.lru_cache(maxsize=32)
def bilinear_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of ``jax.image.resize``'s bilinear
    along one axis (``compute_weight_mat`` with antialias)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = np.maximum(0.0, 1.0 - dist / np.float32(kernel_scale)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0.0).T.astype(np.float32))


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, height, width, C), "bilinear")`` of NHWC ``x``."""
    if (x.shape[1], x.shape[2]) == (height, width):
        return x
    wh = torch.from_numpy(bilinear_resize_weights(x.shape[1], height)).to(x.device, x.dtype)
    ww = torch.from_numpy(bilinear_resize_weights(x.shape[2], width)).to(x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", wh, x)
    return torch.einsum("pw,bowc->bopc", ww, x)


class ResidualMLPBlock(nn.Module):
    """LayerNorm (eps 1e-6), linear, exact GELU, linear (zero-initialised in
    JAX), residual: the DC-AE eval model's block."""

    def __init__(self, dim: int, expansion_ratio: int = 4, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.norm = L.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.fc1 = L.Linear(dim, dim * expansion_ratio, **kw)
        self.fc2 = L.Linear(dim * expansion_ratio, dim, **kw)

    def forward(self, x):
        return x + self.fc2(F.gelu(self.fc1(self.norm(x))))


class RMSResidualMLPBlock(nn.Module):
    """RMSNorm, linear, SiLU, linear (zero-initialised in JAX), residual: the
    latent connector's block."""

    def __init__(self, dim: int, expansion_ratio: int = 4, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.norm = L.RMSNorm(dim)
        self.mlp = nn.Sequential(L.Linear(dim, dim * expansion_ratio, **kw), nn.SiLU(),
                                 L.Linear(dim * expansion_ratio, dim, **kw))

    def forward(self, x):
        return x + self.mlp(self.norm(x))


class LatentConnectorModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, expansion_ratio: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.mlp_blocks = nn.ModuleList(
            RMSResidualMLPBlock(in_channels, expansion_ratio, dtype) for _ in range(3))
        self.final_proj = (L.Linear(in_channels, out_channels, dtype=dtype,
                                    param_dtype=torch.float32)
                           if in_channels != out_channels else None)

    def forward(self, x):
        for block in self.mlp_blocks:
            x = block(x)
        return x if self.final_proj is None else self.final_proj(x)


class DCDownsampleMLP(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.out_channels, self.shortcut = out_channels, shortcut
        self.channel_proj = L.Linear(in_channels, out_channels, **kw)
        self.mlp = nn.Sequential(L.LayerNorm(out_channels, eps=1e-5, dtype=dtype),
                                 L.Linear(out_channels, out_channels, **kw), nn.GELU(),
                                 L.Linear(out_channels, out_channels, **kw))

    def forward(self, x):
        h = self.channel_proj(x)
        if self.shortcut:
            group = x.shape[-1] // self.out_channels
            h = h + x.reshape(*x.shape[:-1], self.out_channels, group).mean(-1)
        return h + self.mlp(h)


class VAEModel(nn.Module):
    """InternViT encoder -> latent grid -> DC-AE decoder; ``stochastic`` adds
    the posterior (``encoder_ae.py``), whose KL the extras carry.

    ``forward(x, generator=None, noise=None)`` takes images (B, H, W, 3) in
    [-1, 1] (H and W multiples of 2 x patch) and returns (reconstruction
    (B, H, W, 3) in ``dtype``, extras): ``student_features`` always, ``kl``
    when stochastic. The posterior sample takes ``noise`` (the latent's
    shape), else draws it from ``generator``; with neither it is the mean,
    as JAX without a key.
    ``device`` defaults to CUDA and raises where there is none.
    """

    def __init__(self, vit: vit_lib.ViTConfig = INTERNVIT, llm_hidden_size: int = 1536,
                 latent_channel: int = 32, gen_select_layer: int = 18, stochastic: bool = False,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 decoder_layers: Sequence[int] = (3, 3, 3, 3, 3, 3),
                 decoder_attn: Sequence[bool] = (False, False, False, True, True, True),
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.vit = vit
        self.dtype = dtype
        self.latent_channel = latent_channel
        self.stochastic = stochastic
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        vh = vit.hidden_size
        with dev:
            self.vision_model = vit_lib.VisionModel(vit, select_layer=gen_select_layer, **kw)
            self.mlp1 = mlp1_connector(vh, llm_hidden_size, kw)
            self.gen_mlp1 = DCDownsampleMLP(4 * vh, 2 * vh, dtype=dtype)
            self.latent_projector = LatentConnectorModule(
                2 * vh, latent_channel * (2 if stochastic else 1), expansion_ratio=1, dtype=dtype)
            self.decoder = DCAEDecoder(latent_channel, 3, tuple(decoder_channels),
                                       tuple(decoder_layers), tuple(decoder_attn), dtype=dtype)
            self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
            self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    def vit_features(self, x):
        """(last hidden, the layer-18 tap), each without the class token."""
        last, tapped = self.vision_model((x * 0.5 + 0.5 - self.mean) / self.std)
        return last[:, 1:], tapped[:, 1:]

    def encode_latent(self, gen_features, generator=None, noise=None):
        latent = self.latent_projector(gen_features)
        extras = {}
        if self.stochastic:
            mean, logvar = latent.chunk(2, dim=-1)
            logvar = logvar.clamp(-30.0, 20.0)
            # diffusers' DiagonalGaussianDistribution.kl(): 0.5 x the sum over
            # the latent's tokens and channels per sample, then the batch mean
            extras["kl"] = (0.5 * (torch.exp(logvar) + mean.float() ** 2 - 1.0 - logvar)
                            .sum(dim=(1, 2))).mean()
            if noise is None and generator is not None:
                noise = mesh_lib.sample(generator, mean.shape, mean.device)
            latent = mean if noise is None else mean + torch.exp(0.5 * logvar) * noise.to(
                mean.dtype)
        return latent, extras

    def decode_latent(self, latent_tokens):
        """(B, N, latent) tokens -> image, with the 14/16 bilinear rescale
        (the patch-14 grid decoded at the decoder's f32)."""
        b, n, c = latent_tokens.shape
        grid = int(round(np.sqrt(n)))
        img = self.decoder(latent_tokens.reshape(b, grid, grid, c))
        return resize_bilinear(img, int(img.shape[1] * 14 / 16), int(img.shape[2] * 14 / 16))

    def forward(self, x, generator: Optional[torch.Generator] = None, noise=None):
        last, tapped = self.vit_features(x)
        gen_features = self.gen_mlp1(resample_tokens(tapped, 0.5))
        latent, extras = self.encode_latent(gen_features, generator, noise)
        recon = self.decode_latent(latent)
        extras["student_features"] = self.mlp1(resample_tokens(last, 0.5))
        return recon, extras


class DCAEDecoderEval(nn.Module):
    """Frozen-encoder features (B, N, llm_hidden_size) -> image: three
    :class:`ResidualMLPBlock`, LayerNorm, a GELU MLP down to the latent
    channels, the grid, the DC-AE decoder (no resize)."""

    def __init__(self, llm_hidden_size: int = 3200, latent_channel: int = 32,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 decoder_layers: Sequence[int] = (3, 3, 3, 3, 3, 3),
                 decoder_attn: Sequence[bool] = (False, False, False, True, True, True),
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        with resolve_device(device):
            self.down_blocks = nn.ModuleList(ResidualMLPBlock(llm_hidden_size, 1, dtype)
                                             for _ in range(3))
            self.down_norm = L.LayerNorm(llm_hidden_size, eps=1e-5, dtype=dtype)
            self.down_fc1 = L.Linear(llm_hidden_size, latent_channel, **kw)
            self.down_fc2 = L.Linear(latent_channel, latent_channel, **kw)
            self.decoder = DCAEDecoder(latent_channel, 3, tuple(decoder_channels),
                                       tuple(decoder_layers), tuple(decoder_attn), dtype=dtype)

    def forward(self, vit_embeds):
        h = vit_embeds
        for block in self.down_blocks:
            h = block(h)
        h = self.down_fc2(F.gelu(self.down_fc1(self.down_norm(h))))
        b, n, c = h.shape
        grid = int(round(np.sqrt(n)))
        return self.decoder(h.reshape(b, grid, grid, c))


# parameters that the Flax modules initialise to zeros (the residual MLPs'
# last layers), by name suffix
_ZEROS = ("gen_mlp1.mlp.3.weight", ".mlp.2.weight", ".fc2.weight")


@torch.no_grad()
def init_like_jax_(model: nn.Module, seed: int) -> nn.Module:
    """Draw the parameters from the Flax initializers' distributions:
    lecun-normal (truncated) kernels over their fan-in (convolutions
    included), zero biases, unit norm scales, the residual MLPs' last layers
    zero, and in a ViT tower normal(1.0) class and position embeddings and
    LayerScale kept at ``initializer_factor`` (``vit.init_like_jax_``'s
    rules). The values come from a generator on the parameters' device
    seeded with ``seed`` (half a billion draws take ~30 s on one CPU core);
    they are not the JAX package's."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    norms = (L.RMSNorm, L.LayerNorm, DCRMSNorm, nn.GroupNorm)
    for name, module in model.named_modules():
        for pname, param in module.named_parameters(recurse=False):
            if isinstance(module, norms):
                param.fill_(1.0 if pname == "weight" else 0.0)
            elif pname in ("ls1", "ls2"):
                continue  # built at initializer_factor
            elif pname in ("class_embedding", "position_embedding"):
                param.normal_(0.0, 1.0, generator=gen)
            elif pname == "bias" or f"{name}.{pname}".endswith(_ZEROS):
                param.zero_()
            else:
                std = (1.0 / param[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(param, 0.0, std, -2 * std, 2 * std, generator=gen)
    return model
