"""ReCo, the image-conditioned pixel reconstruction model (``deco_tpu/models/reco.py``).

The reference's ``dit_t2i_DeCo.PixNerDiT`` in its reconstruction form, as
the ReCo configs build it (``configs_c2i/ReCo_large*.yaml``,
``configs/ReCo_large_stage2.yaml``, ``configs_flow/internvit_2b_*.yaml``):

- the condition image goes through the InternViT tower
  (:class:`~deco_tpu_torch.models.uniflow.vit.VisionModel`, cut to
  ``select_layer`` layers when that is positive) after the ImageNet
  normalisation of ``x * 0.5 + 0.5``; the class token is dropped;
- ``latent_projector`` (linear, exact GELU, linear) maps the ViT tokens to
  ``latent_channel`` channels;
- :class:`PixelDecoder`: ``s_embedder`` lifts the latent tokens to
  ``hidden_size``, 16 learnable tokens go in front of them, and
  ``num_encoder_blocks`` :class:`~deco_tpu_torch.models.uniflow.components.PlainDiTBlock`
  run over both with the extrapolating RoPE table of the token grid (scale
  1), the learnable tokens all at the grid's centre row; then each patch of
  the noisy image is decoded by the t2i ``NerfEmbedderT2I`` and the DeCo
  ``SimpleMLPAdaLN`` (patch = the ViT patch, 14) conditioned on
  silu(t_emb + s).

``mlp1`` (the x0.5 pixel shuffle of the ViT tokens, LayerNorm, linear, GELU,
linear: :meth:`ReCoModel.extract_feature`) is never called by fit or
sampling; it is built so the parameters match the reference checkpoints
and the JAX tree. Module names are the reference's state-dict keys, which
``convert.state_dict_from_jax_reco`` writes.

``forward(x, t, s)`` recomputes the condition from a 4-D ``s`` (the image,
as :class:`~deco_tpu_torch.models.conditioners.ImageConditioner` hands it
over) at every call, as the JAX model does; a 3-D ``s`` is the
precomputed condition tokens.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import layers as L
from deco_tpu_torch.models.dit_t2i import NerfEmbedderT2I
from deco_tpu_torch.models.encoders import IMAGENET_MEAN, IMAGENET_STD
from deco_tpu_torch.models.patching import patchify, unpatchify
from deco_tpu_torch.models.uniflow import vit as vit_lib
from deco_tpu_torch.models.uniflow.components import PlainDiTBlock, resample_tokens

# the tower the JAX dispatch builds when the config's InternVL directory is absent
DEFAULT_VIT = vit_lib.ViTConfig(qk_normalization=True, norm_type="rms_norm",
                                initializer_factor=0.1)


class PixelDecoder(nn.Module):
    """Latent-conditioned pixel decoder: learnable tokens + plain DiT blocks
    over the latent tokens, then the per-patch pixel decoder."""

    def __init__(self, in_channels: int = 3, latent_channel: int = 32, hidden_size: int = 1152,
                 hidden_size_x: int = 64, num_groups: int = 12, num_encoder_blocks: int = 18,
                 num_decoder_blocks: int = 4, patch_size: int = 14,
                 num_learnable_tokens: int = 16, dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.num_groups = num_groups
        self.patch_size = patch_size
        self.dtype = dtype
        self._rope_cache: dict = {}
        self.learnable_tokens = nn.Parameter(
            torch.zeros(1, num_learnable_tokens, hidden_size, dtype=torch.float32))
        self.s_embedder = L.Embed(latent_channel, hidden_size, **kw)
        self.x_embedder = NerfEmbedderT2I(in_channels, hidden_size_x, patch_size, max_freqs=8,
                                          **kw)
        self.t_embedder = L.TimestepEmbedder(hidden_size, **kw)
        self.blocks = nn.ModuleList(PlainDiTBlock(hidden_size, num_groups, **kw)
                                    for _ in range(num_encoder_blocks))
        self.dec_net = L.SimpleMLPAdaLN(
            in_channels=hidden_size_x, model_channels=hidden_size_x, out_channels=in_channels,
            z_channels=hidden_size, num_res_blocks=num_decoder_blocks, patch_size=patch_size,
            **kw)

    def _rope(self, grid: int, device):
        """(cos, sin) of the learnable tokens (the centre row, repeated) and
        the grid, cached on ``device``."""
        key = (grid, device)
        if key not in self._rope_cache:
            cos, sin = (torch.from_numpy(t) for t in L.precompute_rope_2d(
                self.hidden_size // self.num_groups, grid, grid, scale=1.0, extrapolate=True))
            center, k = grid * grid // 2, self.learnable_tokens.shape[1]
            self._rope_cache[key] = tuple(
                torch.cat([t[center:center + 1].expand(k, -1), t]).to(device)
                for t in (cos, sin))
        return self._rope_cache[key]

    def forward_condition(self, latent):
        """latent (B, N, latent_channel) -> the condition tokens (B, N, hidden)."""
        b, n, _ = latent.shape
        rope = self._rope(int(round(n ** 0.5)), latent.device)
        k = self.learnable_tokens.shape[1]
        tokens = self.learnable_tokens.to(self.dtype).expand(b, k, self.hidden_size)
        s = torch.cat([tokens, self.s_embedder(latent.to(self.dtype))], dim=1)
        for block in self.blocks:
            s = block(s, rope)
        return s[:, k:]

    def forward(self, x, t, s):
        """x (B, H, W, C) noisy pixels; t (B,); s (B, N, hidden) -> (B, H, W, C) fp32."""
        b, h, w, _ = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x_patches = patchify(x, p).to(self.dtype)
        t_emb = self.t_embedder(t.reshape(-1)).reshape(b, 1, self.hidden_size)
        s = F.silu(t_emb + s)
        x_pix = self.x_embedder(x_patches.reshape(b, gh * gw, p * p, self.in_channels))
        out = self.dec_net(x_pix, s).reshape(b, gh * gw, p * p * self.in_channels)
        return unpatchify(out.float(), gh, gw, p)


# parameters (by name suffix) whose JAX initializer is not the nn.Dense
# default (lecun-normal kernel, zero bias)
_XAVIER = ("s_embedder.proj.weight", "dec_net.input_proj.weight", "dec_net.cond_embed.weight",
           ".mlp.0.weight", ".mlp.2.weight")
_NORMAL_002 = ("learnable_tokens", "t_embedder.mlp.0.weight", "t_embedder.mlp.2.weight")
_ZEROS = (".adaLN_modulation.1.weight", "final_layer.linear.weight")


class ReCoModel(nn.Module):
    """The InternViT-conditioned reconstruction diffusion model. ``dtype`` is
    the compute dtype, ``param_dtype`` the parameters' (default ``dtype``);
    ``device`` defaults to CUDA and raises where there is none ("meta" builds
    the shapes only)."""

    # the reconstruction loss does not reach ``mlp1`` (the understanding
    # features): DDP looks for unused parameters
    unused_in_fit = True

    def __init__(self, vit: vit_lib.ViTConfig = DEFAULT_VIT, in_channels: int = 3,
                 hidden_size: int = 1152, hidden_size_x: int = 64, num_groups: int = 12,
                 num_encoder_blocks: int = 18, num_decoder_blocks: int = 4,
                 select_layer: int = -1, llm_hidden_size: int = 1536, latent_channel: int = 32,
                 dtype=torch.bfloat16, param_dtype=None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if select_layer > 0:
            vit = dataclasses.replace(vit, num_layers=select_layer)
        self.vit = vit
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        vh = vit.hidden_size
        with dev:
            self.vision_model = vit_lib.VisionModel(vit, **kw)
            self.mlp1 = nn.Sequential(L.LayerNorm(4 * vh, eps=1e-5, dtype=dtype),
                                      L.Linear(4 * vh, llm_hidden_size, **kw), nn.GELU(),
                                      L.Linear(llm_hidden_size, llm_hidden_size, **kw))
            self.latent_projector = nn.Sequential(L.Linear(vh, vh, **kw), nn.GELU(),
                                                  L.Linear(vh, latent_channel, **kw))
            self.pixel_decoder = PixelDecoder(
                in_channels=in_channels, latent_channel=latent_channel, hidden_size=hidden_size,
                hidden_size_x=hidden_size_x, num_groups=num_groups,
                num_encoder_blocks=num_encoder_blocks, num_decoder_blocks=num_decoder_blocks,
                patch_size=vit.patch_size, **kw)
            self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN), persistent=False)
            self.register_buffer("std", torch.from_numpy(IMAGENET_STD), persistent=False)
        self.to(dev)  # buffers made from numpy start on the CPU

    def extract_vision_feature(self, pixel_values):
        """Images in [-1, 1] (B, H, W, 3) -> the ViT's patch tokens (B, N, vh)."""
        x = (pixel_values * 0.5 + 0.5 - self.mean) / self.std
        hidden, _ = self.vision_model(x)
        return hidden[:, 1:]

    def extract_feature(self, pixel_values):
        """The ``mlp1`` understanding features of the x0.5 pixel-shuffled tokens."""
        return self.mlp1(resample_tokens(self.extract_vision_feature(pixel_values), 0.5))

    def forward_condition(self, x, vit_embeds=None):
        if vit_embeds is None:
            vit_embeds = self.extract_vision_feature(x)
        return self.pixel_decoder.forward_condition(self.latent_projector(vit_embeds))

    def forward(self, x, t, s=None, cond_image=None):
        """Denoise x_t given the condition tokens ``s`` (3-D), or the
        condition image (a 4-D ``s``, or ``cond_image``)."""
        if s is not None and s.dim() == 4:
            cond_image, s = s, None
        if s is None:
            s = self.forward_condition(cond_image.to(self.dtype))
        return self.pixel_decoder(x, t, s)

    @torch.no_grad()
    def init_like_jax_(self, seed: int) -> "ReCoModel":
        """Draw the parameters from the JAX initializers' distributions: the
        tower as :func:`vit.init_like_jax_` (lecun-normal, normal(1.0) class
        and position embeddings, LayerScale at ``initializer_factor``),
        normal(0.02) learnable tokens and timestep MLP, xavier-uniform
        ``s_embedder`` and decoder MLPs, zero decoder modulations and final
        linear, lecun-normal (truncated) other kernels (the t2i
        NerfEmbedder's included), zero biases, unit norm scales. The values
        come from CPU generators seeded with ``seed``; they are not the JAX
        package's."""
        vit_lib.init_like_jax_(self.vision_model, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        norms = {m for m in self.modules() if isinstance(m, (L.RMSNorm, L.LayerNorm))}
        for module_name, module in self.named_modules():
            if module_name == "vision_model" or module_name.startswith("vision_model."):
                continue
            for pname, param in module.named_parameters(recurse=False):
                name = f"{module_name}.{pname}" if module_name else pname
                r = torch.empty(param.shape, dtype=torch.float32)
                if module in norms:
                    r.fill_(1.0 if pname == "weight" else 0.0)
                elif pname == "bias" or name.endswith(_ZEROS):
                    r.zero_()
                elif name.endswith(_NORMAL_002):
                    r.normal_(0.0, 0.02, generator=gen)
                elif name.endswith(_XAVIER):
                    fan_out, fan_in = param.shape
                    bound = (6.0 / (fan_in + fan_out)) ** 0.5
                    r.uniform_(-bound, bound, generator=gen)
                else:  # flax lecun_normal: truncated at 2 std, rescaled to unit variance
                    std = (1.0 / param.shape[1]) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(r, 0.0, std, -2 * std, 2 * std, generator=gen)
                param.copy_(r)
        return self
