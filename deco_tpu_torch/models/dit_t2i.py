"""DeCo text-to-image model (``deco_tpu/models/dit_t2i.py`` ``DeCoT2I``).

The t2i trunk (``_T2ITrunk``) under the DeCo pixel decoder, as
``configs_t2i/sft_res512.yaml`` implies it (DeCo-XXL/16: hidden 1536, 24
heads of 64, 16 joint blocks, 4 text blocks, decoder hidden 32 with 3 res
blocks, 1.12B parameters):

- text: ``y_embedder`` (linear + RMSNorm) of the text encoder's
  (B, txt_max_length, txt_embed_dim) embeddings, plus the fp32
  ``y_pos_embedding`` cast to the compute dtype, refined by
  ``num_text_blocks`` self-attention blocks conditioned on silu(t);
- image: ``s_embedder`` of the patches (channel-major, the reference's
  torch ``unfold`` order, as the c2i port), ``num_encoder_blocks`` joint
  blocks whose image queries attend to the image and text keys, RoPE on
  the image only, then s = silu(t_emb + s);
- decoder: the c2i ``NerfEmbedder`` and ``SimpleMLPAdaLN`` through
  :func:`~deco_tpu_torch.models.layers.run_pixel_decoder` (``decoder_chunks``).

``grad_checkpoint`` recomputes each text and joint block in the backward
(:func:`~deco_tpu_torch.models.layers.run_checkpointed`, policy "full"; the
counterpart of ``nn.remat`` over ``_TextScanCell``/``_JointScanCell``), so
every attention's forward with logsumexp runs twice, and each decoder res
block (``SimpleMLPAdaLN.grad_checkpoint``) when the decoder is not chunked.

The RoPE tables extrapolate (``precompute_rope_2d(extrapolate=True)``):
``patch_scaling_hw`` (or the forward's argument of that name, which the
serving pipeline passes per request size) stretches them, and they are
cached on the device per (grid, scale). Module names follow the keys of
``export_deco_t2i(prefix="")``, so ``convert.state_dict_from_jax_t2i``
output and reference-layout t2i checkpoints load with ``strict=True``.

Not ported, and raising when asked for: ``trunk_parallel`` (ROADMAP §A 6),
``quantize`` (§A 7) and ``return_features``/``align_layer`` (§A 4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import layers
from deco_tpu_torch.models.patching import patchify, unpatchify

# constructor fields of the JAX model that the port does not implement:
# (the value that means "off", the ROADMAP §A item that ports them)
_UNPORTED = {
    "trunk_parallel": ("none", 6),
    "quantize": (None, 7),
    "align_layer": (0, 4),
}


class DeCoT2I(nn.Module):
    """Joint-attention t2i trunk + DeCo pixel decoder.

    ``dtype`` is the compute dtype, ``param_dtype`` the parameters' (default
    ``dtype``; ``y_pos_embedding`` and the norm scales stay fp32, as in the
    JAX model); ``device`` defaults to CUDA and raises where there is none.
    """

    def __init__(self, in_channels: int = 3, patch_size: int = 16, num_groups: int = 24,
                 hidden_size: int = 1536, decoder_hidden_size: int = 32,
                 num_encoder_blocks: int = 16, num_decoder_blocks: int = 3,
                 num_text_blocks: int = 4, txt_embed_dim: int = 2048, txt_max_length: int = 128,
                 max_freqs: int = 8, dtype=torch.bfloat16, param_dtype=None,
                 patch_scaling_hw: Tuple[float, float] = (1.0, 1.0), decoder_chunks: int = 0,
                 grad_checkpoint: bool = False, device="cuda", **unported):
        super().__init__()
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"DeCoT2I: unexpected argument {name!r}")
            off, item = _UNPORTED[name]
            if value != off:
                raise NotImplementedError(
                    f"DeCoT2I: {name}={value!r} is not ported to deco_tpu_torch, ROADMAP §A {item}")
        dev = resolve_device(device)
        self.in_channels = in_channels
        self.patch_size = patch_size
        self.num_groups = num_groups
        self.hidden_size = hidden_size
        self.txt_max_length = txt_max_length
        self.dtype = dtype
        self.patch_scaling_hw = tuple(float(s) for s in patch_scaling_hw)
        self.decoder_chunks = decoder_chunks
        self.grad_checkpoint = grad_checkpoint
        self._rope_cache: dict = {}
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        with dev:
            self.s_embedder = layers.Embed(patch_size * patch_size * in_channels, hidden_size,
                                           **kw)
            self.t_embedder = layers.TimestepEmbedder(hidden_size, **kw)
            self.y_embedder = layers.Embed(txt_embed_dim, hidden_size, use_norm=True, **kw)
            self.y_pos_embedding = nn.Parameter(
                torch.zeros(1, txt_max_length, hidden_size, dtype=torch.float32))
            self.text_refine_blocks = nn.ModuleList(
                layers.TextRefineBlock(hidden_size, num_groups, **kw)
                for _ in range(num_text_blocks))
            self.blocks = nn.ModuleList(
                layers.JointDiTBlock(hidden_size, num_groups, **kw)
                for _ in range(num_encoder_blocks))
            self.x_embedder = layers.NerfEmbedder(
                in_channels, decoder_hidden_size, patch_size, max_freqs=max_freqs, **kw)
            self.dec_net = layers.SimpleMLPAdaLN(
                in_channels=decoder_hidden_size, model_channels=decoder_hidden_size,
                out_channels=in_channels, z_channels=hidden_size,
                num_res_blocks=num_decoder_blocks, patch_size=patch_size,
                grad_checkpoint=grad_checkpoint, **kw)
        self.to(dev)  # buffers made from numpy start on the CPU

    def _rope(self, grid_h: int, grid_w: int, scale: Tuple[float, float], device):
        key = (grid_h, grid_w, scale, device)
        if key not in self._rope_cache:
            cos, sin = layers.precompute_rope_2d(self.hidden_size // self.num_groups, grid_h,
                                                 grid_w, scale=scale, extrapolate=True)
            self._rope_cache[key] = (torch.from_numpy(cos).to(device),
                                     torch.from_numpy(sin).to(device))
        return self._rope_cache[key]

    def forward(self, x, t, y, return_features: bool = False,
                patch_scaling_hw: Optional[Tuple[float, float]] = None):
        """x: (B, H, W, C) NHWC; t: (B,) in [0, 1]; y: (B, txt_max_length,
        txt_embed_dim) text embeddings. ``patch_scaling_hw`` (default the
        model's) stretches the RoPE tables. Returns the (B, H, W, C) float32
        network output."""
        if return_features:
            raise NotImplementedError(
                "DeCoT2I: return_features (REPA) is not ported to deco_tpu_torch, ROADMAP §A 4")
        b, h, w, _ = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        scale = tuple(float(s) for s in (patch_scaling_hw or self.patch_scaling_hw))
        x_patches = patchify(x, p).to(self.dtype)  # (B, L, P*P*C), pixel-major

        t_emb = self.t_embedder(t.reshape(-1)).reshape(b, 1, self.hidden_size)
        condition = F.silu(t_emb)
        y_emb = self.y_embedder(y.to(self.dtype)) + self.y_pos_embedding.to(self.dtype)
        for block in self.text_refine_blocks:
            y_emb = layers.run_checkpointed(block, y_emb, condition,
                                            enabled=self.grad_checkpoint)

        # the reference s_embedder weight is channel-major (torch unfold)
        x_pix = x_patches.reshape(b, gh * gw, p * p, self.in_channels)
        s = self.s_embedder(x_pix.transpose(2, 3).reshape(b, gh * gw, -1))
        rope = self._rope(gh, gw, scale, x.device)
        for block in self.blocks:
            s = layers.run_checkpointed(block, s, y_emb, condition, rope,
                                        enabled=self.grad_checkpoint)
        s = F.silu(t_emb + s)

        out = layers.run_pixel_decoder(self.dec_net, self.x_embedder(x_pix), s,
                                       self.decoder_chunks)
        out = out.reshape(b, gh * gw, p * p * self.in_channels)
        return unpatchify(out.float(), gh, gw, p)
