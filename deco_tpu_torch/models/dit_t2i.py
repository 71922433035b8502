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

``return_features`` also returns the joint trunk's image tokens after block
``align_layer`` (1-based; zeros when it is 0 or past the trunk), the REPA tap.
:class:`PixNerdT2I` shares the trunk (``_T2ITrunk``) and decodes with
``NerfEmbedderT2I`` (a cos-RoPE per-pixel basis) and ``NerfBlock`` (fc1
normalised, fc2 not) into a zero-initialised linear; no shipped config uses it.

``quantize="int8"`` (or ``DECO_QUANT=int8`` when the model is built) runs
the text-refine and joint blocks' attention and MLP products through W8A8
int8 (``ops/quant.py``), an inference-only serving mode with the same
parameters. ``trunk_parallel`` ("sp" or "tp") runs the joint blocks under
the joint executors of ``parallel/`` over the current mesh's model axis, as
``DeCoC2I``'s does (the text tokens stay whole on every rank); it refuses
int8 and the REPA tap, and its ``return_features`` are zeros.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import layers
from deco_tpu_torch.models.dit_c2i_deco import check_trunk_parallel, run_trunk_parallel
from deco_tpu_torch.models.patching import patchify, unpatchify
from deco_tpu_torch.ops import quant


def nerf_rope_cos_basis(patch_size: int, max_freqs: int) -> np.ndarray:
    """The t2i per-pixel basis (``nerf_rope_cos_basis``): the cosines of the
    extrapolating RoPE angles of a P x P grid at max_freqs**2 * 2 channels,
    x and y interleaved, (P^2, max_freqs^2) float32."""
    dim = max_freqs**2 * 2
    pos = np.linspace(0, patch_size, patch_size)
    y_grid, x_grid = np.meshgrid(pos, pos, indexing="ij")
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 4)[: dim // 4] / dim))
    basis = np.stack([np.cos(np.outer(x_grid.reshape(-1), freqs)),
                      np.cos(np.outer(y_grid.reshape(-1), freqs))], axis=-1)
    return basis.reshape(patch_size**2, -1).astype(np.float32)


class NerfEmbedderT2I(layers.NerfEmbedder):
    """:class:`~deco_tpu_torch.models.layers.NerfEmbedder` with the t2i
    cos-RoPE basis in place of the DCT one."""

    def __init__(self, in_channels: int, hidden_size: int, patch_size: int,
                 max_freqs: int = 8, dtype=torch.float32, param_dtype=None):
        super().__init__(in_channels, hidden_size, patch_size, max_freqs, dtype, param_dtype)
        self.basis = torch.from_numpy(nerf_rope_cos_basis(patch_size, max_freqs))


class _T2ITrunk(nn.Module):
    """The text-refine and joint-attention trunk that :class:`DeCoT2I` and
    :class:`PixNerdT2I` share; the subclass builds its pixel decoder and
    moves the module to the device."""

    def __init__(self, name: str, in_channels: int, patch_size: int, num_groups: int,
                 hidden_size: int, num_encoder_blocks: int, num_text_blocks: int,
                 txt_embed_dim: int, txt_max_length: int, dtype, param_dtype,
                 patch_scaling_hw, grad_checkpoint: bool, align_layer: int, quantize,
                 trunk_parallel: str):
        super().__init__()
        int8 = quant.resolve_mode(quantize)
        check_trunk_parallel(trunk_parallel, int8)
        self.trunk_parallel = trunk_parallel
        self.quantize = "int8" if int8 else None
        self.in_channels = in_channels
        self.patch_size = patch_size
        self.num_groups = num_groups
        self.hidden_size = hidden_size
        self.num_encoder_blocks = num_encoder_blocks
        self.txt_max_length = txt_max_length
        self.dtype = dtype
        self.patch_scaling_hw = tuple(float(s) for s in patch_scaling_hw)
        self.grad_checkpoint = grad_checkpoint
        self.align_layer = align_layer
        self._rope_cache: dict = {}
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.s_embedder = layers.Embed(patch_size * patch_size * in_channels, hidden_size, **kw)
        self.t_embedder = layers.TimestepEmbedder(hidden_size, **kw)
        self.y_embedder = layers.Embed(txt_embed_dim, hidden_size, use_norm=True, **kw)
        self.y_pos_embedding = nn.Parameter(
            torch.zeros(1, txt_max_length, hidden_size, dtype=torch.float32))
        self.text_refine_blocks = nn.ModuleList(
            layers.TextRefineBlock(hidden_size, num_groups, **kw, quantize=int8)
            for _ in range(num_text_blocks))
        self.blocks = nn.ModuleList(
            layers.JointDiTBlock(hidden_size, num_groups, **kw, quantize=int8)
            for _ in range(num_encoder_blocks))

    def _rope(self, grid_h: int, grid_w: int, scale: Tuple[float, float], device):
        key = (grid_h, grid_w, scale, device)
        if key not in self._rope_cache:
            cos, sin = layers.precompute_rope_2d(self.hidden_size // self.num_groups, grid_h,
                                                 grid_w, scale=scale, extrapolate=True)
            self._rope_cache[key] = (torch.from_numpy(cos).to(device),
                                     torch.from_numpy(sin).to(device))
        return self._rope_cache[key]

    def _trunk(self, x, t, y, return_features: bool, patch_scaling_hw):
        """(x_pix (B, L, P^2, C) pixel-major, s (B, L, hidden), feat or None)."""
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
        feat = None
        if self.trunk_parallel != "none":
            if return_features and self.align_layer:
                raise ValueError("the REPA feature tap is not available under trunk_parallel; "
                                 "train alignment with the sequential trunk")
            s = run_trunk_parallel(self.trunk_parallel, self.blocks[:self.num_encoder_blocks],
                                   s, condition, rope, y=y_emb, remat=self.grad_checkpoint)
        else:
            for i, block in enumerate(self.blocks[:self.num_encoder_blocks]):
                s = layers.run_checkpointed(block, s, y_emb, condition, rope,
                                            enabled=self.grad_checkpoint)
                if return_features and i == self.align_layer - 1:
                    feat = s
        if return_features and feat is None:
            feat = torch.zeros_like(s)
        return x_pix, F.silu(t_emb + s), feat

    def _image(self, out, x, feat, return_features: bool):
        b, h, w, _ = x.shape
        p = self.patch_size
        out = out.reshape(b, (h // p) * (w // p), p * p * self.in_channels)
        img = unpatchify(out.float(), h // p, w // p, p)
        return (img, feat) if return_features else img


class DeCoT2I(_T2ITrunk):
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
                 grad_checkpoint: bool = False, align_layer: int = 0, quantize=None,
                 trunk_parallel: str = "none", device="cuda"):
        dev = resolve_device(device)
        with dev:
            super().__init__("DeCoT2I", in_channels, patch_size, num_groups, hidden_size,
                             num_encoder_blocks, num_text_blocks, txt_embed_dim, txt_max_length,
                             dtype, param_dtype, patch_scaling_hw, grad_checkpoint, align_layer,
                             quantize, trunk_parallel)
            kw = dict(dtype=dtype, param_dtype=param_dtype)
            self.decoder_chunks = decoder_chunks
            self.x_embedder = layers.NerfEmbedder(
                in_channels, decoder_hidden_size, patch_size, max_freqs=max_freqs, **kw)
            self.dec_net = layers.SimpleMLPAdaLN(
                in_channels=decoder_hidden_size, model_channels=decoder_hidden_size,
                out_channels=in_channels, z_channels=hidden_size,
                num_res_blocks=num_decoder_blocks, patch_size=patch_size,
                grad_checkpoint=grad_checkpoint, **kw)
        self.to(dev)  # buffers made from numpy start on the CPU

    def forward(self, x, t, y, return_features: bool = False,
                patch_scaling_hw: Optional[Tuple[float, float]] = None):
        """x: (B, H, W, C) NHWC; t: (B,) in [0, 1]; y: (B, txt_max_length,
        txt_embed_dim) text embeddings. ``patch_scaling_hw`` (default the
        model's) stretches the RoPE tables. Returns the (B, H, W, C) float32
        network output, and the tapped features with ``return_features``."""
        x_pix, s, feat = self._trunk(x, t, y, return_features, patch_scaling_hw)
        out = layers.run_pixel_decoder(self.dec_net, self.x_embedder(x_pix), s,
                                       self.decoder_chunks)
        return self._image(out, x, feat, return_features)


class PixNerdT2I(_T2ITrunk):
    """PixNerd t2i: the joint-attention trunk + NerfBlock hyper-decoder
    (``num_decoder_blocks`` blocks of ``decoder_hidden_size``, fc2 not
    normalised) and a zero-initialised linear (no norm). Module names follow
    the reference ``dit_t2i_pixnerd.PixNerDiT`` state dict: the NerfBlocks
    follow the joint blocks in ``blocks``, and ``final_layer.linear``."""

    def __init__(self, in_channels: int = 3, patch_size: int = 16, num_groups: int = 24,
                 hidden_size: int = 1536, decoder_hidden_size: int = 64,
                 num_encoder_blocks: int = 16, num_decoder_blocks: int = 4,
                 num_text_blocks: int = 4, txt_embed_dim: int = 2048, txt_max_length: int = 128,
                 nerf_mlpratio: int = 2, max_freqs: int = 8, dtype=torch.bfloat16,
                 param_dtype=None, patch_scaling_hw: Tuple[float, float] = (1.0, 1.0),
                 grad_checkpoint: bool = False, align_layer: int = 0, quantize=None,
                 trunk_parallel: str = "none", device="cuda"):
        dev = resolve_device(device)
        with dev:
            super().__init__("PixNerdT2I", in_channels, patch_size, num_groups, hidden_size,
                             num_encoder_blocks, num_text_blocks, txt_embed_dim, txt_max_length,
                             dtype, param_dtype, patch_scaling_hw, grad_checkpoint, align_layer,
                             quantize, trunk_parallel)
            kw = dict(dtype=dtype, param_dtype=param_dtype)
            self.blocks.extend(
                layers.NerfBlock(decoder_hidden_size, hidden_size, nerf_mlpratio, **kw)
                for _ in range(num_decoder_blocks))
            self.x_embedder = NerfEmbedderT2I(in_channels, decoder_hidden_size, patch_size,
                                              max_freqs=max_freqs, **kw)
            self.final_layer = nn.ModuleDict(
                {"linear": layers.Linear(decoder_hidden_size, in_channels, **kw)})
            nn.init.zeros_(self.final_layer["linear"].weight)
            nn.init.zeros_(self.final_layer["linear"].bias)
        self.to(dev)

    def forward(self, x, t, y, return_features: bool = False,
                patch_scaling_hw: Optional[Tuple[float, float]] = None):
        """As :meth:`DeCoT2I.forward`."""
        x_pix, s, feat = self._trunk(x, t, y, return_features, patch_scaling_hw)
        x_pix = self.x_embedder(x_pix)
        for block in self.blocks[self.num_encoder_blocks:]:
            x_pix = block(x_pix, s)
        return self._image(self.final_layer["linear"](x_pix), x, feat, return_features)
