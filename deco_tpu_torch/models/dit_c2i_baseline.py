"""Baseline flat DiT (``deco_tpu/models/dit_c2i_baseline.py`` ``BaselineDiT``).

Patch embed, the DeCo trunk of ``num_blocks`` adaLN blocks (RoPE +
qk-RMSNorm attention, SwiGLU) at full width, and the adaLN
:class:`~deco_tpu_torch.models.layers.FinalLayer` (zero-initialised) back to
patch pixels. ``return_features`` also returns the tokens after block
``align_layer``, the REPA tap. Module names follow the reference
``FlattenDiT`` state dict that ``convert.state_dict_from_jax_baseline``
writes: ``x_embedder`` reads and ``final_layer`` writes the patch pixels in
the channel-major order of torch ``unfold``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import layers
from deco_tpu_torch.models.dit_c2i_deco import _rope_tables, channel_major, run_dit_blocks
from deco_tpu_torch.models.patching import patchify, unpatchify


class BaselineDiT(nn.Module):
    """Baseline-DiT-L/16 (``configs_c2i/Baseline_DiT.yaml``): in_channels 3,
    patch 16, 16 heads, hidden 1024, 24 blocks. ``dtype`` is the compute
    dtype, ``param_dtype`` the parameters' (default ``dtype``); ``device``
    defaults to CUDA and raises where there is none."""

    def __init__(self, in_channels: int = 4, patch_size: int = 2, num_groups: int = 12,
                 hidden_size: int = 1152, num_blocks: int = 18, num_classes: int = 1000,
                 dtype=torch.bfloat16, param_dtype=None, grad_checkpoint: bool = False,
                 align_layer: int = 0, rope_scale: float = 16.0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.in_channels = in_channels
        self.patch_size = patch_size
        self.num_groups = num_groups
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.grad_checkpoint = grad_checkpoint
        self.align_layer = align_layer
        self.rope_scale = rope_scale
        self._rope_cache: dict = {}
        p2c = patch_size * patch_size * in_channels
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        with dev:
            self.x_embedder = layers.Embed(p2c, hidden_size, **kw)
            self.t_embedder = layers.TimestepEmbedder(hidden_size, **kw)
            self.y_embedder = layers.LabelEmbedder(num_classes + 1, hidden_size, **kw)
            self.blocks = nn.ModuleList(
                layers.FlattenDiTBlock(hidden_size, num_groups, **kw) for _ in range(num_blocks))
            self.final_layer = layers.FinalLayer(hidden_size, p2c, modulated=True, **kw)
        self.to(dev)

    _rope = _rope_tables

    def forward(self, x, t, y, mask=None, return_features: bool = False):
        """x: (B, H, W, C) NHWC; t: (B,) in [0, 1]; y: (B,) int labels.
        Returns the (B, H, W, C) float32 output, and the tapped features
        with ``return_features``."""
        b, h, w, _ = x.shape
        p, c_in = self.patch_size, self.in_channels
        gh, gw = h // p, w // p
        xe = self.x_embedder(channel_major(patchify(x, p).to(self.dtype), p, c_in))
        t_emb = self.t_embedder(t.reshape(-1)).reshape(b, 1, self.hidden_size)
        y_emb = self.y_embedder(y).reshape(b, 1, self.hidden_size)
        c = F.silu(t_emb + y_emb)
        xe, feat = run_dit_blocks(self.blocks, xe, c, self._rope(gh, gw, x.device), mask,
                                  align_layer=self.align_layer if return_features else None,
                                  enabled=self.grad_checkpoint)
        out = self.final_layer(xe, c)  # (B, L, C*P*P), channel-major
        out = out.reshape(b, gh * gw, c_in, p * p).transpose(2, 3).reshape(b, gh * gw, -1)
        img = unpatchify(out.float(), gh, gw, p)
        return (img, feat) if return_features else img
