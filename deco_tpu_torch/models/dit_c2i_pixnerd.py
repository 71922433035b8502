"""PixNerd class-to-image model (``deco_tpu/models/dit_c2i_pixnerd.py`` ``PixNerdC2I``).

The DeCo trunk over ``num_cond_blocks`` blocks, s = silu(t + trunk), then a
hyper-network pixel decoder: :class:`~deco_tpu_torch.models.layers.NerfEmbedder`
of each patch's pixels, ``num_blocks - num_cond_blocks``
:class:`~deco_tpu_torch.models.layers.NerfBlock` (fc1 and fc2 both
column-normalised, the c2i variant) whose per-patch weights come from s,
then RMSNorm and a zero-initialised linear. ``return_features`` also returns
the trunk's tokens after block ``align_layer`` (None when ``s`` is given).

Module names follow the reference ``PixNerDiT`` state dict that
``convert.state_dict_from_jax_pixnerd`` writes: one ``blocks`` list holds
the trunk blocks and then the NerfBlocks, and ``final_layer`` holds
``norm`` and ``linear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import layers
from deco_tpu_torch.models.dit_c2i_deco import _rope_tables, channel_major, run_dit_blocks
from deco_tpu_torch.models.patching import patchify, unpatchify


class NerfFinalLayer(nn.Module):
    """RMSNorm and a zero-initialised linear to the pixel channels."""

    def __init__(self, hidden_x: int, out_channels: int, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.norm = layers.RMSNorm(hidden_x)
        self.linear = layers.Linear(hidden_x, out_channels, dtype=dtype, param_dtype=param_dtype)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x):
        return self.linear(self.norm(x))


class PixNerdC2I(nn.Module):
    """PixNerd-L/16 (``configs_c2i/Baseline_PixNerd.yaml``): hidden 1024, 16
    heads, 22 trunk blocks, 2 NerfBlocks of hidden_x 64 with MLP ratio 2.
    ``dtype`` is the compute dtype, ``param_dtype`` the parameters'
    (default ``dtype``); ``device`` defaults to CUDA and raises where there
    is none."""

    def __init__(self, in_channels: int = 4, patch_size: int = 2, num_groups: int = 12,
                 hidden_size: int = 1152, hidden_size_x: int = 64, nerf_mlpratio: int = 4,
                 num_blocks: int = 18, num_cond_blocks: int = 4, num_classes: int = 1000,
                 max_freqs: int = 8, dtype=torch.bfloat16, param_dtype=None,
                 grad_checkpoint: bool = False, align_layer: int = 0, rope_scale: float = 16.0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.in_channels = in_channels
        self.patch_size = patch_size
        self.num_groups = num_groups
        self.hidden_size = hidden_size
        self.num_cond_blocks = num_cond_blocks
        self.dtype = dtype
        self.grad_checkpoint = grad_checkpoint
        self.align_layer = align_layer
        self.rope_scale = rope_scale
        self._rope_cache: dict = {}
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        with dev:
            self.s_embedder = layers.Embed(patch_size * patch_size * in_channels, hidden_size,
                                           **kw)
            self.t_embedder = layers.TimestepEmbedder(hidden_size, **kw)
            self.y_embedder = layers.LabelEmbedder(num_classes + 1, hidden_size, **kw)
            self.blocks = nn.ModuleList(
                [layers.FlattenDiTBlock(hidden_size, num_groups, **kw)
                 for _ in range(num_cond_blocks)]
                + [layers.NerfBlock(hidden_size_x, hidden_size, nerf_mlpratio,
                                    normalize_fc2=True, **kw)
                   for _ in range(num_blocks - num_cond_blocks)])
            self.x_embedder = layers.NerfEmbedder(in_channels, hidden_size_x, patch_size,
                                                  max_freqs=max_freqs, **kw)
            self.final_layer = NerfFinalLayer(hidden_size_x, in_channels, **kw)
        self.to(dev)  # buffers made from numpy start on the CPU

    _rope = _rope_tables

    def forward(self, x, t, y, s=None, mask=None, return_features: bool = False):
        """x: (B, H, W, C) NHWC; t: (B,) in [0, 1]; y: (B,) int labels.
        Returns the (B, H, W, C) float32 output, and the tapped features
        with ``return_features``."""
        b, h, w, _ = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x_patches = patchify(x, p).to(self.dtype)
        t_emb = self.t_embedder(t.reshape(-1)).reshape(b, 1, self.hidden_size)
        y_emb = self.y_embedder(y).reshape(b, 1, self.hidden_size)
        c = F.silu(t_emb + y_emb)
        feat = None
        if s is None:
            s = self.s_embedder(channel_major(x_patches, p, self.in_channels))
            s, feat = run_dit_blocks(
                self.blocks[:self.num_cond_blocks], s, c, self._rope(gh, gw, x.device), mask,
                align_layer=self.align_layer if return_features else None,
                enabled=self.grad_checkpoint)
            s = F.silu(t_emb + s)
        x_pix = self.x_embedder(x_patches.reshape(b, gh * gw, p * p, self.in_channels))
        for block in self.blocks[self.num_cond_blocks:]:
            x_pix = block(x_pix, s)
        out = self.final_layer(x_pix).reshape(b, gh * gw, p * p * self.in_channels)
        img = unpatchify(out.float(), gh, gw, p)
        return (img, feat) if return_features else img
