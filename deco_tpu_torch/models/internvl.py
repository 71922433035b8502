"""InternVL's vision path (``deco_tpu/models/internvl.py`` ``InternVLVision``):
the InternViT tower, the x0.5 token shuffle and the ``mlp1`` connector, the
frozen encoder of the DC-AE decoder eval and the VAE-GAN's student-feature
head. The conversation templates and the chat surface are not here.
"""

from __future__ import annotations

import torch
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import layers as L
from deco_tpu_torch.models.uniflow import vit as vit_lib
from deco_tpu_torch.models.uniflow.components import resample_tokens

# the InternViT tower of InternVL3-2B (the JAX VAEModel's default ViTConfig)
INTERNVIT = vit_lib.ViTConfig(qk_normalization=True, norm_type="rms_norm", initializer_factor=0.1)


def mlp1_connector(vh: int, llm_hidden_size: int, kw: dict) -> nn.Sequential:
    """InternVL's ``mlp1``: LayerNorm(4 vh), linear, exact GELU, linear;
    ``kw`` the linears' dtypes (``dtype``, ``param_dtype``)."""
    return nn.Sequential(L.LayerNorm(4 * vh, eps=1e-5, dtype=kw["dtype"]),
                         L.Linear(4 * vh, llm_hidden_size, **kw), nn.GELU(),
                         L.Linear(llm_hidden_size, llm_hidden_size, **kw))


class InternVLVision(nn.Module):
    """InternViT, the x0.5 token shuffle and ``mlp1``: InternVL's
    ``extract_feature`` (``deco_tpu/models/internvl.py`` ``InternVLVision``).
    ``select_layer`` -1 (or the depth) takes the last layer, else that
    layer's output (1-based); pixel values are the tower's input (B, H, W, 3)."""

    def __init__(self, vit: vit_lib.ViTConfig = INTERNVIT, llm_hidden_size: int = 1536,
                 select_layer: int = -1, downsample_ratio: float = 0.5, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.select = 0 if select_layer in (-1, vit.num_layers) else select_layer
        self.downsample_ratio = downsample_ratio
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        with resolve_device(device):
            self.vision_model = vit_lib.VisionModel(vit, select_layer=self.select, **kw)
            self.mlp1 = mlp1_connector(vit.hidden_size, llm_hidden_size, kw)

    def forward(self, pixel_values):
        hidden, tapped = self.vision_model(pixel_values)
        embeds = (tapped if self.select else hidden)[:, 1:]
        return self.mlp1(resample_tokens(embeds, self.downsample_ratio))
