"""REPA target encoders (``deco_tpu/models/encoders.py``).

Each maps NHWC images in [0, 1] to (B, N, D) features, frozen:

- :class:`DINOv2`: the ViT-B/14 patch-token features in fp32: ImageNet
  normalisation, a cubic resize to h * 14 / 16 (so 256 px gives a 16 x 16
  grid), the tower, the final LayerNorm when the weights carry it, and the
  class token dropped. ``weight_path`` reads the published torch-hub file
  (``dinov2_vitb14_pretrain.pth``) with ``torch.load``; a missing file
  raises. ``weight_path=None`` draws a random tower from ``rng_seed`` with a
  warning, as the JAX package does without weights; it has no final norm,
  as there.
- :class:`CLIP`, :class:`SigLIP`, :class:`SigLIPVision`: Hugging Face
  towers; ``transformers`` is imported when one is built, and its absence
  raises ``ImportError`` naming the weights.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models.uniflow.vit import (
    ViTConfig,
    VisionModel,
    init_like_jax_,
    resize_cubic,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def dinov2_state_dict_from_hub(sd: dict) -> dict:
    """A torch-hub DINOv2 state dict (``patch_embed.proj``, ``cls_token``,
    ``pos_embed``, ``blocks.{i}.*`` with ``ls{1,2}.gamma``, the final
    ``norm``) as :class:`DINOv2`'s (the port's copy of
    ``dinov2_params_from_torch``'s key map); ``mask_token`` is unused."""
    out = {
        "model.embeddings.class_embedding": sd["cls_token"].reshape(1, 1, -1),
        "model.embeddings.position_embedding": sd["pos_embed"],
        "model.embeddings.patch_embedding.weight": sd["patch_embed.proj.weight"],
        "model.embeddings.patch_embedding.bias": sd["patch_embed.proj.bias"],
    }
    for key, value in sd.items():
        if key.startswith("blocks."):
            _, i, rest = key.split(".", 2)
            rest = {"ls1.gamma": "ls1", "ls2.gamma": "ls2"}.get(rest, rest)
            out[f"model.encoder.layers.{i}.{rest}"] = value
        elif key in ("norm.weight", "norm.bias"):
            out["final_" + key] = value
    return {k: torch.as_tensor(v).float() for k, v in out.items()}


class DINOv2(nn.Module):
    """ViT-B/14 patch-token encoder, fp32, frozen (no parameter requires grad)."""

    def __init__(self, weight_path: Optional[str] = None, base_patch_size: int = 16,
                 hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 rng_seed: int = 0, image_size: int = 518, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.base_patch_size = base_patch_size
        self.cfg = ViTConfig(hidden_size=hidden_size, num_layers=num_layers, num_heads=num_heads,
                             intermediate_size=hidden_size * 4, patch_size=14,
                             image_size=image_size, qkv_bias=True, qk_normalization=False,
                             norm_type="layer_norm", initializer_factor=1.0)
        self.model = VisionModel(self.cfg, dtype=torch.float32)
        self.final_norm = None
        if weight_path:
            path = os.path.expanduser(weight_path)
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"DINOv2: no weights at {path!r} (the torch-hub dinov2_vitb14_pretrain.pth); "
                    "pass weight_path=None for a random tower")
            sd = dinov2_state_dict_from_hub(torch.load(path, map_location="cpu",
                                                       weights_only=True))
            if "final_norm.weight" in sd:
                self.final_norm = nn.LayerNorm(hidden_size, eps=1e-6)
            self.load_state_dict(sd, strict=True)
        else:
            warnings.warn("DINOv2 running with random weights (no weight_path); REPA then "
                          "aligns to a fixed random feature space")
            init_like_jax_(self.model, rng_seed)
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD), persistent=False)
        self.requires_grad_(False)
        self.eval()
        self.to(dev)

    def forward(self, x, resize: bool = True):
        """x: (B, H, W, 3) in [0, 1] -> (B, N, hidden) fp32 patch tokens."""
        x = (x.float() - self.mean) / self.std
        if resize:
            _, h, w, _ = x.shape
            x = resize_cubic(x, int(14 * h / self.base_patch_size),
                             int(14 * w / self.base_patch_size))
        hidden, _ = self.model(x)
        if self.final_norm is not None:
            hidden = self.final_norm(hidden)
        return hidden[:, 1:]


def _require_transformers(cls_name: str, weight_path: str):
    try:
        import transformers
    except ImportError as err:
        raise ImportError(
            f"{cls_name} needs the Hugging Face weights at {weight_path!r} and the "
            "'transformers' package, which is not installed") from err
    return transformers


class CLIP:
    """CLIP image-text score maps: (B, N, T) cosine similarities of the
    projected patch tokens and text tokens (reference encoder.py:41-64)."""

    def __init__(self, weight_path: str, device="cuda"):
        tf = _require_transformers("CLIP", weight_path)
        self.device = resolve_device(device)
        self.model = tf.CLIPModel.from_pretrained(weight_path).eval().to(self.device)
        self.tokenizer = tf.CLIPTokenizer.from_pretrained(weight_path)

    @torch.no_grad()
    def __call__(self, x, text, resize: bool = True):
        model = self.model
        xt = x.permute(0, 3, 1, 2).float()
        tokens = self.tokenizer(text, truncation=True, return_tensors="pt", padding="max_length",
                                max_length=self.tokenizer.model_max_length).input_ids
        t_out = model.text_model(input_ids=tokens.to(self.device)).last_hidden_state
        t_out = F.normalize(model.text_projection(t_out), dim=-1)
        if resize:
            size = model.config.vision_config.image_size
            xt = F.interpolate(xt, (size, size), mode="bicubic")
        mean = torch.tensor([0.48145466, 0.4578275, 0.40821073], device=xt.device)
        std = torch.tensor([0.26862954, 0.26130258, 0.27577711], device=xt.device)
        xt = (xt - mean[:, None, None]) / std[:, None, None]
        v_out = model.vision_model(xt).last_hidden_state[:, 1:]
        v_out = F.normalize(model.visual_projection(v_out), dim=-1)
        return torch.bmm(v_out, t_out.transpose(1, 2))


class SigLIP:
    """The SigLIP model and tokenizer (the reference builds them and defines
    no forward)."""

    def __init__(self, weight_path: str, device="cuda"):
        tf = _require_transformers("SigLIP", weight_path)
        self.device = resolve_device(device)
        self.model = tf.SiglipModel.from_pretrained(weight_path).eval().to(self.device)
        self.tokenizer = tf.SiglipTokenizer.from_pretrained(weight_path)


class SigLIPVision:
    """SigLIP vision tower hidden states of [-1, 1]-scaled images."""

    def __init__(self, weight_path: str, base_patch_size: int = 16, device="cuda"):
        tf = _require_transformers("SigLIPVision", weight_path)
        self.device = resolve_device(device)
        self.base_patch_size = base_patch_size
        self.model = tf.SiglipVisionModel.from_pretrained(weight_path).eval().to(self.device)

    @torch.no_grad()
    def __call__(self, x, resize: bool = True):
        xt = x.permute(0, 3, 1, 2).float()
        if resize:
            size = self.model.config.image_size
            xt = F.interpolate(xt, (size, size), mode="bicubic")
        return self.model((xt - 0.5) / 0.5).last_hidden_state
