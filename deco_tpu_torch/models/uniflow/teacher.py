"""The frozen InternVL distillation teacher of UniFlow
(``deco_tpu/convert/vit_bridge.py`` ``load_teacher_feature_fn``; the
reference's ``LightweightTeacherModel``).

An InternVL folder's vision tower (InternViT-300M for InternVL3-2B) and
``mlp1`` map images in [-1, 1] to the two targets of ``forward_loss``'s
distillation terms: ``vit_embeds``, the tower's last hidden state without
the class token, pixel-shuffled x0.5 (:func:`resample_tokens`), in the
tower's dtype; and ``vit_embeds_mlp``, ``mlp1`` of it. As in JAX, ``mlp1``
takes its LayerNorm statistics in fp32 (eps 1e-5, two-pass variance),
casts back to the tower's dtype, and runs both linears and the exact GELU in
fp32 (the JAX weights are fp32 numpy arrays, so the products promote), so
``vit_embeds_mlp`` is fp32. Pixels are normalised with the ImageNet mean and
std first. The tower's attention goes through ``layers.sdpa``: the bf16
flash forward kernel on the card (no grad: one launch a layer), its plain
version on the CPU.

Loading is split so that the training run can fall back as JAX does:
:func:`load_teacher_weights` reads the folder and checks every key and shape
against the tower (on the meta device: nothing is built), and raises on any
fault of the files; :func:`build_teacher` then places the weights on the
device. ``train/workloads.py`` catches the first and never the second.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.convert_vit import read_internvl_folder, vit_config_from_json
from deco_tpu_torch.models.encoders import IMAGENET_MEAN, IMAGENET_STD
from deco_tpu_torch.models.uniflow.components import resample_tokens
from deco_tpu_torch.models.uniflow.vit import ViTConfig, VisionModel

MLP1_KEYS = ("0.weight", "0.bias", "1.weight", "1.bias", "3.weight", "3.bias")


@dataclasses.dataclass
class TeacherWeights:
    """What :func:`load_teacher_weights` read: the tower's config and state
    dict (only the keys it needs) and ``mlp1``'s fp32 weights."""

    config: ViTConfig
    vision: Dict[str, torch.Tensor]
    mlp1: Dict[str, torch.Tensor]


class InternVLTeacher(nn.Module):
    """The tower and ``mlp1`` (its fp32 weights, keyed as :data:`MLP1_KEYS`),
    frozen and in eval mode; calling it on images (B, H, W, 3) in [-1, 1]
    gives ``{"vit_embeds", "vit_embeds_mlp"}``."""

    def __init__(self, cfg: ViTConfig, mlp1: Dict[str, torch.Tensor], dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        dev = torch.device(device)
        self.dtype = dtype
        with dev:
            self.tower = VisionModel(cfg, dtype=dtype, param_dtype=dtype)
        for name in MLP1_KEYS:
            self.register_buffer("mlp1_" + name.replace(".", "_"),
                                 mlp1[name].to(device=dev, dtype=torch.float32))
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN).to(dev), persistent=False)
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD).to(dev), persistent=False)
        self.requires_grad_(False)
        self.eval()

    def mlp1(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        h = (xf - mu) / torch.sqrt(var + 1e-5) * self.mlp1_0_weight + self.mlp1_0_bias
        h = h.to(x.dtype).float()
        h = F.gelu(F.linear(h, self.mlp1_1_weight, self.mlp1_1_bias))
        return F.linear(h, self.mlp1_3_weight, self.mlp1_3_bias)

    @torch.no_grad()
    def forward(self, x) -> Dict[str, torch.Tensor]:
        px = ((x.float() * 0.5 + 0.5) - self.mean) / self.std
        hidden, _ = self.tower(px.to(self.dtype))
        embeds = resample_tokens(hidden[:, 1:], 0.5)
        return {"vit_embeds": embeds, "vit_embeds_mlp": self.mlp1(embeds)}


def load_teacher_weights(model_dir: str) -> TeacherWeights:
    """Read an InternVL folder and check it fits the tower its
    ``config.json`` describes: raises on missing files, a bad
    ``config.json``, missing ``mlp1`` or tower keys, or a shape that does
    not fit. Nothing is built on a device."""
    vision_config, vision, mlp1 = read_internvl_folder(model_dir)
    cfg = vit_config_from_json(vision_config)
    missing = [k for k in MLP1_KEYS if k not in mlp1]
    if missing:
        raise KeyError(f"{model_dir}: mlp1 keys missing: {missing}")
    with torch.device("meta"):
        want = VisionModel(cfg, dtype=torch.float32).state_dict()
    missing = [k for k in want if k not in vision]
    if missing:
        raise KeyError(f"{model_dir}: {len(missing)} vision tower keys missing, e.g. "
                       f"{missing[:3]}")
    for k, v in want.items():
        if tuple(vision[k].shape) != tuple(v.shape):
            raise ValueError(f"{model_dir}: {k} has shape {tuple(vision[k].shape)}, the tower "
                             f"of config.json wants {tuple(v.shape)}")
    width, hidden = 4 * cfg.hidden_size, mlp1["1.weight"].shape[0]
    for k, shape in (("0.weight", (width,)), ("0.bias", (width,)), ("1.weight", (hidden, width)),
                     ("1.bias", (hidden,)), ("3.weight", (hidden, hidden)), ("3.bias", (hidden,))):
        if tuple(mlp1[k].shape) != shape:
            raise ValueError(f"{model_dir}: mlp1.{k} has shape {tuple(mlp1[k].shape)}, "
                             f"expected {shape}")
    return TeacherWeights(cfg, {k: vision[k] for k in want}, {k: mlp1[k] for k in MLP1_KEYS})


def build_teacher(weights: TeacherWeights, device="cuda",
                  dtype=torch.bfloat16) -> InternVLTeacher:
    """The teacher on ``device`` (raises where CUDA is absent unless
    ``device="cpu"``), its tower's weights cast to ``dtype``."""
    dev = resolve_device(device)
    teacher = InternVLTeacher(weights.config, weights.mlp1, dtype=dtype, device=dev)
    teacher.tower.load_state_dict(weights.vision, strict=True)
    return teacher


def load_teacher_feature_fn(model_dir: str, device="cuda", dtype=torch.bfloat16):
    """The frozen teacher of an InternVL folder, ready to call on images in
    [-1, 1]: :func:`load_teacher_weights`, then :func:`build_teacher`."""
    return build_teacher(load_teacher_weights(model_dir), device=device, dtype=dtype)
