"""InternVL folders: read the vision tower and ``mlp1`` of an HF InternVL
checkpoint folder, and write one (``deco_tpu/convert/vit_bridge.py``'s
``export_internvl_folder`` and the file half of ``load_teacher_feature_fn``,
with ``torch_to_flax.load_torch_ckpt``).

The port's ``VisionModel`` already carries the InternViT torch names
(``embeddings.patch_embedding.weight`` as the (C, 3, p, p) conv weight,
``encoder.layers.{i}.attn.qkv.weight``, ``norm1.weight``, ``ls1``, ...), so
no layout changes on the way in or out: the JAX package's transposes and
layer stacking have no counterpart here.

- :func:`checkpoint_files` lists a folder's ``.bin``, ``.safetensors``,
  ``.pt`` and ``.ckpt`` files, sorted, without ``training_args``, as the
  JAX loader does; :func:`read_internvl_folder` merges them, unwraps a
  ``state_dict``, strips ``vision_model.`` (a bare InternVisionModel export,
  which has no such keys, is taken whole) and takes the ``mlp1.`` keys.
- :func:`read_safetensors` reads ``.safetensors`` itself: an 8-byte
  little-endian header length, a JSON header and the raw bytes, taken by
  ``torch.frombuffer``. It reads bf16, which the JAX package's
  ``safetensors.numpy`` reader refuses (ROADMAP §C 15), and it needs no
  ``safetensors`` package. :func:`write_safetensors` writes the same format.
- :func:`export_internvl_folder` writes ``pytorch_model.bin`` (``{"state_dict":
  ...}``, the tower's keys and ``mlp1.*``) and ``config.json``
  (``{"vision_config": ..., "model_type": "internvl_chat"}``) as the JAX
  function writes them, so each package loads the other's folders.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}
CHECKPOINT_SUFFIXES = (".bin", ".safetensors", ".pt", ".ckpt")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, in its stored dtype, on the CPU."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: truncated safetensors header")
    header = json.loads(data[8:8 + n])
    body = memoryview(bytearray(data[8 + n:]))
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype {meta['dtype']}, which the port "
                             f"does not read (it reads {', '.join(SAFETENSORS_DTYPES)})")
        begin, end = meta["data_offsets"]
        shape = list(meta["shape"])
        count = int(np.prod(shape)) if shape else 1
        if end > len(body) or end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: tensor {name}'s bytes do not match its shape and dtype")
        flat = torch.frombuffer(body[begin:end], dtype=dtype) if count else torch.empty(
            0, dtype=dtype)
        out[name] = flat.reshape(shape)
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """``tensors`` as a ``.safetensors`` file (keys sorted, offsets in order)."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the format pads the header to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_torch_ckpt(path: str) -> Dict[str, torch.Tensor]:
    """One checkpoint file as a flat dict of CPU tensors: ``.safetensors``
    through :func:`read_safetensors`, anything else through ``torch.load``
    with a ``state_dict`` unwrapped (entries that are not tensors dropped)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def checkpoint_files(model_dir: str) -> list:
    """The folder's checkpoint files, sorted, as the JAX loader lists them."""
    files = sorted(f for f in os.listdir(model_dir)
                   if f.endswith(CHECKPOINT_SUFFIXES) and "training_args" not in f)
    if not files:
        raise FileNotFoundError(f"no checkpoint files in {model_dir}")
    return [os.path.join(model_dir, f) for f in files]


def read_internvl_folder(model_dir: str) -> Tuple[dict, Dict[str, torch.Tensor],
                                                  Dict[str, torch.Tensor]]:
    """(vision_config, the tower's state dict, ``mlp1``'s) of an InternVL
    folder: ``config.json``'s ``vision_config`` (or the whole file), the
    ``vision_model.`` keys without the prefix (every key for a bare
    InternVisionModel export) and the ``mlp1.`` keys without it."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    vision_config = cfg.get("vision_config", cfg)
    sd: Dict[str, torch.Tensor] = {}
    for path in checkpoint_files(model_dir):
        sd.update(load_torch_ckpt(path))
    vision = {k[len("vision_model."):]: v for k, v in sd.items() if k.startswith("vision_model.")}
    if not vision:  # a bare InternVisionModel export
        vision = sd
    mlp1 = {k[len("mlp1."):]: v for k, v in sd.items() if k.startswith("mlp1.")}
    return vision_config, vision, mlp1


def vit_config_from_json(vc: dict):
    """The tower's :class:`~deco_tpu_torch.models.uniflow.vit.ViTConfig` from
    an InternVL ``vision_config``, with the JAX loader's defaults."""
    from deco_tpu_torch.models.uniflow.vit import ViTConfig

    return ViTConfig(
        hidden_size=vc.get("hidden_size", 1024),
        num_layers=vc.get("num_hidden_layers", 24),
        num_heads=vc.get("num_attention_heads", 16),
        intermediate_size=vc.get("intermediate_size", 4096),
        patch_size=vc.get("patch_size", 14),
        image_size=vc.get("image_size", 448),
        qkv_bias=vc.get("qkv_bias", True),
        qk_normalization=vc.get("qk_normalization", False),
        norm_type=vc.get("norm_type", "layer_norm"),
    )


def vision_config_of(cfg) -> dict:
    """An InternVL ``vision_config`` for a ``ViTConfig`` (the inverse of
    :func:`vit_config_from_json`)."""
    return {"hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
            "patch_size": cfg.patch_size, "image_size": cfg.image_size,
            "qkv_bias": cfg.qkv_bias, "qk_normalization": cfg.qk_normalization,
            "norm_type": cfg.norm_type}


def export_internvl_folder(vision_state: Dict[str, torch.Tensor], out_dir: str, config: dict,
                           mlp1_state: Optional[Dict[str, torch.Tensor]] = None,
                           tokenizer_src: Optional[str] = None) -> None:
    """Write an InternVL-format HF folder (the reference's
    ``convert_vae_to_internvl.py``): ``vision_state`` is a ``VisionModel``
    state dict (of UniFlow's tower: its ``embeddings.*`` and ``encoder.*``
    keys), ``mlp1_state`` the ``mlp1`` Sequential's (``0.weight``, ...);
    ``config`` becomes ``vision_config`` in ``config.json``; tokenizer files
    are copied from ``tokenizer_src`` when it is a folder."""
    os.makedirs(out_dir, exist_ok=True)
    sd = {k: v.detach().cpu().contiguous() for k, v in vision_state.items()}
    if mlp1_state:
        sd.update({f"mlp1.{k}": v.detach().cpu().contiguous() for k, v in mlp1_state.items()})
    torch.save({"state_dict": sd}, os.path.join(out_dir, "pytorch_model.bin"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"vision_config": config, "model_type": "internvl_chat"}, f, indent=2)
    if tokenizer_src and os.path.isdir(tokenizer_src):
        for fn in os.listdir(tokenizer_src):
            if "token" in fn or fn.endswith(".model"):
                shutil.copy(os.path.join(tokenizer_src, fn), out_dir)
