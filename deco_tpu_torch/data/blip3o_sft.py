"""The BLIP3o supervised-finetuning dataset (``deco_tpu/data/blip3o_sft.py``):
T2I/I2I conversation SFT, the reference's ``blip3o_ori_dataset.py``.

Each sample dict (``image``, ``txt``, ``type``) becomes a T2I ("Please
generate image based on the following caption: ...") or I2I ("Please
reconstruct the given image.") conversation in the Qwen
``<|im_start|>role\\ncontent<|im_end|>`` template, tokenized by any
tokenizer with ``encode(text) -> ids``; the id ``encode`` gives
``<image>`` becomes ``IMAGE_TOKEN_INDEX`` (-200) in the inputs and
``IGNORE_INDEX`` (-100) in the labels, which otherwise equal the inputs
(the reference's user-turn masking is commented out upstream). The
collator pads to a static ``max_len``.

The source is any indexable of sample dicts; the images are (H, W, 3)
uint8 arrays, e.g. the ``raw_image`` of
:class:`~deco_tpu_torch.data.webdataset.PixWebDataset` items or of the
packed streams, JPEG members included. numpy only, as in JAX.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
SYSTEM_MESSAGE = "You are a helpful assistant."


def expand2square(img: np.ndarray, fill) -> np.ndarray:
    """Pad an (H, W, C) uint8 image to a centred square."""
    h, w = img.shape[:2]
    if h == w:
        return img
    side = max(h, w)
    out = np.empty((side, side) + img.shape[2:], dtype=img.dtype)
    out[...] = np.asarray(fill, dtype=img.dtype)
    y, x = (side - h) // 2, (side - w) // 2
    out[y:y + h, x:x + w] = img
    return out


def build_conversation(sample_type: str, txt: str = "") -> List[Dict[str, str]]:
    """The T2I / I2I conversation protocol (blip3o_ori_dataset.py:238-255)."""
    if sample_type == "T2I":
        return [
            {"from": "human",
             "value": "Please generate image based on the following caption: "
                      f"{txt}"},
            {"from": "gpt", "value": DEFAULT_IMAGE_TOKEN},
        ]
    if sample_type == "I2I":
        return [
            {"from": "human",
             "value": f"{DEFAULT_IMAGE_TOKEN}\n"
                      "Please reconstruct the given image."},
            {"from": "gpt", "value": ""},
        ]
    raise ValueError(f"Unknown source type {sample_type!r}")


def render_turn(role: str, content: str) -> str:
    """One Qwen chat turn — the exact template the reference installs on the
    tokenizer (blip3o_ori_dataset.py:98)."""
    return f"<|im_start|>{role}\n{content}<|im_end|>\n"


def tokenize_conversation(
    tokenizer,
    conversations: Sequence[Dict[str, str]],
    system_message: str = SYSTEM_MESSAGE,
    image_token_id: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Render + tokenize one conversation (blip3o_ori_dataset.py:78-160).

    ``tokenizer`` needs ``encode(text) -> List[int]`` (add no specials) —
    an HF Qwen tokenizer's ``encode(..., add_special_tokens=False)`` or any
    test stub. ``image_token_id``: the id ``encode`` emits for ``<image>``;
    occurrences in input_ids are replaced by ``IMAGE_TOKEN_INDEX`` (:155).
    Labels mirror input_ids (the upstream user-masking is disabled, :119)
    except at the image sentinel, which is never a prediction target.
    """
    roles = {"human": "user", "gpt": "assistant"}
    convs = list(conversations)
    if convs and roles.get(convs[0].get("from", convs[0].get("role"))) != "user":
        convs = convs[1:]  # drop a leading non-human turn (:110)

    input_ids = list(tokenizer.encode(render_turn("system", system_message)))
    labels = list(input_ids)
    for conv in convs:
        role = roles.get(conv.get("from", conv.get("role")),
                         conv.get("from", conv.get("role")))
        content = conv.get("value", conv.get("content", ""))
        ids = list(tokenizer.encode(render_turn(role, content)))
        input_ids += ids
        labels += ids
    input_ids = np.asarray(input_ids, np.int32)
    labels = np.asarray(labels, np.int32)
    if image_token_id is not None:
        at_image = input_ids == image_token_id
        input_ids = np.where(at_image, IMAGE_TOKEN_INDEX, input_ids)
        labels = np.where(at_image, IGNORE_INDEX, labels)
    return {"input_ids": input_ids, "labels": labels}


class LazySupervisedMixDataset:
    """Mix-modality SFT dataset (blip3o_ori_dataset.py:160-305).

    ``source``: a sequence (or indexable dataset) of sample dicts with keys
    ``image`` (H, W, 3 uint8 array or None), ``txt`` (caption) and ``type``
    ("T2I" | "I2I"; defaults to T2I like the snapshot's single branch).
    ``image_processor`` / ``target_transform``: per-image callables for the
    understanding and generation towers (the torch original uses the HF
    processor and a 1024px SANA transform)."""

    def __init__(
        self,
        tokenizer,
        source,
        image_processor: Optional[Callable] = None,
        target_transform: Optional[Callable] = None,
        image_token_id: Optional[int] = None,
        seed: int = 42,
    ):
        self.tokenizer = tokenizer
        self.source = source
        self.image_processor = image_processor or (lambda im: im)
        self.target_transform = target_transform or (lambda im: im)
        self.image_token_id = image_token_id
        self._rng = random.Random(seed)
        self.modality = 0  # 0 = understanding, 1 = generation (:196)

    def __len__(self):
        return len(self.source)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        # bad-sample retry loop (:233-289): resample a random index on decode
        # failure instead of crashing a long SFT run
        for _ in range(16):
            sample = self.source[i]
            stype = sample.get("type", "T2I")
            convs = build_conversation(stype, sample.get("txt", ""))
            out = tokenize_conversation(self.tokenizer, convs,
                                        image_token_id=self.image_token_id)
            image = sample.get("image")
            if image is not None:
                try:
                    img = np.asarray(image)
                    out["image"] = self.image_processor(img)
                    out["target_image"] = self.target_transform(img)
                except Exception:
                    i = self._rng.randrange(len(self.source))
                    continue
            out["ids"] = sample.get("id", "unk")
            return out
        raise RuntimeError("too many undecodable samples in a row")


@dataclass
class SFTCollator:
    """Static-shape batch collator (blip3o_ori_dataset.py:316-354).

    Pads/truncates token streams to ``max_len`` (right padding by default,
    ``padding_side='left'`` flips like the tokenizer attribute upstream) and
    stacks target images; attention_mask marks real tokens."""

    max_len: int = 2048
    pad_token_id: int = 0
    padding_side: str = "right"

    def _pad(self, seqs: List[np.ndarray], value: int) -> np.ndarray:
        out = np.full((len(seqs), self.max_len), value, np.int32)
        for r, s in enumerate(seqs):
            s = s[: self.max_len]
            if self.padding_side == "left":
                out[r, self.max_len - len(s):] = s
            else:
                out[r, : len(s)] = s
        return out

    def __call__(self, instances: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        input_ids = self._pad([x["input_ids"] for x in instances],
                              self.pad_token_id)
        labels = self._pad([x["labels"] for x in instances], IGNORE_INDEX)
        batch = {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": input_ids != self.pad_token_id,
        }
        if "image" in instances[0]:
            batch["images"] = [x["image"] for x in instances]
            batch["target_images"] = np.stack(
                [np.asarray(x["target_image"]) for x in instances])
        if "prompt" in instances[0]:
            batch["prompts"] = [x["prompt"] for x in instances]
        return batch


def make_supervised_data_module(tokenizer, source, **kw) -> Dict[str, Any]:
    """Dataset + collator pair (blip3o_ori_dataset.py:364-368)."""
    max_len = kw.pop("max_len", 2048)
    pad_token_id = kw.pop("pad_token_id", 0)
    return {
        "train_dataset": LazySupervisedMixDataset(tokenizer, source, **kw),
        "data_collator": SFTCollator(max_len=max_len,
                                     pad_token_id=pad_token_id),
    }
