"""Condition encoders (``deco_tpu/models/conditioners.py``): class labels,
text (Qwen3), images, placeholders and their composition.

A conditioner returns ``(condition, uncondition)`` as CPU tensors; floating
conditions are cast to bf16 (:class:`BaseConditioner`), integer ones keep
their type (int64 class ids, the label table's index type). The text
encoder runs on the host at data-preparation time, as in the JAX package:

- with ``weight_path`` naming a directory, the Hugging Face Qwen3 model
  from it (``transformers`` is imported there, lazily, and only there);
- otherwise per-token hash embeddings (the JAX package's offline fallback);
  a ``weight_path`` that is not a directory warns first, as the JAX class
  does. The fallback seeds each token with Python's ``hash()``, which is
  salted per process unless ``PYTHONHASHSEED`` is set, so its embeddings
  agree between the two packages within one process only (ROADMAP §C 7).
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional

import numpy as np
import torch


class BaseConditioner:
    def _impl_condition(self, y, metadata):
        raise NotImplementedError

    def _impl_uncondition(self, y, metadata):
        raise NotImplementedError

    def __call__(self, y, metadata: Optional[dict] = None):
        metadata = metadata if metadata is not None else {}
        condition = torch.as_tensor(self._impl_condition(y, metadata))
        uncondition = torch.as_tensor(self._impl_uncondition(y, metadata))
        if condition.is_floating_point():
            condition = condition.to(torch.bfloat16)
        if uncondition.is_floating_point():
            uncondition = uncondition.to(torch.bfloat16)
        return condition, uncondition


class ImageConditioner(BaseConditioner):
    """The condition is the input image itself (the ReCo reconstruction
    workloads, whose configs have no conditioner node); the uncondition is
    a zero image."""

    wants_images = True

    def _impl_condition(self, y, metadata):
        return torch.as_tensor(np.asarray(y, np.float32))

    def _impl_uncondition(self, y, metadata):
        return torch.zeros(np.shape(y), dtype=torch.float32)


class LabelConditioner(BaseConditioner):
    """Class ids as int64 tensors; the null class is ``num_classes``."""

    def __init__(self, num_classes: int):
        self.null_condition = num_classes

    def _impl_condition(self, y, metadata):
        return torch.as_tensor(y, dtype=torch.long)

    def _impl_uncondition(self, y, metadata):
        return torch.full((len(y),), self.null_condition, dtype=torch.long)


class PlaceHolderConditioner(BaseConditioner):
    """Random class ids from ``RandomState(seed)`` (a debugging conditioner)."""

    def __init__(self, num_classes: int = 1000, seed: int = 0):
        self.num_classes = num_classes
        self._rng = np.random.RandomState(seed)

    def _impl_condition(self, y, metadata):
        return torch.as_tensor(self._rng.randint(0, self.num_classes, size=(len(y),)),
                               dtype=torch.long)

    def _impl_uncondition(self, y, metadata):
        return torch.full((len(y),), self.num_classes, dtype=torch.long)


class ComposeConditioner(BaseConditioner):
    """The conditions of several conditioners concatenated along dim 1."""

    def __init__(self, conditioners: List[BaseConditioner]):
        self.conditioners = conditioners

    def _impl_condition(self, y, metadata):
        return torch.cat([torch.as_tensor(c._impl_condition(y, metadata))
                          for c in self.conditioners], dim=1)

    def _impl_uncondition(self, y, metadata):
        return torch.cat([torch.as_tensor(c._impl_uncondition(y, metadata))
                          for c in self.conditioners], dim=1)


class Qwen3TextEncoder(BaseConditioner):
    """Qwen3 last-hidden-state text conditioner.

    Prompts are right-padded or truncated to ``max_length`` tokens; the
    hidden states are cut or zero-padded to ``embed_dim``; the number of
    real tokens goes into ``metadata["valid_length_y"]`` (int32); the
    uncondition is the embedding of ``metadata["negative_prompt"]`` (default
    ``negative_prompt``), cached per negative prompt.
    """

    def __init__(self, weight_path: Optional[str] = None, embed_dim: int = 2048,
                 max_length: int = 128, negative_prompt: str = ""):
        self.embed_dim = embed_dim
        self.max_length = max_length
        self.negative_prompt = negative_prompt
        self._model = None
        self._tokenizer = None
        self._uncond_cache: dict = {}
        if weight_path is None:
            return
        if not os.path.isdir(str(weight_path)):
            warnings.warn(f"Qwen3 weights not found at {weight_path}; using the offline "
                          "hash-embedding fallback")
            return
        try:
            from transformers import AutoModel, AutoTokenizer
        except ImportError as err:
            raise ImportError(
                f"Qwen3TextEncoder: the weights at {weight_path} need the 'transformers' "
                "package, which is not installed; pass weight_path=None for the hash "
                "embeddings") from err
        self._tokenizer = AutoTokenizer.from_pretrained(weight_path, padding_side="right")
        self._model = AutoModel.from_pretrained(weight_path, torch_dtype=torch.bfloat16).eval()

    def _encode_hf(self, prompts, metadata):
        tok = self._tokenizer(prompts, padding="max_length", truncation=True,
                              max_length=self.max_length, return_tensors="pt")
        with torch.no_grad():
            out = self._model(input_ids=tok.input_ids, attention_mask=tok.attention_mask)
        metadata["valid_length_y"] = tok.attention_mask.sum(-1).to(torch.int32)
        return self._fit_dim(out.last_hidden_state.float().numpy())

    def _encode_fallback(self, prompts, metadata):
        """Per-token hash embeddings: token j of a prompt gets
        0.02 * randn(embed_dim) from ``RandomState(abs(hash(token)) % 2**31)``."""
        batch = np.zeros((len(prompts), self.max_length, self.embed_dim), np.float32)
        lengths = []
        for i, prompt in enumerate(prompts):
            tokens = str(prompt).lower().split()[: self.max_length]
            lengths.append(max(len(tokens), 1))
            for j, token in enumerate(tokens):
                seed = abs(hash(token)) % (2**31)
                batch[i, j] = np.random.RandomState(seed).randn(self.embed_dim) * 0.02
        metadata["valid_length_y"] = torch.tensor(lengths, dtype=torch.int32)
        return batch

    def _fit_dim(self, hidden: np.ndarray) -> np.ndarray:
        d = hidden.shape[-1]
        if d == self.embed_dim:
            return hidden
        if d > self.embed_dim:
            return hidden[..., : self.embed_dim]
        pad = np.zeros(hidden.shape[:-1] + (self.embed_dim - d,), hidden.dtype)
        return np.concatenate([hidden, pad], axis=-1)

    def _encode(self, prompts, metadata):
        fn = self._encode_hf if self._model is not None else self._encode_fallback
        return torch.from_numpy(np.ascontiguousarray(fn(prompts, metadata)))

    def _impl_condition(self, y, metadata):
        return self._encode(list(y), metadata)

    def _impl_uncondition(self, y, metadata):
        neg = metadata.get("negative_prompt", self.negative_prompt)
        if neg not in self._uncond_cache:
            self._uncond_cache[neg] = self._encode([neg], {})
        emb = self._uncond_cache[neg]
        return emb.expand((len(y),) + tuple(emb.shape[1:]))
