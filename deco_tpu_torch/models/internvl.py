"""InternVL (``deco_tpu/models/internvl.py``): the vision path, the
conversation templates and the chat surface.

- :class:`InternVLVision`: the InternViT tower, the x0.5 token shuffle and
  the ``mlp1`` connector, the frozen encoder of the DC-AE decoder eval and
  the VAE-GAN's student-feature head.
- :class:`Conversation`, :func:`register_conv_template`,
  :func:`get_conv_template`: the prompt templates the JAX module registers
  (Hermes-2, internlm2-chat, phi3-chat, internvl2_5).
- :class:`InternVLChat`: prompt assembly (:meth:`InternVLChat.build_query`)
  and, given a local Hugging Face checkpoint (``weight_path``), ``chat`` and
  ``batch_chat`` through ``transformers`` generate, as the JAX class runs
  them, on the card unless ``device="cpu"`` is asked for; without one they
  raise, as in JAX. No InternVL weights are in the repository.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
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


@dataclasses.dataclass
class Conversation:
    """A chat prompt template, in the one separator style every registered
    template uses (the reference's ``conversation.py``, compacted as in
    JAX)."""

    name: str
    system_template: str = "<|im_start|>system\n{system_message}"
    system_message: str = ""
    roles: Tuple[str, str] = ("<|im_start|>user\n", "<|im_start|>assistant\n")
    sep: str = "<|im_end|>"
    messages: Optional[List[Tuple[str, Optional[str]]]] = None

    def __post_init__(self):
        self.messages = list(self.messages or [])

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        system = self.system_template.format(system_message=self.system_message)
        ret = system + self.sep + "\n"
        for role, message in self.messages:
            if message is not None:
                ret += role + message + self.sep + "\n"
            else:
                ret += role
        return ret

    def copy(self) -> "Conversation":
        return Conversation(
            name=self.name, system_template=self.system_template,
            system_message=self.system_message, roles=self.roles, sep=self.sep,
            messages=list(self.messages),
        )


_TEMPLATES = {}


def register_conv_template(t: Conversation, override: bool = False):
    if not override and t.name in _TEMPLATES:
        raise ValueError(f"template {t.name} already registered")
    _TEMPLATES[t.name] = t


def get_conv_template(name: str) -> Conversation:
    return _TEMPLATES[name].copy()


register_conv_template(Conversation(
    name="Hermes-2",
    system_message="你是书生·万象... (InternVL assistant system prompt)",
))
register_conv_template(Conversation(
    name="internlm2-chat",
    system_message="You are an AI assistant whose name is InternLM (书生·浦语).",
))
register_conv_template(Conversation(
    name="phi3-chat",
    system_template="<|system|>\n{system_message}",
    roles=("<|user|>\n", "<|assistant|>\n"),
    sep="<|end|>",
))
register_conv_template(Conversation(
    name="internvl2_5",
    system_message=(
        "你是书生·万象，英文名是InternVL，是由上海人工智能实验室、清华大学及多家合作单位"
        "联合开发的多模态大语言模型。"
    ),
))


class InternVLChat:
    """The chat surface: the prompt assembly is the port's own; generation
    runs through ``transformers`` from a local checkpoint (``weight_path``)
    on ``device`` (the model, the token ids, the mask and the pixels) and
    raises without one, as in JAX. ``<image>`` in a prompt becomes
    ``<img>`` + ``<IMG_CONTEXT>`` x ``num_image_token`` x patches +
    ``</img>``, where the model splices the vision embeds."""

    IMG_START, IMG_END, IMG_CONTEXT = "<img>", "</img>", "<IMG_CONTEXT>"

    def __init__(self, weight_path: Optional[str] = None,
                 template: str = "internvl2_5", num_image_token: int = 256,
                 device: str = "cuda"):
        self.template = template
        self.num_image_token = num_image_token
        self._model = None
        self._tokenizer = None
        if weight_path is not None:
            self.device = resolve_device(device)
            from transformers import AutoModelForCausalLM, AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(
                weight_path, trust_remote_code=True
            )
            self._model = AutoModelForCausalLM.from_pretrained(
                weight_path, torch_dtype=torch.bfloat16, trust_remote_code=True
            ).to(self.device).eval()

    def build_query(self, question: str, num_patches_list=None,
                    system_message: Optional[str] = None,
                    history=None) -> str:
        """Prompt assembly (modeling_internvl_chat.py:325-359): template turns
        (+history) rendered, then each ``<image>`` replaced by
        IMG_START + IMG_CONTEXT*num_image_token*num_patches + IMG_END.
        Image tokens are inserted only for provided patch counts — a
        text-only chat carries none."""
        conv = get_conv_template(self.template)
        if system_message is not None:
            conv.system_message = system_message
        for old_q, old_a in (history or []):
            conv.append_message(conv.roles[0], old_q)
            conv.append_message(conv.roles[1], old_a)
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], None)
        query = conv.get_prompt()
        for num_patches in (num_patches_list or []):
            image_tokens = (
                self.IMG_START
                + self.IMG_CONTEXT * self.num_image_token * num_patches
                + self.IMG_END
            )
            query = query.replace("<image>", image_tokens, 1)
        return query

    def _pixels(self, pixel_values):
        if pixel_values is None:
            return None
        if not torch.is_tensor(pixel_values):
            pixel_values = torch.as_tensor(np.asarray(pixel_values))
        return pixel_values.to(self.device, self._model.dtype)

    def chat(self, question: str, pixel_values=None, history=None,
             return_history: bool = False, num_patches_list=None,
             **generation_config):
        """Reference chat protocol (modeling_internvl_chat.py:310-384):
        prepend ``<image>`` for a fresh image turn, register the IMG_CONTEXT
        token id on the model, stop at the template separator."""
        if self._model is None:
            raise RuntimeError(
                "InternVLChat.chat needs a local HF checkpoint (weight_path); "
                "none was given"
            )
        if history is None and pixel_values is not None \
                and "<image>" not in question:
            question = "<image>\n" + question
        if num_patches_list is None:
            num_patches_list = ([pixel_values.shape[0]]
                                if pixel_values is not None else [])
        self._model.img_context_token_id = \
            self._tokenizer.convert_tokens_to_ids(self.IMG_CONTEXT)
        conv = get_conv_template(self.template)
        eos_token_id = self._tokenizer.convert_tokens_to_ids(conv.sep.strip())
        query = self.build_query(question, num_patches_list=num_patches_list,
                                 history=history)
        inputs = self._tokenizer(query, return_tensors="pt")
        pixel_values = self._pixels(pixel_values)
        out = self._model.generate(
            pixel_values=pixel_values, input_ids=inputs.input_ids.to(self.device),
            attention_mask=inputs.attention_mask.to(self.device),
            eos_token_id=eos_token_id, **generation_config)
        text = self._tokenizer.batch_decode(out, skip_special_tokens=True)[0]
        response = text.split(conv.sep.strip())[0].strip()
        if return_history:
            return response, (history or []) + [(question, response)]
        return response

    def batch_chat(self, questions, pixel_values=None, num_patches_list=None,
                   **generation_config):
        """Batched single-turn chat (modeling_internvl_chat.py:241-308):
        per-question prompt assembly, LEFT-padded batch tokenization so
        generation continues from the prompt tail, one generate call."""
        if self._model is None:
            raise RuntimeError(
                "InternVLChat.batch_chat needs a local HF checkpoint "
                "(weight_path); none was given"
            )
        if num_patches_list is None:
            num_patches_list = ([1] * len(questions)
                                if pixel_values is not None
                                else [0] * len(questions))
        self._model.img_context_token_id = \
            self._tokenizer.convert_tokens_to_ids(self.IMG_CONTEXT)
        queries = []
        for question, num_patches in zip(questions, num_patches_list):
            if pixel_values is not None and "<image>" not in question:
                question = "<image>\n" + question
            queries.append(self.build_query(
                question,
                num_patches_list=[num_patches] if num_patches else []))
        conv = get_conv_template(self.template)
        self._tokenizer.padding_side = "left"
        inputs = self._tokenizer(queries, return_tensors="pt", padding=True)
        pixel_values = self._pixels(pixel_values)
        out = self._model.generate(
            pixel_values=pixel_values, input_ids=inputs.input_ids.to(self.device),
            attention_mask=inputs.attention_mask.to(self.device),
            eos_token_id=self._tokenizer.convert_tokens_to_ids(
                conv.sep.strip()),
            **generation_config)
        texts = self._tokenizer.batch_decode(out, skip_special_tokens=True)
        return [t.split(conv.sep.strip())[0].strip() for t in texts]
