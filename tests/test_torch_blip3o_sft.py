"""The port's BLIP3o SFT dataset (``deco_tpu_torch.data.blip3o_sft``), its
registry node, and the InternVL conversation templates and prompt assembly
(``deco_tpu_torch.models.internvl``) against the JAX package, on the CPU.

The SFT samples are the JPEG members of a webdataset tar, read by each
package's ``PixWebDataset`` (the JAX one on its PIL path), tokenized by a
plain byte-level ``encode`` with one id for ``<image>``; items and
collated batches are compared exactly. Prompts are compared as strings.
"""

import io
import tarfile
import warnings

import numpy as np
import pytest
from PIL import Image

from deco_tpu.config import registry as jax_registry
from deco_tpu.data import blip3o_sft as jsft
from deco_tpu.data import webdataset as jwebdataset
from deco_tpu.models import internvl as jinternvl
from deco_tpu_torch.config import registry
from deco_tpu_torch.data import blip3o_sft as sft
from deco_tpu_torch.data import webdataset
from deco_tpu_torch.models import internvl
from torch_port_util import jax_decodes_with_pil

NODE = "src.data.dataset.blip3o_ori_dataset.LazySupervisedMixDataset"


class ByteTokenizer:
    """``encode``: one id a UTF-8 byte, ``<image>`` one id of its own."""

    IMAGE_ID = 300

    def encode(self, text):
        ids = []
        for i, part in enumerate(text.split("<image>")):
            if i:
                ids.append(self.IMAGE_ID)
            ids.extend(part.encode())
        return ids


@pytest.fixture(scope="module")
def jpeg_tar(tmp_path_factory):
    root = tmp_path_factory.mktemp("sft_tar")
    rng = np.random.default_rng(0)
    members = []
    for i, (h, w) in enumerate([(48, 40), (40, 56), (44, 44), (60, 36)]):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.clip(np.stack([xx * 4.0, yy * 4.0, (xx + yy) * 2.0], -1)
                      + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, progressive=i % 2 == 1)
        members += [(f"{i:03d}.jpg", buf.getvalue()), (f"{i:03d}.cls", str(i).encode())]
    path = root / "sft-0.tar"
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return str(path)


def _sources(jpeg_tar, monkeypatch):
    """The same sample dicts from both packages' PixWebDataset."""
    kw = dict(resolution=32, is_train=False, process_index=0, process_count=1)
    jax_decodes_with_pil(monkeypatch)
    out = []
    for make in (webdataset.PixWebDataset, jwebdataset.PixWebDataset):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            items = list(make(jpeg_tar, **kw))
        out.append([{"image": np.round(md["raw_image"] * 255).astype(np.uint8),
                     "txt": f"a photo of class {c}", "type": "T2I" if c % 2 == 0 else "I2I",
                     "id": str(c)} for _, c, md in items])
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == np.asarray(b[key]).dtype
            np.testing.assert_array_equal(a[key], b[key])
        elif isinstance(a[key], list) and a[key] and isinstance(a[key][0], np.ndarray):
            for x, y in zip(a[key], b[key]):
                np.testing.assert_array_equal(x, y)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("padding_side", ["right", "left"])
def test_items_and_batches_equal_jax_on_a_jpeg_webdataset(jpeg_tar, monkeypatch, padding_side):
    ours_src, jax_src = _sources(jpeg_tar, monkeypatch)
    assert len(ours_src) == 4
    tok = ByteTokenizer()
    ours = sft.make_supervised_data_module(tok, ours_src, image_token_id=tok.IMAGE_ID,
                                           max_len=160, pad_token_id=1)
    ref = jsft.make_supervised_data_module(tok, jax_src, image_token_id=tok.IMAGE_ID,
                                           max_len=160, pad_token_id=1)
    ours["data_collator"].padding_side = ref["data_collator"].padding_side = padding_side
    items = [ours["train_dataset"][i] for i in range(4)]
    ref_items = [ref["train_dataset"][i] for i in range(4)]
    for a, b in zip(items, ref_items):
        _assert_same(a, b)
        assert (a["input_ids"] == sft.IMAGE_TOKEN_INDEX).sum() == 1
    batch = ours["data_collator"](items)
    _assert_same(batch, ref["data_collator"](ref_items))
    assert batch["input_ids"].shape == batch["labels"].shape == (4, 160)
    assert batch["target_images"].shape == (4, 32, 32, 3)


def test_constants_conversations_and_square_padding_equal_jax():
    assert (sft.IGNORE_INDEX, sft.IMAGE_TOKEN_INDEX, sft.DEFAULT_IMAGE_TOKEN,
            sft.SYSTEM_MESSAGE) == (jsft.IGNORE_INDEX, jsft.IMAGE_TOKEN_INDEX,
                                    jsft.DEFAULT_IMAGE_TOKEN, jsft.SYSTEM_MESSAGE)
    for kind in ("T2I", "I2I"):
        assert sft.build_conversation(kind, "a cat") == jsft.build_conversation(kind, "a cat")
    for mod in (sft, jsft):
        with pytest.raises(ValueError, match="Unknown source type"):
            mod.build_conversation("X2Y")
    img = np.arange(5 * 9 * 3, dtype=np.uint8).reshape(5, 9, 3)
    np.testing.assert_array_equal(sft.expand2square(img, (1, 2, 3)),
                                  jsft.expand2square(img, (1, 2, 3)))
    tok = ByteTokenizer()
    convs = [{"from": "gpt", "value": "dropped"}, {"from": "human", "value": "<image>\nhi"},
             {"role": "assistant", "content": "there"}]
    _assert_same(sft.tokenize_conversation(tok, convs, "sys", tok.IMAGE_ID),
                 jsft.tokenize_conversation(tok, convs, "sys", tok.IMAGE_ID))


def test_a_sample_that_fails_is_retried_then_raises_as_in_jax():
    src = [{"image": np.zeros((4, 4, 3), np.uint8), "txt": "x"}] * 3

    def boom(image):
        raise ValueError("bad")

    for mod in (sft, jsft):
        with pytest.raises(RuntimeError, match="undecodable"):
            mod.LazySupervisedMixDataset(ByteTokenizer(), src, image_processor=boom)[0]


def test_registry_node_builds_the_port_dataset():
    assert registry.resolve(NODE) is sft.LazySupervisedMixDataset
    assert jax_registry.resolve(NODE) is jsft.LazySupervisedMixDataset
    src = [{"image": None, "txt": "a", "type": "T2I"}]
    ds = registry.instantiate({"class_path": NODE, "init_args": {
        "tokenizer": ByteTokenizer(), "source": src, "seed": 3}})
    assert isinstance(ds, sft.LazySupervisedMixDataset) and len(ds) == 1
    _assert_same(ds[0], jsft.LazySupervisedMixDataset(ByteTokenizer(), src, seed=3)[0])


# ---- the InternVL conversation templates and prompt assembly ----

def test_every_jax_template_is_registered():
    assert sorted(internvl._TEMPLATES) == sorted(jinternvl._TEMPLATES)


@pytest.mark.parametrize("name", sorted(jinternvl._TEMPLATES))
def test_template_prompt_equals_jax(name):
    prompts = []
    for mod in (internvl, jinternvl):
        conv = mod.get_conv_template(name)
        conv.append_message(conv.roles[0], "What is in the picture?")
        conv.append_message(conv.roles[1], "A cat.")
        conv.append_message(conv.roles[0], "And its colour?")
        conv.append_message(conv.roles[1], None)
        copy = conv.copy()
        assert copy.messages == conv.messages and copy.messages is not conv.messages
        prompts.append((conv.get_prompt(), conv.sep, conv.roles, conv.system_message))
        assert mod.get_conv_template(name).messages == []  # the registered one is untouched
    assert prompts[0] == prompts[1]


def test_register_conv_template_refuses_a_duplicate_as_jax(monkeypatch):
    monkeypatch.setattr(internvl, "_TEMPLATES", dict(internvl._TEMPLATES))
    monkeypatch.setattr(jinternvl, "_TEMPLATES", dict(jinternvl._TEMPLATES))
    for mod in (internvl, jinternvl):
        with pytest.raises(ValueError, match="already registered"):
            mod.register_conv_template(mod.Conversation(name="phi3-chat"))
        mod.register_conv_template(mod.Conversation(name="phi3-chat", sep="<|x|>"),
                                   override=True)
        mod.register_conv_template(mod.Conversation(name="mine", system_message="s"))
    assert internvl.get_conv_template("mine").get_prompt() == \
        jinternvl.get_conv_template("mine").get_prompt()
    assert internvl.get_conv_template("phi3-chat").sep == "<|x|>"


@pytest.mark.parametrize("template", sorted(jinternvl._TEMPLATES))
@pytest.mark.parametrize("case", ["text", "one_image", "two_images", "history_system"])
def test_build_query_equals_jax(template, case):
    question, kw = {
        "text": ("Describe a sunset.", {}),
        "one_image": ("<image>\nWhat is this?", dict(num_patches_list=[3])),
        "two_images": ("Image-1: <image>\nImage-2: <image>\nCompare them.",
                       dict(num_patches_list=[1, 2])),
        "history_system": ("<image>\nAnd now?", dict(
            num_patches_list=[1], system_message="Be brief.",
            history=[("Hi", "Hello!"), ("Who are you?", "An assistant.")])),
    }[case]
    ours = internvl.InternVLChat(template=template, num_image_token=4).build_query(question, **kw)
    ref = jinternvl.InternVLChat(template=template, num_image_token=4).build_query(question, **kw)
    assert ours == ref
    assert ours.count(internvl.InternVLChat.IMG_CONTEXT) == 4 * sum(kw.get("num_patches_list", []))


def test_chat_without_weights_raises_as_jax():
    for mod in (internvl, jinternvl):
        chat = mod.InternVLChat()
        with pytest.raises(RuntimeError, match="weight_path"):
            chat.chat("hello")
        with pytest.raises(RuntimeError, match="weight_path"):
            chat.batch_chat(["hello"])


class _StubTokenizer:
    """Token ids from the characters of each query, padded on
    ``padding_side``; ``batch_decode`` echoes each row's sum."""

    padding_side = "right"
    IDS = {"<IMG_CONTEXT>": 7, "<|im_end|>": 2}

    def convert_tokens_to_ids(self, token):
        return self.IDS.get(token, 3)

    def __call__(self, text, return_tensors="pt", padding=False):
        import torch

        rows = [[ord(ch) % 97 + 3 for ch in t[-6 - i:]] for i, t in
                enumerate([text] if isinstance(text, str) else text)]
        width = max(len(r) for r in rows)
        ids, mask = [], []
        for r in rows:
            pad = [0] * (width - len(r))
            ids.append(pad + r if self.padding_side == "left" else r + pad)
            mask.append([0] * len(pad) + [1] * len(r) if self.padding_side == "left"
                        else [1] * len(r) + [0] * len(pad))
        return type("Batch", (), {"input_ids": torch.tensor(ids),
                                  "attention_mask": torch.tensor(mask)})()

    def batch_decode(self, out, skip_special_tokens=True):
        return [f" answer {int(row.sum())}<|im_end|> tail" for row in out]


class _StubModel:
    """Records ``generate``'s arguments and where it was moved."""

    def __init__(self):
        import torch

        self.dtype, self.device, self.calls = torch.bfloat16, None, []

    def to(self, device):
        self.device = device
        return self

    def eval(self):
        return self

    def generate(self, **kw):
        self.calls.append(kw)
        return kw["input_ids"][:, :3] + 1


def _stub_transformers(monkeypatch):
    import sys
    import types

    made = []

    def model(path, **kw):
        made.append(_StubModel())
        return made[-1]

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = type("AutoTokenizer", (), {
        "from_pretrained": staticmethod(lambda path, **kw: _StubTokenizer())})
    fake.AutoModelForCausalLM = type("AutoModelForCausalLM", (), {
        "from_pretrained": staticmethod(model)})
    monkeypatch.setitem(sys.modules, "transformers", fake)
    return made


def test_chat_with_weights_drives_generate_as_jax_on_the_asked_device(monkeypatch):
    """With a checkpoint (``transformers`` stubbed: no InternVL weights are
    in the repository) ``chat`` and ``batch_chat`` hand ``generate`` the
    JAX class's token ids, mask, pixels and end token, and return its
    answers; the port moves the model and every input to its device, the
    card unless the CPU is asked for."""
    import torch

    made = _stub_transformers(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        internvl.InternVLChat(weight_path="ckpt", num_image_token=2)  # the card by default
    made.clear()
    ours = internvl.InternVLChat(weight_path="ckpt", num_image_token=2, device="cpu")
    ref = jinternvl.InternVLChat(weight_path="ckpt", num_image_token=2)
    assert made[0].device == torch.device("cpu")
    pixels = np.random.default_rng(0).normal(size=(2, 3, 8, 8)).astype(np.float32)
    runs = [
        lambda chat: chat.chat("what is this?", pixel_values=pixels, max_new_tokens=4),
        lambda chat: chat.chat("and now?", history=[("hi", "hello")], return_history=True),
        lambda chat: chat.batch_chat(["one", "<image>\ntwo"], pixel_values=pixels[:1],
                                     num_patches_list=[1, 1], do_sample=False),
        lambda chat: chat.batch_chat(["text only", "again"]),
    ]
    for run in runs:
        assert run(ours) == run(ref)
        got, want = made[0].calls[-1], made[1].calls[-1]
        assert got.keys() == want.keys()
        for key, value in want.items():
            if torch.is_tensor(value):
                assert got[key].device == torch.device("cpu") and got[key].dtype == value.dtype
                assert torch.equal(got[key], value), key
            else:
                assert got[key] == value, key
