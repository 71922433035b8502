"""The port's PNG decoder (``deco_tpu_torch/utils/png.py`` over
``deco_tpu_torch/csrc/png_decode.cpp``) against PIL, and the port's readers
on PNG files against the JAX package's, on the CPU.

The decoder is held byte for byte to ``Image.open(f).convert("RGB")``: on
the committed fixtures (``torch_png_fixtures/``: every colour type at every
bit depth, plain and Adam7, ``tRNS``, short palettes, an RGB file with a
``PLTE``, with the digests the card's host checks), on the 16-bit and
sub-byte rules, on APNG default images and on seeded corruptions (a file
PIL refuses raises ``ValueError``; one PIL decodes gives PIL's image). The
C++ unfilter equals the plain numpy/Python one on seeded rows of every
filter and filter unit. The readers' items over a palette, an RGB and a
gray + alpha PNG (ROADMAP §C 14's reproduction) equal the JAX readers' byte
for byte.
"""

import hashlib
import io
import json
import os
import struct
import tarfile
import threading
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from deco_tpu.data import image_txt as jimage_txt
from deco_tpu.data import imagenet as jimagenet
from deco_tpu.data import jsonl as jjsonl
from deco_tpu.data import packed as jpacked
from deco_tpu.data import webdataset as jwebdataset
from deco_tpu_torch.data import image_txt, imagenet, jsonl, packed, webdataset
from deco_tpu_torch.utils import png
from torch_png_fixtures import generate
from torch_port_util import jax_decodes_with_pil

FIXTURES = generate.HERE
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)["files"]


def pil_rgb(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # palette transparency given as bytes
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))


def pil_png(image, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "PNG", **kw)
    return buf.getvalue()


def assert_decodes_or_raises_as_pil(data: bytes):
    try:
        ref = pil_rgb(data)
    except Exception:  # noqa: BLE001 - PIL's OSError, SyntaxError, ValueError
        with pytest.raises(ValueError):
            png.decode(data)
        return
    ours = png.decode(data)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


# ---- the decoder against PIL ----

@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_decodes_to_its_pil_digest(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    ours = png.decode(data)
    assert list(ours.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(ours.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
    np.testing.assert_array_equal(ours, pil_rgb(data))


def test_the_fixtures_cover_every_kind():
    kinds = set()
    for name in DIGESTS:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", f.read(29)[16:29])
        kinds.add((depth, color, interlace))
    every = {(d, c, i) for c, depths in generate.DEPTHS.items() for d in depths for i in (0, 1)}
    assert every <= kinds
    assert {DIGESTS[n]["mode"] for n in DIGESTS} == {"1", "L", "LA", "P", "RGB", "RGBA", "I;16"}


def _gray16(values, color=0) -> bytes:
    arr = np.asarray(values).reshape(1, -1, 1)
    if color == 4:
        arr = np.concatenate([arr, np.full_like(arr, 7)], -1)
    return generate.encode(arr, color, 16)


def test_sixteen_bit_rules_as_pil():
    values = [0, 255, 256, 1000, 40000, 65535]
    np.testing.assert_array_equal(png.decode(_gray16(values))[0, :, 0],
                                  [0, 255, 255, 255, 255, 255])  # I;16 clipped, not scaled
    np.testing.assert_array_equal(png.decode(_gray16([1000, 40000], color=4))[0, :, 0],
                                  [3, 156])  # gray + alpha: the high byte
    rgb = generate.encode(np.array([[[0x567F, 0x1234, 0xFFFF]]]), 2, 16)
    np.testing.assert_array_equal(png.decode(rgb)[0, 0], [0x56, 0x12, 0xFF])  # truncated
    for data in (_gray16(values), _gray16([1000, 40000], 4), rgb):
        assert_decodes_or_raises_as_pil(data)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_sub_byte_gray_scales_as_pil(depth):
    arr = np.arange(1 << depth).reshape(1, -1, 1)
    ours = png.decode(generate.encode(arr, 0, depth))[0, :, 0]
    np.testing.assert_array_equal(ours, arr[0, :, 0] * (255 // ((1 << depth) - 1)))
    assert_decodes_or_raises_as_pil(generate.encode(arr, 0, depth))


def test_palette_index_past_the_palette_is_black():
    data = generate.encode(np.array([[[0], [1], [2], [255]]]), 3, 8, palette=bytes(range(6)))
    np.testing.assert_array_equal(png.decode(data)[0], [[0, 1, 2], [3, 4, 5], [0, 0, 0],
                                                        [0, 0, 0]])
    assert_decodes_or_raises_as_pil(data)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P"])
def test_apng_default_image_as_pil(mode):
    frames = [generate.pil_image(11, 13, "RGBA", seed=i) for i in range(3)]
    frames = [f.convert(mode) for f in frames]
    for default_image in (False, True):
        data = pil_png(frames[0], save_all=True, append_images=frames[1:],
                       default_image=default_image)
        assert_decodes_or_raises_as_pil(data)


def test_decode_apng_reads_the_encoded_frames_through_the_library():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (9, 14, 3), np.uint8) for _ in range(4)]
    ours, delays = png.decode_apng(png.encode_apng(frames, delay_ms=70))
    assert delays == [70.0] * 4
    for a, b in zip(ours, frames):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_cpp_unfilter_equals_the_plain_one(bpp):
    rng = np.random.default_rng(bpp)
    stride = bpp * 23
    rows = 40
    raw = rng.integers(0, 256, (rows, stride + 1), np.uint8)
    raw[:, 0] = np.arange(rows) % 5  # every filter, each above every other
    rng.shuffle(raw[:, 0])
    raw = raw.tobytes()
    np.testing.assert_array_equal(png.unfilter(raw, rows, stride, bpp),
                                  png.unfilter_plain(raw, rows, stride, bpp))


def test_unknown_filter_raises_in_both():
    raw = bytes([0, 1, 2, 5, 3, 4])
    for fn in (png.unfilter, png.unfilter_plain):
        with pytest.raises(ValueError, match="filter"):
            fn(raw, 2, 2, 1)


def test_threads_decode_at_once():
    with open(os.path.join(FIXTURES, "pil_RGB_512x512.png"), "rb") as f:
        data = f.read()
    want = png.decode(data)
    out = [None] * 8
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, png.decode(data)))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for o in out:
        np.testing.assert_array_equal(o, want)


def test_a_decompression_bomb_raises_before_any_allocation():
    ihdr = struct.pack(">IIBBBBB", 20000, 20000, 8, 2, 0, 0, 0)
    data = (png.SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(b""))
            + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="decompression-bomb"):
        png.decode(data)


# ---- corrupt data: raised where PIL raises, else PIL's image ----

def _chunk_spans(data: bytes):
    pos, out = 8, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((kind, pos, length))
        pos += 12 + length
    return out


def _corruptions(data: bytes, seed: int):
    """Seeded corruptions of one file: cuts, flipped bytes in the image
    data, in its checksum and in the header chunk's checksum, a bad filter
    byte's worth of zlib noise."""
    rng = np.random.default_rng(seed)
    spans = _chunk_spans(data)
    _, pos, length = next(s for s in spans if s[0] == b"IDAT")
    out = [data[:int(c)] for c in rng.integers(9, len(data), 6)]
    for off in rng.integers(0, length, 8):
        d = bytearray(data)
        d[pos + 8 + int(off)] ^= int(rng.integers(1, 256))
        out.append(bytes(d))
    for at in (pos + 8 + length, 8 + 8 + 13):  # the IDAT and IHDR checksums
        d = bytearray(data)
        d[at] ^= 0x40
        out.append(bytes(d))
    return out


@pytest.mark.parametrize("name", ["pil_P8_trns_37x29.png", "pil_LA_37x29.png",
                                  "c2_d16_adam7_37x29.png", "c0_d1_37x29.png"])
def test_seeded_corruptions_decode_or_raise_as_pil(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    for i, bad in enumerate(_corruptions(data, seed=len(name))):
        assert_decodes_or_raises_as_pil(bad)


# ---- ROADMAP §C 14: the readers against the JAX readers ----

def _c14_files():
    """A palette PNG, an RGB PNG and a gray + alpha PNG, written by Pillow."""
    return [("0_palette.png", pil_png(generate.pil_image(70, 90, "P", seed=1))),
            ("1_rgb.png", pil_png(generate.pil_image(64, 80, "RGB", seed=2))),
            ("2_gray_alpha.png", pil_png(generate.pil_image(75, 66, "LA", seed=3)))]


def _write_tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return str(path)


@pytest.fixture(scope="module")
def c14_tar(tmp_path_factory):
    root = tmp_path_factory.mktemp("c14_tar")
    members = []
    for i, (name, data) in enumerate(_c14_files()):
        key = os.path.splitext(name)[0]
        members += [(f"{key}.png", data), (f"{key}.cls", str(i).encode()),
                    (f"{key}.txt", f"caption {i}".encode())]
    return _write_tar(root / "shard-0.tar", members)


def _same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[2]["raw_image"], b[2]["raw_image"])


@pytest.mark.parametrize("crop", ["center", "random"])
def test_c14_tar_gives_every_item_as_jax(c14_tar, monkeypatch, crop):
    jax_decodes_with_pil(monkeypatch)
    kw = dict(resolution=32, random_crop=crop == "random", random_flip=True, buffer_size=2,
              process_index=0, process_count=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ours = list(webdataset.PixWebDataset(c14_tar, **kw))
    assert not [w for w in caught if "skipping" in str(w.message)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = list(jwebdataset.PixWebDataset(c14_tar, **kw))
    assert len(ours) == len(ref) == 3
    _same(ours, ref)


def test_c14_jsonl_returns_the_palette_image_as_jax(tmp_path, monkeypatch):
    jax_decodes_with_pil(monkeypatch)
    names = []
    for name, data in _c14_files():
        (tmp_path / name).write_bytes(data)
        names.append(name)
    ann = tmp_path / "ann.jsonl"
    ann.write_text("\n".join(json.dumps({"target_image": n}) for n in names) + "\n")
    for crop in (False, True):
        kw = dict(resolution=32, random_crop=crop, random_flip=True, seed=7)
        ours = jsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
        ref = jjsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
        _same([ours[i] for i in range(3)], [ref[i] for i in range(3)])
    item = jsonl.PixJSONLDataset(str(tmp_path), str(ann), resolution=64)[0]
    palette = imagenet.adm_center_crop(pil_rgb(_c14_files()[0][1]), 64)
    np.testing.assert_array_equal(item[2]["raw_image"], palette.astype(np.float32) / 255.0)


def test_c14_packed_stream_gives_every_item_as_jax(c14_tar):
    kw = dict(resolution=40, random_crop=True, shuffle_buffer=2, repeat=False, seed=2,
              shard_index=0, shard_count=1)
    ours = list(packed.WebDatasetPacked(os.path.dirname(c14_tar), **kw))
    ref = list(jpacked.WebDatasetPacked(os.path.dirname(c14_tar), **kw))
    assert len(ours) == len(ref) == 3
    for (x, text, md), (rx, rtext, rmd) in zip(ours, ref):
        assert text == rtext
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(md["raw_image"], rmd["raw_image"])


def test_c14_folder_readers_give_the_jax_items(tmp_path, monkeypatch):
    jax_decodes_with_pil(monkeypatch)
    for i, (name, data) in enumerate(_c14_files()):
        os.makedirs(tmp_path / "folder" / f"n{i % 2}", exist_ok=True)
        (tmp_path / "folder" / f"n{i % 2}" / name).write_bytes(data)
        (tmp_path / "txt").mkdir(exist_ok=True)
        (tmp_path / "txt" / name).write_bytes(data)
        (tmp_path / "txt" / (os.path.splitext(name)[0] + ".txt")).write_text(f"caption {i}")
    folder = str(tmp_path / "folder")
    for kw in (dict(), dict(random_crop=True, random_flip=True)):
        ours = imagenet.PixImageNet(folder, resolution=48, seed=5, **kw)
        ref = jimagenet.PixImageNet(folder, resolution=48, seed=5, **kw)
        _same([ours[i] for i in range(3)], [ref[i] for i in range(3)])
    ours = image_txt.ImageText(str(tmp_path / "txt"), 56)
    ref = jimage_txt.ImageText(str(tmp_path / "txt"), 56)
    assert len(ours) == len(ref) == 3
    for i in range(3):
        (x, text, _), (rx, rtext, _) = ours[i], ref[i]
        assert text == rtext
        np.testing.assert_array_equal(x, rx)


def test_corrupt_members_are_skipped_where_jax_skips(tmp_path, monkeypatch):
    jax_decodes_with_pil(monkeypatch)
    files = _c14_files()
    data = files[1][1]
    spans = _chunk_spans(data)
    _, pos, length = next(s for s in spans if s[0] == b"IDAT")
    bad_crc = bytearray(data)
    bad_crc[pos + 8 + length] ^= 1  # PIL does not check the image data's checksum
    bad_zlib = bytearray(data)
    bad_zlib[pos + 10] ^= 0xFF
    members = [("a.png", files[0][1]), ("b.png", data[:len(data) // 2]), ("c.png", bytes(bad_crc)),
               ("d.png", bytes(bad_zlib)), ("e.png", files[2][1])]
    tar = _write_tar(tmp_path / "shard-0.tar", members)
    kw = dict(resolution=32, random_crop=False, buffer_size=2, process_index=0, process_count=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = list(webdataset.PixWebDataset(tar, **kw))
        ref = list(jwebdataset.PixWebDataset(tar, **kw))
    assert len(ours) == len(ref) == 3
    _same(ours, ref)
