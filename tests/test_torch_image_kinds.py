"""The port's WebP, GIF and BMP decoders (``deco_tpu_torch/csrc/
{webp,gif,bmp}_decode.cpp`` through ``deco_tpu_torch.data.{webp,gif,bmp}``)
against PIL, and the port's readers on mixed WebP/GIF/BMP data against the
JAX package's, on the CPU.

PIL is the judge, under Pillow 12.1 over libwebp 1.6: every committed
fixture (``torch_image_fixtures/``, with the digests the card's host
checks) decodes equal byte for byte to ``Image.open(f).convert("RGB")``; on
seeded corruptions of each format (bytes replaced, bits flipped, runs cut
or inserted, files cut short) the port raises ``ValueError`` exactly where
Pillow raises and gives Pillow's bytes everywhere else; the readers
(``PixImageNet``, ``ImageText``, ``PixWebDataset`` with ``.webp`` members,
``PixJSONLDataset`` and the packed tar stream) give the JAX readers'
items. The formats Pillow decodes and the port does not raise
``NotImplementedError`` naming ROADMAP §A 2e.
"""

import hashlib
import io
import json
import os
import struct
import tarfile
import warnings

import chip_smoke
import numpy as np
import pytest
from PIL import Image

from deco_tpu.data import image_txt as jimage_txt
from deco_tpu.data import imagenet as jimagenet
from deco_tpu.data import jsonl as jjsonl
from deco_tpu.data import packed as jpacked
from deco_tpu.data import webdataset as jwebdataset
from deco_tpu_torch.data import bmp, gif, image_txt, imagenet, jsonl, packed, webdataset, webp
from torch_image_fixtures import generate

FIXTURES = generate.HERE
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    _WRITTEN = json.load(_f)
DIGESTS, GENERATED = _WRITTEN["files"], _WRITTEN["generated"]


def pil_rgb(data: bytes):
    """Pillow's ``convert("RGB")``, or None where Pillow raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any failure of Pillow's is a refusal
        return None


def fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def assert_decodes_or_raises_as_pil(data: bytes, what=""):
    ref = pil_rgb(data)
    try:
        ours = imagenet.decode_image(data)
    except ValueError as err:
        assert ref is None, f"{what}: the port refuses what PIL decodes: {err}"
        return False
    assert ref is not None, f"{what}: the port decodes what PIL refuses"
    assert ours.dtype == np.uint8 and ours.shape == ref.shape, what
    np.testing.assert_array_equal(ours, ref, err_msg=str(what))
    return True


# ---- the decoders against PIL ----

@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_decodes_to_its_pil_digest(name):
    data = fixture(name)
    rgb = imagenet.decode_image(data)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
    assert list(rgb.shape) == DIGESTS[name]["shape"]
    np.testing.assert_array_equal(rgb, pil_rgb(data))


def test_generated_fixtures_decode_to_their_pil_digests():
    """The files written at run time (the 512 x 512 24-bit BMP of the card
    host's timing) are what digests.json describes."""
    for name, data in generate.generated_files().items():
        rgb = imagenet.decode_image(data)
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == GENERATED[name]["sha256"], name
        np.testing.assert_array_equal(rgb, pil_rgb(data))


def test_info_reads_the_headers():
    assert bmp.info(fixture("bmp_rle4.bmp")) == (23, 37, 4, True)
    assert gif.info(fixture("gif_gray_ramp.gif")) == (29, 41, "L", False)
    assert gif.info(fixture("gif_frame_past_screen.gif"))[:2] == (31, 44)
    assert webp.info(fixture("webp_animated_lossy.webp")) == (48, 61, 3, False)
    assert webp.info(fixture("webp_lossless_2_colors.webp")) == (48, 61, 1, True)


def _mutate(data: bytes, rng, header: int) -> bytes:
    """One or two of: a byte replaced, a bit flipped, a run cut or
    inserted, the file cut short; a third of them in the first ``header``
    bytes."""
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 3))):
        if len(d) < 2:
            break
        i = int(rng.integers(0, min(len(d), header))) if rng.random() < 0.33 else int(
            rng.integers(0, len(d)))
        kind = int(rng.integers(0, 5))
        if kind == 0:
            d[i] = int(rng.integers(0, 256))
        elif kind == 1:
            d[i] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            del d[i:i + int(rng.integers(1, 16))]
        elif kind == 3:
            d[i:i] = rng.integers(0, 256, int(rng.integers(1, 8))).astype(np.uint8).tobytes()
        else:
            d = d[:i]
    return bytes(d)


SWEEP = {  # format: (fixtures mutated, header bytes, streams)
    "bmp": ([n for n in DIGESTS if n.startswith("bmp_")], 70, 400),
    "gif": ([n for n in DIGESTS if n.startswith("gif_") and "512" not in n], 40, 1000),
    "webp": ([n for n in DIGESTS if n.startswith("webp_") and "512" not in n], 60, 1000),
}


@pytest.mark.parametrize("kind", sorted(SWEEP))
def test_mutated_streams_decode_or_raise_as_pil(kind):
    """Seeded corruptions of every fixture of a format (bit flips, bytes
    replaced, runs cut or inserted, files cut short; a third of them in the
    headers): ``ValueError`` where Pillow raises, Pillow's bytes where it
    decodes; 400 BMP streams (a corrupt BMP header can ask Pillow for a
    canvas of 10^8 pixels, slow to fill), 1,000 GIF and 1,000 WebP."""
    names, header, count = SWEEP[kind]
    seeds = [fixture(n) for n in sorted(names)]
    rng = np.random.default_rng({"bmp": 1, "gif": 2, "webp": 3}[kind])
    decoded = 0
    for trial in range(count):
        data = _mutate(seeds[trial % len(seeds)], rng, header)
        decoded += assert_decodes_or_raises_as_pil(data, (kind, trial))
    assert 0 < decoded < count  # both outcomes were exercised


def test_a_bmp_rle_stream_that_ends_early_raises_as_pil():
    """Pillow's RLE decoder stops at the end of the bitmap (or of the file)
    and refuses an image it did not fill; a delta reads four bytes."""
    data = fixture("bmp_rle8.bmp")
    offset = struct.unpack("<I", data[10:14])[0]
    early = data[:offset + 40] + b"\0\1"
    assert not assert_decodes_or_raises_as_pil(early)
    with pytest.raises(ValueError, match="RLE"):
        bmp.decode(early)
    assert not assert_decodes_or_raises_as_pil(data[:offset + 41])


def _short_frame(w: int, h: int, indices: np.ndarray) -> bytes:
    """An image descriptor of w x h whose LZW data (ending in an end code)
    holds only ``indices``."""
    return (b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + bytes([8])
            + generate.lzw(indices.reshape(-1), 8))


def test_a_gif_end_code_ends_the_image_only_at_the_end_of_the_data_read():
    """Pillow feeds its LZW decoder 65,536 bytes at a time: an end code
    before the last pixel fails in a small file, and where more data
    follows the codes after it are decoded on (here: the rest of the file,
    read as LZW codes)."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 256, (300, 300)).astype(np.uint8)
    table = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    small = generate.encode_gif(30, 20, [_short_frame(30, 20, idx[:10, :30])], table)
    assert not assert_decodes_or_raises_as_pil(small)
    with pytest.raises(ValueError, match="end code"):
        gif.decode(small)
    large = generate.encode_gif(300, 300, [_short_frame(300, 300, idx[:60]),
                                           generate.gif_frame(idx)], table)
    assert len(large) > 65536
    assert_decodes_or_raises_as_pil(large)
    assert assert_decodes_or_raises_as_pil(
        generate.encode_gif(300, 300, [generate.gif_frame(idx)], table))


def test_webp_alpha_chunks_fail_where_libwebp_fails():
    """ALPH is dropped by convert("RGB"), but a header libwebp refuses, or
    compressed alpha cut short, fails the decode as libwebp fails it."""
    data = fixture("webp_lossy_alpha.webp")
    at = data.index(b"ALPH") + 8
    for change in (0x03, 0xC0, 0x30, 0x0C):
        d = bytearray(data)
        d[at] ^= change
        assert_decodes_or_raises_as_pil(bytes(d), change)
    size = struct.unpack("<I", data[at - 4:at])[0]
    d = bytearray(data)
    d[at + 1:at + size] = bytes(size - 1)
    assert_decodes_or_raises_as_pil(bytes(d), "zeroed alpha")


def test_animated_webp_and_gif_give_the_first_frame_on_its_canvas():
    """The first frame where it lies on the canvas (the canvas outside it
    zeroed as WebPAnimDecoder zeroes it; a GIF's screen as Pillow fills
    it), and a frame placed past the canvas refused as libwebp refuses it."""
    for name in ("webp_animated_lossy.webp", "webp_animated_lossless_rgba.webp",
                 "webp_animated_offset_frames.webp", "gif_pillow_animated.gif",
                 "gif_frame_inside_screen.gif", "gif_transparency.gif"):
        assert assert_decodes_or_raises_as_pil(fixture(name), name)
    buf = io.BytesIO()
    Image.fromarray(generate.photo_like(20, 24, 1)).save(buf, "WEBP", quality=80)
    for x, y, ok in ((36, 28, True), (38, 28, False), (36, 30, False)):
        data = generate.encode_animated_webp(61, 48, [(x, y, buf.getvalue())])
        assert assert_decodes_or_raises_as_pil(data, (x, y)) == ok


@pytest.mark.parametrize("decoder, name", [(webp, "webp_lossy_q75_m4.webp"),
                                           (gif, "gif_global_256.gif"),
                                           (bmp, "bmp_rle8.bmp")])
def test_threads_decode_at_once_to_the_same_bytes(decoder, name):
    from concurrent.futures import ThreadPoolExecutor

    data = fixture(name)
    want = decoder.decode(data)
    with ThreadPoolExecutor(4) as pool:
        for out in pool.map(decoder.decode, [data] * 16):
            np.testing.assert_array_equal(out, want)


# ---- the formats Pillow decodes and the port does not (ROADMAP §A 2e) ----

def _pil_written(fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    mode = {"XBM": "1", "MSP": "1", "BLP": "P", "IM": "RGB"}.get(fmt, "RGB")
    im = Image.fromarray(generate.photo_like(16, 16, 5)).convert(mode)
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# a sample of each format of imagenet.OTHER_FORMATS: Pillow writes those it
# can; the others are the prefix each plugin's _accept tests
OTHER_SAMPLES = {
    "AVIF": lambda: b"\0\0\0\x1cftypavif" + bytes(16),
    "BLP": lambda: _pil_written("BLP"),
    "CUR": lambda: b"\0\0\2\0\1\0" + bytes(16),
    "DCX": lambda: struct.pack("<I", 0x3ADE68B1) + bytes(16),
    "DDS": lambda: _pil_written("DDS"),
    "DIB": lambda: _pil_written("DIB"),
    "EPS": lambda: b"%!PS-Adobe-3.0 EPSF-3.0\n" + bytes(16),
    "FITS": lambda: b"SIMPLE  =                    T" + bytes(16),
    "FLI": lambda: struct.pack("<IHHHHH", 128, 0xAF11, 1, 16, 16, 8) + bytes(16),
    "FTEX": lambda: b"FTEX" + bytes(16),
    "GBR": lambda: struct.pack(">II", 28, 2) + bytes(16),
    "ICNS": lambda: b"icns" + bytes(16),
    "ICO": lambda: _pil_written("ICO"),
    "IM": lambda: _pil_written("IM"),
    "JPEG2000": lambda: _pil_written("JPEG2000"),
    "MCIDAS": lambda: b"\0\0\0\0\0\0\0\4" + bytes(16),
    "MSP": lambda: _pil_written("MSP"),
    "PCD": lambda: bytes(2048) + b"PCD_" + bytes(16),
    "PCX": lambda: _pil_written("PCX"),
    "PIXAR": lambda: b"\x80\xe8\0\0" + bytes(16),
    "PPM": lambda: _pil_written("PPM"),
    "PSD": lambda: b"8BPS\0\1" + bytes(16),
    "QOI": lambda: _pil_written("QOI"),
    "SGI": lambda: _pil_written("SGI"),
    "SUN": lambda: b"\x59\xa6\x6a\x95" + bytes(16),
    "TIFF": lambda: _pil_written("TIFF"),
    "XBM": lambda: _pil_written("XBM"),
    "XPM": lambda: b"/* XPM */\n" + bytes(16),
    "XVTHUMB": lambda: b"P7 332\n" + bytes(16),
}


@pytest.mark.parametrize("fmt", [name for name, _ in imagenet.OTHER_FORMATS])
def test_other_formats_pillow_decodes_raise_naming_2e(fmt):
    """Pillow recognises the sample (its plugin's ``_accept``, or its
    header), and where Pillow wrote it, opens and decodes it; the port
    raises ``NotImplementedError`` naming ROADMAP §A 2e, so a stream reader
    stops where the JAX reader would train on the sample."""
    Image.init()
    data = OTHER_SAMPLES[fmt]()
    _, accept = Image.OPEN[fmt]
    assert accept is None or accept(data[:16]), fmt
    if fmt in ("BLP", "DDS", "DIB", "ICO", "IM", "JPEG2000", "MSP", "PCX", "PPM", "QOI", "SGI",
               "TIFF", "XBM"):
        assert pil_rgb(data) is not None
    assert imagenet.other_format(data) == fmt
    with pytest.raises(NotImplementedError, match=f"{fmt}.*ROADMAP §A 2e"):
        imagenet.decode_image(data)


def test_a_riff_that_is_not_webp_and_unknown_bytes_raise_value_error():
    for data in (b"RIFF\x24\0\0\0WAVEfmt " + bytes(32), b"RIFF\x10\0\0\0WEBPXXXX" + bytes(8),
                 b"\x00\x01 not an image", b""):
        assert pil_rgb(data) is None
        with pytest.raises(ValueError):
            imagenet.decode_image(data)


# ---- the readers on mixed WebP/GIF/BMP data against the JAX readers ----

MIXED = ["webp_lossy_q75_m4.webp", "webp_lossless_photo.webp", "webp_lossy_alpha.webp",
         "webp_animated_lossy.webp", "gif_global_256.gif", "gif_transparency.gif",
         "bmp_24bpp.bmp", "bmp_rle4.bmp", "bmp_32bpp_bgra_v3.bmp"]


@pytest.fixture(scope="module")
def mixed_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed_folder")
    for i, name in enumerate(MIXED):
        os.makedirs(root / f"c{i % 2}", exist_ok=True)
        (root / f"c{i % 2}" / name).write_bytes(fixture(name))
    return str(root)


def _same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[2]["raw_image"], b[2]["raw_image"])


@pytest.mark.parametrize("kw", [dict(), dict(random_crop=True, random_flip=True)],
                         ids=["center", "random_crop"])
def test_pix_imagenet_mixed_kinds_equal_jax(mixed_folder, kw):
    ours = imagenet.PixImageNet(mixed_folder, resolution=24, seed=3, **kw)
    ref = jimagenet.PixImageNet(mixed_folder, resolution=24, seed=3, **kw)
    assert len(ours) == len(ref) == len(MIXED) - 2  # the folder scan takes no .gif
    _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])


def test_image_text_mixed_kinds_equals_jax(tmp_path):
    """``ImageText`` lists .png and .jpg names (as the JAX reader does) and
    decodes what they hold: WebP, GIF and BMP bytes under those names read
    as the JAX reader reads them."""
    for i, name in enumerate(MIXED):
        (tmp_path / f"{i}{('.jpg', '.png')[i % 2]}").write_bytes(fixture(name))
        (tmp_path / f"{i}.txt").write_text(f"caption {i}")
    ours = image_txt.ImageText(str(tmp_path), 24)
    ref = jimage_txt.ImageText(str(tmp_path), 24)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        (x, text, md), (rx, rtext, rmd) = ours[i], ref[i]
        assert text == rtext and md["image_path"] == rmd["image_path"]
        np.testing.assert_array_equal(x, rx)


@pytest.fixture(scope="module")
def mixed_tar(tmp_path_factory):
    """A webdataset tar of .webp members (WebP, and a GIF and a BMP as a
    scraped shard may hold them), one of them cut short."""
    root = tmp_path_factory.mktemp("mixed_tar")
    names = [n for n in DIGESTS if n.startswith("webp_") and "512" not in n]
    names = sorted(names) + ["gif_transparency.gif", "bmp_rle4.bmp"]
    with tarfile.open(root / "shard-0.tar", "w") as tf:
        for i, name in enumerate(names):
            data = fixture(name)
            if i == 3:
                data = data[:len(data) // 2]
            ext = ".webp" if i % 3 else ".jpg"  # the packed stream takes .jpg and .png only
            for member, payload in ((f"{i:03d}{ext}", data), (f"{i:03d}.cls", str(i).encode()),
                                    (f"{i:03d}.txt", f"caption {i}".encode())):
                info = tarfile.TarInfo(member)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    return str(root / "shard-0.tar"), len(names)


def test_pix_webdataset_webp_members_equal_jax(mixed_tar):
    shard, count = mixed_tar
    kw = dict(resolution=24, random_crop=True, random_flip=True, buffer_size=3,
              process_index=0, process_count=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = list(webdataset.PixWebDataset(shard, **kw))
        ref = list(jwebdataset.PixWebDataset(shard, **kw))
    assert len(ours) == len(ref) == count - 1
    _same(ours, ref)


def test_webdataset_packed_webp_members_equal_jax(mixed_tar):
    shard, count = mixed_tar
    kw = dict(resolution=24, random_crop=True, shuffle_buffer=3, repeat=False, seed=2,
              shard_index=0, shard_count=1)
    ours = list(packed.WebDatasetPacked(os.path.dirname(shard), **kw))
    ref = list(jpacked.WebDatasetPacked(os.path.dirname(shard), **kw))
    assert len(ours) == len(ref) > 0
    for (x, text, md), (rx, rtext, rmd) in zip(ours, ref):
        assert text == rtext
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(md["raw_image"], rmd["raw_image"])


def test_jsonl_mixed_kinds_equal_jax(mixed_folder, tmp_path):
    names = [os.path.relpath(os.path.join(mixed_folder, f"c{i % 2}", n), str(tmp_path))
             for i, n in enumerate(MIXED)]
    (tmp_path / "cut.gif").write_bytes(fixture("gif_global_256.gif")[:300])
    ann = tmp_path / "ann.jsonl"
    ann.write_text("\n".join(json.dumps({"target_image": n}) for n in ["cut.gif", *names]))
    for crop in (False, True):
        kw = dict(resolution=24, random_crop=crop, random_flip=True, seed=7)
        ours = jsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
        ref = jjsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
        _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])


# ---- chip_smoke.py's phase, on the CPU ----

def test_chip_smoke_image_kinds_phase_runs_on_the_cpu(monkeypatch, capsys):
    """``phase_image_kinds_decode`` loads the three decoders this host's
    compiler built from these sources, holds every fixture to its digest
    without PIL, and times the 512 x 512 files; here on the CPU at one
    round."""
    monkeypatch.chdir(os.path.dirname(os.path.abspath(chip_smoke.__file__)))
    monkeypatch.setattr(chip_smoke, "IMAGE_KINDS_ROUNDS", 1)
    out = chip_smoke.phase_image_kinds_decode("cpu", 2)
    assert all(f["equal"] for f in out["files"].values()) and out["kinds"] == len(DIGESTS) + 1
    assert set(out["ms_per_mp"]) == {"webp_lossy", "webp_lossless", "gif", "bmp"}
    assert set(out["libraries"]) == {"webp_decode", "gif_decode", "bmp_decode"}
    assert all(lib["loaded"] for lib in out["libraries"].values())
    assert "image_kinds_decode" in capsys.readouterr().out
