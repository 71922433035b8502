"""The port's JPEG decoder (``deco_tpu_torch/csrc/jpeg_decode.cpp`` through
``deco_tpu_torch.data.jpeg``) against PIL, and the port's readers on JPEG
files against the JAX package's, on the CPU.

The decoder is held bit for bit (0 LSB) to ``Image.open(f).convert("RGB")``
(Pillow 12.1 on libjpeg-turbo 3.1): on the committed fixtures
(``torch_jpeg_fixtures/`` and its ``kinds/``, with the digests the card's
host checks: arithmetic coding, sequential and progressive, with restart
intervals and DAC conditioning; progressive files libjpeg smooths; lossless
files of every predictor), on a parametrised and a ``hypothesis``-drawn set
of Pillow-written files (sizes 1-300 a side, quality 10-100, 4:4:4, 4:2:2
and 4:2:0, progressive or not, restart intervals, gray, CMYK, optimised
tables), on streams Pillow cannot write but reads
(``generate.encode_baseline``: 4:4:0, 4:1:1 and other ratios, YCCK, Adobe
RGB, no Huffman tables; ``generate.encode_lossless``: lossless JPEG of
every predictor, point transform, sampling and scan layout), and on seeded
corruptions of every kind. The readers' JPEG items equal
the JAX readers' byte for byte with the JAX package on its PIL path
(``DECO_NATIVE_DECODE=0``), and lie within 1 LSB of its native path where
``native/libdataplane.so`` is built (the bound its own tests hold). A
truncated or corrupt file is skipped, retried or raised exactly where the
JAX reader does so.
"""

import hashlib
import io
import json
import os
import tarfile
import threading
import warnings

import chip_smoke
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from deco_tpu.data import image_txt as jimage_txt
from deco_tpu.data import imagenet as jimagenet
from deco_tpu.data import jsonl as jjsonl
from deco_tpu.data import packed as jpacked
from deco_tpu.data import webdataset as jwebdataset
from deco_tpu_torch.data import image_txt, imagenet, jpeg, jsonl, packed, webdataset
from torch_jpeg_fixtures import generate
from torch_port_util import jax_decodes_with_pil, jax_native_data_plane

FIXTURES = generate.HERE
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    _WRITTEN = json.load(_f)
DIGESTS, READER_DIGESTS = _WRITTEN["files"], _WRITTEN["readers"]
with open(os.path.join(generate.KINDS_DIR, "digests.json")) as _f:
    KIND_DIGESTS = json.load(_f)["files"]


def kind_fixture(name: str) -> bytes:
    with open(os.path.join(generate.KINDS_DIR, name), "rb") as f:
        return f.read()
ONE_LSB = 2.0 / 255 + 1e-6  # one level of a uint8 image on [-1, 1]


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def pil_jpeg(arr: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    h, w = arr.shape[:2]
    if mode == "L":
        image = Image.fromarray(arr[..., 0])
    elif mode == "CMYK":
        image = Image.frombytes("CMYK", (w, h), np.ascontiguousarray(arr[..., :4]).tobytes())
    else:
        image = Image.fromarray(arr[..., :3])
    buf = io.BytesIO()
    image.save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_equals_pil(data: bytes):
    ours = jpeg.decode(data)
    ref = pil_rgb(data)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


# ---- the decoder against PIL ----

@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_decodes_to_its_pil_digest(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    ours = jpeg.decode(data)
    assert list(ours.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(ours.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
    np.testing.assert_array_equal(ours, pil_rgb(data))


@pytest.mark.parametrize("name", sorted(KIND_DIGESTS))
def test_kind_fixture_decodes_to_its_pil_digest(name):
    """Arithmetic coding (SOF9, SOF10), block smoothing (SOF2, SOF10) and
    lossless JPEG (SOF3): the committed files equal Pillow's bytes, and
    ``info`` names their kind."""
    data = kind_fixture(name)
    ours = jpeg.decode(data)
    assert list(ours.shape) == KIND_DIGESTS[name]["shape"]
    assert hashlib.sha256(ours.tobytes()).hexdigest() == KIND_DIGESTS[name]["sha256"]
    assert jpeg.info(data)[3] == KIND_DIGESTS[name]["kind"]
    np.testing.assert_array_equal(ours, pil_rgb(data))


GRID = [  # (h, w, mode, save keywords)
    (1, 1, "RGB", dict(quality=90, subsampling=2)),
    (1, 7, "RGB", dict(quality=50, subsampling=1)),
    (2, 2, "RGB", dict(quality=75, subsampling=2)),
    (3, 5, "RGB", dict(quality=75, subsampling=2, progressive=True)),
    (5, 3, "CMYK", dict(quality=60)),
    (9, 4, "RGB", dict(quality=100, subsampling=1)),
    (8, 8, "L", dict(quality=30)),
    (15, 17, "RGB", dict(quality=10, subsampling=2)),
    (17, 15, "RGB", dict(quality=95, subsampling=0, progressive=True)),
    (31, 33, "RGB", dict(quality=85, subsampling=2, restart_marker_blocks=1)),
    (33, 31, "RGB", dict(quality=85, subsampling=1, restart_marker_rows=1, progressive=True)),
    (40, 1, "L", dict(quality=70, progressive=True)),
    (64, 48, "RGB", dict(quality=80, subsampling=2, optimize=True)),
    (48, 64, "RGB", dict(quality=20, subsampling=0, optimize=True, progressive=True)),
    (71, 93, "CMYK", dict(quality=90, progressive=True)),
    (97, 70, "L", dict(quality=95, optimize=True, restart_marker_blocks=3)),
    (120, 160, "RGB", dict(quality=60, subsampling=1, progressive=True, optimize=True)),
    (161, 121, "RGB", dict(quality=100, subsampling=2, restart_marker_blocks=5)),
    (255, 300, "RGB", dict(quality=75, subsampling=2, progressive=True)),
    (300, 255, "CMYK", dict(quality=45, restart_marker_blocks=2)),
]


@pytest.mark.parametrize("h, w, mode, kw", GRID,
                         ids=[f"{h}x{w}-{m}-" + "-".join(f"{k}{v}" for k, v in kw.items())
                              for h, w, m, kw in GRID])
def test_decoder_equals_pil(h, w, mode, kw):
    arr = generate.photo_like(h, w, 4, seed=h * 1000 + w)
    assert_equals_pil(pil_jpeg(arr, mode, **kw))


@settings(max_examples=40, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 300), w=st.integers(1, 300), quality=st.integers(10, 100),
       mode=st.sampled_from(["RGB", "RGB", "RGB", "L", "CMYK"]),
       subsampling=st.sampled_from([0, 1, 2]), progressive=st.booleans(),
       optimize=st.booleans(), restart=st.sampled_from([0, 0, 1, 4]),
       noise=st.booleans(), seed=st.integers(0, 2**16))
def test_decoder_equals_pil_on_drawn_files(h, w, quality, mode, subsampling, progressive,
                                           optimize, restart, noise, seed):
    if noise:
        arr = np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)
    else:
        arr = generate.photo_like(h, w, 4, seed)
    kw = dict(quality=quality, progressive=progressive, optimize=optimize)
    if mode == "RGB":
        kw["subsampling"] = subsampling
    if restart:
        kw["restart_marker_blocks"] = restart
    assert_equals_pil(pil_jpeg(arr, mode, **kw))


SAMPLINGS = {  # streams of sampling factors Pillow reads but does not write
    "440": [(1, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)],
    "h1v4": [(1, 4), (1, 1), (1, 1)],
    "mixed": [(2, 2), (1, 2), (2, 1)],
    "chroma_above_luma": [(1, 1), (2, 2), (1, 1)],
    "h4v2": [(4, 2), (1, 1), (1, 1)],
    "h3v1": [(3, 1), (1, 1), (1, 1)],
    "h2v1_h1v2": [(2, 2), (2, 1), (1, 2)],
}


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (19, 37), (65, 9)], ids=str)
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_decoder_equals_pil_on_every_sampling_ratio(sampling, size):
    h, w = size
    arr = generate.photo_like(h, w, 3, seed=h + w)
    data = generate.encode_baseline([arr[..., i] for i in range(3)], SAMPLINGS[sampling],
                                    quality_scale=0.5, restart_interval=2 if h > 8 else 0)
    assert_equals_pil(data)


def test_more_than_ten_blocks_an_mcu_raises_as_in_pil():
    arr = generate.photo_like(20, 20, 3, seed=0)
    data = generate.encode_baseline([arr[..., i] for i in range(3)], [(2, 2)] * 3)
    with pytest.raises(OSError):
        pil_rgb(data)
    with pytest.raises(ValueError, match="10 blocks"):
        jpeg.decode(data)


@pytest.mark.parametrize("case", ["adobe_rgb", "rgb_ids", "ycck", "cmyk_not_adobe",
                                  "jfif_over_adobe"])
def test_decoder_picks_the_colour_space_as_libjpeg(case):
    """A JFIF APP0 means YCbCr; else an Adobe transform of 0 means RGB, and
    component ids 'R','G','B' do; four components are CMYK, or YCCK where
    the Adobe transform is 2, read inverted as Pillow's "CMYK;I"."""
    arr = generate.photo_like(37, 29, 4, seed=3)
    planes3 = [arr[..., i] for i in range(3)]
    samp3 = [(2, 2), (1, 1), (1, 1)]
    kw = {
        "adobe_rgb": dict(planes=planes3, sampling=samp3, jfif=False, adobe_transform=0),
        "rgb_ids": dict(planes=planes3, sampling=samp3, jfif=False, ids=[82, 71, 66]),
        "ycck": dict(planes=[arr[..., i] for i in range(4)], sampling=samp3 + [(2, 2)],
                     jfif=False, adobe_transform=2),
        "cmyk_not_adobe": dict(planes=[arr[..., i] for i in range(4)],
                               sampling=[(1, 1)] * 4, jfif=False),
        "jfif_over_adobe": dict(planes=planes3, sampling=samp3, jfif=True, adobe_transform=0),
    }[case]
    assert_equals_pil(generate.encode_baseline(**kw))


def _without_markers(data: bytes, markers) -> bytes:
    out, p = bytearray(data[:2]), 2
    while data[p + 1] != 0xDA:
        length = int.from_bytes(data[p + 2:p + 4], "big")
        if data[p + 1] not in markers:
            out += data[p:p + 2 + length]
        p += 2 + length
    return bytes(out + data[p:])


def test_a_stream_without_huffman_tables_takes_the_standard_ones():
    """Motion-JPEG frames omit the K.3 tables; libjpeg-turbo supplies them."""
    data = pil_jpeg(generate.photo_like(40, 56, 3, seed=5), quality=80)
    stripped = _without_markers(data, {0xC4})
    assert b"\xff\xc4" not in stripped[:stripped.index(b"\xff\xda")]
    assert_equals_pil(stripped)
    np.testing.assert_array_equal(jpeg.decode(stripped), jpeg.decode(data))


def test_info_reads_the_frame_header():
    arr = generate.photo_like(30, 50, 4, seed=1)
    assert jpeg.info(pil_jpeg(arr, quality=80)) == (30, 50, 3, "baseline")
    assert jpeg.info(pil_jpeg(arr, "L", progressive=True)) == (30, 50, 1, "progressive")
    assert jpeg.info(pil_jpeg(arr, "CMYK")) == (30, 50, 4, "baseline")


def _patched_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:i + 4] + bytes([precision]) + data[i + 5:]


@pytest.mark.parametrize("kind, marker, precision", [
    ("12-bit", 0xC1, 12), ("arithmetic-coded", 0xC9, 8), ("lossless", 0xC3, 8),
    ("hierarchical", 0xC5, 8), ("lossless arithmetic-coded", 0xCB, 8)])
def test_kinds_it_does_not_read_raise_naming_the_roadmap_item(kind, marker, precision):
    """Every kind Pillow reads decodes to Pillow's bytes (an arithmetic-coded
    stream, a genuine lossless file); the kinds Pillow refuses (12-bit
    samples, hierarchical frames, lossless arithmetic coding, which
    libjpeg-turbo has no decoder for) raise ``ValueError``, as the readers
    need to skip them where the JAX readers skip (ROADMAP §C 17)."""
    arr = generate.photo_like(16, 16, 3, seed=0)
    if kind == "lossless":
        data = generate.encode_lossless(arr)
    elif kind == "arithmetic-coded":
        data = kind_fixture("arith_444_restart_dac_333x250.jpg")
    else:
        data = _patched_sof(pil_jpeg(arr), marker, precision)
    try:
        pil_rgb(data)
        pil_reads = True
    except OSError:
        pil_reads = False
    assert pil_reads == (kind in ("arithmetic-coded", "lossless"))
    if pil_reads:
        assert_equals_pil(data)
    else:
        with pytest.raises(ValueError, match=kind):
            jpeg.decode(data)


def _sof_of(data: bytes) -> int:
    return next(i for i in range(2, len(data) - 1) if data[i] == 0xFF
                and 0xC0 <= data[i + 1] <= 0xCF and data[i + 1] not in (0xC4, 0xC8, 0xCC))


@pytest.mark.parametrize("source", ["baseline", "lossless", "arith", "arith_progressive",
                                    "progressive_noise"])
def test_a_lossless_arithmetic_frame_raises_whatever_its_data(source):
    """SOF11 (lossless, arithmetic-coded): Pillow reads the frame header and
    libjpeg-turbo refuses it before it reads any scan, so the streams of
    every other kind patched to SOF11 raise alike."""
    arr = generate.photo_like(24, 40, 3, seed=6)
    data = {"baseline": lambda: pil_jpeg(arr, quality=80),
            "lossless": lambda: generate.encode_lossless(arr, predictor=5),
            "arith": lambda: kind_fixture("arith_gray_restart_300x200.jpg"),
            "arith_progressive": lambda: kind_fixture("smooth_dc_only_arith_177x93.jpg"),
            "progressive_noise": lambda: pil_jpeg(np.random.default_rng(1).integers(
                0, 256, (40, 24, 3), dtype=np.uint8), quality=95, progressive=True)}[source]()
    i = _sof_of(data)
    patched = data[:i + 1] + b"\xcb" + data[i + 2:]
    with pytest.raises(OSError):
        pil_rgb(patched)
    with pytest.raises(ValueError, match="SOF11"):
        jpeg.info(patched)
    with pytest.raises(ValueError, match="SOF11"):
        jpeg.decode(patched)


def test_a_progressive_file_that_needs_block_smoothing_raises():
    """A progressive stream whose scans stop before the first AC
    coefficients are finished (here: cut after each of its scans): libjpeg
    smooths its blocks (jdcoefct.c decompress_smooth_data, from the DC
    values of the 5 x 5 blocks around each), and so does the decoder."""
    data = pil_jpeg(generate.photo_like(32, 32, 3, seed=2), progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    for k in range(1, len(sos)):
        assert_equals_pil(data[:sos[k]] + b"\xff\xd9")  # the first k scans


@pytest.mark.parametrize("fraction", [0.02, 0.3, 0.6, 0.95])
@pytest.mark.parametrize("progressive", [False, True])
def test_a_truncated_file_raises_where_pil_does(fraction, progressive):
    data = pil_jpeg(generate.photo_like(64, 80, 3, seed=4), quality=85, progressive=progressive)
    cut = data[:int(len(data) * fraction)]
    with pytest.raises(OSError):
        pil_rgb(cut)
    with pytest.raises(ValueError, match="truncated|not a JPEG"):
        jpeg.decode(cut)


@pytest.mark.parametrize("data", [b"", b"\xff\xd8", b"\xff\xd8\xff\xd9", b"GIF89a....",
                                  b"\xff\xd8\xff\xc0\x00\x04\x08\x00"],
                         ids=["empty", "soi", "no_frame", "gif", "short_frame"])
def test_corrupt_headers_raise_value_error(data):
    with pytest.raises(ValueError):
        jpeg.decode(data)


def _scan_data(data: bytes):
    """[start, end) of each scan's entropy-coded data (restart markers
    included)."""
    out, i = [], 2
    while i < len(data) - 1:
        marker = data[i + 1]
        if data[i] != 0xFF or marker == 0xFF:
            i += 1
        elif marker == 0xD9:
            break
        elif marker == 0xDA:
            start = end = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            out.append((start, end))
            i = end
        else:
            i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return out


def assert_decodes_or_raises_as_pil(data: bytes):
    """Pillow's image where it returns one (0 LSB); ``ValueError`` where it
    raises."""
    try:
        ref = pil_rgb(data)
    except OSError:
        ref = None
    try:
        ours = jpeg.decode(data)
    except ValueError:
        assert ref is None, "PIL decodes a stream the decoder refuses"
        return
    assert ref is not None, "the decoder returns an image where PIL raises"
    np.testing.assert_array_equal(ours, ref)


def test_mutated_streams_decode_or_raise():
    """400 seeded mutations (bytes replaced, bits flipped, runs cut or
    inserted, stray markers) of baseline, progressive, restart and CMYK
    streams, most inside their entropy-coded data: each decodes to PIL's
    bytes where Pillow reads it and raises ``ValueError`` where Pillow
    raises (the decoder was run over 20,000 such streams under
    AddressSanitizer and UBSan while it was written, and over 12,000 against
    Pillow)."""
    rng = np.random.default_rng(1)
    arr = generate.photo_like(40, 56, 4, seed=1)
    seeds = [pil_jpeg(arr, **kw) for kw in (
        dict(quality=80), dict(quality=50, progressive=True),
        dict(quality=90, subsampling=0, restart_marker_blocks=2))]
    seeds.append(pil_jpeg(arr, "CMYK", progressive=True))
    outcomes = {"image": 0, "error": 0}
    for t in range(400):
        d = bytearray(seeds[t % len(seeds)])
        scans = _scan_data(bytes(d))
        start, end = scans[int(rng.integers(0, len(scans)))]
        for _ in range(int(rng.integers(1, 4))):
            kind = int(rng.integers(0, 5))
            i = int(rng.integers(start, end) if t % 5 else rng.integers(2, len(d)))
            if kind == 0:
                d[i] = int(rng.integers(0, 256))
            elif kind == 1:
                d[i] ^= 1 << int(rng.integers(0, 8))
            elif kind == 2:
                del d[i:i + int(rng.integers(1, 20))]
            elif kind == 3:
                d[i:i] = bytes(rng.integers(0, 256, int(rng.integers(1, 8)), dtype=np.uint8))
            else:
                d[i:i] = bytes([0xFF, int(rng.integers(1, 255))])
        assert_decodes_or_raises_as_pil(bytes(d))
        try:
            pil_rgb(bytes(d))
            outcomes["image"] += 1
        except OSError:
            outcomes["error"] += 1
    assert min(outcomes.values()) > 40, outcomes


def _mutate_scans(data: bytes, rng, anywhere: bool) -> bytes:
    """One to three of: a byte replaced, a bit flipped, a run cut or
    inserted, a stray marker; inside one scan's entropy-coded data unless
    ``anywhere``."""
    d = bytearray(data)
    scans = _scan_data(bytes(d))
    start, end = scans[int(rng.integers(0, len(scans)))]
    for _ in range(int(rng.integers(1, 4))):
        kind = int(rng.integers(0, 5))
        i = int(rng.integers(2, len(d)) if anywhere else rng.integers(start, end))
        i = min(i, len(d) - 1)  # an earlier cut may have shortened the stream
        if kind == 0:
            d[i] = int(rng.integers(0, 256))
        elif kind == 1:
            d[i] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            del d[i:i + int(rng.integers(1, 20))]
        elif kind == 3:
            d[i:i] = bytes(rng.integers(0, 256, int(rng.integers(1, 8)), dtype=np.uint8))
        else:
            d[i:i] = bytes([0xFF, int(rng.integers(1, 255))])
    return bytes(d)


NEW_KIND_SEEDS = {
    "arithmetic": lambda: [kind_fixture(n) for n in (
        "arith_422_restart_dac_250x333.jpg", "arith_gray_restart_300x200.jpg",
        "arith_adobe_cmyk_dac_240x180.jpg")],
    "arithmetic_progressive": lambda: [kind_fixture(n) for n in (
        "arith_progressive_gray_restart_200x150.jpg", "smooth_early_stop_arith_211x157.jpg",
        "smooth_no_chroma_ac_arith_199x131.jpg")],
    "lossless": lambda: [generate.encode_lossless(generate.photo_like(40, 56, 4, seed=1)[
        ..., :c], seed=1, **kw) for c, kw in (
        (3, dict(predictor=4)), (3, dict(predictor=7, pt=1, restart_rows=3)),
        (1, dict(predictor=5, wild=0.05)),
        (3, dict(predictor=2, sampling=[(2, 2), (1, 1), (1, 1)], interleaved=False)),
        (4, dict(predictor=3, sampling=[(1, 2), (1, 1), (1, 1), (1, 2)], restart_rows=2)))],
}


@pytest.mark.parametrize("kind", sorted(NEW_KIND_SEEDS))
def test_mutated_streams_of_the_new_kinds_decode_or_raise(kind):
    """100 seeded mutations (as in :func:`test_mutated_streams_decode_or_raise`)
    of arithmetic-coded sequential and progressive streams and of lossless
    streams: Pillow's bytes where Pillow reads the stream (jdarith.c feeds
    zeros after a marker and leaves the rest of a segment as it is after a
    bad code; jdlhuff.c's differences past the data are zero, from a reset
    predictor), ``ValueError`` where it raises (while it was written the
    decoder was held to Pillow on 1,800 such streams of each kind)."""
    rng = np.random.default_rng({"arithmetic": 2, "arithmetic_progressive": 3,
                                 "lossless": 4}[kind])
    seeds = NEW_KIND_SEEDS[kind]()
    outcomes = {"image": 0, "error": 0}
    for t in range(100):
        d = _mutate_scans(seeds[t % len(seeds)], rng, anywhere=t % 5 == 0)
        assert_decodes_or_raises_as_pil(d)
        try:
            pil_rgb(d)
            outcomes["image"] += 1
        except OSError:
            outcomes["error"] += 1
    assert min(outcomes.values()) > 5, outcomes


LOSSLESS_CASES = {  # name: (channels, encode_lossless keywords)
    **{f"p{p}_pt{pt}": (3, dict(predictor=p, pt=pt)) for p in range(1, 8) for pt in (0, 1, 2)},
    "pt7_gray": (1, dict(predictor=4, pt=7)),
    "wild_p5": (3, dict(predictor=5, wild=0.1)),
    "wild_p6_420": (3, dict(predictor=6, wild=0.1, sampling=[(2, 2), (1, 1), (1, 1)])),
    "wild_p7_pt1": (1, dict(predictor=7, pt=1, wild=0.1)),
    "422_restart": (3, dict(predictor=4, sampling=[(2, 1), (1, 1), (1, 1)], restart_rows=2)),
    "440": (3, dict(predictor=1, sampling=[(1, 2), (1, 1), (1, 1)])),
    "411": (3, dict(predictor=7, sampling=[(4, 1), (1, 1), (1, 1)])),
    "chroma_above_luma": (3, dict(predictor=3, sampling=[(1, 1), (2, 2), (1, 1)])),
    "gray_2x2_sampling": (1, dict(predictor=2, sampling=[(2, 2)])),
    "three_scans_restart": (3, dict(predictor=6, interleaved=False, restart_rows=4)),
    "cmyk": (4, dict(predictor=5)),
    "ids_456": (3, dict(predictor=1, ids=[4, 5, 6])),
}


@pytest.mark.parametrize("case", sorted(LOSSLESS_CASES))
def test_lossless_equals_pil(case):
    """Lossless JPEG as libjpeg-turbo 3.1 reads it: predictors 1-7, the
    point transform, the first row and each restart predicted from
    2^(7 - Pt) and the left, 16-bit sums cut to 8-bit samples, sampling
    factors replicated (no fancy upsampling: a lossless data unit is one
    sample), no colour conversion (three components are RGB)."""
    channels, kw = LOSSLESS_CASES[case]
    arr = generate.photo_like(19, 23, 4, seed=len(case))[..., :channels]
    assert_equals_pil(generate.encode_lossless(arr, seed=3, **kw))


@pytest.mark.parametrize("case", ["jfif", "adobe_ycc", "ycck", "restart_not_a_row",
                                  "component_without_scan", "predictor_0", "predictor_8",
                                  "se_not_0", "pt_8"])
def test_lossless_streams_pillow_refuses_raise(case):
    """libjpeg-turbo converts no colour in lossless mode (a JFIF or an Adobe
    YCC frame is refused), wants a restart interval of whole MCU rows,
    reads no component a scan never wrote, and checks the scan's predictor,
    Se and point transform."""
    arr = generate.photo_like(21, 17, 4, seed=8)
    data = {
        "jfif": lambda: generate.encode_lossless(arr[..., :3], jfif=True),
        "adobe_ycc": lambda: generate.encode_lossless(arr[..., :3], adobe_transform=1),
        "ycck": lambda: generate.encode_lossless(arr, adobe_transform=2),
        "restart_not_a_row": lambda: _with_dri(generate.encode_lossless(arr[..., :3]), 5),
        "component_without_scan": lambda: _without_last_scan(
            generate.encode_lossless(arr[..., :3], interleaved=False)),
        "predictor_0": lambda: _patched_sos(generate.encode_lossless(arr[..., :3]), 0, 0, 0),
        "predictor_8": lambda: _patched_sos(generate.encode_lossless(arr[..., :3]), 8, 0, 0),
        "se_not_0": lambda: _patched_sos(generate.encode_lossless(arr[..., :3]), 1, 1, 0),
        "pt_8": lambda: _patched_sos(generate.encode_lossless(arr[..., :3]), 1, 0, 8),
    }[case]()
    with pytest.raises(OSError):
        pil_rgb(data)
    with pytest.raises(ValueError):
        jpeg.decode(data)


def _with_dri(data: bytes, interval: int) -> bytes:
    i = data.index(b"\xff\xda")
    return data[:i] + b"\xff\xdd\x00\x04" + interval.to_bytes(2, "big") + data[i:]


def _without_last_scan(data: bytes) -> bytes:
    return data[:data.rindex(b"\xff\xda")] + b"\xff\xd9"


def _patched_sos(data: bytes, ss: int, se: int, al: int) -> bytes:
    i = data.index(b"\xff\xda")
    end = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return data[:end - 3] + bytes([ss, se, al]) + data[end:]


def _com(n: int) -> bytes:
    """A COM segment of n zero bytes."""
    return b"\xff\xfe" + (n + 2).to_bytes(2, "big") + bytes(n)


def test_arithmetic_data_past_pillows_read_raises_as_pil():
    """libjpeg's arithmetic decoder cannot suspend: Pillow hands libjpeg the
    file in reads of 65,536 bytes and reads on only where libjpeg suspends,
    in its marker reader, so a scan whose data runs past the bytes handed
    over by its header's end fails. Padding (a COM segment) before each
    scan, to put its header on either side of a read's end, gives both
    outcomes; so do large files."""
    data = kind_fixture("arith_progressive_custom_scans_300x200.jpg")
    sos = [i for i in range(2, len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    outcomes = set()
    for k in range(1, len(sos), 2):
        end = sos[k] + 2 + int.from_bytes(data[sos[k] + 2:sos[k] + 4], "big")
        for delta in (-3, -1, 0, 1, 2):
            pad = (end // 65536 + 1) * 65536 + delta - end - 4
            padded = data[:sos[k]] + _com(pad) + data[sos[k]:]
            assert_decodes_or_raises_as_pil(padded)
            try:
                pil_rgb(padded)
                outcomes.add("image")
            except OSError:
                outcomes.add("error")
    assert outcomes == {"image", "error"}
    big = kind_fixture("arith_q100_noise_160x120.jpg")
    for pad in (1000, 5000, 65000):  # a header in the first read, the data past it
        assert_decodes_or_raises_as_pil(big[:2] + _com(pad) + big[2:])


def test_c18_arithmetic_data_past_pillows_read_raises_as_the_jax_pil_path(tmp_path,
                                                                          monkeypatch):
    """ROADMAP §C 18: an arithmetic-coded JPEG whose scan data runs past
    Pillow's first read (here: a COM segment of 60,000 bytes before it).
    The JAX reader's PIL path raises and the port raises as it does; the
    JAX reader's native data plane, where it is built, hands libjpeg the
    whole file and decodes it (the JAX package's two paths disagree)."""
    big = kind_fixture("arith_q100_noise_160x120.jpg")
    data = big[:2] + _com(60_000) + big[2:]
    os.makedirs(tmp_path / "c")
    (tmp_path / "c" / "a.jpg").write_bytes(data)
    jax_decodes_with_pil(monkeypatch)
    with pytest.raises(OSError):
        jimagenet.PixImageNet(str(tmp_path), resolution=16)[0]
    with pytest.raises(ValueError, match="arithmetic-coded data past"):
        imagenet.PixImageNet(str(tmp_path), resolution=16)[0]
    if jax_native_data_plane(monkeypatch):
        assert jimagenet.PixImageNet(str(tmp_path), resolution=16)[0][0].shape == (16, 16, 3)


@pytest.mark.parametrize("name", ["progressive_420_640x480.jpg", "smooth_early_stop_arith",
                                  "arith_progressive_custom_scans_300x200.jpg"])
def test_a_progressive_file_cut_inside_a_scan_decodes_as_pil(name):
    """EOI inside a scan's data: the Huffman decoder leaves the MCUs after
    the cut as they are, and libjpeg smooths the iMCU rows after the last
    one that began with data by the coefficient bits of the scan before;
    the arithmetic decoder reads zeros after the marker."""
    data = (kind_fixture(f"{name}_211x157.jpg") if name.startswith("smooth")
            else kind_fixture(name) if name.startswith("arith")
            else open(os.path.join(FIXTURES, name), "rb").read())
    for start, end in _scan_data(data)[-3:]:
        for f in (0.2, 0.7):
            assert_decodes_or_raises_as_pil(data[:start + int((end - start) * f)] + b"\xff\xd9")


@pytest.mark.parametrize("name", ["arith_gray_restart_300x200.jpg",
                                  "lossless_gray_restart_p7_64x64.jpg",
                                  "lossless_three_scans_p2_59x37.jpg"])
def test_a_new_kind_without_eoi_decodes_or_raises_as_pil(name):
    """A file cut just before or inside its end: a single-scan image
    decodes where libjpeg never read past the end (the arithmetic decoder
    reads lazily; the lossless Huffman decoder refills as jdhuff.c's slow
    path does), and a multi-scan one needs its EOI."""
    data = kind_fixture(name)
    for cut in range(len(data) - 10, len(data) + 1):
        assert_decodes_or_raises_as_pil(data[:cut])


def test_info_reports_the_new_kinds():
    assert jpeg.info(kind_fixture("arith_420_512x512.jpg")) == (512, 512, 3, "arithmetic")
    assert jpeg.info(kind_fixture("smooth_dc_only_arith_177x93.jpg"))[3] == \
        "arithmetic-progressive"
    assert jpeg.info(kind_fixture("lossless_adobe_cmyk_p1_37x29.jpg")) == (29, 37, 4, "lossless")


@pytest.mark.parametrize("seed", ["baseline", "progressive", "restart", "gray_optimized"])
def test_a_bad_huffman_code_decodes_as_pil(seed):
    """A run of 1 bits no table holds: libjpeg warns, drops 17 bits, takes
    the symbol 0 and decodes on, and so does the decoder; the garbage that
    follows reaches the IDCT with coefficients whose 16-bit sums wrap as in
    libjpeg-turbo's SIMD code."""
    arr = generate.photo_like(40, 56, 4, seed=1)
    data = {"baseline": lambda: pil_jpeg(arr, quality=80),
            "progressive": lambda: pil_jpeg(arr, quality=50, progressive=True),
            "restart": lambda: pil_jpeg(arr, quality=90, subsampling=0, restart_marker_blocks=2),
            "gray_optimized": lambda: pil_jpeg(arr, "L", quality=70, optimize=True)}[seed]()
    start, end = _scan_data(data)[0]
    for i in range(start + 5, end - 2, (end - start) // 24):
        planted = data[:i] + b"\xff\x00" * 3 + data[i:]
        pil_rgb(planted)  # Pillow returns an image
        assert_decodes_or_raises_as_pil(planted)


@pytest.mark.parametrize("where", ["eoi_early", "stray_rst", "restart_missing", "restart_swapped"])
def test_a_short_or_misordered_segment_decodes_as_pil(where):
    """Entropy-coded data cut short by EOI (libjpeg feeds zero bits to the
    MCU that ran short and leaves the rest gray), and restart markers
    missing, stray or out of order (jpeg_resync_to_restart)."""
    arr = generate.photo_like(64, 72, 4, seed=9)
    data = pil_jpeg(arr, quality=85, restart_marker_blocks=3)
    start, end = _scan_data(data)[0]
    rst = [i for i in range(start, end - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    if where == "eoi_early":
        cases = [data[:i] + b"\xff\xd9" for i in range(start + 40, end, (end - start) // 9)]
    elif where == "stray_rst":
        cases = [data[:i] + bytes([0xFF, 0xD0 + k]) + data[i:]
                 for k, i in enumerate(range(start + 30, end, (end - start) // 8))]
    elif where == "restart_missing":
        cases = [data[:i] + data[i + 2:] for i in rst[1:12:2]]
    else:
        cases = [data[:i + 1] + bytes([0xD0 + (data[i + 1] + 3 + k) % 8]) + data[i + 2:]
                 for k, i in enumerate(rst[2:12:2])]
    for case in cases:
        assert_decodes_or_raises_as_pil(case)


@pytest.mark.parametrize("image", ["gray_small", "rgb_small", "progressive", "gray_over_64k"])
def test_a_file_without_eoi_decodes_or_raises_as_pil(image):
    """A single-scan file that ends inside or right after its entropy-coded
    data: Pillow returns the image if libjpeg never asked for a byte past
    the end, which turns on libjpeg's bit-buffer refills (its fast and slow
    paths, and Pillow's reads of 65,536 bytes); a progressive one always
    raises."""
    big = image == "gray_over_64k"  # seeds where both outcomes occur
    arr = generate.photo_like(400 if big else 40, 500 if big else 56, 4, seed=21 if big else 17)
    data = {"gray_small": lambda: pil_jpeg(arr, "L", quality=70, optimize=True),
            "rgb_small": lambda: pil_jpeg(arr, quality=80),
            "progressive": lambda: pil_jpeg(arr, quality=80, progressive=True),
            "gray_over_64k": lambda: pil_jpeg(arr, "L", quality=97)}[image]()
    assert len(data) > 65536 or not big
    end = _scan_data(data)[-1][1]
    outcomes = set()
    for cut in range(end - 12, end + 2):
        assert_decodes_or_raises_as_pil(data[:cut])
        try:
            pil_rgb(data[:cut])
            outcomes.add("image")
        except OSError:
            outcomes.add("error")
    assert outcomes == ({"error"} if image == "progressive" else {"image", "error"})


@pytest.mark.parametrize("where", ["anywhere", "before_a_read_boundary"])
def test_ff_ff_in_the_data_decodes_as_pil(where):
    """FF FF 00 inside entropy-coded data: libjpeg's slow path reads one FF
    byte, its fast path (taken where 512 bytes a block of the MCU remain in
    Pillow's buffer) a marker, and the MCU it was in keeps what the fast
    try wrote under what the slow path decodes. Pillow hands libjpeg the
    file in reads of 65,536 bytes, so just before a read's end the slow
    path decodes alone."""
    rng = np.random.default_rng(4)
    if where == "anywhere":
        arr = generate.photo_like(200, 240, 4, seed=12)
        streams = (pil_jpeg(arr, quality=92), pil_jpeg(arr, "L", quality=95))
    else:
        streams = (pil_jpeg(generate.photo_like(400, 500, 4, seed=21), quality=95, subsampling=0),)
    for data in streams:
        start, end = _scan_data(data)[0]
        if where == "anywhere":
            spots = rng.integers(start, end - 4000, 6)
        else:
            assert end > 2 * 65536
            spots = [b - k for b in (65536, 131072) for k in (1490, 1200, 900, 610, 320, 40)]
        stuffed = [i for i in range(start, end - 1) if data[i] == 0xFF and data[i + 1] == 0]
        near = [i for i in stuffed if min(abs(i - s) for s in spots) < 150]
        for i in rng.choice(stuffed, 6, replace=False) if where == "anywhere" else near[:12]:
            assert_decodes_or_raises_as_pil(data[:i + 1] + b"\xff" + data[i + 2:])
        for i in spots:
            assert_decodes_or_raises_as_pil(data[:i] + b"\xff\xff\x00" + data[i:])


def test_a_decompression_bomb_raises_as_in_pil():
    """A frame header claiming 60,000 x 60,000 pixels: Pillow refuses it
    (``DecompressionBombError``) and so does the decoder, before it
    allocates."""
    data = pil_jpeg(generate.photo_like(16, 16, 3, seed=0))
    i = data.index(b"\xff\xc0")
    bomb = data[:i + 5] + (60000).to_bytes(2, "big") * 2 + data[i + 9:]
    with pytest.raises(Image.DecompressionBombError):
        pil_rgb(bomb)
    with pytest.raises(ValueError, match="decompression-bomb"):
        jpeg.decode(bomb)


def test_two_threads_decode_at_once_to_the_same_bytes():
    names = sorted(DIGESTS)
    blobs = []
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            blobs.append(f.read())
    alone = [jpeg.decode(b) for b in blobs]
    results = [[None] * len(blobs) for _ in range(2)]

    def work(t):
        for k in range(3):
            for i in range(len(blobs)):
                j = (i + t * 3 + k) % len(blobs)  # the two threads on different files
                results[t][j] = jpeg.decode(blobs[j])

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for t in range(2):
        for i in range(len(blobs)):
            np.testing.assert_array_equal(results[t][i], alone[i])


def test_many_threads_load_the_library_once_and_decode_alike(monkeypatch):
    """The first decode of a process loads (and configures) the library under
    a lock: 16 threads, more than the cores, start together on an unloaded
    module with a short switch interval and all get PIL's bytes."""
    import sys

    from deco_tpu_torch.ops import _build

    name = "baseline_420_500x375.jpg"
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    want = pil_rgb(data)
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(_build, "_loaded", {})
    start = threading.Barrier(16)
    results, errors = [None] * 16, []

    def work(i):
        try:
            start.wait(timeout=30)
            results[i] = jpeg.decode(data)
        except Exception as err:  # noqa: BLE001 - reported by the assertion below
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    for r in results:
        np.testing.assert_array_equal(r, want)


def test_reader_digests_are_the_port_items_and_equal_jax(tmp_path, monkeypatch):
    """The PixImageNet digests the card's host checks (``digests.json``
    ``readers``, which the port's items give on the CPU) are what the JAX
    package's items give on its PIL path."""
    root = str(tmp_path / "folder")
    assert chip_smoke.jpeg_fixture_folder(root, FIXTURES) == 8
    # the port's side: test_chip_smoke_jpeg_decode_phase_runs_on_the_cpu
    jax_decodes_with_pil(monkeypatch)
    for crop in ("center", "random_crop"):
        ref = jimagenet.PixImageNet(root, random_crop=crop == "random_crop",
                                    **chip_smoke.JPEG_READER)
        assert chip_smoke.reader_digest(ref) == READER_DIGESTS[crop]


def test_chip_smoke_jpeg_decode_phase_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 17's ``jpeg_decode`` is host code: here it builds the decoder
    afresh, holds every fixture (the kinds of ``kinds/`` too) and both
    readers to their digests and times the decode, as on the card's host."""
    from deco_tpu_torch.data import jpeg as jpeg_module
    from deco_tpu_torch.ops import _build

    monkeypatch.chdir(os.path.dirname(os.path.abspath(chip_smoke.__file__)))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(jpeg_module, "_lib", None)
    monkeypatch.setattr(chip_smoke, "JPEG_DIR", str(tmp_path / "jpeg"))
    out = chip_smoke.phase_jpeg_decode("cpu", workers=2)
    assert out["build_s"] > 0 and all(f["equal"] for f in out["files"].values())
    assert out["readers"] == {"center": True, "random_crop": True}
    assert out["decode_ms_per_mp_one_thread"] > 0 and out["host_cpu"]
    assert len(out["kinds"]) == len(KIND_DIGESTS) and all(k["equal"] for k in out["kinds"].values())
    assert set(out["kind_ms_per_mp_threads"]) == {"arithmetic", "arithmetic-progressive",
                                                  "lossless"}
    assert '"phase": "jpeg_decode"' in capsys.readouterr().out


def test_chip_smoke_jpeg_fit_data_reads_as_jax(tmp_path, monkeypatch):
    """The data of phase 17's two fits: the caption folder through
    ``ImageText`` at 512 px and the tar through ``PixWebDataset`` at 448 px
    with random crop and flip, both equal to the JAX readers' items."""
    monkeypatch.setattr(chip_smoke, "JPEG_FIXTURES", FIXTURES)
    assert chip_smoke.write_jpeg_caption_folder(str(tmp_path / "t2i"), 0, copies=1) == 8
    ours = image_txt.ImageText(str(tmp_path / "t2i"), 512)
    ref = jimage_txt.ImageText(str(tmp_path / "t2i"), 512)
    for i in (0, 5):  # the CMYK and the 1,024 px fixtures
        np.testing.assert_array_equal(ours[i][0], ref[i][0])
        assert ours[i][1] == ref[i][1]
    shard = str(tmp_path / "shards" / "x.tar")
    assert chip_smoke.write_jpeg_tar_shard(shard, copies=1) == 8
    jax_decodes_with_pil(monkeypatch)
    kw = dict(resolution=448, random_crop=True, random_flip=True, buffer_size=4,
              process_index=0, process_count=1)
    ours, ref = (_items(make(shard, **kw)) for make in (webdataset.PixWebDataset,
                                                         jwebdataset.PixWebDataset))
    assert len(ours) == 8
    _same(ours, ref)


# ---- the readers on JPEG files ----

def _jpeg_file(path, h, w, seed, **kw):
    arr = generate.photo_like(h, w, 4, seed)
    mode = kw.pop("mode", "RGB")
    data = pil_jpeg(arr, mode, **kw)
    with open(path, "wb") as f:
        f.write(data)
    return data


SIZES = [(70, 90, dict(quality=90)), (96, 64, dict(quality=75, progressive=True)),
         (64, 64, dict(mode="L", quality=85)), (75, 81, dict(mode="CMYK", quality=90)),
         (130, 100, dict(quality=60, subsampling=1))]


@pytest.fixture(scope="module")
def jpeg_folder(tmp_path_factory):
    """An image folder of JPEGs in two classes: baseline, progressive, gray,
    CMYK and 4:2:2."""
    root = tmp_path_factory.mktemp("jpeg_folder")
    for c in range(2):
        os.makedirs(root / f"n{c}")
        for i, (h, w, kw) in enumerate(SIZES):
            _jpeg_file(root / f"n{c}" / f"{i}.jpg", h + 3 * c, w, seed=10 * c + i, **dict(kw))
    return str(root)


def _same(ours, ref, tol=0.0):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a[1] == b[1]
        if tol:
            assert np.abs(a[0] - b[0]).max() <= tol
        else:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[2]["raw_image"], b[2]["raw_image"])


@pytest.mark.parametrize("kw", [dict(), dict(random_crop=True), dict(random_flip=True)],
                         ids=["center", "random_crop", "flip"])
def test_pix_imagenet_jpeg_equals_jax(jpeg_folder, monkeypatch, kw):
    jax_decodes_with_pil(monkeypatch)
    ours = imagenet.PixImageNet(jpeg_folder, resolution=48, seed=5, **kw)
    ref = jimagenet.PixImageNet(jpeg_folder, resolution=48, seed=5, **kw)
    _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])


def test_pix_imagenet_jpeg_within_one_level_of_jax_native_path(jpeg_folder, monkeypatch):
    if not jax_native_data_plane(monkeypatch):
        pytest.skip("the JAX package's native/libdataplane.so is not built")
    ours = imagenet.PixImageNet(jpeg_folder, resolution=48)
    ref = jimagenet.PixImageNet(jpeg_folder, resolution=48)
    # the native library reads RGB and gray JPEGs; CMYK goes to PIL on its side too
    _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))], tol=ONE_LSB)


KIND_FOLDER = ["arith_422_restart_dac_250x333.jpg", "arith_progressive_gray_restart_200x150.jpg",
               "arith_adobe_cmyk_dac_240x180.jpg", "smooth_early_stop_huffman_211x157.jpg",
               "smooth_no_chroma_ac_arith_199x131.jpg", "lossless_420_p5_71x53.jpg",
               "lossless_three_scans_p2_59x37.jpg", "lossless_gray_restart_p7_64x64.jpg"]


@pytest.fixture(scope="module")
def kinds_folder(tmp_path_factory):
    """An image folder of .jpg files of the new kinds in two classes:
    arithmetic-coded (sequential and progressive), smoothed progressive and
    lossless."""
    root = tmp_path_factory.mktemp("kinds_folder")
    for i, name in enumerate(KIND_FOLDER):
        os.makedirs(root / f"n{i % 2}", exist_ok=True)
        (root / f"n{i % 2}" / name).write_bytes(kind_fixture(name))
    return str(root)


@pytest.mark.parametrize("kw", [dict(), dict(random_crop=True, random_flip=True)],
                         ids=["center", "random_crop"])
def test_pix_imagenet_new_jpeg_kinds_equal_jax(kinds_folder, monkeypatch, kw):
    """The JAX reader picks these files by their .jpg name and decodes them
    with PIL (its native data plane switched off here), so the port's items
    must be equal to its items, byte for byte."""
    jax_decodes_with_pil(monkeypatch)
    ours = imagenet.PixImageNet(kinds_folder, resolution=40, seed=4, **kw)
    ref = jimagenet.PixImageNet(kinds_folder, resolution=40, seed=4, **kw)
    assert len(ours) == len(ref) == len(KIND_FOLDER)
    _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])


def test_pix_imagenet_new_jpeg_kinds_within_one_level_of_jax_native_path(kinds_folder,
                                                                         monkeypatch):
    """Where ``native/libdataplane.so`` is built, the JAX reader's center
    crop decodes the arithmetic-coded and smoothed files with the system
    libjpeg (the whole file in memory, so no read boundary), and hands the
    lossless ones, which that libjpeg does not read, to PIL."""
    if not jax_native_data_plane(monkeypatch):
        pytest.skip("the JAX package's native/libdataplane.so is not built")
    ours = imagenet.PixImageNet(kinds_folder, resolution=40)
    ref = jimagenet.PixImageNet(kinds_folder, resolution=40)
    _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))], tol=ONE_LSB)


def test_local_cached_dataset_jpeg_equals_jax(jpeg_folder, tmp_path, monkeypatch):
    jax_decodes_with_pil(monkeypatch)
    cache = tmp_path / "cache"
    rng = np.random.default_rng(0)
    for path, _ in imagenet._scan_image_folder(jpeg_folder)[0]:
        target = cache / os.path.relpath(path, jpeg_folder)
        os.makedirs(target.parent, exist_ok=True)
        np.savez(str(target) + ".npz", mean=rng.normal(size=(4, 4, 2)).astype(np.float32),
                 logvar=rng.normal(size=(4, 4, 2)).astype(np.float32))
    for cache_root in (None, str(cache)):
        ours = imagenet.LocalCachedDataset(jpeg_folder, resolution=40, cache_root=cache_root)
        ref = jimagenet.LocalCachedDataset(jpeg_folder, resolution=40, cache_root=cache_root)
        _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])


def test_a_corrupt_jpeg_raises_in_pix_imagenet_as_in_jax(tmp_path, monkeypatch):
    jax_decodes_with_pil(monkeypatch)
    os.makedirs(tmp_path / "c")
    data = _jpeg_file(tmp_path / "c" / "a.jpg", 40, 40, seed=1)
    (tmp_path / "c" / "a.jpg").write_bytes(data[:len(data) // 2])
    with pytest.raises(OSError):
        jimagenet.PixImageNet(str(tmp_path), resolution=16)[0]
    with pytest.raises(ValueError, match="truncated"):
        imagenet.PixImageNet(str(tmp_path), resolution=16)[0]


def _write_tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return str(path)


@pytest.fixture(scope="module")
def jpeg_tar(tmp_path_factory):
    """A webdataset tar of JPEG members with classes and captions, one of
    them truncated and one not an image."""
    root = tmp_path_factory.mktemp("jpeg_tar")
    members = []
    for i, (h, w, kw) in enumerate(SIZES * 2):
        data = _jpeg_file(root / "tmp.jpg", h, w + i, seed=100 + i, **dict(kw))
        if i == 3:
            data = data[:len(data) // 3]  # truncated: PIL raises, so does the port
        if i == 6:
            data = b"\xff\xd8\xff\xe0 not a jpeg"
        members += [(f"{i:03d}.jpg", data), (f"{i:03d}.cls", str(i).encode()),
                    (f"{i:03d}.txt", f"caption {i}".encode())]
    return _write_tar(root / "shard-0.tar", members)


def _items(dataset):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return list(dataset)


@pytest.mark.parametrize("crop", ["center", "random"])
def test_pix_webdataset_skips_the_bad_jpegs_as_jax_does(jpeg_tar, monkeypatch, crop):
    jax_decodes_with_pil(monkeypatch)
    kw = dict(resolution=32, random_crop=crop == "random", random_flip=True, buffer_size=3,
              process_index=0, process_count=1)
    ours = _items(webdataset.PixWebDataset(jpeg_tar, **kw))
    ref = _items(jwebdataset.PixWebDataset(jpeg_tar, **kw))
    assert len(ours) == len(ref) == 8
    _same(ours, ref)


def test_webdataset_packed_skips_the_bad_jpegs_as_jax_does(jpeg_tar):
    kw = dict(resolution=40, random_crop=True, shuffle_buffer=3, repeat=False, seed=2,
              shard_index=0, shard_count=1)
    ours = list(packed.WebDatasetPacked(os.path.dirname(jpeg_tar), **kw))
    ref = list(jpacked.WebDatasetPacked(os.path.dirname(jpeg_tar), **kw))
    assert len(ours) == len(ref) == 8
    for (x, text, md), (rx, rtext, rmd) in zip(ours, ref):
        assert text == rtext
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(md["raw_image"], rmd["raw_image"])


def test_packed_parquet_skips_the_bad_jpegs_as_jax_does(tmp_path):
    pa = pytest.importorskip("pyarrow", reason="PackedParquetDataset reads parquet with pyarrow")
    import pyarrow.parquet as pq

    images = [_jpeg_file(tmp_path / "x.jpg", h, w, seed=i, **dict(kw))
              for i, (h, w, kw) in enumerate(SIZES)]
    images[2] = images[2][:100]
    pq.write_table(pa.table({"image": images, "caption_long": [f"c{i}" for i in range(5)]}),
                   str(tmp_path / "0.parquet"))
    runs = []
    for make in (packed.PackedParquetDataset, jpacked.PackedParquetDataset):
        np.random.seed(3)
        stream = make({str(tmp_path): 1}, {"caption_long": 1.0}, resolution=48,
                      random_crop=True, seed=1, shard_index=0, shard_count=1)
        runs.append([item for _, item in zip(range(8), stream)])
    for (x, text, md), (rx, rtext, rmd) in zip(*runs):
        assert text == rtext
        np.testing.assert_array_equal(x, rx)
    assert {text for _, text, _ in runs[0]} == {"c0", "c1", "c3", "c4"}


def test_jsonl_retries_a_truncated_jpeg_as_jax_does(jpeg_folder, tmp_path, monkeypatch):
    jax_decodes_with_pil(monkeypatch)
    data = _jpeg_file(tmp_path / "bad.jpg", 50, 50, seed=3)
    (tmp_path / "bad.jpg").write_bytes(data[:len(data) // 2])
    names = ["bad.jpg"] + [os.path.relpath(os.path.join(jpeg_folder, "n0", f"{i}.jpg"),
                                           str(tmp_path)) for i in range(5)]
    ann = tmp_path / "ann.jsonl"
    ann.write_text("\n".join(json.dumps({"target_image": n}) for n in names) + "\n")
    for crop in (False, True):
        kw = dict(resolution=32, random_crop=crop, random_flip=True, seed=7)
        ours = jsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
        ref = jjsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
        _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])
    (tmp_path / "only.jsonl").write_text(json.dumps({"target_image": "bad.jpg"}) + "\n")
    for cls in (jsonl.PixJSONLDataset, jjsonl.PixJSONLDataset):
        with pytest.raises(RuntimeError, match="after 2 attempts"):
            cls(str(tmp_path), str(tmp_path / "only.jsonl"), resolution=32, max_retries=2)[0]


def test_c17_streams_skip_12_bit_and_hierarchical_jpegs_as_jax(tmp_path, monkeypatch):
    """ROADMAP §C 17: a tar shard and a JSONL source holding a 12-bit and a
    hierarchical JPEG among good ones. Pillow refuses both, so the JAX
    readers skip (tar) or retry (JSONL) them; the port's decoder raises
    ``ValueError`` for them (it raised ``NotImplementedError``, which
    stopped the port's readers), and its readers give the JAX items."""
    jax_decodes_with_pil(monkeypatch)
    good = [_jpeg_file(tmp_path / f"g{i}.jpg", h, w, seed=40 + i, **dict(kw))
            for i, (h, w, kw) in enumerate(SIZES) if not kw.get("progressive")]
    bad = {"twelve_bit.jpg": _patched_sof(good[0], 0xC1, 12),
           "hierarchical.jpg": _patched_sof(good[1], 0xC5)}
    for name, data in bad.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(OSError):
            pil_rgb(data)
        with pytest.raises(ValueError):
            jpeg.decode(data)
    order = [good[0], bad["twelve_bit.jpg"], good[1], good[2], bad["hierarchical.jpg"], good[3]]
    members = []
    for i, data in enumerate(order):
        members += [(f"{i:03d}.jpg", data), (f"{i:03d}.cls", str(i).encode()),
                    (f"{i:03d}.txt", f"caption {i}".encode())]
    os.makedirs(tmp_path / "shards")
    shard = _write_tar(tmp_path / "shards" / "shard-0.tar", members)
    kw = dict(resolution=32, random_crop=True, random_flip=True, buffer_size=3,
              process_index=0, process_count=1)
    ours = _items(webdataset.PixWebDataset(shard, **kw))
    ref = _items(jwebdataset.PixWebDataset(shard, **kw))
    assert len(ours) == len(ref) == 4
    _same(ours, ref)
    kw = dict(resolution=40, random_crop=True, shuffle_buffer=3, repeat=False, seed=2,
              shard_index=0, shard_count=1)
    ours = list(packed.WebDatasetPacked(str(tmp_path / "shards"), **kw))
    ref = list(jpacked.WebDatasetPacked(str(tmp_path / "shards"), **kw))
    assert len(ours) == len(ref) == 4
    for (x, text, _), (rx, rtext, _) in zip(ours, ref):
        assert text == rtext
        np.testing.assert_array_equal(x, rx)
    names = ["g0.jpg", "twelve_bit.jpg", "g1.jpg", "hierarchical.jpg", "g2.jpg"]
    ann = tmp_path / "ann.jsonl"
    ann.write_text("\n".join(json.dumps({"target_image": n}) for n in names) + "\n")
    kw = dict(resolution=32, random_crop=True, random_flip=True, seed=5)
    ours = jsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
    ref = jjsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
    _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])


def test_image_text_jpeg_equals_jax(tmp_path):
    for i, (h, w, kw) in enumerate(SIZES):
        _jpeg_file(tmp_path / f"{i}.jpg", h, w, seed=20 + i, **dict(kw))
        (tmp_path / f"{i}.txt").write_text(f"caption {i}")
    ours = image_txt.ImageText(str(tmp_path), 56)
    ref = jimage_txt.ImageText(str(tmp_path), 56)
    assert len(ours) == len(ref) == 5
    for i in range(5):
        (x, text, md), (rx, rtext, rmd) = ours[i], ref[i]
        assert text == rtext and md["image_path"] == rmd["image_path"]
        np.testing.assert_array_equal(x, rx)


@pytest.mark.parametrize("data", [b"RIFF\x00\x00\x00\x00WEBPVP8 ", b"GIF89a\x01\x00",
                                  b"BM\x00\x00"], ids=["webp", "gif", "bmp"])
def test_other_formats_raise_naming_their_roadmap_item(data):
    """WebP, GIF and BMP decode since ROADMAP §A 2b closed: a truncated
    header raises ``ValueError`` as Pillow raises."""
    with pytest.raises(OSError):
        pil_rgb(data)
    with pytest.raises(ValueError, match="truncated|not a|WebP|GIF|BMP"):
        imagenet.decode_image(data)
