"""The port's WebP, GIF, BMP, DIB, ICO, CUR, PNM and QOI decoders
(``deco_tpu_torch/csrc/{webp,gif,bmp,pnm,qoi}_decode.cpp`` through
``deco_tpu_torch.data.{webp,gif,bmp,ico,pnm,qoi}``) against PIL, and the
port's readers on mixed data of these kinds against the JAX package's, on
the CPU.

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
from deco_tpu_torch.data import (bmp, gif, ico, image_txt, imagenet, jsonl, packed, pnm, qoi,
                                 webdataset, webp)
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
    """The files written at run time (the 512 x 512 24-bit BMP, P6 PNM and
    QOI of the card host's timing) are what digests.json describes."""
    for name, data in generate.generated_files().items():
        rgb = imagenet.decode_image(data)
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == GENERATED[name]["sha256"], name
        np.testing.assert_array_equal(rgb, pil_rgb(data))


def test_info_reads_the_headers():
    assert pnm.info(fixture("pnm_p5_maxval_1000.pgm")) == (19, 27, "I", False)
    assert pnm.info(fixture("pnm_p3_plain_maxval_1000.ppm")) == (19, 27, "RGB", True)
    assert pnm.info(fixture("pnm_pycmyk_maxval_7000.ppm"))[2] == "CMYK"
    assert qoi.info(fixture("qoi_every_op.qoi")) == (3, 4, 4)
    assert ico.ICO.info(fixture("ico_bmp_8bpp.ico"))[:3] == (24, 24, 8)
    assert ico.ICO.info(fixture("ico_png_sizes.ico"))[3] > 0  # a PNG frame's offset
    assert ico.CUR.info(fixture("cur_largest_second.cur"))[:2] == (24, 24)
    assert bmp.DIB.info(fixture("dib_os2_24bpp.dib"))[:3] == (21, 35, 24)
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
    "dib": ([n for n in DIGESTS if n.startswith("dib_")], 60, 200),
    "ico_cur": ([n for n in DIGESTS if n.startswith(("ico_", "cur_"))], 110, 400),
    "pnm": ([n for n in DIGESTS if n.startswith("pnm_")], 30, 600),
    "qoi": ([n for n in DIGESTS if n.startswith("qoi_")], 20, 300),
    "gif": ([n for n in DIGESTS if n.startswith("gif_") and "512" not in n], 40, 1000),
    "webp": ([n for n in DIGESTS if n.startswith("webp_") and "512" not in n], 60, 1000),
}


@pytest.mark.parametrize("kind", sorted(SWEEP))
def test_mutated_streams_decode_or_raise_as_pil(kind):
    """Seeded corruptions of every fixture of a format (bit flips, bytes
    replaced, runs cut or inserted, files cut short; a third of them in the
    headers): ``ValueError`` where Pillow raises, Pillow's bytes where it
    decodes; 400 BMP streams (a corrupt BMP header can ask Pillow for a
    canvas of 10^8 pixels, slow to fill), 1,000 GIF and 1,000 WebP, 200
    DIB, 400 ICO and CUR, 600 PNM and 300 QOI (while they were written the
    five new decoders were held to Pillow on 9,000 such streams)."""
    names, header, count = SWEEP[kind]
    seeds = [fixture(n) for n in sorted(names)]
    rng = np.random.default_rng({"bmp": 1, "gif": 2, "webp": 3, "dib": 4, "ico_cur": 5,
                                 "pnm": 6, "qoi": 7}[kind])
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
                                           (bmp, "bmp_rle8.bmp"),
                                           (ico, "ico_pick_lowest_depth.ico"),
                                           (pnm, "pnm_p3_plain_maxval_1000.ppm"),
                                           (qoi, "qoi_rgba.qoi")])
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
    "DCX": lambda: struct.pack("<I", 0x3ADE68B1) + bytes(16),
    "DDS": lambda: _pil_written("DDS"),
    "EPS": lambda: b"%!PS-Adobe-3.0 EPSF-3.0\n" + bytes(16),
    "FITS": lambda: b"SIMPLE  =                    T" + bytes(16),
    "FLI": lambda: struct.pack("<IHHHHH", 128, 0xAF11, 1, 16, 16, 8) + bytes(16),
    "FTEX": lambda: b"FTEX" + bytes(16),
    "GBR": lambda: struct.pack(">II", 28, 2) + bytes(16),
    "ICNS": lambda: b"icns" + bytes(16),
    "IM": lambda: _pil_written("IM"),
    "JPEG2000": lambda: _pil_written("JPEG2000"),
    "MCIDAS": lambda: b"\0\0\0\0\0\0\0\4" + bytes(16),
    "MSP": lambda: _pil_written("MSP"),
    "PCD": lambda: bytes(2048) + b"PCD_" + bytes(16),
    "PCX": lambda: _pil_written("PCX"),
    "PIXAR": lambda: b"\x80\xe8\0\0" + bytes(16),
    "PSD": lambda: b"8BPS\0\1" + bytes(16),
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
    if fmt in ("BLP", "DDS", "IM", "JPEG2000", "MSP", "PCX", "SGI", "TIFF", "XBM"):
        assert pil_rgb(data) is not None
    assert imagenet.other_format(data) == fmt
    with pytest.raises(NotImplementedError, match=f"{fmt}.*ROADMAP §A 2e"):
        imagenet.decode_image(data)


# ---- DIB, ICO, CUR, PNM and QOI: the edges Pillow's plugins draw ----

PNM_CASES = {  # name: bytes
    "comment_splits_width": b"P5\n1#c\n9 2\n255\n" + bytes(range(38)),
    "comment_at_the_end_of_the_header": b"P5 2 2 255#x\n" + bytes(4),
    "token_of_10_digits": b"P5 0000000002 2 255\n" + bytes(4),
    "token_of_11_digits": b"P5 00000000002 2 255\n" + bytes(4),
    "underscores_and_sign": b"P6 +1_0 1 2_55 " + bytes(30),
    "double_underscore": b"P6 1__0 1 255 " + bytes(30),
    "maxval_0": b"P5 2 1 0\n" + bytes(2),
    "maxval_65536": b"P5 2 1 65536\n" + bytes(4),
    "maxval_256_raw": b"P5 3 1 256\n" + bytes([0, 0, 1, 0, 0, 255]),
    "raw_sample_over_maxval": b"P5 3 1 9\n" + bytes([3, 9, 200]),
    "plain_sample_over_maxval": b"P2 3 1 9\n3 9 10",
    "plain_negative": b"P2 2 1 9\n3 -1",
    "plain_half_token_at_the_end": b"P2 2 1 255\n7 25",
    "plain_trailing_junk": b"P3 1 1 255\n1 2 3 junk",
    "plain_bitonal_junk_after_the_image": b"P1 2 1\n01x",
    "plain_bitonal_no_spaces": b"P1\n3 2\n011010",
    "plain_short": b"P3 2 1 255\n1 2 3 4",
    "plain_comment_in_data": b"P2 3 1 255\n1 #two\n2 3",
    "pf_scale_zero": b"Pf 1 1 0.0\n" + bytes(4),
    "pf_scale_nan": b"Pf 1 1 nan\n" + bytes(4),
    "pf_scale_exponent": b"Pf 2 1 -1e-3\n" + struct.pack("<2f", 300.5, 7.9),
    "pf_scale_hex": b"Pf 1 1 0x1p3\n" + bytes(4),
    "colour_pfm": b"PF\n1 1\n-1.0\n" + bytes(12),
    "negative_width": b"P5 -2 1 255\n" + bytes(4),
    "raw_short": b"P6 2 1 255\n" + bytes(5),
    "magic_without_space": b"P63 1 255\n" + bytes(3),
    "pyp_indices": b"PyP 4 1 255\n" + bytes([0, 7, 128, 255]),
}


@pytest.mark.parametrize("case", sorted(PNM_CASES))
def test_pnm_headers_and_data_decode_or_raise_as_pil(case):
    """PpmImagePlugin's header tokens (comments anywhere, up to 10 bytes,
    Python's int() and float()), its maxval rules, and its raw, scaled and
    plain decoders (a plain block is checked whole; a sample over maxval
    fails in plain data and clips in raw data)."""
    assert_decodes_or_raises_as_pil(PNM_CASES[case], case)


def test_plain_pnm_blocks_as_pil():
    """Plain data of more than ImageFile.SAFEBLOCK bytes, read in its
    blocks: a token, and a comment, split between two blocks."""
    block = 1024 * 1024
    w = 320_000
    head = b"P2 %d 1 255\n" % w
    body = b" ".join(b"%d" % (i % 256) for i in range(w))
    assert len(body) > block
    for lead in range(4):  # one of these ends the first block inside a token
        assert_decodes_or_raises_as_pil(head + b" " * lead + body, ("split token", lead))
    at = body.index(b" ", block - 30)
    for shift in (0, 20, 40):  # a comment across the end of the first block
        commented = body[:at - shift] + b" # a comment" + b"x" * 40 + b"\n" + body[at - shift:]
        assert_decodes_or_raises_as_pil(head + commented, ("split comment", shift))


QOI_CASES = {
    "header_of_13_bytes": b"qoif" + struct.pack(">II", 1, 1) + b"\3",
    "header_of_12_bytes": b"qoif" + struct.pack(">II", 1, 1),
    "zero_width": b"qoif" + struct.pack(">IIBB", 0, 1, 3, 0) + bytes(8),
    "ends_inside_rgb": b"qoif" + struct.pack(">IIBB", 2, 1, 3, 0) + b"\xfe\1\2",
    "ends_inside_luma": b"qoif" + struct.pack(">IIBB", 2, 1, 4, 0) + b"\x40\x80",
    "ends_before_the_image": b"qoif" + struct.pack(">IIBB", 3, 1, 3, 0) + b"\x40\x41",
    "index_never_written": b"qoif" + struct.pack(">IIBB", 2, 1, 4, 0) + b"\x05\x35",
    "run_past_the_image": b"qoif" + struct.pack(">IIBB", 2, 2, 3, 0) + b"\xfd",
}


@pytest.mark.parametrize("case", sorted(QOI_CASES))
def test_qoi_edges_decode_or_raise_as_pil(case):
    assert_decodes_or_raises_as_pil(QOI_CASES[case], case)


def _icon_cases() -> dict:
    bitmap = generate.icon_bitmap(generate.photo_like(8, 8, 1)[..., ::-1], 24, seed=2)
    png = fixture("ico_bmp_and_png.ico")
    png = png[struct.unpack("<I", png[6 + 16 + 12:6 + 16 + 16])[0]:]
    return {
        "ico_no_entry": b"\0\0\1\0\0\0",
        "ico_short_directory": b"\0\0\1\0\2\0" + bytes(20),
        "ico_offset_past_the_end": generate.encode_icon([(8, 8, 0, 24, bitmap)])[:22] + struct.pack(
            "<I", 10_000) + bitmap,
        "ico_and_mask_cut": generate.encode_icon([(8, 8, 0, 24, bitmap)])[:-20],
        "ico_and_mask_past_the_entry": generate.encode_icon([(8, 8, 0, 24, bitmap + bytes(8))]),
        "ico_32bpp_entry_of_a_24bpp_bitmap": generate.encode_icon([(8, 8, 0, 32, bitmap)]),
        "ico_png_with_trailing_bytes": generate.encode_icon([(32, 32, 0, 32, png + bytes(50))]),
        "ico_entry_of_256": generate.encode_icon([(0, 0, 0, 24, bitmap), (8, 8, 0, 24, bitmap)]),
        "ico_depth_from_one_colour": generate.encode_icon([(8, 8, 1, 0, bitmap),
                                                           (8, 8, 2, 0, bitmap)]),
        "cur_no_entry": b"\0\0\2\0\0\0",
        "cur_offset_0": b"\0\0\2\0\1\0" + struct.pack("<BBBBHHII", 8, 8, 0, 0, 1, 24,
                                                      len(bitmap), 0) + bitmap,
        "cur_short_second_entry": generate.encode_icon([(8, 8, 0, 24, bitmap)], kind=2)[:6] +
        b"\2\0"[:0] + generate.encode_icon([(8, 8, 0, 24, bitmap)], kind=2)[6:22],
        "cur_height_of_1": generate.encode_icon([(8, 1, 0, 24, generate.icon_bitmap(
            generate.photo_like(1, 8, 3), 24)[:8] + struct.pack("<i", 1) + generate.icon_bitmap(
            generate.photo_like(1, 8, 3), 24)[12:])], kind=2),
    }


ICON_CASES = _icon_cases()


@pytest.mark.parametrize("case", sorted(ICON_CASES))
def test_icon_and_cursor_edges_decode_or_raise_as_pil(case):
    """IcoImagePlugin and CurImagePlugin: empty and short directories, an
    offset past the end, an AND mask (or a 32-bit entry's alpha bytes) cut
    short, the entry a 0 byte means 256 for, a depth the colour count
    gives, a cursor offset of 0 (the bitmap read on from the directory)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert_decodes_or_raises_as_pil(ICON_CASES[case], case)


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


NEW_KINDS = ["dib_rle8.dib", "ico_pick_lowest_depth.ico", "ico_png_sizes.ico",
             "cur_largest_second.cur", "pnm_p3_plain_maxval_1000.ppm", "pnm_p5_16bit.pgm",
             "pnm_pf_little_endian.pfm", "qoi_every_op.qoi", "qoi_rgba.qoi"]


def test_jsonl_new_kinds_equal_jax(tmp_path):
    """A JSONL source naming one file of each kind this slice decodes (DIB,
    ICO, CUR, PNM, QOI), by its own extension and under a .png name: the
    JAX reader opens every one with PIL (its native data plane reads .jpg
    names only), so the port's items equal its items byte for byte."""
    names = []
    for i, name in enumerate(NEW_KINDS):
        stored = name if i % 2 else f"{i}.png"
        (tmp_path / stored).write_bytes(fixture(name))
        names.append(stored)
    ann = tmp_path / "ann.jsonl"
    ann.write_text("\n".join(json.dumps({"target_image": n}) for n in names))
    for crop in (False, True):
        kw = dict(resolution=16, random_crop=crop, random_flip=True, seed=5)
        ours = jsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
        ref = jjsonl.PixJSONLDataset(str(tmp_path), str(ann), **kw)
        assert len(ours) == len(ref) == len(NEW_KINDS)
        _same([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])


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
    """``phase_image_kinds_decode`` loads the five decoders this host's
    compiler built from these sources, holds every fixture to its digest
    without PIL, and times the 512 x 512 files; here on the CPU at one
    round."""
    monkeypatch.chdir(os.path.dirname(os.path.abspath(chip_smoke.__file__)))
    monkeypatch.setattr(chip_smoke, "IMAGE_KINDS_ROUNDS", 1)
    out = chip_smoke.phase_image_kinds_decode("cpu", 2)
    assert all(f["equal"] for f in out["files"].values())
    assert out["kinds"] == len(DIGESTS) + len(GENERATED)
    assert set(out["ms_per_mp"]) == {"webp_lossy", "webp_lossless", "gif", "bmp", "pnm", "qoi"}
    assert set(out["libraries"]) == {"webp_decode", "gif_decode", "bmp_decode", "pnm_decode",
                                     "qoi_decode"}
    assert all(lib["loaded"] for lib in out["libraries"].values())
    assert "image_kinds_decode" in capsys.readouterr().out
