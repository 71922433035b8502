"""The port's data path (deco_tpu_torch.data, utils.png) against the JAX
package's: the FID-protocol noise dataset, PNG reading and writing against
PIL, the ADM crop, the ImageNet folder dataset and the loader's order."""

import io
import os
import shutil
import struct
import subprocess
import zlib

import numpy as np
import pytest
from PIL import Image

from deco_tpu.data import imagenet as jax_imagenet
from deco_tpu.data import loader as jax_loader
from deco_tpu.data import randn as jax_randn
from deco_tpu_torch.data import imagenet, loader, randn
from deco_tpu_torch.utils import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smooth_image(rng, h, w):
    """A photo-like image: a gradient plus noise (random pixels would make
    every resampling window look alike)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h, (xx + yy) * 127.0 / (h + w)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


# ---- randn: the FID protocol ----

@pytest.mark.parametrize("kwargs", [
    dict(num_classes=5, max_num_instances=15),  # 3 seeds a class
    dict(num_classes=4, max_num_instances=10),  # rounded up to 3 seeds a class
    dict(num_classes=3, seeds=[7, 11]),
    dict(num_classes=3, num_samples_per_instance=2),
])
def test_class_label_dataset_matches_jax(kwargs):
    """Same (latent, condition, filename, seed) at every index, across the
    num_seeds boundaries where the class changes."""
    ours = randn.ClassLabelRandomNDataset(latent_shape=(3, 8, 8), **kwargs)
    ref = jax_randn.ClassLabelRandomNDataset(latent_shape=(3, 8, 8), **kwargs)
    assert len(ours) == len(ref) and ours.num_seeds == ref.num_seeds
    for i in range(len(ref)):
        x, y, md = ours[i]
        rx, ry, rmd = ref[i]
        np.testing.assert_array_equal(x, rx)
        assert y == ry == i // ref.num_seeds
        assert (md["filename"], md["seed"], md["condition"]) == (
            rmd["filename"], rmd["seed"], rmd["condition"])


def test_noise_file_and_text_conditions_match_jax(tmp_path):
    noise = np.random.default_rng(0).standard_normal((4, 8, 8, 3)).astype(np.float32)
    np.save(tmp_path / "noise.npy", noise)
    (tmp_path / "prompts.txt").write_text("A Cat/Dog\nsecond. prompt\n")
    kw = dict(latent_shape=(3, 8, 8), conditions=str(tmp_path / "prompts.txt"),
              max_num_instances=4, noise_file=str(tmp_path / "noise.npy"))
    ours, ref = randn.RandomNDataset(**kw), jax_randn.RandomNDataset(**kw)
    for i in range(4):
        np.testing.assert_array_equal(ours[i][0], ref[i][0])
        assert ours[i][1] == ref[i][1] and ours[i][2]["filename"] == ref[i][2]["filename"]


def test_save_fn_writes_the_png_pil_reads(tmp_path):
    image = _smooth_image(np.random.default_rng(1), 12, 20)
    (tmp_path / "ours").mkdir()
    (tmp_path / "ref").mkdir()
    randn.save_fn(image, {"filename": "3_7"}, str(tmp_path / "ours"))
    jax_randn.save_fn(image, {"filename": "3_7"}, str(tmp_path / "ref"))
    ours = np.array(Image.open(tmp_path / "ours" / "3_7.png"))
    np.testing.assert_array_equal(ours, np.array(Image.open(tmp_path / "ref" / "3_7.png")))
    np.testing.assert_array_equal(ours, image)


# ---- PNG against PIL ----

def _pil_png(array, **save):
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG", **save)
    return buf.getvalue()


def _pil_image_png(image) -> bytes:
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return buf.getvalue()


def _png_with_filters(image, filters):
    """PNG bytes of an (H, W, 3) uint8 image with row y filtered by
    ``filters[y % len(filters)]`` (the PNG specification's five filters)."""
    h, w, _ = image.shape
    rows, prior, bpp = [], bytes(3 * w), 3
    for y in range(h):
        line, kind = image[y].reshape(-1).tobytes(), filters[y % len(filters)]
        out = bytearray([kind])
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            b, c = prior[i], prior[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((x - pred) & 0xFF)
        rows.append(bytes(out))
        prior = line

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_png_encode_reads_back_in_pil():
    image = _smooth_image(np.random.default_rng(2), 31, 17)
    np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(png.encode(image)))), image)


@pytest.mark.parametrize("channels", [3, 1, 4], ids=["RGB", "L", "RGBA"])
@pytest.mark.parametrize("optimize", [False, True])
def test_png_decode_equals_pil(channels, optimize):
    """PIL's adaptive filtering picks a filter per row; gray and RGBA become
    RGB as PIL's convert("RGB") makes them."""
    rng = np.random.default_rng(3)
    image = _smooth_image(rng, 29, 41)
    if channels == 1:
        array = image[:, :, 0]
    elif channels == 4:
        array = np.concatenate([image, rng.integers(0, 256, (29, 41, 1), np.uint8)], -1)
    else:
        array = image
    data = _pil_png(array, optimize=optimize)
    expected = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(png.decode(data), expected)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]])
def test_png_decode_each_row_filter(filters):
    image = _smooth_image(np.random.default_rng(4), 9, 13)
    data = _png_with_filters(image, filters)
    np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(data))), image)
    np.testing.assert_array_equal(png.decode(data), image)


def _interlaced(data: bytes) -> bytes:
    """``data`` with the IHDR interlace byte set to 1 (Adam7) and its CRC redone."""
    body = b"IHDR" + data[16:28] + b"\x01"
    return data[:12] + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + data[33:]


@pytest.mark.parametrize("make", [
    lambda: _pil_image_png(Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P")),
    lambda: _pil_png(np.zeros((4, 4), np.uint16)),  # 16-bit gray
    lambda: _interlaced(png.encode(np.zeros((4, 4, 3), np.uint8))),  # Adam7
    lambda: b"GIF89a" + bytes(20),
], ids=["palette", "16bit", "interlaced", "not_png"])
def test_png_decode_rejects_other_formats(make):
    with pytest.raises(ValueError):
        png.decode(make())


# ---- ADM crop against PIL ----

@pytest.mark.parametrize("hw,resolution", [((288, 320), 256), ((384, 288), 256),
                                           ((700, 523), 128), ((64, 64), 32),
                                           ((257, 1031), 64), ((45, 61), 16)])
def test_adm_center_crop_within_one_lsb_of_pil(hw, resolution):
    image = _smooth_image(np.random.default_rng(sum(hw)), *hw)
    ours = imagenet.adm_center_crop(image, resolution)
    ref = np.array(jax_imagenet.adm_center_crop(Image.fromarray(image), resolution))
    assert ours.shape == ref.shape == (resolution, resolution, 3)
    assert np.abs(ours.astype(int) - ref).max() <= 1


@pytest.mark.parametrize("kind,pil", [("bicubic", Image.BICUBIC), ("box", Image.BOX)])
def test_resample_within_one_lsb_of_pil(kind, pil):
    rng = np.random.default_rng(5)
    image = _smooth_image(rng, 53, 71)
    for out_w, out_h in [(30, 20), (71, 25), (17, 53), (100, 90)]:
        ours = imagenet.resample(image, out_w, out_h, kind)
        ref = np.array(Image.fromarray(image).resize((out_w, out_h), pil))
        assert np.abs(ours.astype(int) - ref).max() <= 1, (out_w, out_h)


# ---- PixImageNet against the JAX dataset ----

@pytest.fixture(scope="module")
def png_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("png_imagenet")
    rng = np.random.default_rng(6)
    for c in ("n01", "n02"):
        (root / c).mkdir()
        for i, hw in enumerate([(40, 52), (52, 40), (33, 33)]):
            Image.fromarray(_smooth_image(rng, *hw)).save(root / c / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("kw", [{}, {"random_flip": True, "seed": 3},
                                {"random_crop": True, "seed": 4}])
def test_pix_imagenet_matches_jax_on_png(png_folder, kw):
    ours = imagenet.PixImageNet(png_folder, resolution=32, **kw)
    ref = jax_imagenet.PixImageNet(png_folder, resolution=32, **kw)
    assert [(os.path.relpath(p, png_folder), c) for p, c in ours.samples] == [
        (os.path.relpath(p, png_folder), c) for p, c in ref.samples]
    for i in range(len(ref)):  # in order, so both draw from RandomState(seed) alike
        x, y, md = ours[i]
        rx, ry, rmd = ref[i]
        assert y == ry and x.shape == rx.shape == (32, 32, 3)
        assert np.abs(x - rx).max() <= 2.0 / 255 + 1e-6  # 1 LSB on [-1, 1]
        assert np.abs(md["raw_image"] - rmd["raw_image"]).max() <= 1.0 / 255 + 1e-6


@pytest.fixture(scope="module")
def native_lib():
    so = os.path.join(REPO, "native", "libdataplane.so")
    if not os.path.exists(so) and shutil.which("g++"):
        subprocess.run(["bash", os.path.join(REPO, "scripts", "build_native.sh")],
                       capture_output=True, timeout=300)
    if not os.path.exists(so):
        pytest.skip("native/libdataplane.so is not built and g++ cannot build it")
    return so


def test_pix_imagenet_jpeg_equals_jax_native_path(native_lib, tmp_path):
    rng = np.random.default_rng(7)
    for c in ("a", "b"):
        (tmp_path / c).mkdir()
        for i, hw in enumerate([(300, 260), (140, 190)]):
            Image.fromarray(_smooth_image(rng, *hw)).save(tmp_path / c / f"{i}.jpg", quality=90)
    ours = imagenet.PixImageNet(str(tmp_path), resolution=128)
    ref = jax_imagenet.PixImageNet(str(tmp_path), resolution=128)
    for i in range(len(ref)):
        np.testing.assert_array_equal(ours[i][0], ref[i][0])


def test_jpeg_without_the_library_names_the_build(monkeypatch, tmp_path):
    from deco_tpu_torch.data import native

    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build_native.sh"):
        native.decode_jpeg_adm(b"\xff\xd8", 16)


# ---- the loader's order ----

class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), i, {"idx": i, "name": f"s{i}"}


def _order(ld, batches):
    out = []
    for b in ld:
        out.append(b[1].tolist())
        if len(out) == batches:
            break
    return out


@pytest.mark.parametrize("n,batch,shuffle", [(10, 4, True), (13, 5, True), (3, 4, True),
                                             (10, 4, False)])
def test_sharded_loader_order_matches_jax(n, batch, shuffle):
    kw = dict(shuffle=shuffle, seed=5, num_workers=2, infinite=True)
    ours = loader.ShardedLoader(_Indices(n), batch, **kw)
    ref = jax_loader.ShardedLoader(_Indices(n), batch, process_index=0, process_count=1, **kw)
    assert len(ours) == len(ref)
    assert _order(ours, 7) == _order(ref, 7)  # several epochs


def test_set_position_continues_the_stream_like_jax():
    kw = dict(shuffle=True, seed=1, num_workers=2, infinite=True)
    full = _order(loader.ShardedLoader(_Indices(11), 3, **kw), 9)
    for start in (1, 3, 5):
        ours = loader.ShardedLoader(_Indices(11), 3, **kw)
        ref = jax_loader.ShardedLoader(_Indices(11), 3, process_index=0, process_count=1, **kw)
        ours.set_position(start)
        ref.set_position(start)
        assert _order(ours, 9 - start) == _order(ref, 9 - start) == full[start:]


def test_collate_matches_jax():
    samples = [_Indices(4)[i] for i in range(3)]
    x, y, md = loader.collate(samples)
    rx, ry, rmd = jax_loader.collate(samples)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    assert md.keys() == rmd.keys() and md["name"] == rmd["name"]
    np.testing.assert_array_equal(md["idx"], rmd["idx"])


def test_make_loader_rejects_streaming_datasets():
    with pytest.raises(NotImplementedError, match="ROADMAP §A 3"):
        loader.make_loader(iter([]), 2)


def test_unseeded_noise_mode_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP §A 2"):
        randn.RandomNDataset(latent_shape=(3, 8, 8), conditions=2, deterministic_seeds=False)


# ---- animated PNG (serve's trajectories) ----

def test_apng_frames_read_back_here_and_in_pil():
    """Every frame exact, 100 ms each, looping: read back by the port's
    reader and by PIL's APNG decoder."""
    rng = np.random.default_rng(4)
    frames = [_smooth_image(rng, 13, 21) for _ in range(5)]
    data = png.encode_apng(frames, delay_ms=100)
    ours, delays = png.decode_apng(data)
    assert delays == [100.0] * 5
    for a, b in zip(ours, frames):
        np.testing.assert_array_equal(a, b)
    im = Image.open(io.BytesIO(data))
    assert im.n_frames == 5 and im.info.get("loop") == 0
    for i, frame in enumerate(frames):
        im.seek(i)
        assert im.info["duration"] == 100
        np.testing.assert_array_equal(np.array(im.convert("RGB")), frame)
    np.testing.assert_array_equal(png.decode(data), frames[0])  # a plain reader: the first
    with pytest.raises(ValueError):
        png.encode_apng([frames[0], frames[1][:5]])


# ---- GenEval and DPG prompt datasets (t2i predict) ----

from deco_tpu.data import dpg as jax_dpg  # noqa: E402
from deco_tpu.data import geneval as jax_geneval  # noqa: E402
from deco_tpu_torch.data import dpg, geneval  # noqa: E402

GENEVAL = os.path.join(REPO, "evaluations/geneval/evaluation_metadata.jsonl")
DPG = os.path.join(REPO, "evaluations/dpg/prompts")


@pytest.mark.parametrize("idx", [0, 5, 2211])  # the last item has an "exclude" list
def test_geneval_items_and_files_match_jax(tmp_path, idx):
    ours = geneval.GenEvalDataset(GENEVAL, 4, (3, 8, 12))
    ref = jax_geneval.GenEvalDataset(GENEVAL, 4, (3, 8, 12))
    assert len(ours) == len(ref) == 553 * 4
    (x, y, md), (rx, ry, rmd) = ours[idx], ref[idx]
    np.testing.assert_array_equal(x, rx)
    assert x.shape == (8, 12, 3) and y == ry
    assert {k: v for k, v in md.items() if k != "save_fn"} == {
        k: v for k, v in rmd.items() if k != "save_fn"}
    image = _smooth_image(np.random.default_rng(idx), 8, 12)
    # a collated record: numpy scalars and the text encoder's valid_length_y tensor
    import torch

    record = {**md, "seed": np.int64(md["seed"]), "valid_length_y": torch.tensor(5)}
    for fn, root in ((md["save_fn"], tmp_path / "ours"), (rmd["save_fn"], tmp_path / "ref")):
        root.mkdir()
        fn(image, {**record, "save_fn": fn}, str(root))
    sample = f"{idx}/samples/{idx % 4}.png"
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "ours" / sample)),
                                  np.array(Image.open(tmp_path / "ref" / sample)))
    assert (tmp_path / "ours" / f"{idx}/metadata.jsonl").read_text() == (
        tmp_path / "ref" / f"{idx}/metadata.jsonl").read_text()


def test_dpg_items_files_and_grids_match_jax(tmp_path):
    ours, ref = dpg.DPGDataset(DPG, 4, (3, 8, 8)), jax_dpg.DPGDataset(DPG, 4, (3, 8, 8))
    assert len(ours) == len(ref) == 1065 * 4
    assert ours.filenames == ref.filenames and ours.prompts == ref.prompts
    rng = np.random.default_rng(0)
    for idx in (0, 1, 2, 3, 4, 4259):
        (x, y, md), (rx, ry, rmd) = ours[idx], ref[idx]
        np.testing.assert_array_equal(x, rx)
        assert y == ry and {k: md[k] for k in ("prompt", "filename", "seed")} == {
            k: rmd[k] for k in ("prompt", "filename", "seed")}
        image = _smooth_image(rng, 8, 8)
        for fn, root in ((md["save_fn"], tmp_path / "ours"), (rmd["save_fn"], tmp_path / "ref")):
            root.mkdir(exist_ok=True)
            fn(image, md, str(root))
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "ref"))
    dpg.concat_dpg_grids(str(tmp_path / "ours"), str(tmp_path / "grid_ours"))
    jax_dpg.concat_dpg_grids(str(tmp_path / "ref"), str(tmp_path / "grid_ref"))
    names = sorted(os.listdir(tmp_path / "grid_ref"))
    assert sorted(os.listdir(tmp_path / "grid_ours")) == names and len(names) == 3
    for name in names:
        grid = png.read(str(tmp_path / "grid_ours" / name))
        assert grid.shape == (16, 16, 3)
        np.testing.assert_array_equal(grid, np.array(Image.open(tmp_path / "grid_ref" / name)))
