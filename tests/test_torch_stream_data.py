"""The port's t2i training data (deco_tpu_torch.data.image_txt, .packed and
loader.IterableLoader) against the JAX package's readers.

Both read the same seeded PNG files: the JAX readers with PIL, the port with
its own PNG codec and PIL-exact resampler, so the items are compared for
equality (byte for byte on the uint8 images, exactly on the floats made
from them). Where a reader draws (shuffle buffer, caption source, prefix,
random crop), both are given the same seed and shard (0 of 1), and the
parquet reader's caption draws come from numpy's global generator, seeded
before each side runs.
"""

import io
import os
import random
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from deco_tpu.config import registry as jax_registry
from deco_tpu.data import image_txt as jimage_txt
from deco_tpu.data import loader as jloader
from deco_tpu.data import packed as jpacked
from deco_tpu_torch.config import _yaml, registry
from deco_tpu_torch.data import image_txt, loader, packed
from deco_tpu_torch.utils import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((40, 52), (56, 36), (33, 33), (24, 64))  # (H, W): both orientations, ragged


def _png_bytes(rng, h, w) -> bytes:
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h, np.full((h, w), 90.0)], -1)
    return png.encode(np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8))


def _jpeg_bytes(rng, h=40, w=40, **kw) -> bytes:
    """A photo-like JPEG written by PIL (its default 4:2:0 unless ``kw``
    says otherwise)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h, np.full((h, w), 150.0)], -1)
    buf = io.BytesIO()
    Image.fromarray(np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)).save(
        buf, format="JPEG", **kw)
    return buf.getvalue()


def _same_items(ours, theirs):
    assert len(ours) == len(theirs)
    for (x, text, md), (rx, rtext, rmd) in zip(ours, theirs):
        assert text == rtext
        np.testing.assert_array_equal(x, rx)
        assert sorted(md) == sorted(rmd)
        for key, value in md.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(value, rmd[key])
            else:
                assert value == rmd[key], key


# ---- ImageText ----

@pytest.fixture(scope="module")
def caption_folder(tmp_path_factory):
    """PNG + caption pairs in two nested folders, an image without a caption,
    and a caption without an image."""
    root = tmp_path_factory.mktemp("image_txt")
    rng = np.random.default_rng(0)
    for d, count in (("a", 3), ("b/c", 3)):
        os.makedirs(root / d)
        for i in range(count):
            (root / d / f"{i}.png").write_bytes(_png_bytes(rng, *SIZES[(i + len(d)) % 4]))
            (root / d / f"{i}.txt").write_text(f"caption {d} {i}\nsecond line")
    (root / "a" / "lonely.png").write_bytes(_png_bytes(rng, 30, 30))
    (root / "a" / "orphan.txt").write_text("no image")
    return str(root)


@pytest.mark.parametrize("resolution", [24, 32])
def test_image_text_equals_jax_byte_for_byte(caption_folder, resolution):
    ours = image_txt.ImageText(caption_folder, resolution)
    theirs = jimage_txt.ImageText(caption_folder, resolution)
    assert ours.image_paths == theirs.image_paths and ours.texts == theirs.texts
    assert len(ours) == 6
    _same_items([ours[i] for i in range(len(ours))], [theirs[i] for i in range(len(theirs))])
    assert ours[0][0].shape == (resolution, resolution, 3) and ours[0][0].dtype == np.float32


def test_image_text_raises_on_a_jpeg(tmp_path):
    """JPEG + caption pairs (a baseline, a progressive and a 4:4:4 file):
    once a refusal (the port had no JPEG decoder), now the JAX reader's
    items byte for byte, through the port's own decoder."""
    rng = np.random.default_rng(5)
    for i, kw in enumerate([dict(quality=90), dict(progressive=True), dict(subsampling=0)]):
        (tmp_path / f"x{i}.jpg").write_bytes(_jpeg_bytes(rng, *SIZES[i], **kw))
        (tmp_path / f"x{i}.txt").write_text(f"a photo {i}")
    ours = image_txt.ImageText(str(tmp_path), 24)
    theirs = jimage_txt.ImageText(str(tmp_path), 24)
    assert len(ours) == len(theirs) == 3
    _same_items([ours[i] for i in range(3)], [theirs[i] for i in range(3)])


# ---- IterableLoader ----

class _Stream:
    """A re-iterable stream of (x, caption, metadata) items; ``fail_at``
    raises in the stream at that item."""

    def __init__(self, n: int, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise KeyError(f"item {i}")
            yield (np.full((2, 2, 3), i, np.float32), f"caption {i}",
                   {"raw_image": np.full((2, 2, 3), i / 10, np.float32), "prompt": f"p{i}",
                    "idx": i})


@pytest.mark.parametrize("kw", [dict(drop_last=True), dict(drop_last=False),
                                dict(drop_last=True, infinite=True)])
def test_iterable_loader_batches_like_jax(kw):
    ours, theirs = (make(_Stream(7), 3, **kw) for make in (loader.IterableLoader,
                                                           jloader.IterableLoader))
    count = 6 if kw.get("infinite") else None
    got, want = [], []
    for it, out in ((ours, got), (theirs, want)):
        for i, batch in enumerate(it):
            if count is not None and i == count:
                break
            out.append(batch)
    assert len(got) == len(want) == (count or (2 if kw["drop_last"] else 3))
    for (x, y, md), (rx, ry, rmd) in zip(got, want):
        np.testing.assert_array_equal(x, rx)
        assert y == ry
        assert sorted(md) == sorted(rmd)
        for key in md:
            np.testing.assert_array_equal(np.asarray(md[key]), np.asarray(rmd[key]))


def test_iterable_loader_delivers_stream_errors_and_has_no_set_position():
    made = loader.make_loader(_Stream(7, fail_at=4), 2, shuffle=True, num_workers=8,
                              infinite=True)
    assert isinstance(made, loader.IterableLoader) and not hasattr(made, "set_position")
    got = []
    with pytest.raises(KeyError, match="item 4"):
        for batch in made:
            got.append(batch[1])
    assert got == [["caption 0", "caption 1"], ["caption 2", "caption 3"]]


# ---- WebDatasetPacked ----

def _write_tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def tar_folder(tmp_path_factory):
    """Two shards of stem-grouped png + txt samples, with the samples the
    JAX reader skips: a member without a caption, an image under the
    resolution, a corrupt PNG; and a corrupt tar."""
    root = tmp_path_factory.mktemp("wds")
    rng = np.random.default_rng(1)
    for shard in range(2):
        members = []
        for i in range(5):
            stem = f"s{shard}/{i:04d}"
            members.append((f"{stem}.png", _png_bytes(rng, *SIZES[(i + shard) % 4])))
            members.append((f"{stem}.txt", f"  sample {shard} {i} \n".encode()))
        members.append(("s/nocap.png", _png_bytes(rng, 40, 40)))
        members.append(("s/small.png", _png_bytes(rng, 12, 40)))
        members.append(("s/small.txt", b"too small"))
        members.append(("s/broken.png", _png_bytes(rng, 40, 40)[:60]))
        members.append(("s/broken.txt", b"corrupt"))
        _write_tar(root / f"{shard:05d}.tar", members)
    (root / "00002.tar").write_bytes(b"not a tar file at all" * 30)
    return str(root)


@pytest.mark.parametrize("kw", [
    dict(shuffle_buffer=3, repeat=False),
    dict(shuffle_buffer=4, repeat=False, random_crop=True, seed=5),
    dict(shuffle_buffer=2, repeat=True, seed=1),
], ids=["buffer", "random_crop", "repeat"])
def test_webdataset_packed_yields_the_jax_items_in_order(tar_folder, kw):
    take = 25 if kw["repeat"] else None
    streams = [make(tar_folder, resolution=24, shard_index=0, shard_count=1, **kw)
               for make in (packed.WebDatasetPacked, jpacked.WebDatasetPacked)]
    ours, theirs = ([item for _, item in zip(range(take or 10**6), s)] for s in streams)
    assert len(ours) == (take or 10)
    _same_items(ours, theirs)


def test_webdataset_packed_takes_sample_shuffle(tar_folder):
    """The pretraining YAMLs pass ``sample_shuffle``, which the JAX class
    refuses (ROADMAP §C 8); False turns the buffer off: the JAX reader with
    a buffer of one sample."""
    ours = list(packed.WebDatasetPacked(tar_folder, resolution=24, shuffle_buffer=50,
                                        sample_shuffle=False, repeat=False, shard_index=0,
                                        shard_count=1))
    theirs = list(jpacked.WebDatasetPacked(tar_folder, resolution=24, shuffle_buffer=1,
                                           repeat=False, shard_index=0, shard_count=1))
    _same_items(ours, theirs)
    with pytest.raises(TypeError, match="sample_shuffle"):
        jpacked.WebDatasetPacked(tar_folder, sample_shuffle=True, shard_index=0, shard_count=1)


def test_webdataset_packed_raises_on_a_jpeg_sample(tmp_path):
    """A tar of PNG and JPEG samples (a BLIP3o tar is all JPEG): once a
    refusal, now the JAX reader's items in its order, byte for byte."""
    rng = np.random.default_rng(2)
    _write_tar(tmp_path / "0.tar", [("a.png", _png_bytes(rng, 30, 30)), ("a.txt", b"ok"),
                                    ("b.jpg", _jpeg_bytes(rng)), ("b.txt", b"jpeg"),
                                    ("c.jpg", _jpeg_bytes(rng, 44, 36, progressive=True)),
                                    ("c.txt", b"progressive")])
    kw = dict(resolution=16, random_crop=True, repeat=False, shuffle_buffer=2,
              shard_index=0, shard_count=1)
    theirs = list(jpacked.WebDatasetPacked(str(tmp_path), **kw))
    assert len(theirs) == 3
    _same_items(list(packed.WebDatasetPacked(str(tmp_path), **kw)), theirs)


def test_shards_come_from_torch_distributed(tar_folder, monkeypatch):
    import torch.distributed as dist

    tars = sorted(os.path.join(tar_folder, f) for f in os.listdir(tar_folder))
    assert packed.WebDatasetPacked(tar_folder)._tars == tars  # not initialised: 0 of 1
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    ds = packed.WebDatasetPacked(tar_folder, seed=3)
    assert ds._tars == tars[1::2]
    assert ds._rng.random() == random.Random(3 + 1).random()
    assert packed.WebDatasetPacked(tar_folder, shard_index=0, shard_count=3)._tars == tars[::3]


# ---- PackedParquetDataset ----

@pytest.fixture(scope="module")
def parquet_sources(tmp_path_factory):
    pa = pytest.importorskip("pyarrow", reason="PackedParquetDataset reads parquet with pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(3)
    roots = []
    for source in range(2):
        root = tmp_path_factory.mktemp(f"parquet{source}")
        for f in range(2):
            images, longs, shorts = [], [], []
            for i in range(5):
                images.append(_png_bytes(rng, *SIZES[(i + f) % 4]))
                longs.append(f"a long caption of {source}/{f}/{i}")
                shorts.append(f"short {source}/{f}/{i}")
            images[1] = _png_bytes(rng, 10, 40)  # under the resolution
            images[3] = images[3][:50]  # corrupt
            pq.write_table(pa.table({"image": images, "caption_long": longs,
                                     "caption_short": shorts}), str(root / f"{f}.parquet"))
        roots.append(str(root))
    return roots


@pytest.mark.parametrize("weights", [{"caption_long": 1.0},
                                     {"caption_long": 0.4, "caption_short": 0.4, "missing": 0.2}],
                         ids=["long", "mixed"])
def test_packed_parquet_yields_the_jax_items_in_order(parquet_sources, weights):
    sources = {parquet_sources[0]: 1, parquet_sources[1]: 2}
    runs = []
    for make in (packed.PackedParquetDataset, jpacked.PackedParquetDataset):
        np.random.seed(11)
        stream = make(sources, weights, resolution=24, random_crop=True, seed=4,
                      shard_index=0, shard_count=1)
        runs.append([item for _, item in zip(range(14), stream)])
    _same_items(*runs)
    assert any(text.startswith(tuple(packed.PREFIX_TEMPLATES)) for _, text, _ in runs[0]) == (
        "caption_short" in weights)


def test_packed_parquet_raises_on_a_jpeg_sample(tmp_path):
    """Parquet rows of JPEG bytes: once a refusal, now the JAX reader's
    items in its order, byte for byte."""
    pa = pytest.importorskip("pyarrow", reason="PackedParquetDataset reads parquet with pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(6)
    images = [_jpeg_bytes(rng, *SIZES[i % 4], quality=70 + 5 * i) for i in range(3)]
    pq.write_table(pa.table({"image": images, "caption_long": ["j0", "j1", "j2"]}),
                   str(tmp_path / "0.parquet"))
    runs = []
    for make in (packed.PackedParquetDataset, jpacked.PackedParquetDataset):
        np.random.seed(2)
        stream = make({str(tmp_path): 1}, {"caption_long": 1.0}, resolution=16,
                      random_crop=True, seed=3, shard_index=0, shard_count=1)
        runs.append([item for _, item in zip(range(5), stream)])
    _same_items(*runs)


# ---- the registry ----

def test_registry_builds_the_three_t2i_data_nodes(caption_folder, tar_folder, tmp_path):
    """The nodes the JAX registry maps to its ImageText and packed readers
    build the port's; the JAX registry raises TypeError on the pretraining
    YAMLs' WebDatasetPackedDataset node (its ``sample_shuffle``, ROADMAP §C 8),
    the port takes it."""
    image_node = {"class_path": "src.data.dataset.image_txt.ImageText",
                  "init_args": {"root": caption_folder, "resolution": 24}}
    assert isinstance(registry.instantiate(image_node), image_txt.ImageText)
    parquet_node = {"class_path": "src.data.dataset.blip3o_dataset.PackedParquetDataset",
                    "init_args": {"data_sources": {str(tmp_path): 1},
                                  "caption_weight": {"caption_long": 1.0}}}
    assert isinstance(registry.instantiate(parquet_node), packed.PackedParquetDataset)
    for name in ("pretraining_res256", "pretraining_res512"):
        config = _yaml.load(os.path.join(REPO, "configs_t2i", f"{name}.yaml"))
        node = config["data"]["train_dataset"]
        node["init_args"]["urls"] = [tar_folder]
        stream = registry.instantiate(node)
        assert isinstance(stream, packed.WebDatasetPacked)
        assert stream.shuffle_buffer == 20000 and stream.resolution == int(name[-3:])
        with pytest.raises(TypeError, match="sample_shuffle"):
            jax_registry.instantiate(node)


@pytest.mark.parametrize("name", ["pretraining_res256", "pretraining_res512", "DeCo_large"])
def test_pretraining_configs_still_raise_at_the_dinov2_encoder(name):
    """The absent torch-hub weight file still raises, but only where the
    encoder is called: the DeCo trainer never runs its REPA encoder, so its
    node builds as shipped, the encoder an unbuilt node (no tower, no file
    read)."""
    folder = "configs_c2i" if name == "DeCo_large" else "configs_t2i"
    config = _yaml.load(os.path.join(REPO, folder, f"{name}.yaml"))
    node = config["model"]["diffusion_trainer"]
    node["init_args"]["encoder"]["init_args"]["device"] = "cpu"
    trainer = registry.instantiate(node)
    assert type(trainer).__name__ == "DeCoTrainer"
    assert trainer.align_layer == (8 if name == "DeCo_large" else 6)
    assert isinstance(trainer.encoder, registry.Deferred) and trainer.encoder.built is None
    assert trainer.metadata_keys == ()  # the loop hands it no raw_image to encode
    with pytest.raises(FileNotFoundError, match="dinov2_vitb14_pretrain.pth"):
        trainer.encoder(torch.zeros(1, 32, 32, 3))
    assert trainer.encoder.built is None


def test_repa_trainer_still_raises_without_the_dinov2_file():
    """Baseline_DiT.yaml's REPATrainer runs its tower every step: its node
    still builds the tower with the trainer, and the absent file raises."""
    config = _yaml.load(os.path.join(REPO, "configs_c2i", "Baseline_DiT.yaml"))
    node = config["model"]["diffusion_trainer"]
    node["init_args"]["encoder"]["init_args"]["device"] = "cpu"
    with pytest.raises(FileNotFoundError, match="dinov2_vitb14_pretrain.pth"):
        registry.instantiate(node)
    node["init_args"]["encoder"]["init_args"].update(weight_path=None, num_layers=1)
    with pytest.warns(UserWarning, match="random weights"):
        trainer = registry.instantiate(node)
    assert type(trainer.encoder).__name__ == "DINOv2" and trainer.align_layer == 8
