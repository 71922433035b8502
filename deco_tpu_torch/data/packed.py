"""Streaming packed t2i datasets: webdataset tars and parquet shards
(``deco_tpu/data/packed.py``), the ``train_dataset`` of the
``configs_t2i/pretraining_*.yaml`` configs.

Both are endless iterables of ``(x, caption, {"raw_image", "prompt"})``
with the JAX readers' draws in the JAX order: the shard's files are
``files[shard_index::shard_count]`` and one ``random.Random(seed +
shard_index)`` drives the file order, the shuffle buffer, the prefix
templates and the random crop; ``PackedParquetDataset`` picks each
sample's caption key from numpy's global generator, as the JAX reader does.

Departures from the JAX package:

- The shard index and count are the config's when it gives them, else
  the data rank and size of the mesh that the loader passes
  (:meth:`StreamShard.use_loader_shard`: the model axis's ranks of one
  data rank read the same stream), else ``torch.distributed``'s rank and
  world size when it is initialised, else (0, 1), in place of
  ``jax.process_index()``.
- Images are decoded by :func:`~deco_tpu_torch.data.imagenet.decode_image`
  (PNG, JPEG of every kind Pillow reads, WebP, GIF, BMP, DIB, ICO, CUR,
  PNM and QOI, equal to PIL's ``convert("RGB")``) and resized with the
  PIL-exact resampler. The JAX readers skip every sample
  that fails; the port skips what PIL also rejects (images smaller than
  the resolution, corrupt or truncated data, bytes of no image format,
  unreadable tars) and raises where the port lacks a decoder PIL has: the
  formats of ROADMAP §A 2e (``NotImplementedError``). Skipping those
  would drop every sample of such a shard and spin forever.
- ``WebDatasetPacked`` takes the reference ``WebDatasetPackedDataset``'s
  ``sample_shuffle`` (the pretraining YAMLs set it; the JAX class has no
  such argument, ROADMAP §C 8): False turns the shuffle buffer off.
"""

from __future__ import annotations

import os
import random
import struct
import tarfile
import zlib
from typing import Dict, Iterator, Optional

import numpy as np

from deco_tpu_torch.data import imagenet
from deco_tpu_torch.data.imagenet import center_crop, resize_short_side

PREFIX_TEMPLATES = [
    "A photo of ",
    "A picture of ",
    "A visual representation of ",
    "A image of ",
    "A scene of ",
    "A view of ",
    "A depiction of ",
]


def shard_of_process(shard_index: Optional[int], shard_count: Optional[int]):
    """(index, count) of this process's shard: the arguments when given,
    else ``torch.distributed``'s rank and world size when it is
    initialised, else (0, 1)."""
    if shard_index is not None:
        return shard_index, max(shard_count, 1)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class StreamShard:
    """The shard a stream reads, set by the subclass's ``select_shard(index,
    count)``: the config's when given, else :func:`shard_of_process`'s
    until the loader passes its data rank (:meth:`use_loader_shard`)."""

    def _init_shard(self, index: Optional[int], count: Optional[int]) -> None:
        self.shard_fixed = index is not None
        self.select_shard(*shard_of_process(index, count))

    def use_loader_shard(self, index: int, count: int) -> None:
        if not self.shard_fixed:
            self.select_shard(index, count)


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Image bytes as (H, W, 3) uint8 RGB
    (:func:`~deco_tpu_torch.data.imagenet.decode_image`), or None for corrupt
    or truncated data and bytes of no image format (the samples the JAX
    reader skips). A format or kind the port does not decode raises."""
    try:
        return imagenet.decode_image(data)
    except (ValueError, zlib.error, struct.error):
        return None


def _process_image(image: np.ndarray, resolution: int, random_crop: bool,
                   rng: random.Random):
    """(x in [-1, 1], raw in [0, 1]) of the resized and cropped image, or
    None when its short side is under ``resolution``."""
    if min(image.shape[:2]) < resolution:
        return None
    arr = resize_short_side(image, resolution)
    if random_crop:
        my, mx = arr.shape[0] - resolution, arr.shape[1] - resolution
        y0 = rng.randint(0, my) if my > 0 else 0
        x0 = rng.randint(0, mx) if mx > 0 else 0
        arr = arr[y0:y0 + resolution, x0:x0 + resolution]
    else:
        arr = center_crop(arr, resolution)
    raw = arr.astype(np.float32) / 255.0
    return raw * 2.0 - 1.0, raw


def _item(img_bytes: bytes, caption: str, resolution: int, random_crop: bool,
          rng: random.Random):
    image = decode_image(img_bytes)
    out = None if image is None else _process_image(image, resolution, random_crop, rng)
    if out is None:
        return None
    x, raw = out
    return x, caption, {"raw_image": raw, "prompt": caption}


class PackedParquetDataset(StreamShard):
    """Endless iterable over parquet shards of (image bytes, captions):
    ``data_sources`` maps a folder to how often its files repeat, and
    ``caption_weight`` a caption column to its sampling weight."""

    def __init__(self, data_sources: Dict[str, int], caption_weight: Dict[str, float],
                 resolution: int = 256, random_crop: bool = False, seed: int = 0,
                 shard_index: Optional[int] = None, shard_count: Optional[int] = None):
        self.resolution = resolution
        self.random_crop = random_crop
        self.caption_weight = caption_weight
        self.parquet_files = []
        for root, repeat in data_sources.items():
            files = sorted(os.path.join(root, f) for f in os.listdir(root)
                           if f.endswith(".parquet"))
            self.parquet_files.extend(files * int(repeat))
        self.seed = seed
        self._init_shard(shard_index, shard_count)

    def select_shard(self, index: int, count: int) -> None:
        self._files = self.parquet_files[index::count]
        self._rng = random.Random(self.seed + index)

    def __iter__(self) -> Iterator:
        try:
            import pyarrow.parquet as pq
        except ImportError as err:
            raise ImportError("PackedParquetDataset reads parquet with the 'pyarrow' package, "
                              "which is not installed") from err
        rng = self._rng
        keys = list(self.caption_weight.keys())
        probs = np.asarray(list(self.caption_weight.values()), np.float64)
        probs = probs / probs.sum()
        while True:
            table = pq.read_table(rng.choice(self._files))
            order = np.random.RandomState(rng.randint(0, 2**31)).permutation(table.num_rows)
            for i in order.tolist():
                record = {c: table[c][i].as_py() for c in table.column_names}
                caption_key = np.random.choice(keys, p=probs)
                if caption_key not in record:
                    continue
                caption = record[caption_key]
                if rng.random() < 0.5 and "long" not in caption_key:
                    caption = rng.choice(PREFIX_TEMPLATES) + caption
                item = _item(record["image"], caption, self.resolution, self.random_crop, rng)
                if item is not None:
                    yield item


class WebDatasetPacked(StreamShard):
    """Local webdataset tar shards of (jpg/png + txt/json caption) members
    grouped by stem, through a shuffle buffer of ``shuffle_buffer``
    samples; ``repeat`` starts over after the last tar. ``urls`` are tar
    files or folders of them."""

    def __init__(self, urls, resolution: int = 512, random_crop: bool = False,
                 shuffle_buffer: int = 1000, sample_shuffle: bool = True, repeat: bool = True,
                 caption_key: str = "txt", seed: int = 0, shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None):
        self.resolution = resolution
        self.random_crop = random_crop
        self.shuffle_buffer = shuffle_buffer if sample_shuffle else 1
        self.repeat = repeat
        self.caption_key = caption_key
        tars = []
        for url in (urls if isinstance(urls, (list, tuple)) else [urls]):
            if os.path.isdir(url):
                tars.extend(sorted(os.path.join(url, f) for f in os.listdir(url)
                                   if f.endswith(".tar")))
            else:
                tars.append(url)
        self.tars, self.seed = tars, seed
        self._init_shard(shard_index, shard_count)

    def select_shard(self, index: int, count: int) -> None:
        self._tars = self.tars[index::count]
        self._rng = random.Random(self.seed + index)

    def _samples_from_tar(self, path: str) -> list:
        """(image bytes, caption) of each stem with an image and a caption, in
        tar order."""
        groups: Dict[str, dict] = {}
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                stem, ext = os.path.splitext(member.name)
                groups.setdefault(stem, {})[ext.lstrip(".").lower()] = \
                    tf.extractfile(member).read()
        samples = []
        for stem, parts in groups.items():
            img_bytes = parts.get("jpg") or parts.get("jpeg") or parts.get("png")
            cap = parts.get(self.caption_key)
            if img_bytes is None or cap is None:
                continue
            samples.append((img_bytes, cap.decode("utf-8").strip()))
        return samples

    def __iter__(self):
        rng = self._rng
        buffer = []
        while True:
            tars = list(self._tars)
            rng.shuffle(tars)
            for tar in tars:
                try:
                    samples = self._samples_from_tar(tar)
                except (tarfile.TarError, OSError):
                    continue  # an unreadable tar, skipped as the JAX reader does
                for sample in samples:
                    buffer.append(sample)
                    if len(buffer) >= self.shuffle_buffer:
                        i = rng.randrange(len(buffer))
                        buffer[i], buffer[-1] = buffer[-1], buffer[i]
                        out = _item(*buffer.pop(), self.resolution, self.random_crop, rng)
                        if out is not None:
                            yield out
            while buffer:
                out = _item(*buffer.pop(), self.resolution, self.random_crop, rng)
                if out is not None:
                    yield out
            if not self.repeat:
                break
