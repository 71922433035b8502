"""The streaming WebDataset reader over local tar shards (``deco_tpu/data/webdataset.py``).

:class:`PixWebDataset` is the reference ``PixWebDataset`` as the JAX
package streams it: the shards in a seeded shuffled order (training), a
seeded 1,000-sample shuffle buffer, one-shot sharding by a global sample
index striped over the processes (no sample reaches two), the samples
grouped by their member key, the image and an optional ``.cls`` class,
and ``(x in [-1, 1], class, {"raw_image" in [0, 1], "class"})`` items. One
``random.Random(seed + epoch)`` draws the shard order, the buffer, the
crops and the flips, in the JAX order.

Departures from the JAX package:

- The process index and count are chosen as ``data/packed.py``'s shard
  (:class:`~deco_tpu_torch.data.packed.StreamShard`), in place of
  ``jax.process_index()``.
- Members are decoded by :func:`~deco_tpu_torch.data.imagenet.decode_image`
  (PNG, JPEG of every kind Pillow reads, WebP, GIF, BMP, DIB, ICO, CUR, PNM
  and QOI, equal to PIL's ``convert("RGB")``) and cropped by the PIL-exact
  resampler (the ADM center crop, or with ``random_crop`` a bicubic resize
  of the short side and a random crop). Another format Pillow decodes
  (TIFF, JPEG 2000, ...) raises ``NotImplementedError`` (ROADMAP §A 2e),
  where the JAX reader would decode it. Every other failing sample
  (corrupt or truncated data, bytes of no image format) is skipped with a
  warning, as in JAX.
"""

from __future__ import annotations

import glob
import os
import random
import tarfile
import warnings
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from deco_tpu_torch.data.imagenet import adm_center_crop, decode_image, resize_short_side
from deco_tpu_torch.data.packed import StreamShard

_IMAGE_EXT = (".jpg", ".jpeg", ".png", ".webp")


def decode_and_crop(data: bytes, resolution: int, random_crop: bool, crop_at) -> np.ndarray:
    """Image bytes -> (resolution, resolution, 3) uint8: the ADM center crop,
    or with ``random_crop`` the short side resized to ``resolution`` and the
    window that ``crop_at(max_y0, max_x0)`` gives as (y0, x0). The bytes go
    through :func:`~deco_tpu_torch.data.imagenet.decode_image`: a format the
    port does not decode raises ``NotImplementedError``; corrupt data and
    bytes of no known format raise ``ValueError`` (a bad sample)."""
    image = decode_image(data)
    if not random_crop:
        return adm_center_crop(image, resolution)
    arr = resize_short_side(image, resolution)
    y0, x0 = crop_at(arr.shape[0] - resolution, arr.shape[1] - resolution)
    return arr[y0:y0 + resolution, x0:x0 + resolution]


class PixWebDataset(StreamShard):
    """Iterable over webdataset tar shards -> (x, class, metadata)."""

    def __init__(self, data_files: Union[str, Sequence[str]], resolution: int = 256,
                 random_crop: bool = False, random_flip: bool = False, is_train: bool = True,
                 random_seed: int = 42, buffer_size: int = 1000,
                 cache_dir: Optional[str] = None,  # taken for the configs' sake
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        if isinstance(data_files, str):
            files = sorted(glob.glob(data_files)) or [data_files]
        else:
            files = list(data_files)
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            raise FileNotFoundError(f"webdataset shards not found: {missing[:3]} (pass local "
                                    ".tar shards; remote streaming is not supported)")
        self.files: List[str] = files
        self.resolution = resolution
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.is_train = is_train
        self.seed = random_seed
        self.buffer_size = buffer_size
        self._epoch = 0
        self._init_shard(process_index, process_count)

    def select_shard(self, index: int, count: int) -> None:
        self.rank, self.world = index, count

    def _process(self, image_bytes: bytes, target: int, rng: random.Random):
        # random.randint is inclusive; x is drawn before y, as in JAX
        def crop_at(max_y0, max_x0):
            x0 = rng.randint(0, max_x0)
            return rng.randint(0, max_y0), x0

        arr = decode_and_crop(image_bytes, self.resolution, self.random_crop, crop_at)
        if self.random_flip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        raw = np.ascontiguousarray(arr, np.float32) / 255.0
        return raw * 2.0 - 1.0, int(target), {"raw_image": raw, "class": int(target)}

    def _grouped_members(self, path: str):
        """(image bytes, class) per sample key of one tar, streamed."""
        with tarfile.open(path, "r|*") as tf:
            current_key, img_bytes, cls = None, None, 0
            for member in tf:
                if not member.isfile():
                    continue
                key, ext = os.path.splitext(os.path.basename(member.name))
                ext = ext.lower()
                if key != current_key:
                    if img_bytes is not None:
                        yield img_bytes, cls
                    current_key, img_bytes, cls = key, None, 0
                data = tf.extractfile(member)
                if data is None:
                    continue
                if ext in _IMAGE_EXT:
                    img_bytes = data.read()
                elif ext == ".cls":
                    try:
                        cls = int(data.read().decode().strip())
                    except ValueError:
                        cls = 0
            if img_bytes is not None:
                yield img_bytes, cls

    def _processed(self, item, rng: random.Random):
        try:
            return self._process(item[0], item[1], rng)
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001 - skip a bad sample, as JAX does
            warnings.warn(f"[rank {self.rank}] skipping bad sample: {e}")
            return None

    def __iter__(self) -> Iterator:
        epoch = self._epoch
        self._epoch += 1
        rng = random.Random(self.seed + epoch)
        files = list(self.files)
        if self.is_train:
            rng.shuffle(files)

        def raw_stream():
            idx = 0
            for path in files:
                try:
                    for img_bytes, cls in self._grouped_members(path):
                        if idx % self.world == self.rank:
                            yield img_bytes, cls
                        idx += 1
                except (tarfile.TarError, OSError) as e:
                    warnings.warn(f"[rank {self.rank}] skipping bad shard {path}: {e}")

        buffer: list = []
        for item in raw_stream():
            if not self.is_train or self.buffer_size <= 1:
                out = item
            else:
                buffer.append(item)
                if len(buffer) < self.buffer_size:
                    continue
                j = rng.randrange(len(buffer))
                buffer[j], out = buffer[-1], buffer[j]
                buffer.pop()
            sample = self._processed(out, rng)
            if sample is not None:
                yield sample
        while buffer:
            j = rng.randrange(len(buffer))
            buffer[j], out = buffer[-1], buffer[j]
            buffer.pop()
            sample = self._processed(out, rng)
            if sample is not None:
                yield sample
