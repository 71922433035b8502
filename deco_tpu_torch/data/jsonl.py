"""JSONL annotation datasets with retry-on-bad-sample (``deco_tpu/data/jsonl.py``).

:class:`PixJSONLDataset` reads the ``target_image`` entries of a JSONL
annotation under ``root``; :class:`PixMultiJSONLDataset` merges the sources
of a JSON config (``{name: {"root", "annotation", "repeat_time"}}``, the
``scripts/total_images.json`` format), each entry repeated ``repeat_time``
times. ``max_num_samples`` keeps a seeded subset (numpy ``RandomState(42)``),
and a sample that fails to load is retried at a random index from the
dataset's ``RandomState(seed)``, up to ``max_retries`` attempts, as in JAX.
The random crop resizes the short side bicubically, draws y0 then x0, and
flips with probability 0.5 whatever ``random_flip`` says (the reference's
quirk, kept); the center crop is the ADM one, flipped under ``random_flip``.

Decoding follows ``data/webdataset.py``: PNG, JPEG (every kind Pillow
reads), WebP, GIF, BMP, DIB, ICO, CUR, PNM and QOI through
:func:`~deco_tpu_torch.data.imagenet.decode_image`, equal to PIL's
``convert("RGB")``. Corrupt or truncated files are retried like any bad
sample; a format Pillow decodes and the port does not (those of ROADMAP
§A 2e) raises ``NotImplementedError`` at once, naming its ROADMAP item (no
retry: the decoder is missing, not the sample).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from deco_tpu_torch.data.webdataset import decode_and_crop


def _load_jsonl(path: str) -> list:
    samples = []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line:
                item = json.loads(line)
                if "target_image" in item:
                    samples.append(item)
    return samples


class PixJSONLDataset:
    def __init__(self, root: str, annotation: str, resolution: int = 256,
                 random_crop: bool = False, random_flip: bool = False,
                 max_num_samples: Optional[int] = None, seed: int = 42, max_retries: int = 5):
        self.root = root
        self._setup(resolution, random_crop, random_flip, seed, max_retries)
        self.samples = _load_jsonl(annotation)
        self._subsample(max_num_samples)

    def _setup(self, resolution, random_crop, random_flip, seed, max_retries):
        self.resolution = resolution
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.max_retries = max_retries
        self._rng = np.random.RandomState(seed)

    def _subsample(self, max_num_samples: Optional[int]):
        if max_num_samples is not None and max_num_samples < len(self.samples):
            idx = np.random.RandomState(42).choice(len(self.samples), size=max_num_samples,
                                                   replace=False)
            self.samples = [self.samples[i] for i in idx]

    def __len__(self):
        return len(self.samples)

    def _load_one(self, idx: int):
        with open(os.path.join(self.root, self.samples[idx]["target_image"]), "rb") as f:
            data = f.read()

        def crop_at(max_y0, max_x0):
            y0 = self._rng.randint(0, max_y0 + 1) if max_y0 > 0 else 0
            x0 = self._rng.randint(0, max_x0 + 1) if max_x0 > 0 else 0
            return y0, x0

        arr = decode_and_crop(data, self.resolution, self.random_crop, crop_at)
        if (self.random_crop or self.random_flip) and self._rng.rand() < 0.5:
            arr = arr[:, ::-1]
        raw = arr.astype(np.float32) / 255.0
        return raw * 2.0 - 1.0, 0, {"raw_image": raw, "class": 0}

    def __getitem__(self, idx: int):
        for attempt in range(self.max_retries):
            try:
                if attempt > 0:
                    idx = int(self._rng.randint(0, len(self.samples)))
                return self._load_one(idx)
            except NotImplementedError:
                raise
            except Exception as e:  # noqa: BLE001 - retry another sample, as JAX does
                if attempt == self.max_retries - 1:
                    raise RuntimeError(
                        f"Failed to load sample after {self.max_retries} attempts: {e}") from e


class PixMultiJSONLDataset(PixJSONLDataset):
    """The sources of a JSON config merged, each entry ``repeat_time`` times."""

    def __init__(self, config_path: str, resolution: int = 256, random_crop: bool = False,
                 random_flip: bool = False, max_num_samples: Optional[int] = None,
                 seed: int = 42, max_retries: int = 5):
        self._setup(resolution, random_crop, random_flip, seed, max_retries)
        with open(config_path, "rb") as f:
            config = json.loads(f.read())
        self.samples, self.dataset_names = [], []
        for name, dcfg in config.items():
            repeat = int(dcfg.get("repeat_time", 1))
            for item in _load_jsonl(dcfg["annotation"]):
                item = dict(item, target_image=os.path.join(dcfg["root"], item["target_image"]))
                self.samples.extend([item] * repeat)
            self.dataset_names.append(name)
        self._subsample(max_num_samples)
        self.root = ""  # the merged paths carry their roots
