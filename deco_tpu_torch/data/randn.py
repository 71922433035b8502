"""Seeded eval-noise datasets for FID sampling (``deco_tpu/data/randn.py``).

Each item is (noise, condition, metadata) with a ``save_fn`` that writes the
image as ``<filename>.png``. The FID protocol pairs item ``idx`` with
condition ``idx // num_seeds`` and seed ``idx % num_seeds``; the noise is
numpy's Philox counter generator keyed on the seed, bit-equal to the JAX
package's. Latent shapes are CHW as in the configs; the noise is HWC.
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import List, Optional, Union

import numpy as np

from deco_tpu_torch.utils import png


def clean_filename(s: str) -> str:
    """Filename sanitization (ASCII, no slashes, lower case, <= 200 chars)."""
    s = s.strip().strip(".")
    s = unicodedata.normalize("NFKD", s).encode("ASCII", "ignore").decode("ASCII")
    s = re.sub(r"[/]", "_", s)
    s = re.sub(r"_{2,}", "_", s)
    s = s.lower()
    return s[:200] or "untitled"


def save_fn(image: np.ndarray, metadata: dict, root_path: str):
    """Write one (H, W, 3) uint8 image as ``<metadata['filename']>.png``."""
    png.write(os.path.join(root_path, str(metadata["filename"]) + ".png"), image)


def seeded_noise(seed: int, chw_shape) -> np.ndarray:
    """Deterministic float32 noise for one sample, returned HWC."""
    rng = np.random.Generator(np.random.Philox(seed))
    c, h, w = chw_shape
    return rng.standard_normal((h, w, c), dtype=np.float32)


class RandomNDataset:
    """Seeded-noise dataset over ``conditions`` x seeds.

    ``conditions`` is a count, a list, or a file with one condition a line.
    ``seeds`` fixes the seed list; otherwise item ``idx`` uses seed
    ``idx % num_seeds``. ``noise_file`` reads the noise from an
    (N, H, W, C) ``.npy`` instead. ``deterministic_seeds=False`` gives each
    item read a fresh seed from numpy's global generator (the reference's
    behaviour, which the JAX package keeps as an option): the noise of an
    item then depends on the order of reads and on ``np.random.seed``.
    """

    def __init__(self, latent_shape=(4, 64, 64),
                 conditions: Union[int, List, str, None] = None,
                 seeds: Optional[List[int]] = None, max_num_instances: int = 50000,
                 num_samples_per_instance: int = -1, noise_file: Optional[str] = None,
                 deterministic_seeds: bool = True):
        if isinstance(conditions, int):
            conditions = list(range(conditions))
        elif isinstance(conditions, str):
            if not os.path.exists(conditions):
                raise FileNotFoundError(conditions)
            with open(conditions) as f:
                conditions = f.read().splitlines()
        self.conditions = conditions
        self.num_conditions = len(conditions)
        self.seeds = seeds
        if num_samples_per_instance > 0:
            max_num_instances = num_samples_per_instance * self.num_conditions
        if seeds is not None:
            self.max_num_instances = len(seeds) * self.num_conditions
            self.num_seeds = len(seeds)
        else:
            self.num_seeds = (max_num_instances + self.num_conditions - 1) // self.num_conditions
            self.max_num_instances = self.num_seeds * self.num_conditions
        self.latent_shape = tuple(latent_shape)
        self.deterministic_seeds = deterministic_seeds
        self._noise = np.load(noise_file, mmap_mode="r") if noise_file else None

    def _seed_for(self, idx: int) -> int:
        if self.seeds is not None:
            return self.seeds[idx % self.num_seeds]
        if self.deterministic_seeds:
            return idx % self.num_seeds
        return int(np.random.randint(0, 1 << 31))

    def __len__(self):
        return self.max_num_instances

    def __getitem__(self, idx: int):
        condition = self.conditions[idx // self.num_seeds]
        seed = self._seed_for(idx)
        filename = f"{clean_filename(str(condition))}_{seed}"
        if self._noise is not None:
            latent = np.asarray(self._noise[idx], np.float32)
        else:
            latent = seeded_noise(seed, self.latent_shape)
        metadata = dict(filename=filename, seed=seed, condition=condition, save_fn=save_fn)
        return latent, condition, metadata


class ClassLabelRandomNDataset(RandomNDataset):
    """The class-label FID protocol: ``num_classes`` classes x seeds."""

    def __init__(self, latent_shape=(4, 64, 64), num_classes: int = 1000, conditions=None,
                 seeds=None, max_num_instances: int = 50000,
                 num_samples_per_instance: int = -1, **kw):
        if conditions is None:
            conditions = list(range(num_classes))
        super().__init__(latent_shape, conditions, seeds, max_num_instances,
                         num_samples_per_instance, **kw)
