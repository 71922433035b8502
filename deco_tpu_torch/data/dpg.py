"""DPG-Bench prompt dataset and the 2x2 grid tool (``deco_tpu/data/dpg.py``).

Item ``idx`` is prompt file ``idx // num_samples_per_instance`` (sorted by
name) with seed ``idx % num_samples_per_instance``; its noise is
``seeded_noise(seed)``, and it is saved as ``<filename>_<seed>.png``.
:func:`concat_dpg_grids` tiles each prompt's first four samples into the
2x2 grid the DPG scorer reads. PNGs go through the port's codec.
"""

from __future__ import annotations

import os

import numpy as np

from deco_tpu_torch.data.randn import seeded_noise
from deco_tpu_torch.utils import png


def dpg_save_fn(image: np.ndarray, metadata: dict, root_path: str):
    png.write(os.path.join(root_path, f"{metadata['filename']}_{metadata['seed']}.png"), image)


class DPGDataset:
    def __init__(self, prompt_path: str, num_samples_per_instance: int, latent_shape):
        self.latent_shape = tuple(latent_shape)
        self.prompts, self.filenames = [], []
        for prompt_file in sorted(os.listdir(prompt_path)):
            with open(os.path.join(prompt_path, prompt_file)) as fp:
                self.prompts.append(fp.readline().strip())
            self.filenames.append(prompt_file.replace(".txt", ""))
        self.num_instances = len(self.prompts)
        self.num_samples_per_instance = num_samples_per_instance
        self.num_samples = self.num_instances * num_samples_per_instance

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int):
        instance_idx = idx // self.num_samples_per_instance
        sample_idx = idx % self.num_samples_per_instance
        metadata = dict(prompt=self.prompts[instance_idx], filename=self.filenames[instance_idx],
                        seed=sample_idx, save_fn=dpg_save_fn)
        return seeded_noise(sample_idx, self.latent_shape), metadata["prompt"], metadata


def concat_dpg_grids(sample_dir: str, out_dir: str, num_samples: int = 4):
    """Each prompt's first ``num_samples`` images (by name) as one 2x2 grid PNG."""
    os.makedirs(out_dir, exist_ok=True)
    names: dict = {}
    for f in sorted(os.listdir(sample_dir)):
        if not f.endswith(".png"):
            continue
        stem, _ = f.rsplit("_", 1)
        names.setdefault(stem, []).append(os.path.join(sample_dir, f))
    for stem, paths in names.items():
        imgs = [png.read(p) for p in sorted(paths)[:num_samples]]
        h, w = imgs[0].shape[:2]
        grid = np.zeros((2 * h, 2 * w, imgs[0].shape[2]), imgs[0].dtype)
        for i, img in enumerate(imgs):
            r, c = divmod(i, 2)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
        png.write(os.path.join(out_dir, stem + ".png"), grid)
