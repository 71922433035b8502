"""GenEval prompt dataset and the scorer's file layout
(``deco_tpu/data/geneval.py``).

Item ``idx`` is prompt ``idx // num_samples_per_instance`` of the GenEval
metadata file with seed ``idx % num_samples_per_instance``; its noise is
``seeded_noise(seed)``. The save function writes
``<idx>/samples/<seed>.png`` and ``<idx>/metadata.jsonl``, as GenEval's
scorer expects, with the port's PNG encoder.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from deco_tpu_torch.data.randn import seeded_noise
from deco_tpu_torch.utils import png


def _jsonable(v):
    """Plain JSON for the scorer's metadata: the loader's collate turns
    numbers into numpy scalars and lists into arrays, and the text
    conditioner writes tensors (``valid_length_y``)."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if hasattr(v, "__array__") and not isinstance(v, (str, bytes)):
        arr = np.asarray(v)
        return arr.item() if arr.ndim == 0 else arr.tolist()
    return v


def geneval_save_fn(image: np.ndarray, metadata: dict, root_path: str):
    path = os.path.join(root_path, str(metadata["filename"]))
    os.makedirs(os.path.join(path, "samples"), exist_ok=True)
    png.write(os.path.join(path, "samples", f"{_jsonable(metadata['seed'])}.png"), image)
    clean = {k: _jsonable(v) for k, v in metadata.items() if k != "save_fn"}
    with open(os.path.join(path, "metadata.jsonl"), "w") as fp:
        json.dump(clean, fp)


class GenEvalDataset:
    def __init__(self, meta_json_path: str, num_samples_per_instance: int, latent_shape):
        self.latent_shape = tuple(latent_shape)
        with open(meta_json_path) as fp:
            self.metadatas = [json.loads(line) for line in fp]
        self.num_instances = len(self.metadatas)
        self.num_samples_per_instance = num_samples_per_instance
        self.num_samples = self.num_instances * num_samples_per_instance

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int):
        instance_idx = idx // self.num_samples_per_instance
        sample_idx = idx % self.num_samples_per_instance
        metadata = copy.deepcopy(self.metadatas[instance_idx])
        metadata["seed"] = sample_idx
        metadata["filename"] = f"{idx}"
        metadata["save_fn"] = geneval_save_fn
        return seeded_noise(sample_idx, self.latent_shape), metadata["prompt"], metadata
