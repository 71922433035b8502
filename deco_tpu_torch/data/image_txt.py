"""Image + caption folder dataset (``deco_tpu/data/image_txt.py`` ``ImageText``),
the ``train_dataset`` of ``configs_t2i/sft_res512.yaml`` (the BLIP3o-60k
SFT layout).

The folder is walked in sorted order and each image with a same-name
``.txt`` caption is one item. An item's short side is resized to the
resolution with PIL's BICUBIC filter to ``(round(w * scale), round(h *
scale))``, byte for byte (:func:`~deco_tpu_torch.data.imagenet.resize_short_side`),
then center-cropped. Images are read by
:func:`~deco_tpu_torch.data.imagenet.read_image` (PNG, JPEG, WebP, GIF and
BMP, equal to PIL's ``convert("RGB")``); a file that does not decode raises, as PIL's
``open`` does in the JAX reader.
"""

from __future__ import annotations

import os

import numpy as np

from deco_tpu_torch.data.imagenet import center_crop, read_image, resize_short_side

IMG_EXTS = (".png", ".jpg", ".jpeg", ".JPEG")


class ImageText:
    """Items ``(x, text, {"image_path", "prompt", "raw_image"})``: x the
    (resolution, resolution, 3) float32 crop in [-1, 1], raw_image in [0, 1]."""

    def __init__(self, root: str, resolution: int):
        self.image_paths, self.texts = [], []
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                if f.endswith(IMG_EXTS):
                    image_path = os.path.join(dirpath, f)
                    text_path = os.path.splitext(image_path)[0] + ".txt"
                    if os.path.exists(text_path):
                        with open(text_path) as fh:
                            self.texts.append(fh.read())
                        self.image_paths.append(image_path)
        self.resolution = resolution

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int):
        path, text = self.image_paths[idx], self.texts[idx]
        arr = center_crop(resize_short_side(read_image(path), self.resolution), self.resolution)
        raw = arr.astype(np.float32) / 255.0
        return raw * 2.0 - 1.0, text, {"image_path": path, "prompt": text, "raw_image": raw}
