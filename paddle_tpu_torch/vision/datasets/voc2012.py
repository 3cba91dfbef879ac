# Copied from paddle_tpu/vision/datasets/voc2012.py (numpy-only synthetic surrogate), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""VOC2012 segmentation surrogate (ref: python/paddle/vision/datasets/voc2012.py)."""
from __future__ import annotations

import numpy as np

from ...io.dataset import Dataset


class VOC2012(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="numpy"):
        self.transform = transform
        n = 128 if mode == "train" else 16
        rng = np.random.RandomState(21)
        self.images = rng.randint(0, 255, (n, 96, 96, 3)).astype(np.uint8)
        self.masks = rng.randint(0, 21, (n, 96, 96)).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)
