# Copied from paddle_tpu/vision/datasets/flowers.py (numpy-only synthetic surrogate), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""Flowers dataset surrogate (ref: python/paddle/vision/datasets/flowers.py)."""
from __future__ import annotations

import numpy as np

from ...io.dataset import Dataset


class Flowers(Dataset):
    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend="numpy"):
        self.transform = transform
        n = 512 if mode == "train" else 64
        rng = np.random.RandomState(11)
        self.labels = rng.randint(0, 102, n).astype(np.int64)
        self.images = rng.randint(0, 255, (n, 64, 64, 3)).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.images)
