# Copied from paddle_tpu/vision/datasets/cifar.py (numpy-only archive parser and synthetic surrogate), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""Cifar10/100 (ref: python/paddle/vision/datasets/cifar.py).

Parses the real tar.gz batch archives (pickled dicts of Nx3072 uint8 rows,
the reference's on-disk format) when ``data_file`` exists; in this
zero-egress environment, absent files fall back to a deterministic
learnable synthetic surrogate with the exact reference schema."""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ...io.dataset import Dataset


def _parse_cifar_archive(path, mode):
    """tar.gz of pickled batches -> (images [N,32,32,3] u8, labels [N]).
    Cifar100 archives carry fine_labels; plain 'labels' otherwise."""
    images, labels = [], []
    with tarfile.open(path, "r:*") as tf:
        for member in sorted(tf.getnames()):
            base = os.path.basename(member)
            is_train = base.startswith("data_batch") or base == "train"
            is_test = base.startswith("test_batch") or base == "test"
            if not ((mode == "train" and is_train)
                    or (mode != "train" and is_test)):
                continue
            with tf.extractfile(member) as f:
                d = pickle.load(f, encoding="bytes")
            data = np.asarray(d[b"data"], np.uint8)
            images.append(data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            key = b"fine_labels" if b"fine_labels" in d else b"labels"
            labels.append(np.asarray(d[key], np.int64))
    if not images:
        raise ValueError(f"no {mode} batches found in {path}")
    return np.concatenate(images), np.concatenate(labels)


class Cifar10(Dataset):
    n_classes = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="numpy"):
        self.mode = mode
        self.transform = transform
        if data_file is not None and os.path.exists(data_file):
            self.images, self.labels = _parse_cifar_archive(
                data_file, mode)
            return
        n = 2048 if mode == "train" else 256
        rng = np.random.RandomState(7 if mode == "train" else 8)
        self.labels = rng.randint(0, self.n_classes, n).astype(np.int64)
        yy, xx = np.mgrid[0:32, 0:32]
        imgs = np.zeros((n, 32, 32, 3), np.uint8)
        for i, lab in enumerate(self.labels):
            base = np.stack([
                (np.sin(xx * (lab % 5 + 1) / 3.0) * 80 + 100),
                (np.cos(yy * (lab % 3 + 1) / 3.0) * 80 + 100),
                ((xx + yy) * (lab % 7 + 1) % 255),
            ], axis=-1)
            noise = rng.randint(0, 40, (32, 32, 3))
            imgs[i] = np.clip(base + noise, 0, 255).astype(np.uint8)
        self.images = imgs

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    n_classes = 100
