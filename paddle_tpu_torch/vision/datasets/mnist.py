# Copied from paddle_tpu/vision/datasets/mnist.py (numpy-only idx parser and synthetic surrogate), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""MNIST / FashionMNIST (ref: python/paddle/vision/datasets/mnist.py).

Parses the real idx files (big-endian magic 2051/2049, optionally
gzipped — the reference's on-disk format) when image_path/label_path
exist.  Zero-egress environment: absent files fall back to a
deterministic, learnable synthetic surrogate — digit-dependent structured
images — with the exact reference schema (28x28 uint8 -> transform, int
label), so LeNet smoke training behaves like the real thing.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io.dataset import Dataset


def _open_maybe_gz(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def parse_idx_images(path):
    """idx3-ubyte: >iiii magic=2051, n, rows, cols; then u8 pixels."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">iiii", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad image magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols)


def parse_idx_labels(path):
    """idx1-ubyte: >ii magic=2049, n; then u8 labels."""
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">ii", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad label magic {magic}")
        data = np.frombuffer(f.read(n), np.uint8)
    return data.astype(np.int64)


def _synth_mnist(n, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.int64)
    images = np.zeros((n, 28, 28), np.uint8)
    yy, xx = np.mgrid[0:28, 0:28]
    for i, lab in enumerate(labels):
        # class-dependent oriented bar + frequency pattern, plus noise
        ang = lab * np.pi / 10
        line = np.abs((yy - 14) * np.cos(ang) - (xx - 14) * np.sin(ang)) < 2.5
        wave = (np.sin(xx * (lab + 1) / 4.0) > 0.3)
        img = (line * 200 + wave * 55).astype(np.uint8)
        noise = rng.randint(0, 30, (28, 28)).astype(np.uint8)
        images[i] = np.clip(img + noise, 0, 255)
    return images, labels


class MNIST(Dataset):
    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="numpy"):
        self.mode = mode
        self.transform = transform
        self.backend = backend
        if (image_path is not None and os.path.exists(image_path)
                and label_path is not None and os.path.exists(label_path)):
            self.images = parse_idx_images(image_path)
            self.labels = parse_idx_labels(label_path)
            if len(self.images) != len(self.labels):
                raise ValueError("image/label count mismatch: "
                                 f"{len(self.images)} vs {len(self.labels)}")
            return
        n = 4096 if mode == "train" else 512
        # zlib.crc32 is stable across interpreter runs (str hash is not)
        import zlib
        seed = ((42 if mode == "train" else 43)
                + zlib.crc32(self.NAME.encode()) % 1000)
        self.images, self.labels = _synth_mnist(n, seed)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)[None] / 255.0
        return img, np.asarray([label], np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"
