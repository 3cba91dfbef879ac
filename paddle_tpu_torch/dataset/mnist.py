# Copied from paddle_tpu/dataset/mnist.py (reader creators over the port's vision.datasets and text.datasets), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.dataset.mnist (ref: python/paddle/dataset/mnist.py).

train()/test() yield (image float32[784] scaled to [-1, 1], int label) —
the reference's exact sample schema."""
from __future__ import annotations

import numpy as np


def _reader_creator(mode):
    def reader():
        from ..vision.datasets import MNIST
        ds = MNIST(mode=mode)
        for img, label in ((ds.images[i], ds.labels[i])
                           for i in range(len(ds))):
            flat = img.astype(np.float32).reshape(-1) / 127.5 - 1.0
            yield flat, int(label)
    return reader


def train(image_path=None, label_path=None):
    if image_path is not None:
        def reader():
            from ..vision.datasets.mnist import (parse_idx_images,
                                                 parse_idx_labels)
            images = parse_idx_images(image_path)
            labels = parse_idx_labels(label_path)
            for i in range(len(images)):
                yield (images[i].astype(np.float32).reshape(-1) / 127.5
                       - 1.0, int(labels[i]))
        return reader
    return _reader_creator("train")


def test(image_path=None, label_path=None):
    if image_path is not None:
        return train(image_path, label_path)
    return _reader_creator("test")
