# Copied from paddle_tpu/dataset/cifar.py (reader creators over the port's vision.datasets and text.datasets), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.dataset.cifar (ref: python/paddle/dataset/cifar.py).

train10/test10/train100/test100 yield (float32[3072] scaled to [0,1],
int label)."""
from __future__ import annotations

import numpy as np


def _reader_creator(cls_name, mode, data_file=None):
    def reader():
        from ..vision import datasets as vd
        ds = getattr(vd, cls_name)(data_file=data_file, mode=mode)
        for i in range(len(ds)):
            img = ds.images[i].astype(np.float32) / 255.0
            # reference layout: flat [C*H*W]
            yield img.transpose(2, 0, 1).reshape(-1), int(ds.labels[i])
    return reader


def train10(data_file=None):
    return _reader_creator("Cifar10", "train", data_file)


def test10(data_file=None):
    return _reader_creator("Cifar10", "test", data_file)


def train100(data_file=None):
    return _reader_creator("Cifar100", "train", data_file)


def test100(data_file=None):
    return _reader_creator("Cifar100", "test", data_file)
