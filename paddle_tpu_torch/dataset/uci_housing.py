# Copied from paddle_tpu/dataset/uci_housing.py (reader creators over the port's vision.datasets and text.datasets), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.dataset.uci_housing (ref: python/paddle/dataset/uci_housing.py).

train()/test() yield (features float32[13], price float32[1])."""
from __future__ import annotations

import numpy as np


def _reader_creator(mode, data_file=None):
    def reader():
        from ..text.datasets import UCIHousing
        ds = UCIHousing(data_file=data_file, mode=mode)
        for x, y in (ds[i] for i in range(len(ds))):
            yield np.asarray(x, np.float32), np.asarray(y, np.float32)
    return reader


def train(data_file=None):
    return _reader_creator("train", data_file)


def test(data_file=None):
    return _reader_creator("test", data_file)
