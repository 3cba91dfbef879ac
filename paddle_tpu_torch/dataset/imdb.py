# Copied from paddle_tpu/dataset/imdb.py (reader creators over the port's vision.datasets and text.datasets), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.dataset.imdb (ref: python/paddle/dataset/imdb.py).

word_dict() -> {word: id}; train(word_idx)/test(word_idx) yield
([token ids], 0/1 label)."""
from __future__ import annotations

import numpy as np


def word_dict(data_file=None, cutoff=150):
    from ..text.datasets import Imdb
    return Imdb(data_file=data_file, mode="train", cutoff=cutoff).word_idx


def _reader_creator(mode, word_idx, data_file=None):
    def reader():
        from ..text.datasets import Imdb
        ds = Imdb(data_file=data_file, mode=mode)
        for doc, label in (ds[i] for i in range(len(ds))):
            yield [int(t) for t in doc], int(label)
    return reader


def train(word_idx=None, data_file=None):
    return _reader_creator("train", word_idx, data_file)


def test(word_idx=None, data_file=None):
    return _reader_creator("test", word_idx, data_file)
