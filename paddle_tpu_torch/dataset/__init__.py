# Copied from paddle_tpu/dataset/__init__.py (reader creators over the port's vision.datasets and text.datasets), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.dataset — legacy reader-creator data modules.

Re-design of the reference's module-level dataset readers
(ref: python/paddle/dataset/{mnist,cifar,uci_housing,imdb}.py): each
sub-module exposes ``train()``/``test()`` returning zero-arg reader
creators that yield one sample at a time — the shape the
``paddle.reader`` decorators and ``paddle.batch`` compose over.  Backed
by the modern dataset classes (real-file parsing when paths are given,
deterministic synthetic data otherwise in this zero-egress environment).
"""
from . import mnist
from . import cifar
from . import uci_housing
from . import imdb

__all__ = ["mnist", "cifar", "uci_housing", "imdb"]
