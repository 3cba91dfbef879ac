"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``; only
``Linear``, ``Embedding`` and ``Dropout``)."""
from __future__ import annotations

from .. import functional as F
from ..initializer import XavierUniform
from .layers import Layer


class Linear(Layer):
    """y = xW + b, W: [in, out]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, input):
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierUniform())

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):
        return F.dropout(input, self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"
