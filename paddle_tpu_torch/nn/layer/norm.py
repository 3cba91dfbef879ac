"""Norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``; only
``LayerNorm`` and ``RMSNorm``)."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = (None if weight_attr is False else
                       self.create_parameter(shape=self._normalized_shape,
                                             attr=weight_attr,
                                             default_initializer=Constant(1.0)))
        self.bias = (None if bias_attr is False else
                     self.create_parameter(shape=self._normalized_shape,
                                           attr=bias_attr, is_bias=True))

    def forward(self, input):
        return F.layer_norm(input, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=[hidden_size], attr=weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
