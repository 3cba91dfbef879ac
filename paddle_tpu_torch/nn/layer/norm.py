"""Norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``; only
``BatchNorm``, ``BatchNorm1D/2D/3D``, ``LayerNorm`` and ``RMSNorm``).

The batch norms keep the reference's persistable buffers ``_mean``
(zeros) and ``_variance`` (ones), fp32, and Paddle's momentum (0.9 keeps
90% of the running statistics).  ``SyncBatchNorm`` raises: cross-device
batch statistics wait for data parallelism (ROADMAP Queue 1 item 13)."""
from __future__ import annotations

import numpy as np

from .. import functional as F
from ..initializer import Constant
from .layers import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True)
        self.register_buffer("_mean", np.zeros(num_features, np.float32))
        self.register_buffer("_variance", np.ones(num_features, np.float32))

    def forward(self, input):
        return F.batch_norm(input, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm (ref: ``fluid/dygraph/nn.py::BatchNorm``):
    any rank, channel at axis 1, an optional activation after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, input):
        out = super().forward(input)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm is not ported: cross-device batch statistics "
            "come with data parallelism (ROADMAP Queue 1 item 13)")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError(
            "SyncBatchNorm is not ported (ROADMAP Queue 1 item 13)")


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
