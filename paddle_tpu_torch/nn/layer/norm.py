"""Norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``).

The batch norms keep the reference's persistable buffers ``_mean``
(zeros) and ``_variance`` (ones), fp32, and Paddle's momentum (0.9 keeps
90% of the running statistics).  ``SyncBatchNorm`` raises: cross-device
batch statistics wait for data parallelism (ROADMAP Queue 1 item 13)."""
from __future__ import annotations

import numpy as np
import torch

from ...ops.dispatch import call
from .. import functional as F
from ..initializer import Constant, Normal
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


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = (None if weight_attr is False else
                       self.create_parameter(shape=[num_channels],
                                             attr=weight_attr,
                                             default_initializer=Constant(1.0)))
        self.bias = (None if bias_attr is False else
                     self.create_parameter(shape=[num_channels],
                                           attr=bias_attr, is_bias=True))

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self._num_features = num_features
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter(
                shape=[num_features], attr=bias_attr, is_bias=True)

    def forward(self, input):
        return F.instance_norm(input, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, input):
        return F.local_response_norm(input, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


def _matrix(w, dim):
    return w.movedim(dim, 0).reshape(w.shape[dim], -1)


def _unit(t, eps):
    return t / (torch.linalg.vector_norm(t) + eps)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the largest singular value of the weight
    as a [shape[dim], -1] matrix by power iteration.  Each eager call
    first moves the stored ``weight_u`` / ``weight_v`` by ``power_iters``
    iterations off the tape (not while ``jit.to_static`` captures); the op itself restarts from them (from a
    unit vector if ``weight_u`` is ~0) and takes two more, so a replay
    follows the weight it is given."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            shape=[h], default_initializer=Normal(0, 1))
        self.weight_v = self.create_parameter(
            shape=[w], default_initializer=Normal(0, 1))
        for p in (self.weight_u, self.weight_v):
            p.stop_gradient = True
            p._mark()

    def forward(self, weight):
        dim, eps = self._dim, self._eps
        from ...framework import core
        if not core.in_tracing():
            with torch.no_grad():
                wm = _matrix(weight.value, dim)
                u, v = self.weight_u.value, self.weight_v.value
                for _ in range(max(self._power_iters, 1)):
                    v = _unit(wm.T @ u, eps)
                    u = _unit(wm @ v, eps)
                self.weight_u.value.copy_(u)
                self.weight_v.value.copy_(v)

        def _sn(w, u, v):
            wm = _matrix(w, dim)
            u = torch.where(torch.linalg.vector_norm(u) < 1e-6,
                            torch.ones_like(u) / (1.0 * u.shape[0]) ** 0.5,
                            u)
            for _ in range(2):
                v = _unit(wm.T @ u, eps)
                u = _unit(wm @ v, eps)
            sigma = u @ wm @ v
            return w / torch.clamp(sigma, min=eps)
        return call(_sn, weight, self.weight_u, self.weight_v,
                    _name="spectral_norm")
