"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``):
``Conv1D/2D/3D`` and their transposes, with the reference's weight layout
(``[out, in / groups, *k]``; transposes ``[in, out / groups, *k]``) and
initialisers (KaimingUniform weights with fan-in ``in / groups * prod(k)``,
a Uniform(+-1/sqrt(fan-in)) bias).  Padding modes other than zeros pad
the input explicitly first, as the reference does."""
from __future__ import annotations

import numpy as np
import torch.nn.functional as TF

from ...ops.dispatch import call
from .. import functional as F
from ..initializer import KaimingUniform, Uniform
from .layers import Layer


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, nd, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transposed=False, output_padding=0):
        super().__init__()
        self._nd = nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tup(kernel_size, nd)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        self._output_padding = output_padding
        if transposed:
            wshape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            wshape = [out_channels, in_channels // groups, *self._kernel_size]
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            shape=wshape, attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, stride={self._stride}")

    def _prepad(self, x):
        """reflect / replicate / circular padding, applied to the input
        before an unpadded convolution."""
        if self._padding_mode == "zeros":
            return x, self._padding
        pad = self._padding
        pad = [int(p) for p in ([pad] * self._nd if isinstance(pad, int)
                                else pad)]
        flat = []
        for p in pad[::-1]:
            flat += [p, p]
        last = not self._data_format.startswith("NC")
        mode = self._padding_mode

        def _pad(a):
            a = a.movedim(-1, 1) if last else a
            a = TF.pad(a, flat, mode=mode)
            return a.movedim(1, -1) if last else a
        return call(_pad, x, _name="pad"), 0


def _conv_layer(nd, fn_name, fmt, cls_name):
    fn = getattr(F, fn_name)

    class _Conv(_ConvNd):
        def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                     padding=0, dilation=1, groups=1, padding_mode="zeros",
                     weight_attr=None, bias_attr=None, data_format=fmt):
            super().__init__(nd, in_channels, out_channels, kernel_size,
                             stride, padding, dilation, groups, padding_mode,
                             weight_attr, bias_attr, data_format)

        def forward(self, x):
            x, padding = self._prepad(x)
            return fn(x, self.weight, self.bias, self._stride, padding,
                      self._dilation, self._groups, self._data_format)

    _Conv.__name__ = _Conv.__qualname__ = cls_name
    return _Conv


def _conv_transpose_layer(nd, fn_name, fmt, cls_name):
    fn = getattr(F, fn_name)

    class _ConvT(_ConvNd):
        def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                     padding=0, output_padding=0, groups=1, dilation=1,
                     weight_attr=None, bias_attr=None, data_format=fmt):
            super().__init__(nd, in_channels, out_channels, kernel_size,
                             stride, padding, dilation, groups, "zeros",
                             weight_attr, bias_attr, data_format,
                             transposed=True, output_padding=output_padding)

        def forward(self, x, output_size=None):
            return fn(x, self.weight, self.bias, self._stride, self._padding,
                      self._output_padding, self._groups, self._dilation,
                      output_size, self._data_format)

    _ConvT.__name__ = _ConvT.__qualname__ = cls_name
    return _ConvT


Conv1D = _conv_layer(1, "conv1d", "NCL", "Conv1D")
Conv2D = _conv_layer(2, "conv2d", "NCHW", "Conv2D")
Conv3D = _conv_layer(3, "conv3d", "NCDHW", "Conv3D")
Conv1DTranspose = _conv_transpose_layer(1, "conv1d_transpose", "NCL",
                                        "Conv1DTranspose")
Conv2DTranspose = _conv_transpose_layer(2, "conv2d_transpose", "NCHW",
                                        "Conv2DTranspose")
Conv3DTranspose = _conv_transpose_layer(3, "conv3d_transpose", "NCDHW",
                                        "Conv3DTranspose")
