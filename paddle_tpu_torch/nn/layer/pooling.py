"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``): the
twelve max, average and adaptive pools in 1, 2 and 3 dims."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class _Pool(Layer):
    def __init__(self, kernel_size=None, stride=None, padding=0):
        super().__init__()
        self.ksize = kernel_size
        self.stride = stride
        self.padding = padding


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding)
        self.return_mask = return_mask
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.max_pool1d(x, self.ksize, self.stride, self.padding,
                            self.return_mask, self.ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding)
        self.return_mask = return_mask
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.ksize, self.stride, self.padding,
                            self.return_mask, self.ceil_mode, self.data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding)
        self.return_mask = return_mask
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool3d(x, self.ksize, self.stride, self.padding,
                            self.return_mask, self.ceil_mode, self.data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding)
        self.exclusive = exclusive
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.avg_pool1d(x, self.ksize, self.stride, self.padding,
                            self.exclusive, self.ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding)
        self.exclusive = exclusive
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.exclusive, None,
                            self.data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding)
        self.exclusive = exclusive
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool3d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.exclusive, None,
                            self.data_format)


def _adaptive(fname, cls_name, with_mask):
    fn = getattr(F, fname)

    class _Adaptive(Layer):
        def __init__(self, output_size, *args, return_mask=False,
                     data_format=None, name=None):
            super().__init__()
            self._output_size = output_size
            # the max pools' second positional argument is return_mask,
            # the average pools' data_format (ignored, as the reference)
            self._return_mask = bool(args[0]) if with_mask and args \
                else return_mask

        def forward(self, x):
            if with_mask:
                return fn(x, self._output_size, self._return_mask)
            return fn(x, self._output_size)

    _Adaptive.__name__ = _Adaptive.__qualname__ = cls_name
    return _Adaptive


AdaptiveAvgPool1D = _adaptive("adaptive_avg_pool1d", "AdaptiveAvgPool1D",
                              False)
AdaptiveAvgPool2D = _adaptive("adaptive_avg_pool2d", "AdaptiveAvgPool2D",
                              False)
AdaptiveAvgPool3D = _adaptive("adaptive_avg_pool3d", "AdaptiveAvgPool3D",
                              False)
AdaptiveMaxPool1D = _adaptive("adaptive_max_pool1d", "AdaptiveMaxPool1D",
                              True)
AdaptiveMaxPool2D = _adaptive("adaptive_max_pool2d", "AdaptiveMaxPool2D",
                              True)
AdaptiveMaxPool3D = _adaptive("adaptive_max_pool3d", "AdaptiveMaxPool3D",
                              True)
