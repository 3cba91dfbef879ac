"""MobileNetV1 (counterpart of ``paddle_tpu/vision/models/mobilenetv1.py``;
ref: python/paddle/vision/models/mobilenetv1.py): Howard et al. 2017's
depthwise-separable stack at width ``scale``, with the reference's layer
names, so ``state_dict`` keys match key for key."""
from __future__ import annotations

from ... import nn


class ConvBNLayer(nn.Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, num_groups=1):
        super().__init__()
        self._conv = nn.Conv2D(in_channels, out_channels, kernel_size,
                               stride=stride, padding=padding,
                               groups=num_groups, bias_attr=False)
        self._norm_layer = nn.BatchNorm2D(out_channels)
        self._act = nn.ReLU()

    def forward(self, x):
        return self._act(self._norm_layer(self._conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale):
        super().__init__()
        self._depthwise_conv = ConvBNLayer(
            in_channels, int(out_channels1 * scale), 3, stride, 1,
            int(num_groups * scale))
        self._pointwise_conv = ConvBNLayer(
            int(out_channels1 * scale), int(out_channels2 * scale), 1, 1, 0)

    def forward(self, x):
        return self._pointwise_conv(self._depthwise_conv(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, 2, 1)
        cfg = [(32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
               (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
               (256, 256, 256, 256, 1), (256, 256, 512, 256, 2)]
        cfg += [(512, 512, 512, 512, 1)] * 5
        cfg += [(512, 512, 1024, 512, 2), (1024, 1024, 1024, 1024, 1)]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(int(in_c * scale), c1, c2, g, s, scale)
            for in_c, c1, c2, g, s in cfg])
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            from ...tensor.manipulation import flatten
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)
