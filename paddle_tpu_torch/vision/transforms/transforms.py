# Copied from paddle_tpu/vision/transforms/transforms.py (the transform classes, drawing from Python's random module in the same order), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""Transform classes (ref: python/paddle/vision/transforms/transforms.py)."""
from __future__ import annotations

import numbers
import random

import numpy as np

from . import functional as F


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        from ...tensor.tensor import Tensor
        if isinstance(img, Tensor):
            img = img.numpy()
        return F.normalize(img, self.mean, self.std, self.data_format)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(self.order)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(size, int):
            size = (size, size)
        self.size = size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        if self.padding is not None:
            img = F.pad(img, self.padding, self.fill, self.padding_mode)
        h, w = img.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            # F.pad takes (left, top, right, bottom): width deficit goes
            # on left/right, height deficit on top/bottom
            img = F.pad(img, (max(tw - w, 0), max(th - h, 0),
                              max(tw - w, 0), max(th - h, 0)),
                        self.fill, self.padding_mode)
            h, w = img.shape[:2]
        i = random.randint(0, h - th) if h > th else 0
        j = random.randint(0, w - tw) if w > tw else 0
        return F.crop(img, i, j, th, tw)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return F.hflip(img)
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return F.vflip(img)
        return img


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        if isinstance(size, int):
            size = (size, size)
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = random.randint(0, h - ch)
                j = random.randint(0, w - cw)
                img2 = F.crop(img, i, j, ch, cw)
                return F.resize(img2, self.size, self.interpolation)
        return F.resize(F.center_crop(img, min(h, w)), self.size,
                        self.interpolation)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_brightness(img, factor)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(-self.value, self.value)
        return F.adjust_hue(img, factor)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = list(self.transforms)
        random.shuffle(order)
        for t in order:
            img = t(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, fill=self.fill)
