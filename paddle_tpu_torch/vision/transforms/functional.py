# Copied from paddle_tpu/vision/transforms/functional.py (host-side numpy image functionals; to_tensor builds the port's Tensor), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""Image transform functionals on numpy HWC arrays
(ref: python/paddle/vision/transforms/functional_cv2.py — cv2-free here)."""
from __future__ import annotations

import numbers

import numpy as np


def _is_numpy(img):
    return isinstance(img, np.ndarray)


def resize(img, size, interpolation="bilinear"):
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    if (nh, nw) == (h, w):
        return img
    # bilinear resize in numpy
    ys = np.linspace(0, h - 1, nh)
    xs = np.linspace(0, w - 1, nw)
    if interpolation == "nearest":
        yi = np.round(ys).astype(int)
        xi = np.round(xs).astype(int)
        return img[yi[:, None], xi[None, :]]
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None] if img.ndim == 3 else (ys - y0)[:, None]
    wx = (xs - x0)[None, :, None] if img.ndim == 3 else (xs - x0)[None, :]
    im = img.astype(np.float32)
    top = im[y0[:, None], x0[None, :]] * (1 - wx) + im[y0[:, None], x1[None, :]] * wx
    bot = im[y1[:, None], x0[None, :]] * (1 - wx) + im[y1[:, None], x1[None, :]] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(img.dtype) if img.dtype != np.uint8 else \
        np.clip(out, 0, 255).astype(np.uint8)


def crop(img, top, left, height, width):
    return img[top:top + height, left:left + width]


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = img.shape[:2]
    th, tw = output_size
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return crop(img, i, j, th, tw)


def hflip(img):
    return img[:, ::-1]


def vflip(img):
    return img[::-1]


def pad(img, padding, fill=0, padding_mode="constant"):
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    l, t, r, b = padding
    widths = [(t, b), (l, r)] + [(0, 0)] * (img.ndim - 2)
    if padding_mode == "constant":
        return np.pad(img, widths, mode="constant", constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    return np.pad(img, widths, mode=mode)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    img = np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        return (img - mean[:, None, None]) / std[:, None, None]
    return (img - mean) / std


def to_tensor(pic, data_format="CHW"):
    arr = np.asarray(pic)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    from ...tensor.tensor import Tensor
    return Tensor(np.ascontiguousarray(arr))


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    # nearest-neighbor rotation
    h, w = img.shape[:2]
    cy, cx = (h / 2, w / 2) if center is None else (center[1], center[0])
    rad = -np.deg2rad(angle)
    yy, xx = np.mgrid[0:h, 0:w]
    ys = (yy - cy) * np.cos(rad) - (xx - cx) * np.sin(rad) + cy
    xs = (yy - cy) * np.sin(rad) + (xx - cx) * np.cos(rad) + cx
    yi = np.clip(np.round(ys).astype(int), 0, h - 1)
    xi = np.clip(np.round(xs).astype(int), 0, w - 1)
    out = img[yi, xi]
    mask = (ys < 0) | (ys >= h) | (xs < 0) | (xs >= w)
    out[mask] = fill
    return out


def adjust_brightness(img, factor):
    out = img.astype(np.float32) * factor
    return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 \
        else out


def adjust_contrast(img, factor):
    mean = img.astype(np.float32).mean()
    out = (img.astype(np.float32) - mean) * factor + mean
    return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 \
        else out


def adjust_saturation(img, factor):
    gray = img.astype(np.float32).mean(axis=-1, keepdims=True)
    out = (img.astype(np.float32) - gray) * factor + gray
    return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 \
        else out


def adjust_hue(img, factor):
    # cheap hue shift via channel roll interpolation
    out = img.astype(np.float32)
    shifted = np.roll(out, 1, axis=-1)
    out = out * (1 - abs(factor)) + shifted * abs(factor)
    return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 \
        else out


def to_grayscale(img, num_output_channels=1):
    gray = (img.astype(np.float32) @ np.array([0.299, 0.587, 0.114]))
    gray = gray.astype(img.dtype)
    if num_output_channels == 3:
        return np.stack([gray] * 3, axis=-1)
    return gray[..., None]
