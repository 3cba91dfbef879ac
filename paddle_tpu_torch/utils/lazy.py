# Copied from paddle_tpu/utils/lazy.py (try_import and flops over the port's Linear and _ConvNd, whose attribute names match), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""Misc utilities (ref: python/paddle/utils/)."""
from __future__ import annotations

import importlib


def try_import(name, err_msg=None):
    try:
        return importlib.import_module(name)
    except ImportError:
        raise ImportError(err_msg or f"{name} is required") from None


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Rough analytic FLOPs for Linear/Conv layers (ref: paddle.flops /
    hapi/dynamic_flops.py)."""
    import numpy as np
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import _ConvNd
    total = 0
    spatial = int(np.prod(input_size[2:])) if len(input_size) > 2 else 1
    for layer in net.sublayers(include_self=True):
        if isinstance(layer, Linear):
            total += 2 * layer._in_features * layer._out_features
        elif isinstance(layer, _ConvNd):
            k = int(np.prod(layer._kernel_size))
            total += (2 * k * layer._in_channels * layer._out_channels
                      // layer._groups) * spatial
    if print_detail:
        print(f"Total FLOPs: {total}")
    return total
