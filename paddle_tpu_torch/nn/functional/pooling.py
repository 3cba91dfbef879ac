"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The reference pools with ``lax.reduce_window``; the port with PyTorch's
pooling on explicitly padded input, so that the reference's window
geometry holds at every setting:

* padding as in ``conv`` (ints, pairs, ``2 * n`` lists, "SAME" /
  "VALID"), the max pad value -inf;
* ``ceil_mode`` extends the high-side padding until the last partial
  window counts (``_window_geometry``);
* average pooling divides by the count of input elements in the window
  with ``exclusive=True`` (the default; padding never counts), else by
  the full window size, also on a ``ceil_mode`` edge, or by
  ``divisor_override``;
* ``return_mask`` gives each window's first maximum as an index into
  the input's flattened spatial dims (-1 for a window of padding only);
* adaptive average pooling takes the reference's bins, [floor(i in /
  out), ceil((i + 1) in / out)), one spatial axis at a time (a mean over
  the axis where out divides in), in fp32; adaptive pools take NC...
  input whatever ``data_format`` says, as the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...ops.dispatch import call
from .conv import _flat_pads, _padding, _same_pads, _tup


def _window_pads(nd, spatial, k, s, pad, ceil_mode):
    """(low, high) padding per spatial dim with the reference's "SAME" and
    ``ceil_mode`` rules."""
    if pad == "VALID":
        pads = [(0, 0)] * nd
    elif pad == "SAME":
        pads = _same_pads(spatial, k, s)
    else:
        pads = [tuple(p) for p in pad]
    if ceil_mode:
        for i in range(nd):
            eff = spatial[i] + pads[i][0] + pads[i][1]
            rem = (eff - k[i]) % s[i]
            if rem:
                pads[i] = (pads[i][0], pads[i][1] + s[i] - rem)
    return pads


def _nc_first(a, channel_last):
    return a.movedim(-1, 1) if channel_last else a


def _sum_pool(nd, a, k, s):
    """Window sums of an already padded [N, C, *spatial] tensor."""
    if nd == 1:
        return TF.avg_pool2d(a[:, :, None], (1,) + k, (1,) + s,
                             divisor_override=1)[:, :, 0]
    fn = TF.avg_pool2d if nd == 2 else TF.avg_pool3d
    return fn(a, k, s, divisor_override=1)


_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}


def _pool_nd(nd, x, kernel, stride, padding, mode, ceil_mode, exclusive,
             data_format, opname, divisor_override=None):
    channel_last = not data_format.startswith("NC")
    k = _tup(kernel, nd)
    s = _tup(stride if stride is not None else kernel, nd)
    pad = _padding(padding, nd)

    def _pool(a):
        a = _nc_first(a, channel_last)
        pads = _flat_pads(_window_pads(nd, a.shape[2:], k, s, pad,
                                       ceil_mode))
        if mode == "max":
            fill = (-math.inf if a.is_floating_point()
                    else torch.iinfo(a.dtype).min)
            out = _MAX[nd](TF.pad(a, pads, value=fill), k, s)
        else:
            summed = _sum_pool(nd, TF.pad(a, pads), k, s)
            if divisor_override:
                out = summed / float(divisor_override)
            elif exclusive:
                ones = TF.pad(torch.ones((1, 1) + tuple(a.shape[2:]),
                                         dtype=a.dtype, device=a.device),
                              pads)
                out = summed / _sum_pool(nd, ones, k, s)
            else:
                out = summed / float(np.prod(k))
        return out.movedim(1, -1) if channel_last else out
    return call(_pool, x, _name=opname)


def _pool_mask(nd, x, kernel, stride, padding, ceil_mode, data_format):
    """Each window's argmax as a flattened spatial index of the input (the
    first maximum in the window's row-major order), int32."""
    channel_last = not data_format.startswith("NC")
    k = _tup(kernel, nd)
    s = _tup(stride if stride is not None else kernel, nd)
    pad = _padding(padding, nd)

    def _mask(a):
        a = _nc_first(a, channel_last)
        spatial = tuple(a.shape[2:])
        pads = _flat_pads(_window_pads(nd, spatial, k, s, pad, ceil_mode))
        v = TF.pad(a, pads, value=-math.inf)
        idx = TF.pad(torch.arange(int(np.prod(spatial)),
                                  device=a.device).reshape(spatial),
                     pads, value=-1)
        for i in range(nd):
            v = v.unfold(2 + i, k[i], s[i])
            idx = idx.unfold(i, k[i], s[i])
        out_sp = v.shape[2:2 + nd]
        v = v.reshape(*v.shape[:2 + nd], -1)
        idx = idx.reshape(*out_sp, -1).expand(v.shape)
        am = v.argmax(-1, keepdim=True)
        out = idx.gather(-1, am)[..., 0].to(torch.int32)
        return out.movedim(1, -1) if channel_last else out
    return call(_mask, x, _name="max_pool_mask")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    out = _pool_nd(1, x, kernel_size, stride, padding, "max", ceil_mode, True,
                   "NCW", "max_pool1d")
    if return_mask:
        return out, _pool_mask(1, x, kernel_size, stride, padding, ceil_mode,
                               "NCW")
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool_nd(2, x, kernel_size, stride, padding, "max", ceil_mode, True,
                   data_format, "max_pool2d")
    if return_mask:
        return out, _pool_mask(2, x, kernel_size, stride, padding, ceil_mode,
                               data_format)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool_nd(3, x, kernel_size, stride, padding, "max", ceil_mode, True,
                   data_format, "max_pool3d")
    if return_mask:
        return out, _pool_mask(3, x, kernel_size, stride, padding, ceil_mode,
                               data_format)
    return out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool_nd(1, x, kernel_size, stride, padding, "avg", ceil_mode,
                    exclusive, "NCW", "avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_nd(2, x, kernel_size, stride, padding, "avg", ceil_mode,
                    exclusive, data_format, "avg_pool2d",
                    divisor_override=divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd(3, x, kernel_size, stride, padding, "avg", ceil_mode,
                    exclusive, data_format, "avg_pool3d",
                    divisor_override=divisor_override)


def _bins(n_in, n_out):
    """The reference's adaptive bins: [floor(i in / out), ceil((i + 1) in /
    out)) for i < out."""
    i = np.arange(n_out, dtype=np.int64)
    return (i * n_in) // n_out, -((-(i + 1) * n_in) // n_out)


def _adaptive_axis(a, ax, n_out, mode):
    n_in = a.shape[ax]
    if mode == "avg":
        if n_in == n_out:
            return a
        af = a.float()
        if n_in % n_out == 0:
            shape = a.shape[:ax] + (n_out, n_in // n_out) + a.shape[ax + 1:]
            return af.reshape(shape).mean(ax + 1).to(a.dtype)
        st, en = _bins(n_in, n_out)
        member = ((np.arange(n_in)[None, :] >= st[:, None])
                  & (np.arange(n_in)[None, :] < en[:, None]))
        w = torch.from_numpy(member / member.sum(1, keepdims=True)).to(
            device=a.device, dtype=torch.float32)
        out = torch.tensordot(af.movedim(ax, -1), w.T, dims=1)
        return out.movedim(-1, ax).to(a.dtype)
    if n_in % n_out == 0:
        shape = a.shape[:ax] + (n_out, n_in // n_out) + a.shape[ax + 1:]
        return a.reshape(shape).amax(ax + 1)
    st, en = _bins(n_in, n_out)
    return torch.cat([a.narrow(ax, int(b), int(e - b)).amax(ax, keepdim=True)
                      for b, e in zip(st, en)], ax)


def _adaptive_pool_nd(nd, x, output_size, mode, opname):
    out_sz = _tup(output_size, nd)

    def _ap(a):
        out = a
        for i in range(nd):
            ax = 2 + i
            osz = out_sz[i] if out_sz[i] is not None else out.shape[ax]
            out = _adaptive_axis(out, ax, int(osz), mode)
        return out
    return call(_ap, x, _name=opname)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool_nd(1, x, output_size, "avg", "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool_nd(2, x, output_size, "avg", "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool_nd(3, x, output_size, "avg", "adaptive_avg_pool3d")


def _adaptive_max_mask(nd, x, output_size):
    """Each adaptive bin's argmax (first maximum) as a flattened spatial
    index, int32."""
    out_sz = _tup(output_size, nd)

    def _m(a):
        spatial = tuple(a.shape[2:])
        osz = [int(out_sz[i]) if out_sz[i] is not None else spatial[i]
               for i in range(nd)]
        flat = torch.arange(int(np.prod(spatial)), device=a.device).reshape(
            spatial)
        bins = [_bins(spatial[i], osz[i]) for i in range(nd)]
        idxs = []
        for pos in np.ndindex(*osz):
            sl = tuple(slice(int(bins[i][0][p]), int(bins[i][1][p]))
                       for i, p in enumerate(pos))
            win = a[(slice(None), slice(None)) + sl].reshape(
                a.shape[:2] + (-1,))
            am = win.argmax(-1)
            idxs.append(flat[sl].reshape(-1)[am])
        return (torch.stack(idxs, -1).reshape(a.shape[:2] + tuple(osz))
                .to(torch.int32))
    return call(_m, x, _name="adaptive_max_mask")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool_nd(1, x, output_size, "max", "adaptive_max_pool1d")
    if return_mask:
        return out, _adaptive_max_mask(1, x, output_size)
    return out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool_nd(2, x, output_size, "max", "adaptive_max_pool2d")
    if return_mask:
        return out, _adaptive_max_mask(2, x, output_size)
    return out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool_nd(3, x, output_size, "max", "adaptive_max_pool3d")
    if return_mask:
        return out, _adaptive_max_mask(3, x, output_size)
    return out
