"""Vision sampling functionals (counterpart of
``paddle_tpu/nn/functional/vision.py``: ``affine_grid`` and
``grid_sample``), op for op: the grid from elementwise multiply-adds in
float32, the sample from gathers with the reference's coordinate rules
(``align_corners``; ``zeros``, ``border`` and ``reflection`` padding;
nearest rounds half to even, as ``jnp.round``).  ``grid_sample`` takes
4-D input, as the reference does.
"""
from __future__ import annotations

import torch

from ...ops.dispatch import call
from .common import _linspace


def _base_coords(n, align_corners, device):
    """The normalised sample centres of an axis of length n, in [-1, 1]."""
    if align_corners:
        if n == 1:
            return torch.zeros((1,), device=device)
        return _linspace(-1.0, 1.0, n, device)
    return (2.0 * torch.arange(n, dtype=torch.float32, device=device)
            + 1.0) / n - 1.0


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta [N, 2, 3] (out_shape [N, C, H, W]) or [N, 3, 4] (5-D).
    Returns the grid [N, H, W, 2] or [N, D, H, W, 3]."""
    if hasattr(out_shape, "numpy"):
        out_shape = out_shape.numpy().tolist()
    out_shape = [int(s) for s in out_shape]

    def _ag(th):
        th = th.float()
        dev = th.device
        if len(out_shape) == 4:
            _, _, H, W = out_shape
            gy, gx = torch.meshgrid(_base_coords(H, align_corners, dev),
                                    _base_coords(W, align_corners, dev),
                                    indexing="ij")
            coords = (gx, gy)
        else:
            _, _, D, H, W = out_shape
            gz, gy, gx = torch.meshgrid(_base_coords(D, align_corners, dev),
                                        _base_coords(H, align_corners, dev),
                                        _base_coords(W, align_corners, dev),
                                        indexing="ij")
            coords = (gx, gy, gz)
        nd = len(coords)
        sp = (1,) * nd
        out = []
        for j in range(nd):
            acc = th[:, j, nd].reshape(-1, *sp)
            for k, c in enumerate(coords):
                acc = acc + th[:, j, k].reshape(-1, *sp) * c[None]
            out.append(acc)
        return torch.stack(out, -1)
    return call(_ag, theta, _name="affine_grid")


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(x, lo, hi):
    rng = hi - lo
    if rng <= 0:
        return torch.zeros_like(x)
    x = torch.remainder((x - lo).abs(), 2.0 * rng)
    return lo + torch.where(x > rng, 2.0 * rng - x, x)


def _resolve_coord(c, size, padding_mode, align_corners):
    if padding_mode == "border":
        return c.clamp(0.0, size - 1.0)
    if padding_mode == "reflection":
        c = (_reflect(c, 0.0, float(size - 1)) if align_corners
             else _reflect(c, -0.5, size - 0.5))
        return c.clamp(0.0, size - 1.0)
    return c


def _gather_2d(img, iy, ix, valid):
    """img [N, C, H, W]; iy, ix, valid [N, Hg, Wg] -> [N, C, Hg, Wg],
    zero where not valid."""
    N, C, H, W = img.shape
    flat = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(N, 1, -1)
    out = torch.gather(img.reshape(N, C, H * W), 2,
                       flat.expand(N, C, flat.shape[-1]))
    out = out.reshape(N, C, *iy.shape[1:])
    return torch.where(valid[:, None], out, 0.0)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x [N, C, H, W]; grid [N, Hg, Wg, 2] of (x, y) in [-1, 1]."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    if len(x.shape) != 4:
        raise NotImplementedError(
            f"grid_sample supports 4-D [N,C,H,W] input, got "
            f"{len(x.shape)}-D; volumetric (5-D) sampling is not implemented")

    def _gs(xv, gv):
        N, C, H, W = xv.shape
        gv = gv.float()
        fx = _resolve_coord(_unnormalize(gv[..., 0], W, align_corners), W,
                            padding_mode, align_corners)
        fy = _resolve_coord(_unnormalize(gv[..., 1], H, align_corners), H,
                            padding_mode, align_corners)

        def inside(iy, ix):
            return (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        if mode == "nearest":
            ix = torch.round(fx).long()
            iy = torch.round(fy).long()
            return _gather_2d(xv, iy, ix, inside(iy, ix)).to(xv.dtype)
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx = (fx - x0).to(xv.dtype)[:, None]
        wy = (fy - y0).to(xv.dtype)[:, None]
        x0i, y0i = x0.long(), y0.long()
        out = 0.0
        for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                          (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
            iy, ix = y0i + dy, x0i + dx
            out = out + w * _gather_2d(xv, iy, ix, inside(iy, ix))
        return out.to(xv.dtype)
    return call(_gs, x, grid, _name="grid_sample")
