"""paddle.vision.ops (counterpart of ``paddle_tpu/vision/ops.py``; ref:
python/paddle/vision/ops.py): ``deform_conv2d`` / ``DeformConv2D``,
``yolo_box``, ``yolo_loss``, ``read_file`` and ``decode_jpeg``.

Each device op is one ``dispatch.call`` over torch tensors, op for op
with the reference's arithmetic in float32:

* ``deform_conv2d`` samples the input at the offset lattice with four
  clamped gathers a kernel point (samples outside the image read zero;
  the bilinear weights come from ``floor``, so the gradient reaches the
  offsets and the mask only through the weights), then contracts the
  [N, Cin, K, Ho, Wo] column tensor with the kernel in one ``einsum``.
* ``yolo_loss`` assigns targets scatter-free, as the reference does: each
  gt's (anchor, cell) match is a one-hot mask over the grid, and the
  predictions at the matches are mask products (exact: one nonzero a
  gt).  No gradient flows through the ignore mask's IoU.

``read_file`` and ``decode_jpeg`` stay on the host (PIL, imported when
``decode_jpeg`` runs).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..nn import initializer as I
from ..nn.layer.layers import Layer
from ..ops.dispatch import call
from ..tensor.tensor import Tensor

__all__ = ["yolo_loss", "yolo_box", "deform_conv2d", "DeformConv2D",
           "read_file", "decode_jpeg"]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


# --------------------------------------------------------------------------
# deformable convolution
# --------------------------------------------------------------------------

def _bilinear_sample(img, ys, xs):
    """img [N, G, C, H, W]; ys, xs [N, G, K, Ho, Wo] fractional
    coordinates -> [N, G, C, K, Ho, Wo], zero outside the image."""
    N, G, C, H, W = img.shape
    flat = img.reshape(N, G, C, H * W)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    out = 0.0
    for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                      (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        iy = y0i + dy
        ix = x0i + dx
        valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        v = torch.gather(flat, 3, idx.reshape(N, G, 1, -1).expand(
            N, G, C, idx[0, 0].numel())).reshape(N, G, C, *idx.shape[2:])
        out = out + w[:, :, None] * torch.where(valid[:, :, None], v, 0.0)
    return out


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (``mask`` None) and v2.  x [N, Cin, H,
    W]; offset [N, 2 dg Kh Kw, Ho, Wo] ((dy, dx) interleaved a kernel
    point); weight [Cout, Cin / groups, Kh, Kw]; mask [N, dg Kh Kw, Ho,
    Wo]."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    dg = deformable_groups

    def _dc(xv, off, w, *rest):
        rest = list(rest)
        b = rest.pop(0) if bias is not None else None
        m = rest.pop(0) if mask is not None else None
        N, Cin, H, W = xv.shape
        Cout, Cin_g, Kh, Kw = w.shape
        Ho = (H + 2 * ph - (dh * (Kh - 1) + 1)) // sh + 1
        Wo = (W + 2 * pw - (dw * (Kw - 1) + 1)) // sw + 1
        K = Kh * Kw
        dev = xv.device
        off = off.reshape(N, dg, K, 2, Ho, Wo).float()
        oy = torch.arange(Ho, device=dev) * sh - ph
        ox = torch.arange(Wo, device=dev) * sw - pw
        ky, kx = torch.meshgrid(torch.arange(Kh, device=dev) * dh,
                                torch.arange(Kw, device=dev) * dw,
                                indexing="ij")
        base_y = (oy[None, :, None] + ky.reshape(K, 1, 1)).float()
        base_x = (ox[None, None, :] + kx.reshape(K, 1, 1)).float()
        ys = base_y + off[:, :, :, 0]                  # [N, dg, K, Ho, Wo]
        xs = base_x + off[:, :, :, 1]
        samp = _bilinear_sample(xv.float().reshape(N, dg, Cin // dg, H, W),
                                ys, xs)                # [N,dg,cg,K,Ho,Wo]
        if m is not None:
            samp = samp * m.reshape(N, dg, K, Ho, Wo).float()[:, :, None]
        samp = samp.reshape(N, groups, Cin // groups, K, Ho, Wo)
        w_g = w.float().reshape(groups, Cout // groups, Cin_g, K)
        out = torch.einsum("ngckhw,gock->ngohw", samp, w_g)
        out = out.reshape(N, Cout, Ho, Wo)
        if b is not None:
            out = out + b.float()[None, :, None, None]
        return out.to(xv.dtype)

    args = [x, offset, weight]
    if bias is not None:
        args.append(bias)
    if mask is not None:
        args.append(mask)
    return call(_dc, *args, _name="deform_conv2d")


class DeformConv2D(Layer):
    """The layer over :func:`deform_conv2d`: it owns the weight and bias;
    the offset (and the mask for v2) are forward inputs, made by a
    sibling convolution."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           deformable_groups=deformable_groups, groups=groups)
        bound = 1.0 / math.sqrt(in_channels // groups * kh * kw)
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, kh, kw],
            attr=weight_attr, default_initializer=I.Uniform(-bound, bound))
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, mask=mask,
                             **self._attrs)


# --------------------------------------------------------------------------
# YOLOv3
# --------------------------------------------------------------------------

def _grid(H, W, dev):
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :,
                                                           None]
    return gx, gy


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0):
    """Decode a YOLOv3 head into boxes and scores.  x [N, S (5 + cls), H,
    W]; img_size [N, 2] (h, w).  Returns (boxes [N, S H W, 4] xyxy in
    image pixels, scores [N, S H W, cls]); a box whose objectness is under
    ``conf_thresh`` has zero box and scores."""
    anchors = [int(a) for a in anchors]
    S = len(anchors) // 2
    an = np.asarray(anchors, np.float32).reshape(S, 2)

    def _yb(xv, isz):
        N, C, H, W = xv.shape
        dev = xv.device
        xv = xv.reshape(N, S, 5 + class_num, H, W).float()
        tx, ty, tw, th = xv[:, :, 0], xv[:, :, 1], xv[:, :, 2], xv[:, :, 3]
        conf = torch.sigmoid(xv[:, :, 4])
        cls = torch.sigmoid(xv[:, :, 5:]).permute(0, 1, 3, 4, 2)
        gx, gy = _grid(H, W, dev)
        alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
        bx = (torch.sigmoid(tx) * alpha + beta + gx) / W
        by = (torch.sigmoid(ty) * alpha + beta + gy) / H
        anw = torch.from_numpy(an[:, 0]).to(dev)[None, :, None, None] \
            / (downsample_ratio * W)
        anh = torch.from_numpy(an[:, 1]).to(dev)[None, :, None, None] \
            / (downsample_ratio * H)
        bw = torch.exp(tw) * anw
        bh = torch.exp(th) * anh
        img_h = isz[:, 0].float()[:, None, None, None]
        img_w = isz[:, 1].float()[:, None, None, None]
        x1 = (bx - bw / 2) * img_w
        y1 = (by - bh / 2) * img_h
        x2 = (bx + bw / 2) * img_w
        y2 = (by + bh / 2) * img_h
        if clip_bbox:
            zero = torch.zeros((), device=dev)
            x1 = torch.clamp(x1, zero, img_w - 1)
            y1 = torch.clamp(y1, zero, img_h - 1)
            x2 = torch.clamp(x2, zero, img_w - 1)
            y2 = torch.clamp(y2, zero, img_h - 1)
        keep = conf >= conf_thresh
        boxes = torch.stack([x1, y1, x2, y2], -1) * keep[..., None]
        scores = cls * (conf * keep)[..., None]
        return (boxes.reshape(N, S * H * W, 4),
                scores.reshape(N, S * H * W, class_num))
    return call(_yb, x, img_size, _name="yolo_box")


def _bce(logit, target):
    return (torch.clamp(logit, min=0) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 loss.  x [N, S (5 + cls), H, W] raw head output; gt_box
    [N, B, 4] normalised (cx, cy, w, h); gt_label [N, B]; gt_score
    [N, B] mixup weights.  Returns the loss of each image, [N].

    Each gt's best anchor (by wh IoU over all anchors) and cell become a
    one-hot mask [N, B, S, H, W]; the predictions at the matches are
    contractions with that mask, which has one nonzero a gt, so they are
    exact."""
    anchors = [int(a) for a in anchors]
    anchor_mask = [int(a) for a in anchor_mask]
    all_an = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask_an = np.asarray(anchor_mask, np.int64)
    S = len(anchor_mask)

    def _yl(xv, gbox, glabel, *rest):
        gscore = rest[0] if rest else None
        N, C, H, W = xv.shape
        dev = xv.device
        xv = xv.reshape(N, S, 5 + class_num, H, W).float()
        tx, ty = xv[:, :, 0], xv[:, :, 1]
        tw, th = xv[:, :, 2], xv[:, :, 3]
        tobj = xv[:, :, 4]
        tcls = xv[:, :, 5:]                                # [N,S,cls,H,W]
        in_w = float(downsample_ratio * W)
        in_h = float(downsample_ratio * H)
        gbox = gbox.detach().float()
        gw = gbox[..., 2]
        gh = gbox[..., 3]
        valid = (gw > 0) & (gh > 0)                        # [N, B]
        score = (gscore.detach().float() if gscore is not None
                 else torch.ones_like(gw)) * valid

        an_all_w = torch.from_numpy(all_an[:, 0]).to(dev)
        an_all_h = torch.from_numpy(all_an[:, 1]).to(dev)
        an_w = an_all_w / in_w
        an_h = an_all_h / in_h
        inter = (torch.minimum(gw[..., None], an_w)
                 * torch.minimum(gh[..., None], an_h))     # [N, B, A]
        iou_an = inter / (gw[..., None] * gh[..., None]
                          + an_w * an_h - inter + 1e-10)
        best = torch.argmax(iou_an, dim=-1)                # [N, B]
        in_mask = best[..., None] == torch.from_numpy(mask_an).to(dev)
        matched = torch.any(in_mask, dim=-1) & valid
        s_idx = torch.argmax(in_mask.to(torch.int8), dim=-1)

        gi = torch.clamp((gbox[..., 0] * W).to(torch.int32), 0, W - 1)
        gj = torch.clamp((gbox[..., 1] * H).to(torch.int32), 0, H - 1)
        pos = (TF.one_hot(s_idx, S).float()[..., None, None]
               * TF.one_hot(gj.long(), H).float()[:, :, None, :, None]
               * TF.one_hot(gi.long(), W).float()[:, :, None, None, :]
               ) * (matched * score)[..., None, None, None]

        tgt_x = gbox[..., 0] * W - gi
        tgt_y = gbox[..., 1] * H - gj
        an_sel_w = an_all_w[best] / in_w
        an_sel_h = an_all_h[best] / in_h
        tgt_w = torch.log(torch.clamp(gw / torch.clamp(an_sel_w, min=1e-10),
                                      min=1e-10))
        tgt_h = torch.log(torch.clamp(gh / torch.clamp(an_sel_h, min=1e-10),
                                      min=1e-10))
        box_scale = 2.0 - gw * gh

        hit = (pos > 0).float()                            # [N,B,S,H,W]

        def at_pos(pred):                                  # [N,S,H,W]
            return torch.einsum("nshw,nbshw->nb", pred, hit)

        px, py = at_pos(tx), at_pos(ty)
        pw, ph = at_pos(tw), at_pos(th)
        wgt = matched * score * box_scale
        loss_xy = (_bce(px, tgt_x) + _bce(py, tgt_y)) * wgt
        loss_wh = (torch.abs(pw - tgt_w) + torch.abs(ph - tgt_h)) * wgt

        pcls = torch.einsum("nschw,nbshw->nbc", tcls, hit)  # [N, B, cls]
        onehot = TF.one_hot(glabel.detach().long(), class_num).float()
        if use_label_smooth:
            delta = 1.0 / class_num
            onehot = torch.clamp(onehot, delta, 1.0 - delta)
        loss_cls = torch.sum(_bce(pcls, onehot), -1) * matched * score

        gx_f, gy_f = _grid(H, W, dev)
        alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
        with torch.no_grad():
            bx = (torch.sigmoid(tx) * alpha + beta + gx_f) / W
            by = (torch.sigmoid(ty) * alpha + beta + gy_f) / H
            m_an_w = an_all_w[mask_an] / in_w
            m_an_h = an_all_h[mask_an] / in_h
            bw = torch.exp(tw) * m_an_w[None, :, None, None]
            bh = torch.exp(th) * m_an_h[None, :, None, None]
            px1, px2 = bx - bw / 2, bx + bw / 2
            py1, py2 = by - bh / 2, by + bh / 2
            gx1 = gbox[..., 0] - gw / 2
            gx2 = gbox[..., 0] + gw / 2
            gy1 = gbox[..., 1] - gh / 2
            gy2 = gbox[..., 1] + gh / 2
            g4 = (lambda v: v[..., None, None, None])
            ix1 = torch.maximum(px1[:, None], g4(gx1))
            ix2 = torch.minimum(px2[:, None], g4(gx2))
            iy1 = torch.maximum(py1[:, None], g4(gy1))
            iy2 = torch.minimum(py2[:, None], g4(gy2))
            iw = torch.clamp(ix2 - ix1, min=0)
            ih = torch.clamp(iy2 - iy1, min=0)
            inter_ = iw * ih
            area_p = (px2 - px1) * (py2 - py1)
            area_g = g4(gw * gh)
            iou_all = inter_ / (area_p[:, None] + area_g - inter_ + 1e-10)
            iou_all = iou_all * g4(valid)
            max_iou = torch.amax(iou_all, dim=1)           # [N, S, H, W]

        pos_map = torch.clamp(torch.sum(pos, dim=1), min=0.0)
        is_pos = pos_map > 0
        ignore = (max_iou > ignore_thresh) & ~is_pos
        obj_w = torch.where(is_pos, pos_map,
                            torch.where(ignore, 0.0, 1.0))
        obj_t = is_pos.float()
        loss_obj = torch.sum(_bce(tobj, obj_t) * obj_w, dim=(1, 2, 3))
        return torch.sum(loss_xy + loss_wh + loss_cls, dim=1) + loss_obj
    args = [x, gt_box, gt_label] + ([gt_score] if gt_score is not None
                                    else [])
    return call(_yl, *args, _name="yolo_loss")


# --------------------------------------------------------------------------
# host-side image io
# --------------------------------------------------------------------------

def read_file(filename, name=None):
    """The file's bytes as a uint8 1-D Tensor."""
    with open(filename, "rb") as f:
        data = f.read()
    return Tensor(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """JPEG bytes -> [C, H, W] uint8 Tensor, decoded on the host with
    PIL."""
    import io as _io
    from PIL import Image
    data = bytes(np.asarray(x.numpy() if hasattr(x, "numpy") else x,
                            np.uint8))
    img = Image.open(_io.BytesIO(data))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return Tensor(arr.copy())
