"""The detection op family (counterpart of ``paddle_tpu/vision/detection.py``;
ref: python/paddle/fluid/layers/detection.py).

Every op keeps the reference's fixed-shape contract, not the ragged LoD
output of Paddle's C++: NMS returns [B, keep_top_k, 6] rows (label,
score, x1, y1, x2, y2) padded with label -1, proposals come back as
zero-padded [B, K, 4] with their counts as tensors, and the target
assigners return dense per-anchor tensors.

Rankings keep the reference's order among ties: every sort is a stable
``torch.sort`` / ``argsort(stable=True)`` (ties lowest index first, as
``jnp.argsort`` and ``lax.top_k``), never ``torch.topk``, and ``argmax``
takes the first maximum.  The greedy loops (NMS, bipartite matching)
run each round for all images and classes at once, with the
reference's per-round arithmetic, so the kept sets are the same; an
NMS round touches only the ``min(top_k, N)`` best boxes of a row, whose
IoUs are the reference's (elementwise, the same formula).  Priors and
anchors are host numpy lattices, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops.dispatch import call
from ..tensor.tensor import Tensor

__all__ = ["prior_box", "density_prior_box", "anchor_generator",
           "iou_similarity", "box_coder", "box_clip", "bipartite_match",
           "target_assign", "multiclass_nms", "matrix_nms", "ssd_loss",
           "multi_box_head", "polygon_box_transform", "generate_proposals",
           "rpn_target_assign", "locality_aware_nms",
           "distribute_fpn_proposals", "collect_fpn_proposals",
           "retinanet_target_assign", "retinanet_detection_output",
           "roi_perspective_transform", "generate_proposal_labels"]

NEG = -1e9


def _nondiff(fn, *args, _name):
    """``call`` for an op with no gradient (indices, masks, matched
    targets): the inputs are detached inside and the outputs stop
    gradients."""
    out = call(lambda *a: fn(*[v.detach() if isinstance(v, torch.Tensor)
                               else v for v in a]), *args, _name=_name)
    for o in (out if isinstance(out, tuple) else (out,)):
        o.stop_gradient = True
    return out


# --------------------------------------------------------------------------
# prior / anchor generation (host lattices)
# --------------------------------------------------------------------------

def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    """SSD prior boxes of one feature map.  Returns (boxes [H, W, P, 4]
    normalised xyxy, variances of the same shape).  An empty or None
    ``max_sizes`` adds no sqrt(min max) box."""
    H, W = int(input.shape[2]), int(input.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    step_h = steps[1] if steps[1] > 0 else img_h / H
    step_w = steps[0] if steps[0] > 0 else img_w / W
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    whs = []
    for i, ms in enumerate(min_sizes):
        ms = float(ms)
        big = []
        if max_sizes:
            mx = float(max_sizes[i])
            big = [(math.sqrt(ms * mx), math.sqrt(ms * mx))]
        if min_max_aspect_ratios_order:
            whs += [(ms, ms)] + big + [
                (ms * math.sqrt(ar), ms / math.sqrt(ar)) for ar in ars
                if abs(ar - 1.0) >= 1e-6]
        else:
            whs += [(ms * math.sqrt(ar), ms / math.sqrt(ar))
                    for ar in ars] + big
    wh = np.asarray(whs, np.float32)                       # [P, 2]
    cx = (np.arange(W, dtype=np.float32) + offset) * step_w
    cy = (np.arange(H, dtype=np.float32) + offset) * step_h
    gx, gy = np.meshgrid(cx, cy)
    boxes = np.empty((H, W, len(whs), 4), np.float32)
    boxes[..., 0] = (gx[..., None] - wh[None, None, :, 0] / 2) / img_w
    boxes[..., 1] = (gy[..., None] - wh[None, None, :, 1] / 2) / img_h
    boxes[..., 2] = (gx[..., None] + wh[None, None, :, 0] / 2) / img_w
    boxes[..., 3] = (gy[..., None] + wh[None, None, :, 1] / 2) / img_h
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          boxes.shape).copy()
    return Tensor(boxes), Tensor(var)


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None):
    """Dense sub-lattice priors: ``density``^2 shifted boxes a fixed size
    and ratio at each cell.  Returns (boxes [H, W, P, 4], variances), or
    [H W P, 4] each with ``flatten_to_2d``."""
    H, W = int(input.shape[2]), int(input.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    step_h = steps[1] if steps[1] > 0 else img_h / H
    step_w = steps[0] if steps[0] > 0 else img_w / W
    all_boxes = []
    gx, gy = np.meshgrid((np.arange(W, dtype=np.float32) + offset) * step_w,
                         (np.arange(H, dtype=np.float32) + offset) * step_h)
    for density, fsize in zip(densities, fixed_sizes):
        density = int(density)
        fsize = float(fsize)
        shift = step_w / density
        for r in fixed_ratios:
            w = fsize * math.sqrt(r)
            h = fsize / math.sqrt(r)
            for di in range(density):
                for dj in range(density):
                    ccx = gx + (dj + 0.5) * shift - step_w / 2
                    ccy = gy + (di + 0.5) * shift - step_h / 2
                    all_boxes.append(np.stack([
                        (ccx - w / 2) / img_w, (ccy - h / 2) / img_h,
                        (ccx + w / 2) / img_w, (ccy + h / 2) / img_h], -1))
    boxes = np.stack(all_boxes, 2).astype(np.float32)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          boxes.shape).copy()
    if flatten_to_2d:
        boxes = boxes.reshape(-1, 4)
        var = var.reshape(-1, 4)
    return Tensor(boxes), Tensor(var)


def anchor_generator(input, anchor_sizes, aspect_ratios, variance=(
        0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5, name=None):
    """RPN anchors in pixels: (anchors [H, W, P, 4], variances)."""
    H, W = int(input.shape[2]), int(input.shape[3])
    sw, sh = (stride or [16.0, 16.0])[:2]
    whs = []
    for size in anchor_sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            whs.append((w, w * ar))
    wh = np.asarray(whs, np.float32)
    gx, gy = np.meshgrid((np.arange(W, dtype=np.float32) + offset) * sw,
                         (np.arange(H, dtype=np.float32) + offset) * sh)
    anchors = np.empty((H, W, len(whs), 4), np.float32)
    anchors[..., 0] = gx[..., None] - wh[None, None, :, 0] / 2
    anchors[..., 1] = gy[..., None] - wh[None, None, :, 1] / 2
    anchors[..., 2] = gx[..., None] + wh[None, None, :, 0] / 2
    anchors[..., 3] = gy[..., None] + wh[None, None, :, 1] / 2
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          anchors.shape).copy()
    return Tensor(anchors), Tensor(var)


# --------------------------------------------------------------------------
# ranking, IoU and the greedy NMS round
# --------------------------------------------------------------------------

def _desc(scores):
    """Indices that sort the last axis descending, ties lowest index
    first (``jnp.argsort(-s)``)."""
    return torch.argsort(-scores, dim=-1, stable=True)


def _topk_padded(scores, K):
    """The K best of the last axis, padded to exactly K when it is
    shorter: (idx [..., K], valid [..., K]); padded slots point at index 0
    with valid False, as do entries at or under -1e8."""
    order = _desc(scores)
    n = scores.shape[-1]
    if n >= K:
        idx = order[..., :K]
        return idx, torch.gather(scores, -1, idx) > -1e8
    pad = K - n
    idx = torch.cat([order, order.new_zeros(*order.shape[:-1], pad)], -1)
    valid = torch.cat([torch.gather(scores, -1, order) > -1e8,
                       torch.zeros(*order.shape[:-1], pad, dtype=torch.bool,
                                   device=scores.device)], -1)
    return idx, valid


def _pairwise_iou(a, b):
    """a [..., N, 4], b [..., M, 4] xyxy -> [..., N, M] IoU."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    iw = torch.clamp(ix2 - ix1, min=0.0)
    ih = torch.clamp(iy2 - iy1, min=0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-10)


def _rows(v, idx):
    """v [R, N, D] gathered at idx [R, K] -> [R, K, D]."""
    return torch.gather(v, 1, idx[..., None].expand(*idx.shape, v.shape[-1]))


def _nms_keep(scores, boxes, iou_threshold, top_k, eta=1.0):
    """Greedy NMS of each row at once.  scores [R, N]; boxes [R, N, 4]
    (may be an expanded view).  Returns keep [R, N] in the input order.

    A row's boxes are ranked (stable, descending); only the K = min(top_k,
    N) best take part.  Round i keeps box i unless a kept box ranked
    above it overlaps it by more than the row's threshold; with ``eta``
    under 1 a row's threshold shrinks by ``eta`` each time a box is kept
    while it is above 0.5 (the reference's adaptive NMS)."""
    R, N = scores.shape
    K = min(top_k, N)
    order = _desc(scores)[:, :K]
    iou = _pairwise_iou(*(2 * (_rows(boxes, order),)))      # [R, K, K]
    keep = torch.ones((R, K), dtype=torch.bool, device=scores.device)
    thr = torch.full((R,), iou_threshold, dtype=torch.float32,
                     device=scores.device)
    adaptive = eta is not None and eta < 1.0
    eta_t = torch.tensor(eta if adaptive else 1.0, dtype=torch.float32,
                         device=scores.device)
    for i in range(K):
        sup = ((iou[:, i, :i] > thr[:, None]) & keep[:, :i]).any(-1)
        kept = ~sup
        keep[:, i] = kept
        if adaptive:
            thr = torch.where(kept & (thr > 0.5), thr * eta_t, thr)
    out = torch.zeros((R, N), dtype=torch.bool, device=scores.device)
    return out.scatter(1, order, keep)


# --------------------------------------------------------------------------
# box maths
# --------------------------------------------------------------------------

def iou_similarity(x, y, box_normalized=True, name=None):
    """[N, 4] x [M, 4] -> [N, M] IoU."""
    return call(lambda a, b: _pairwise_iou(a.float(), b.float()), x, y,
                _name="iou_similarity")


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """SSD box encode / decode against priors with their variances.

    encode: prior [M, 4], target [N, 4] -> [N, M, 4] (every target
    against every prior).  decode: target [N, M, 4] with prior [M, 4]
    (``axis`` 0) or [N, 4] (``axis`` 1) broadcast along ``axis``; a 2-D
    target [M, 4] decodes row against row."""
    encode = code_type.lower().startswith("encode")
    off = 0.0 if box_normalized else 1.0

    def _cwh(b):
        w = b[..., 2] - b[..., 0] + off
        h = b[..., 3] - b[..., 1] + off
        return b[..., 0] + w * 0.5, b[..., 1] + h * 0.5, w, h

    def _bc(pb, pv, tb):
        pb = pb.float()
        tb = tb.float()
        pcx, pcy, pw, ph = _cwh(pb)
        if pv is not None:
            pv = pv.float()
        if encode:
            tcx, tcy, tw, th = _cwh(tb)
            out = torch.stack([
                (tcx[:, None] - pcx[None]) / pw[None],
                (tcy[:, None] - pcy[None]) / ph[None],
                torch.log(torch.clamp(tw[:, None] / pw[None], min=1e-10)),
                torch.log(torch.clamp(th[:, None] / ph[None], min=1e-10))],
                -1)
            return out if pv is None else out / pv[None]
        if tb.dim() == 3:
            exp = (lambda v: v[None, :]) if axis == 0 else \
                (lambda v: v[:, None])
            pcx, pcy, pw, ph = map(exp, (pcx, pcy, pw, ph))
            if pv is not None:
                pv = exp(pv)
        d = tb if pv is None else tb * pv
        ocx = pcx + d[..., 0] * pw
        ocy = pcy + d[..., 1] * ph
        ow = pw * torch.exp(d[..., 2])
        oh = ph * torch.exp(d[..., 3])
        return torch.stack([ocx - ow * 0.5, ocy - oh * 0.5,
                            ocx + ow * 0.5 - off, ocy + oh * 0.5 - off], -1)
    if prior_box_var is None:
        return call(lambda pb, tb: _bc(pb, None, tb), prior_box, target_box,
                    _name="box_coder")
    return call(_bc, prior_box, prior_box_var, target_box, _name="box_coder")


def box_clip(input, im_info, name=None):
    """Clip boxes to the original image: im_info [B, 3] or [3] (scaled
    h, scaled w, scale) bounds them at round(h / scale) - 1 and
    round(w / scale) - 1; a 2-vector (h, w) means scale 1."""
    def _clip(b, info):
        info = info.float()
        if info.dim() == 1:
            h, w = info[0], info[1]
            if info.shape[0] >= 3:
                h = torch.round(h / info[2])
                w = torch.round(w / info[2])
        else:
            h, w = info[..., 0], info[..., 1]
            if info.shape[-1] >= 3:
                h = torch.round(h / info[..., 2])
                w = torch.round(w / info[..., 2])
            extra = b.dim() - h.dim() - 1
            h = h.reshape(h.shape + (1,) * extra)
            w = w.reshape(w.shape + (1,) * extra)
        zero = torch.zeros((), device=b.device)
        return torch.stack([torch.clamp(b[..., 0], zero, w - 1),
                            torch.clamp(b[..., 1], zero, h - 1),
                            torch.clamp(b[..., 2], zero, w - 1),
                            torch.clamp(b[..., 3], zero, h - 1)], -1)
    return call(_clip, input, im_info, _name="box_clip")


def polygon_box_transform(input, name=None):
    """EAST's geometry map: per-pixel corner offsets [N, 8, H, W] to
    absolute quad coordinates (4 x the cell minus the offset)."""
    def _pbt(x):
        N, C, H, W = x.shape
        dev = x.device
        gx = torch.arange(W, dtype=torch.float32, device=dev)[
            None, None, None, :] * 4.0
        gy = torch.arange(H, dtype=torch.float32, device=dev)[
            None, None, :, None] * 4.0
        is_x = (torch.arange(C, device=dev) % 2 == 0)[None, :, None, None]
        return torch.where(is_x, gx, gy) - x
    return call(_pbt, input, _name="polygon_box_transform")


# --------------------------------------------------------------------------
# matching / assignment
# --------------------------------------------------------------------------

def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Greedy bipartite matching: min(M, N) rounds, each taking the
    globally best remaining (row, col) pair (the first maximum of the
    flattened matrix) while it is above 0.  dist_matrix [M, N] (gt rows,
    prior columns).  Returns (match_indices [N] int32, -1 unmatched;
    match_dist [N]); ``per_prediction`` then gives each unmatched column
    its best row when that is at least ``dist_threshold`` (0.5)."""
    def _bm(dist):
        M, N = dist.shape
        dev = dist.device
        d = dist.float()
        mi = torch.full((N,), -1, dtype=torch.int32, device=dev)
        md = torch.zeros((N,), dtype=torch.float32, device=dev)
        rows = torch.arange(M, device=dev)
        cols = torch.arange(N, device=dev)
        for _ in range(min(M, N)):
            flat = torch.argmax(d)
            r, c = flat // N, flat % N
            best = d.reshape(-1)[flat]
            take = best > 0
            at_c = take & (cols == c)
            mi = torch.where(at_c, r.to(torch.int32), mi)
            md = torch.where(at_c, best, md)
            d = torch.where(take & ((rows == r)[:, None] | (cols == c)[None]),
                            NEG, d)
        if match_type == "per_prediction":
            thr = dist_threshold if dist_threshold is not None else 0.5
            col_best, col_best_row = torch.max(dist, dim=0)
            extra = (mi < 0) & (col_best >= thr)
            mi = torch.where(extra, col_best_row.to(torch.int32), mi)
            md = torch.where(extra, col_best.float(), md)
        return mi, md
    return _nondiff(_bm, dist_matrix, _name="bipartite_match")


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    """Gather rows by match index.  input [M, K], matched_indices [N] ->
    (out [N, K], out_weight [N, 1]); unmatched rows get
    ``mismatch_value`` and weight 0, rows in ``negative_indices``
    ``mismatch_value`` and weight 1."""
    def _ta(x, mi, *rest):
        mi = mi.long()
        out = x[torch.clamp(mi, 0, x.shape[0] - 1)]
        pos = mi >= 0
        out = torch.where(pos[:, None], out,
                          torch.tensor(mismatch_value, dtype=out.dtype,
                                       device=out.device))
        w = pos.float()
        if rest:
            neg = torch.clamp(rest[0].reshape(-1).long(), 0, mi.shape[0] - 1)
            w = w.index_fill(0, neg, 1.0)
            out = out.index_fill(0, neg, mismatch_value)
        return out, w[:, None]
    args = [input, matched_indices] + (
        [negative_indices] if negative_indices is not None else [])
    return call(lambda x, *r: _ta(x, *[v.detach() for v in r]), *args,
                _name="target_assign")


def _box_delta_encode(anchors, targets, eps=1e-10):
    """Faster R-CNN's (+1 pixel) centre / size delta encode: anchors,
    targets [..., 4] -> [..., 4] (dx, dy, log dw, log dh)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + aw * 0.5
    acy = anchors[..., 1] + ah * 0.5
    tw = targets[..., 2] - targets[..., 0] + 1.0
    th = targets[..., 3] - targets[..., 1] + 1.0
    tcx = targets[..., 0] + tw * 0.5
    tcy = targets[..., 1] + th * 0.5
    return torch.stack([(tcx - acx) / aw, (tcy - acy) / ah,
                        torch.log(torch.clamp(tw / aw, min=eps)),
                        torch.log(torch.clamp(th / ah, min=eps))], -1)


# --------------------------------------------------------------------------
# NMS family: fixed-size outputs, label -1 marks padding
# --------------------------------------------------------------------------

def _nms_rows(boxes, flat, keep_top_k, n):
    """The [B, keep_top_k, 6] rows of the kept scores ``flat`` [B, C n]
    (class-major), and the kept boxes' indices [B, keep_top_k] (-1 on
    padding)."""
    top, valid = _topk_padded(flat, keep_top_k)
    lbl = (top // n).float()
    idx = top % n
    rows = torch.cat([
        torch.where(valid, lbl, -1.0)[..., None],
        torch.where(valid, torch.gather(flat, 1, top), 0.0)[..., None],
        torch.where(valid[..., None], _rows(boxes, idx), 0.0)], -1)
    return rows, torch.where(valid, idx, -1).to(torch.int32)


def _multiclass_keep(bb, sc, score_threshold, nms_top_k, nms_threshold,
                     nms_eta, background_label):
    """keep [B, C, N] of per-class NMS over boxes bb [B, N, 4] and scores
    sc [B, C, N], every image and class in each round at once."""
    B, C, N = sc.shape
    keep = torch.zeros((B, C, N), dtype=torch.bool, device=sc.device)
    fg = [c for c in range(C) if c != background_label]
    if not fg or N == 0:
        return keep
    s = sc[:, fg]
    valid = s > score_threshold
    s_m = torch.where(valid, s, NEG)
    R = B * len(fg)
    k = _nms_keep(s_m.reshape(R, N),
                  bb[:, None].expand(B, len(fg), N, 4).reshape(R, N, 4),
                  nms_threshold, nms_top_k, eta=nms_eta)
    keep[:, fg] = k.reshape(B, len(fg), N) & valid
    return keep


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None,
                   return_index=False):
    """Per-class NMS.  bboxes [B, N, 4], scores [B, C, N].  Returns
    [B, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), label -1 on
    padding; with ``return_index`` also the kept boxes' indices
    [B, keep_top_k] (-1 on padding)."""
    def _mn(bb, sc):
        bb = bb.float()
        sc = sc.float()
        B, C, N = sc.shape
        keep = _multiclass_keep(bb, sc, score_threshold, nms_top_k,
                                nms_threshold, nms_eta, background_label)
        flat = torch.where(keep, sc, NEG).reshape(B, C * N)
        return _nms_rows(bb, flat, keep_top_k, N)
    rows, idxs = _nondiff(_mn, bboxes, scores, _name="multiclass_nms")
    return (rows, idxs) if return_index else rows


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               name=None):
    """Matrix NMS (SOLOv2): each box's score decays by its overlap with
    the higher-scored boxes of its class, from one IoU matrix a class.
    Returns [B, keep_top_k, 6] rows, label -1 on padding."""
    def _mx(bb, sc):
        bb = bb.float()
        sc = sc.float()
        B, C, N = sc.shape
        fg = [c for c in range(C) if c != background_label]
        if not fg:
            return torch.cat([torch.full((B, keep_top_k, 1), -1.0,
                                         device=sc.device),
                              torch.zeros((B, keep_top_k, 5),
                                          device=sc.device)], -1)
        s = sc[:, fg]                                      # [B, C', N]
        valid = s > score_threshold
        s_m = torch.where(valid, s, 0.0)
        rank = torch.argsort(_desc(s_m), dim=-1, stable=True)
        s_m = torch.where(rank < nms_top_k, s_m, 0.0)
        order = _desc(s_m)
        Cf = len(fg)
        b_s = _rows(bb[:, None].expand(B, Cf, N, 4).reshape(B * Cf, N, 4),
                    order.reshape(B * Cf, N)).reshape(B, Cf, N, 4)
        s_s = torch.gather(s_m, -1, order)
        iou = _pairwise_iou(b_s, b_s)                      # [B, C', N, N]
        lower = torch.tril(torch.ones((N, N), dtype=torch.bool,
                                      device=sc.device), -1)
        ious = torch.where(lower, iou, 0.0)
        max_iou = torch.amax(ious, dim=-1)
        if use_gaussian:
            decay = torch.where(
                lower, torch.exp((max_iou[..., None, :] * max_iou[..., None, :]
                                  - ious * ious) * gaussian_sigma), 1.0)
        else:
            decay = torch.where(
                lower, (1 - ious) / torch.clamp(1 - max_iou[..., None, :],
                                                min=1e-10), 1.0)
        dec = s_s * torch.amin(decay, dim=-1)
        lbls = torch.tensor(fg, dtype=torch.float32, device=sc.device)[
            None, :, None].expand(B, Cf, N).reshape(B, Cf * N)
        scs = dec.reshape(B, Cf * N)
        bxs = b_s.reshape(B, Cf * N, 4)
        scs = torch.where(scs > post_threshold, scs, NEG)
        top, ok = _topk_padded(scs, keep_top_k)
        return torch.cat([
            torch.where(ok, torch.gather(lbls, 1, top), -1.0)[..., None],
            torch.where(ok, torch.gather(scs, 1, top), 0.0)[..., None],
            torch.where(ok[..., None], _rows(bxs, top), 0.0)], -1)
    return _nondiff(_mx, bboxes, scores, _name="matrix_nms")


# --------------------------------------------------------------------------
# SSD training loss and head
# --------------------------------------------------------------------------

def _ssd_encode(pb, pv, tb):
    pw = pb[..., 2] - pb[..., 0]
    ph = pb[..., 3] - pb[..., 1]
    pcx = pb[..., 0] + pw / 2
    pcy = pb[..., 1] + ph / 2
    tw = tb[..., 2] - tb[..., 0]
    th = tb[..., 3] - tb[..., 1]
    tcx = tb[..., 0] + tw / 2
    tcy = tb[..., 1] + th / 2
    pw_ = torch.clamp(pw, min=1e-10)
    ph_ = torch.clamp(ph, min=1e-10)
    out = torch.stack([(tcx - pcx) / pw_, (tcy - pcy) / ph_,
                       torch.log(torch.clamp(tw / pw_, min=1e-10)),
                       torch.log(torch.clamp(th / ph_, min=1e-10))], -1)
    return out if pv is None else out / pv


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None,
             name=None):
    """SSD multibox loss.  location [B, N, 4]; confidence [B, N, C];
    gt_box [B, G, 4] normalised xyxy (zero-area rows are padding);
    gt_label [B, G]; prior_box [N, 4].

    Priors match the gt of best IoU at ``overlap_threshold``, and each
    valid gt's best prior is forced positive (two gts that pick one
    prior: the larger IoU wins, then the lower gt).  Smooth-L1 on the
    encoded offsets of positives; softmax CE on positives and on the hard
    negatives: n_neg = min(int(n_pos * neg_pos_ratio), N - n_pos), mined
    among priors under ``neg_overlap``, every tie at the n_neg-th loss
    kept.  The batch's summed loss divides by its total positives.  The
    loss is float32, or float64 for float64 locations and confidences
    (the reference casts those down)."""
    if mining_type != "max_negative":
        raise NotImplementedError("only max_negative mining is supported")

    def _loss(loc, conf, gb, gl, pb, *rest):
        pv = rest[0].detach().float() if rest else None
        gb, gl, pb = gb.detach(), gl.detach(), pb.detach().float()
        if loc.dim() == 2:
            loc, conf = loc[None], conf[None]
            gb = gb.reshape(1, -1, 4)
            gl = gl.reshape(1, -1)
        # float32, as the reference; float64 stays float64 (a parity
        # check's dtype), where the reference casts it down
        dt = torch.promote_types(loc.dtype, torch.float32)
        loc = loc.to(dt)
        conf = conf.to(dt)
        gb = gb.float()
        gl = gl.reshape(gb.shape[0], -1)
        B, N, _ = loc.shape
        G = gb.shape[1]
        dev = loc.device
        valid_g = (gb[..., 2] > gb[..., 0]) & (gb[..., 3] > gb[..., 1])
        iou = _pairwise_iou(gb, pb[None])                   # [B, G, N]
        iou = torch.where(valid_g[..., None], iou, -1.0)
        best_iou, best_g = torch.max(iou, dim=1)
        pos = best_iou >= overlap_threshold
        best_p = torch.argmax(iou, dim=2)                   # [B, G]
        at_best = torch.gather(iou, 2, best_p[..., None])[..., 0]
        lattice = torch.full((B, G, N), -math.inf, device=dev).scatter(
            2, best_p[..., None],
            torch.where(valid_g, at_best, -math.inf)[..., None])
        forced = torch.amax(lattice, dim=1) > -math.inf
        forced_g = torch.argmax(lattice, dim=1)
        pos = pos | forced
        best_g = torch.where(forced, forced_g, best_g)

        tgt_box = torch.gather(gb, 1, best_g[..., None].expand(B, N, 4))
        enc = _ssd_encode(pb[None], pv, tgt_box)
        sl1 = torch.abs(loc - enc)
        sl1 = torch.where(sl1 < 1.0, 0.5 * sl1 * sl1, sl1 - 0.5)
        loc_l = torch.sum(torch.sum(sl1, -1) * pos, -1)

        tgt_lbl = torch.where(pos, torch.gather(gl.long(), 1, best_g),
                              background_label)
        logp = torch.log_softmax(conf, -1)
        ce = -torch.gather(logp, 2, tgt_lbl[..., None])[..., 0]
        n_pos = torch.sum(pos, -1)                          # [B]
        n_neg = torch.minimum((n_pos * neg_pos_ratio).to(torch.int32),
                              (N - n_pos).to(torch.int32))
        if sample_size is not None:
            n_neg = torch.clamp(n_neg, max=sample_size)
        minable = (~pos) & (best_iou < neg_overlap)
        neg_ce = torch.where(minable, ce, NEG)
        srt = torch.sort(neg_ce, dim=-1, descending=True).values
        thresh = torch.gather(srt, 1, torch.clamp(n_neg - 1, min=0)
                              .long()[:, None])
        hard_neg = minable & (neg_ce >= thresh) & (n_neg > 0)[:, None]
        conf_l = torch.sum(ce * (pos | hard_neg), -1)
        per = loc_loss_weight * loc_l + conf_loss_weight * conf_l
        if normalize:
            return torch.sum(per) / torch.clamp(torch.sum(n_pos).float(),
                                                min=1.0)
        return torch.sum(per)
    args = [location, confidence, gt_box, gt_label, prior_box]
    if prior_box_var is not None:
        args.append(prior_box_var)
    return call(_loss, *args, _name="ssd_loss")


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """The SSD head over several feature maps: a ``static.nn.conv2d``
    each for the locations and the confidences, and the maps' priors.
    Returns (mbox_locs [B, N, 4], mbox_confs [B, N, C], boxes [N, 4],
    variances [N, 4]).  With ``min_sizes`` None the sizes follow the
    reference's ratio schedule between ``min_ratio`` and ``max_ratio``."""
    from ..static import nn as snn
    from ..tensor.manipulation import concat, reshape, transpose

    n_maps = len(inputs)
    if min_sizes is None:
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio)
                              / max(n_maps - 2, 1)))
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes

    def _list(v):
        return list(v) if isinstance(v, (list, tuple)) else [v]

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, x in enumerate(inputs):
        mx = _list(max_sizes[i]) if max_sizes else None
        if steps:
            st = (steps[i] if isinstance(steps[i], (list, tuple))
                  else (steps[i], steps[i]))
        else:
            st = (step_w or 0.0, step_h or 0.0)
        box, var = prior_box(x, image, _list(min_sizes[i]), mx,
                             _list(aspect_ratios[i]), variance, flip, clip,
                             st, offset, min_max_aspect_ratios_order=
                             min_max_aspect_ratios_order)
        P = box.shape[2]
        loc = snn.conv2d(x, P * 4, kernel_size, stride=stride, padding=pad)
        conf = snn.conv2d(x, P * num_classes, kernel_size, stride=stride,
                          padding=pad)
        # 0 keeps the batch dim: a static program's placeholder batch is
        # not baked into the reshape
        locs.append(reshape(transpose(loc, [0, 2, 3, 1]), [0, -1, 4]))
        confs.append(reshape(transpose(conf, [0, 2, 3, 1]),
                             [0, -1, num_classes]))
        boxes_all.append(reshape(box, [-1, 4]))
        vars_all.append(reshape(var, [-1, 4]))
    return (concat(locs, 1), concat(confs, 1),
            concat(boxes_all, 0), concat(vars_all, 0))


# --------------------------------------------------------------------------
# two-stage detectors: proposals, RPN / RetinaNet targets, FPN routing
# --------------------------------------------------------------------------

def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False, name=None):
    """RPN proposals: decode the anchor deltas, clip to the image, drop
    boxes under ``min_size``, keep the ``pre_nms_top_n`` best, NMS, keep
    ``post_nms_top_n``.  scores [N, A, H, W]; bbox_deltas [N, 4A, H, W];
    im_info [N, 3]; anchors, variances [H, W, A, 4].  Returns (rois [N,
    post_nms_top_n, 4], roi_probs [N, post_nms_top_n, 1]), zero past each
    image's count, and with ``return_rois_num`` the counts [N]."""
    def _gp(sc, bd, info, an, var):
        N, A, H, W = sc.shape
        an = an.reshape(-1, 4).float()
        var_f = var.reshape(-1, 4).float()
        bd_r = bd.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
            .reshape(N, -1, 4).float()
        sc_r = sc.permute(0, 2, 3, 1).reshape(N, -1).float()
        inf = info.float()
        aw = an[:, 2] - an[:, 0] + 1.0
        ah = an[:, 3] - an[:, 1] + 1.0
        acx = an[:, 0] + aw * 0.5
        acy = an[:, 1] + ah * 0.5
        d = bd_r * var_f
        cx = acx + d[..., 0] * aw
        cy = acy + d[..., 1] * ah
        w = aw * torch.exp(torch.clamp(d[..., 2], max=10.0))
        h = ah * torch.exp(torch.clamp(d[..., 3], max=10.0))
        imh, imw, scale = (inf[:, i:i + 1] for i in range(3))
        zero = torch.zeros((), device=sc.device)
        x1 = torch.clamp(cx - w * 0.5, zero, imw - 1)
        y1 = torch.clamp(cy - h * 0.5, zero, imh - 1)
        x2 = torch.clamp(cx + w * 0.5 - 1.0, zero, imw - 1)
        y2 = torch.clamp(cy + h * 0.5 - 1.0, zero, imh - 1)
        keep = ((x2 - x1 + 1 >= min_size * scale)
                & (y2 - y1 + 1 >= min_size * scale))
        s_m = torch.where(keep, sc_r, NEG)
        K = min(pre_nms_top_n, s_m.shape[1])
        top = _desc(s_m)[:, :K]
        boxes = _rows(torch.stack([x1, y1, x2, y2], -1), top)  # [N, K, 4]
        st = torch.gather(s_m, 1, top)
        nkeep = _nms_keep(st, boxes, nms_thresh, K)
        s_f = torch.where(nkeep & (st > -1e8), st, NEG)
        sel, valid = _topk_padded(s_f, post_nms_top_n)
        out_b = torch.where(valid[..., None], _rows(boxes, sel), 0.0)
        out_s = torch.where(valid, torch.gather(s_f, 1, sel), 0.0)[..., None]
        return out_b, out_s, valid.sum(-1, dtype=torch.int32)
    rois, probs, num = _nondiff(_gp, scores, bbox_deltas, im_info, anchors,
                                variances, _name="generate_proposals")
    if return_rois_num:
        return rois, probs, num
    return rois, probs


def _force_lattice(iou, valid_g):
    """[B, G, M] -> [B, M]: is the anchor some valid gt's best anchor?"""
    B, G, M = iou.shape
    best_a = torch.argmax(iou, dim=2)
    at_best = torch.gather(iou, 2, best_a[..., None])[..., 0]
    lattice = torch.full((B, G, M), -math.inf, device=iou.device).scatter(
        2, best_a[..., None],
        torch.where(valid_g, at_best, -math.inf)[..., None])
    return torch.amax(lattice, dim=1) > -math.inf


def _gather_gt(gt, best_g):
    """gt [B, G, 4] at best_g [B, M] -> [B, M, 4]."""
    return torch.gather(gt, 1, best_g[..., None].expand(*best_g.shape, 4))


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=False,
                      name=None):
    """RPN training targets, dense: (labels [N, M] int32 {1 fg, 0 bg, -1
    ignored}, bbox_targets [N, M, 4], fg_mask [N, M], bg_mask [N, M]).
    Anchors at IoU >= ``rpn_positive_overlap`` and each valid gt's best
    anchor are fg, IoU < ``rpn_negative_overlap`` bg; crowd gts and, with
    ``im_info``, anchors past the straddle threshold take no part.  fg is
    capped at fraction x batch and bg at batch - n_fg, first come first
    kept (the deterministic stand-in for the reference's random draw)."""
    def _rta(ab, gb, *rest):
        rest = list(rest)
        crowd = rest.pop(0) if is_crowd is not None else None
        info = rest[0].float() if rest else None
        ab_f = ab.reshape(-1, 4).float()
        M = ab_f.shape[0]
        gt = gb.float()
        if gt.dim() == 2:
            gt = gt[None]
        B, G, _ = gt.shape
        valid_g = (gt[..., 2] > gt[..., 0]) & (gt[..., 3] > gt[..., 1])
        if crowd is not None:
            valid_g = valid_g & (crowd.reshape(B, -1) == 0)
        if info is None:
            inside = torch.ones((1, M), dtype=torch.bool, device=gt.device)
        else:
            th = rpn_straddle_thresh
            inside = ((ab_f[None, :, 0] >= -th) & (ab_f[None, :, 1] >= -th)
                      & (ab_f[None, :, 2] < info[:, 1:2] + th)
                      & (ab_f[None, :, 3] < info[:, 0:1] + th))
        iou = _pairwise_iou(gt, ab_f[None])                 # [B, G, M]
        iou = torch.where(valid_g[..., None] & inside[:, None, :], iou, -1.0)
        best_iou, best_g = torch.max(iou, dim=1)
        fg = (best_iou >= rpn_positive_overlap) & inside
        fg = fg | (_force_lattice(iou, valid_g) & inside)
        bg = (best_iou < rpn_negative_overlap) & ~fg & inside
        max_fg = int(rpn_batch_size_per_im * rpn_fg_fraction)
        fg = fg & (torch.cumsum(fg.int(), 1) - 1 < max_fg)
        n_fg = fg.int().sum(1, keepdim=True)
        bg = bg & (torch.cumsum(bg.int(), 1) - 1
                   < rpn_batch_size_per_im - n_fg)
        labels = torch.where(fg, 1, torch.where(bg, 0, -1)).to(torch.int32)
        enc = _box_delta_encode(ab_f[None].expand(B, M, 4),
                                _gather_gt(gt, best_g))
        enc = torch.where(fg[..., None], enc, 0.0)
        return labels, enc, fg, bg
    args = ([anchor_box, gt_boxes]
            + ([is_crowd] if is_crowd is not None else [])
            + ([im_info] if im_info is not None else []))
    return _nondiff(_rta, *args, _name="rpn_target_assign")


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    """EAST's locality-aware NMS: boxes that overlap above the threshold
    merge by a weighted average (weights: each box's best foreground
    score) in one symmetric pass, as the reference does (not the C++ op's
    sequential chain), then :func:`multiclass_nms`."""
    def _merge(bb, sc):
        bb = bb.float()
        s = sc.float()
        if 0 <= background_label < s.shape[1]:
            s = s.clone()
            s[:, background_label] = 0.0
        w = torch.amax(s, dim=1)                            # [B, N]
        iou = _pairwise_iou(bb, bb)
        wmat = torch.where(iou > nms_threshold, w[:, None, :], 0.0)
        wsum = torch.sum(wmat, -1, keepdim=True)
        return torch.matmul(wmat, bb) / torch.clamp(wsum, min=1e-10)
    merged = _nondiff(_merge, bboxes, scores, _name="lanms_merge")
    return multiclass_nms(merged, scores, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, nms_eta=nms_eta,
                          background_label=background_label)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=True, rois_num=None,
                             name=None):
    """Route each RoI to its FPN level, floor(log2(sqrt(area) /
    refer_scale) + refer_level) clipped to [min_level, max_level].
    fpn_rois [N, 4] (rows past ``sum(rois_num)`` are padding).  Returns
    (multi_rois: a [N, 4] a level, its RoIs first in input order, zeros
    after; restore_ind [N, 1] into the levels' concatenation, padding
    pointing at the last (zero) slot) and with ``rois_num`` the counts a
    level."""
    num_lvl = max_level - min_level + 1

    def _dist(rois, *rest):
        N = rois.shape[0]
        dev = rois.device
        ar = torch.arange(N, device=dev)
        n_valid = rest[0].sum() if rest else N
        valid = ar < n_valid
        w = rois[:, 2] - rois[:, 0]
        h = rois[:, 3] - rois[:, 1]
        area = (w + 1.0) * (h + 1.0) if pixel_offset else w * h
        scale = torch.sqrt(torch.clamp(area, min=0.0))
        lvl = torch.floor(torch.log2(scale / refer_scale + 1e-6)
                          + refer_level)
        lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
        multi, counts = [], []
        pos = torch.full((N,), -1, dtype=torch.int64, device=dev)
        for li, L in enumerate(range(min_level, max_level + 1)):
            sel = (lvl == L) & valid
            order = torch.argsort(torch.where(sel, ar, N + ar))
            n_sel = sel.sum()
            multi.append(torch.where((ar < n_sel)[:, None], rois[order],
                                     0.0))
            counts.append(n_sel.to(torch.int32))
            pos = pos.scatter_reduce(0, order, torch.where(
                sel[order], ar + li * N, -1), reduce="amax")
        pos = torch.where(pos < 0, num_lvl * N - 1, pos).to(torch.int32)
        return (*multi, pos.reshape(N, 1), *counts)

    args = [fpn_rois] + ([rois_num] if rois_num is not None else [])
    out = _nondiff(_dist, *args, _name="distribute_fpn_proposals")
    multi_rois = list(out[:num_lvl])
    restore_ind = out[num_lvl]
    if rois_num is not None:
        return multi_rois, restore_ind, list(out[num_lvl + 1:])
    return multi_rois, restore_ind


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None,
                          name=None):
    """Concatenate the levels' RoIs and keep the ``post_nms_top_n`` best
    by score (ties: the earlier row).  Each level is [Ni, 4] RoIs and
    [Ni] (or [Ni, 1]) scores, ``rois_num_per_level`` marking its valid
    prefix.  Returns fpn_rois [post_nms_top_n, 4] (zero padding) and,
    with counts given, the count [1]."""
    num_lvl = max_level - min_level + 1
    assert len(multi_rois) == num_lvl and len(multi_scores) == num_lvl

    def _collect(*flat):
        rois = flat[:num_lvl]
        scores = flat[num_lvl:2 * num_lvl]
        nums = flat[2 * num_lvl:]
        parts_r, parts_s = [], []
        for i in range(num_lvl):
            r = rois[i].reshape(-1, 4)
            s = scores[i].reshape(-1).float()
            if nums:
                v = torch.arange(r.shape[0], device=r.device) < nums[i]
                s = torch.where(v, s, NEG)
            parts_r.append(r)
            parts_s.append(s)
        allr = torch.cat(parts_r, 0)
        alls = torch.cat(parts_s, 0)
        K = min(post_nms_top_n, allr.shape[0])
        top_s, top_i = torch.sort(alls, descending=True, stable=True)
        top_s, top_i = top_s[:K], top_i[:K]
        valid = top_s > -1e8
        out = torch.where(valid[:, None], allr[top_i], 0.0)
        if K < post_nms_top_n:
            out = TF.pad(out, (0, 0, 0, post_nms_top_n - K))
        return out, valid.sum(dtype=torch.int32).reshape(1)

    args = list(multi_rois) + list(multi_scores) + (
        list(rois_num_per_level) if rois_num_per_level is not None else [])
    out, num = _nondiff(_collect, *args, _name="collect_fpn_proposals")
    if rois_num_per_level is not None:
        return out, num
    return out


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    """RetinaNet training targets, dense: (score_pred, loc_pred (the
    inputs passed through), target_label [B, M] int32 (the gt's class on
    positives, 0 negatives, -1 ignored), target_bbox [B, M, 4],
    bbox_inside_weight [B, M, 4], fg_num [B, 1] = positives + 1).  An
    anchor is positive when it is a valid gt's best anchor or its best IoU
    is at least ``positive_overlap``; crowd gts take no part."""
    def _assign(ab, gb, gl, *rest):
        crowd = rest[0] if rest else None
        ab_f = ab.reshape(-1, 4).float()
        M = ab_f.shape[0]
        gt = gb.float()
        if gt.dim() == 2:
            gt = gt[None]
        B, G, _ = gt.shape
        lbl = (gl if gl.dim() >= 2 else gl[None]).reshape(B, -1)
        valid_g = (gt[..., 2] > gt[..., 0]) & (gt[..., 3] > gt[..., 1])
        if crowd is not None:
            valid_g = valid_g & ((crowd if crowd.dim() >= 2 else crowd[None])
                                 .reshape(B, -1) == 0)
        iou = _pairwise_iou(gt, ab_f[None])
        iou = torch.where(valid_g[..., None], iou, -1.0)
        best_iou, best_g = torch.max(iou, dim=1)
        best_a = torch.argmax(iou, dim=2)
        force = torch.zeros((B, M), dtype=torch.int32,
                            device=gt.device).scatter_reduce(
            1, best_a, valid_g.int(), reduce="amax") > 0
        fg = (best_iou >= positive_overlap) | force
        bg = (best_iou < negative_overlap) & ~fg
        labels = torch.where(fg, torch.gather(lbl, 1, best_g).to(torch.int32),
                             torch.where(bg, 0, -1).to(torch.int32))
        enc = _box_delta_encode(ab_f[None].expand(B, M, 4),
                                _gather_gt(gt, best_g))
        enc = torch.where(fg[..., None], enc, 0.0)
        inside_w = fg[..., None].float().expand(B, M, 4).contiguous()
        return (labels, enc, inside_w,
                (fg.int().sum(1, dtype=torch.int32) + 1).reshape(-1, 1))

    args = [anchor_box, gt_boxes, gt_labels] + (
        [is_crowd] if is_crowd is not None else [])
    labels, enc, iw, fg_num = _nondiff(_assign, *args,
                                       _name="retinanet_target_assign")
    return cls_logits, bbox_pred, labels, enc, iw, fg_num


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """RetinaNet's inference head: each FPN level's ``nms_top_k`` best
    (anchor, class) scores over the threshold (the last level without
    it), their anchors' deltas decoded (+1 pixel, / im_scale, clipped),
    then per-class NMS over the merged levels.  bboxes: [B, Mi, 4] a
    level; scores: [B, Mi, C] (activated); anchors: [Mi, 4]; im_info
    [B, 3].  Returns [B, min(keep_top_k, C Nc), 6] rows, label -1 on
    padding."""
    L = len(bboxes)

    def _detect(info, *flat):
        bxs, scs, ancs = flat[:L], flat[L:2 * L], flat[2 * L:]
        B = info.shape[0]
        C = scs[0].shape[-1]
        inf = info.float()
        scale = inf[:, 2:3]
        im_h = torch.round(inf[:, 0:1] / scale)
        im_w = torch.round(inf[:, 1:2] / scale)
        zero = torch.zeros((), device=info.device)
        cand_boxes, cand_scores, cand_cls = [], [], []
        for li in range(L):
            d = bxs[li].float()                             # [B, Mi, 4]
            s = scs[li].float()                             # [B, Mi, C]
            a = ancs[li].float()                            # [Mi, 4]
            Mi = d.shape[1]
            flat_s = s.reshape(B, -1)
            if li < L - 1:
                flat_s = torch.where(flat_s > score_threshold, flat_s, NEG)
            K = min(nms_top_k, Mi * C)
            top_s, top_i = torch.sort(flat_s, dim=1, descending=True,
                                      stable=True)
            top_s, top_i = top_s[:, :K], top_i[:, :K]
            ai = top_i // C
            ci = top_i % C
            aa = a[ai]                                      # [B, K, 4]
            aw = aa[..., 2] - aa[..., 0] + 1.0
            ah = aa[..., 3] - aa[..., 1] + 1.0
            acx = aa[..., 0] + aw * 0.5
            acy = aa[..., 1] + ah * 0.5
            dd = _rows(d, ai)
            cx = dd[..., 0] * aw + acx
            cy = dd[..., 1] * ah + acy
            w = torch.exp(dd[..., 2]) * aw
            h = torch.exp(dd[..., 3]) * ah
            cand_boxes.append(torch.stack([
                torch.clamp((cx - w * 0.5) / scale, zero, im_w - 1),
                torch.clamp((cy - h * 0.5) / scale, zero, im_h - 1),
                torch.clamp((cx + w * 0.5 - 1.0) / scale, zero, im_w - 1),
                torch.clamp((cy + h * 0.5 - 1.0) / scale, zero, im_h - 1)],
                -1))
            cand_scores.append(top_s)
            cand_cls.append(ci)
        boxes = torch.cat(cand_boxes, 1)                    # [B, Nc, 4]
        sc = torch.cat(cand_scores, 1)
        cls = torch.cat(cand_cls, 1)
        Nc = boxes.shape[1]
        dense = torch.full((B, C, Nc), NEG, device=info.device).scatter(
            1, cls[:, None, :], torch.where(sc > -1e8, sc, NEG)[:, None, :])
        keep = _nms_keep(dense.reshape(B * C, Nc),
                         boxes[:, None].expand(B, C, Nc, 4).reshape(
                             B * C, Nc, 4),
                         nms_threshold, nms_top_k, eta=nms_eta)
        keep = keep.reshape(B, C, Nc) & (dense > -1e8)
        flat = torch.where(keep, dense, NEG).reshape(B, C * Nc)
        top = _desc(flat)[:, :keep_top_k]
        idx = top % Nc
        valid = torch.gather(flat, 1, top) > -1e8
        return torch.cat([
            torch.where(valid, (top // Nc).float(), -1.0)[..., None],
            torch.where(valid, torch.gather(flat, 1, top), 0.0)[..., None],
            torch.where(valid[..., None], _rows(boxes, idx), 0.0)], -1)

    args = [im_info] + list(bboxes) + list(scores) + list(anchors)
    return _nondiff(_detect, *args, _name="retinanet_detection_output")


def _quad_mask(px, py, qx, qy):
    """Is (px, py) [R, th, tw] inside or on the quad (qx, qy) [R, 4]? A
    crossing-number ray cast with a 1e-4 edge tolerance."""
    inside = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    on_edge = torch.zeros_like(inside)
    for i in range(4):
        xs, ys = qx[:, i, None, None], qy[:, i, None, None]
        xe, ye = qx[:, (i + 1) % 4, None, None], qy[:, (i + 1) % 4, None,
                                                    None]
        flat_edge = torch.abs(ys - ye) < 1e-4
        on_flat = ((torch.abs(py - ys) < 1e-4) & (torch.abs(py - ye) < 1e-4)
                   & (px >= torch.minimum(xs, xe) - 1e-4)
                   & (px <= torch.maximum(xs, xe) + 1e-4))
        ix = (py - ys) * (xe - xs) / torch.where(flat_edge, 1.0,
                                                 ye - ys) + xs
        on_slant = ((torch.abs(ix - px) < 1e-4)
                    & (py >= torch.minimum(ys, ye) - 1e-4)
                    & (py <= torch.maximum(ys, ye) + 1e-4))
        on_edge = on_edge | torch.where(flat_edge, on_flat, on_slant)
        crosses = ((ys > py) != (ye > py)) & (
            px < (xe - xs) * (py - ys)
            / torch.where(torch.abs(ye - ys) < 1e-12, 1e-12, ye - ys) + xs)
        inside = inside ^ crosses
    return inside | on_edge


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_num=None, name=None):
    """Warp each quadrilateral RoI to a th x tw rectangle (EAST / OCR).
    input [N, C, H, W]; rois [R, 8] (x1, y1, ..., x4, y4) clockwise from
    the top left; ``rois_num`` [N] the RoIs of each image in turn (default:
    all on image 0).  Returns (out [R, C, th, tw], mask [R, 1, th, tw]
    int32, transform_matrix [R, 9]): the reference's matrix (normalised
    width from the estimated aspect, 1e-5 in the denominators) and
    bilinear samples inside the quad, zero elsewhere."""
    th_, tw_ = int(transformed_height), int(transformed_width)

    def _rpt(x, r, *rest):
        N, C, H, W = x.shape
        R = r.shape[0]
        dev = x.device
        r = r.detach()
        if rest:
            ends = torch.cumsum(rest[0].detach().to(torch.int32), 0)
            img_of = torch.sum(torch.arange(R, device=dev)[:, None]
                               >= ends[None, :], -1)
            img_of = torch.clamp(img_of, 0, N - 1)
        else:
            img_of = torch.zeros((R,), dtype=torch.int64, device=dev)
        rs = r.float() * spatial_scale
        rx, ry = rs[:, 0::2], rs[:, 1::2]
        len1 = torch.hypot(rx[:, 0] - rx[:, 1], ry[:, 0] - ry[:, 1])
        len2 = torch.hypot(rx[:, 1] - rx[:, 2], ry[:, 1] - ry[:, 2])
        len3 = torch.hypot(rx[:, 2] - rx[:, 3], ry[:, 2] - ry[:, 3])
        len4 = torch.hypot(rx[:, 3] - rx[:, 0], ry[:, 3] - ry[:, 0])
        est_h = (len2 + len4) / 2.0
        est_w = (len1 + len3) / 2.0
        norm_h = max(2, th_)
        norm_w = torch.round(est_w * (norm_h - 1)
                             / torch.clamp(est_h, min=1e-6)) + 1.0
        norm_w = torch.clamp(norm_w, 2.0, float(tw_))
        dx1 = rx[:, 1] - rx[:, 2]
        dx2 = rx[:, 3] - rx[:, 2]
        dx3 = rx[:, 0] - rx[:, 1] + rx[:, 2] - rx[:, 3]
        dy1 = ry[:, 1] - ry[:, 2]
        dy2 = ry[:, 3] - ry[:, 2]
        dy3 = ry[:, 0] - ry[:, 1] + ry[:, 2] - ry[:, 3]
        den = dx1 * dy2 - dx2 * dy1 + 1e-5
        m6 = (dx3 * dy2 - dx2 * dy3) / den / (norm_w - 1)
        m7 = (dx1 * dy3 - dx3 * dy1) / den / (norm_h - 1)
        m8 = torch.ones_like(m6)
        m3 = (ry[:, 1] - ry[:, 0] + m6 * (norm_w - 1) * ry[:, 1]) \
            / (norm_w - 1)
        m4 = (ry[:, 3] - ry[:, 0] + m7 * (norm_h - 1) * ry[:, 3]) \
            / (norm_h - 1)
        m5 = ry[:, 0]
        m0 = (rx[:, 1] - rx[:, 0] + m6 * (norm_w - 1) * rx[:, 1]) \
            / (norm_w - 1)
        m1 = (rx[:, 3] - rx[:, 0] + m7 * (norm_h - 1) * rx[:, 3]) \
            / (norm_h - 1)
        m2 = rx[:, 0]
        mat = torch.stack([m0, m1, m2, m3, m4, m5, m6, m7, m8], -1)
        ov, ou = torch.meshgrid(torch.arange(th_, dtype=torch.float32,
                                             device=dev),
                                torch.arange(tw_, dtype=torch.float32,
                                             device=dev), indexing="ij")
        m = [mat[:, i, None, None] for i in range(9)]
        u = m[0] * ou + m[1] * ov + m[2]
        v = m[3] * ou + m[4] * ov + m[5]
        wq = m[6] * ou + m[7] * ov + m[8]
        in_w = u / wq                                       # [R, th, tw]
        in_h = v / wq
        in_bounds = ((in_w > -0.5) & (in_w < W - 0.5)
                     & (in_h > -0.5) & (in_h < H - 0.5))
        mask = _quad_mask(in_w, in_h, rx, ry) & in_bounds
        x0 = torch.floor(in_w)
        y0 = torch.floor(in_h)
        lw = in_w - x0
        lh = in_h - y0
        feats = x[img_of].reshape(R, C, H * W)

        def gather(yy, xx):
            ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            yc = torch.clamp(yy, 0, H - 1).long()
            xc = torch.clamp(xx, 0, W - 1).long()
            g = torch.gather(feats, 2, (yc * W + xc).reshape(R, 1, -1)
                             .expand(R, C, th_ * tw_)).reshape(R, C, th_,
                                                               tw_)
            return torch.where(ok[:, None], g, 0.0)

        val = (gather(y0, x0) * ((1 - lw) * (1 - lh))[:, None]
               + gather(y0, x0 + 1) * (lw * (1 - lh))[:, None]
               + gather(y0 + 1, x0) * ((1 - lw) * lh)[:, None]
               + gather(y0 + 1, x0 + 1) * (lw * lh)[:, None])
        out = torch.where(mask[:, None], val, 0.0)
        return out.to(x.dtype), mask[:, None].to(torch.int32), mat

    args = [input, rois] + ([rois_num] if rois_num is not None else [])
    out, mask, mat = call(_rpt, *args, _name="roi_perspective_transform")
    mask.stop_gradient = mat.stop_gradient = True
    return out, mask, mat


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False,
                             max_overlap=None, return_max_overlap=False):
    """Fast R-CNN's second-stage sampling, dense and batched: the gts
    (first) and the proposals are the candidates; fg at max IoU >=
    ``fg_thresh`` (capped at fraction x S unless cascade), bg in
    [bg_thresh_lo, bg_thresh_hi); fg rows first, then bg, each in input
    order, in S = ``batch_size_per_im`` slots (label -1 unfilled); per
    class regression targets divided by ``bbox_reg_weights``.  rpn_rois
    [B, N, 4], gt_classes [B, G], is_crowd [B, G], gt_boxes [B, G, 4]
    (zero-area rows are padding).  Returns (rois [B, S, 4], labels [B, S]
    int32, bbox_targets, bbox_inside_weights, bbox_outside_weights
    [B, S, 4C][, max_overlap [B, S]]).  Cascade mode needs
    ``max_overlap`` [B, N]: RoIs at overlap >= 1 or of no size drop out,
    and nothing is subsampled."""
    C = 2 if is_cls_agnostic else int(class_nums)
    S = int(batch_size_per_im)
    max_fg = int(batch_size_per_im * fg_fraction)
    if is_cascade_rcnn and max_overlap is None:
        raise ValueError("generate_proposal_labels: max_overlap must be "
                         "given when is_cascade_rcnn=True (reference "
                         "contract)")

    def _gpl(rois_in, gcls, crowd, gbox, *rest):
        rois = rois_in.float()
        gt = gbox.float()
        B, N, _ = rois.shape
        G = gt.shape[1]
        dev = rois.device
        rw = torch.tensor(bbox_reg_weights, dtype=torch.float32, device=dev)
        pad_g = ~((gt[..., 2] > gt[..., 0]) & (gt[..., 3] > gt[..., 1]))
        if is_cascade_rcnn:
            roi_ok = ((rois[..., 2] - rois[..., 0] + 1 > 0)
                      & (rois[..., 3] - rois[..., 1] + 1 > 0)
                      & (rest[0].float() < 1.0))
        else:
            roi_ok = torch.ones((B, N), dtype=torch.bool, device=dev)
        cand = torch.cat([gt, rois], 1)                     # [B, M, 4]
        cand_ok = torch.cat([~pad_g, roi_ok], 1)
        M = G + N
        iou = _pairwise_iou(gt, cand)
        iou = torch.where(pad_g[..., None], -1.0, iou)
        best, best_g = torch.max(iou, dim=1)
        bad = torch.cat([(crowd.reshape(B, -1) != 0) | pad_g,
                         torch.zeros((B, N), dtype=torch.bool, device=dev)],
                        1) | ~cand_ok
        best = torch.where(bad, -1.0, best)
        best = torch.where(~bad & (best < 0), 0.0, best)
        fg = best >= fg_thresh
        bg = (best >= bg_thresh_lo) & (best < bg_thresh_hi) & ~fg
        if not is_cascade_rcnn:
            fg = fg & (torch.cumsum(fg.int(), 1) - 1 < max_fg)
        n_fg = fg.int().sum(1, keepdim=True)
        bg = bg & (torch.cumsum(bg.int(), 1) - 1
                   < S - torch.clamp(n_fg, max=S))
        prio = torch.where(fg, 0, torch.where(bg, 1, 2))
        order = torch.argsort(prio * M + torch.arange(M, device=dev), dim=1)
        if S <= M:
            order = order[:, :S]
            real = torch.ones((S,), dtype=torch.bool, device=dev)
        else:
            order = torch.cat([order, order.new_zeros(B, S - M)], 1)
            real = torch.arange(S, device=dev) < M
        sel_fg = torch.gather(fg, 1, order) & real
        sel_bg = torch.gather(bg, 1, order) & real
        filled = sel_fg | sel_bg
        sel_rois = torch.where(filled[..., None], _rows(cand, order), 0.0)
        g_sel = torch.gather(best_g, 1, order)
        lbl_fg = torch.gather(gcls.reshape(B, -1), 1, g_sel).to(torch.int32)
        if is_cls_agnostic:
            lbl_fg = torch.ones_like(lbl_fg)
        labels = torch.where(sel_fg, lbl_fg, torch.where(sel_bg, 0, -1)
                             .to(torch.int32))
        enc = _box_delta_encode(sel_rois, _gather_gt(gt, g_sel)) / rw
        onehot = TF.one_hot(torch.clamp(labels, 0, C - 1).long(), C).float()
        onehot = onehot * sel_fg[..., None].float()         # [B, S, C]
        bbox_targets = (onehot[..., None] * enc[..., None, :]).reshape(
            B, S, 4 * C)
        inside_w = (onehot[..., None] * torch.ones((1, 1, 1, 4), device=dev)
                    ).reshape(B, S, 4 * C)
        return (sel_rois, labels, bbox_targets, inside_w, inside_w,
                torch.where(filled, torch.gather(best, 1, order), 0.0))

    args = [rpn_rois, gt_classes, is_crowd, gt_boxes] + (
        [max_overlap] if max_overlap is not None else [])
    out = _nondiff(_gpl, *args, _name="generate_proposal_labels")
    return out if return_max_overlap else out[:5]
