# Copied from paddle_tpu/vision/mask_labels.py (host-side numpy Mask R-CNN mask targets), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""Mask-RCNN mask-target generation — host-side numpy.

ref: python/paddle/fluid/layers/detection.py:2748 (generate_mask_labels),
paddle/fluid/operators/detection/generate_mask_labels_op.cc,
paddle/fluid/operators/detection/mask_util.cc.

The reference registers this as a CPU-only kernel (GetExpectedKernelType
pins CPUPlace) — mask-target assembly is inherently ragged host-side
preprocessing, so the TPU-native form keeps it in numpy on the host: run
it in the input pipeline (DataLoader worker / py_reader source) and feed
the fixed-shape results to the device step.  Polygon rasterization
reproduces the COCO RLE scheme the reference's mask_util.cc implements
(5x upsampled boundary trace, downsample to x-column crossings,
column-major run-length decode), so targets match the reference bit-for-
bit on the same inputs.

Ragged ground-truth segmentation format (replaces the reference's
3-level LoD): per image, ``gt_segms[i]`` is a list over gt objects, each
object a list of polygons, each polygon a flat [x0, y0, x1, y1, ...]
coordinate list in original-image scale.
"""
from __future__ import annotations

import math

import numpy as np


def _poly_to_mask(xy, h, w):
    """Rasterize one polygon (flat xy list, mask-grid coords) to an
    h x w uint8 mask — COCO rleFrPoly semantics (mask_util.cc:42)."""
    scale = 5.0
    k = len(xy) // 2
    if k == 0:
        return np.zeros((h, w), np.uint8)
    px = [int(scale * xy[2 * j] + .5) for j in range(k)]
    py = [int(scale * xy[2 * j + 1] + .5) for j in range(k)]
    px.append(px[0])
    py.append(py[0])

    # trace every edge at the upsampled resolution
    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = px[j], px[j + 1], py[j], py[j + 1]
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = 0.0 if dx == 0 else (ye - ys) / dx
            for d in range(dx + 1):
                t = dx - d if flip else d
                us.append(t + xs)
                vs.append(int(ys + s * t + .5))
        else:
            s = 0.0 if dy == 0 else (xe - xs) / dy
            for d in range(dy + 1):
                t = dy - d if flip else d
                vs.append(t + ys)
                us.append(int(xs + s * t + .5))

    # keep the x-column crossings, downsampled back to grid resolution
    cols, rows = [], []
    for j in range(1, len(us)):
        if us[j] == us[j - 1]:
            continue
        xd = float(us[j] if us[j] < us[j - 1] else us[j] - 1)
        xd = (xd + .5) / scale - .5
        if math.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(vs[j] if vs[j] < vs[j - 1] else vs[j - 1])
        yd = (yd + .5) / scale - .5
        yd = min(max(yd, 0.0), float(h))
        cols.append(int(xd))
        rows.append(int(math.ceil(yd)))

    # column-major run-length decode between crossings
    a = sorted(c * h + r for c, r in zip(cols, rows))
    a.append(h * w)
    runs, prev = [], 0
    for t in a:
        runs.append(t - prev)
        prev = t
    merged = [runs[0]]
    j = 1
    while j < len(runs):
        if runs[j] > 0:
            merged.append(runs[j])
            j += 1
        else:
            j += 1
            if j < len(runs):
                merged[-1] += runs[j]
                j += 1
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in merged:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T        # runs are column-major (x*h + y)


def _polys_to_mask_wrt_box(polygons, box, M):
    """Union of polygons rasterized relative to `box` at M x M
    (mask_util.cc:183 Polys2MaskWrtBox)."""
    w = max(box[2] - box[0], 1.0)
    h = max(box[3] - box[1], 1.0)
    mask = np.zeros((M, M), np.uint8)
    for poly in polygons:
        p = []
        for j in range(len(poly) // 2):
            p.append((poly[2 * j] - box[0]) * M / w)
            p.append((poly[2 * j + 1] - box[1]) * M / h)
        mask |= _poly_to_mask(p, M, M)
    return mask


def _poly_bbox(polys):
    """Tight bbox over all of one object's polygon points
    (mask_util.cc:159 Poly2Boxes)."""
    pts = np.concatenate([np.asarray(p, np.float32).reshape(-1, 2)
                          for p in polys], axis=0)
    return np.array([pts[:, 0].min(), pts[:, 1].min(),
                     pts[:, 0].max(), pts[:, 1].max()], np.float32)


def _bbox_overlaps(a, b):
    """Pairwise IoU with the +1 pixel convention (bbox_util.h:99)."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    x0 = np.maximum(a[:, None, 0], b[None, :, 0])
    y0 = np.maximum(a[:, None, 1], b[None, :, 1])
    x1 = np.minimum(a[:, None, 2], b[None, :, 2])
    y1 = np.minimum(a[:, None, 3], b[None, :, 3])
    iw = np.maximum(x1 - x0 + 1, 0)
    ih = np.maximum(y1 - y0 + 1, 0)
    inter = iw * ih
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(inter > 0,
                       inter / (area_a[:, None] + area_b[None, :] - inter),
                       0.0)
    return iou


def _sample_one_image(im_scale, gt_classes, is_crowd, gt_segms, rois,
                      labels_int32, num_classes, resolution):
    """generate_mask_labels_op.cc SampleMaskForOneImage."""
    M = int(resolution)
    gt_classes = np.asarray(gt_classes, np.int64).reshape(-1)
    is_crowd = np.asarray(is_crowd, np.int64).reshape(-1)
    rois = np.asarray(rois, np.float32).reshape(-1, 4)
    labels = np.asarray(labels_int32, np.int64).reshape(-1)
    if rois.shape[0] != labels.shape[0]:
        raise ValueError("rois and labels_int32 must have equal length")

    # fg gts keep their polygons; crowds and background are skipped
    gt_polys = [gt_segms[i] for i in range(len(gt_classes))
                if gt_classes[i] > 0 and is_crowd[i] == 0]
    fg_inds = np.flatnonzero(labels > 0)

    if rois.shape[0] == 0:
        # zero proposals for this image: emit zero rows consistently
        # (the reference's bg fallback would desync rois vs masks here)
        return (np.zeros((0, 4), np.float32), np.zeros((0, 1), np.int32),
                np.zeros((0, num_classes * M * M), np.int32))

    if fg_inds.size > 0 and gt_polys:
        poly_boxes = np.stack([_poly_bbox(p) for p in gt_polys])
        rois_fg = rois[fg_inds] / im_scale
        cls_fg = labels[fg_inds]
        best_gt = np.argmax(_bbox_overlaps(rois_fg, poly_boxes), axis=1)
        masks = np.stack([
            _polys_to_mask_wrt_box(gt_polys[g], roi, M)
            for g, roi in zip(best_gt, rois_fg)]).reshape(len(fg_inds), -1)
        masks = masks.astype(np.int32)
        roi_has_mask = fg_inds.astype(np.int32)
        out_rois = rois_fg * im_scale
        out_cls = cls_fg
    else:
        # no fg: one bg roi with an all-ignore (-1) mask, class 0
        # (the reference's "network cannot handle empty blobs" fallback)
        bg = np.flatnonzero(labels == 0)
        roi_has_mask = (bg[:1] if bg.size else np.zeros(1, np.int64)
                        ).astype(np.int32)
        out_rois = rois[:1].copy()
        out_cls = np.zeros(1, np.int64)
        masks = np.full((1, M * M), -1, np.int32)

    # expand to class-specific targets: -1 everywhere except the fg
    # class's M*M slice (ExpandMaskTarget)
    P = masks.shape[0]
    expanded = np.full((P, num_classes * M * M), -1, np.int32)
    for i in range(P):
        c = int(out_cls[i])
        if c > 0:
            expanded[i, c * M * M:(c + 1) * M * M] = masks[i]
    return (out_rois.astype(np.float32), roi_has_mask.reshape(-1, 1),
            expanded)


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution):
    """Per-image mask targets for the Mask-RCNN mask head.

    Host-side numpy (matches the reference's CPU-pinned kernel).  Inputs
    are per-image lists (the ragged replacement of the reference's LoD):

      im_info        [B, 3] array ([height, width, scale] rows)
      gt_classes     list of [G_i] int arrays
      is_crowd       list of [G_i] int arrays
      gt_segms       list (images) of lists (objects) of lists (polygons)
                     of flat [x0, y0, ...] coords at original-image scale
      rois           list of [R_i, 4] float arrays (image-scale boxes)
      labels_int32   list of [R_i] int arrays (RoI class labels)

    Returns ``(mask_rois, roi_has_mask_int32, mask_int32, lod)``: the
    first three concatenated over images ([P, 4] float32, [P, 1] int32
    indices into each image's roi list, [P, K*M*M] int32 targets with -1
    outside the fg class slice), and ``lod`` the per-image row counts
    (the reference returns the same splits as output LoD).
    """
    def _np(x):
        return x.numpy() if hasattr(x, "numpy") else x

    im_info = np.asarray(_np(im_info), np.float32).reshape(-1, 3)
    gt_classes = [_np(g) for g in gt_classes]
    is_crowd = [_np(c) for c in is_crowd]
    rois = [_np(r) for r in rois]
    labels_int32 = [_np(l) for l in labels_int32]
    B = im_info.shape[0]
    if not (len(gt_classes) == len(is_crowd) == len(gt_segms)
            == len(rois) == len(labels_int32) == B):
        raise ValueError("generate_mask_labels: all inputs must cover the "
                         f"same {B} images")
    out_r, out_idx, out_m, lod = [], [], [], []
    for i in range(B):
        r, idx, m = _sample_one_image(
            float(im_info[i, 2]), gt_classes[i], is_crowd[i], gt_segms[i],
            rois[i], labels_int32[i], int(num_classes), int(resolution))
        out_r.append(r)
        out_idx.append(idx)
        out_m.append(m)
        lod.append(r.shape[0])
    return (np.concatenate(out_r, axis=0),
            np.concatenate(out_idx, axis=0),
            np.concatenate(out_m, axis=0),
            np.asarray(lod, np.int64))
