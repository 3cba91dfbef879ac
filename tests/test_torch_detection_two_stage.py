"""The port's two-stage detection family and ``vision.ops`` against the
JAX package, on the CPU: ``generate_proposals`` (tie sets included),
the RPN / RetinaNet target assigners, ``locality_aware_nms``, the FPN
routing pair, ``retinanet_detection_output``,
``roi_perspective_transform``, ``generate_proposal_labels`` (cascade
too), ``yolo_box``, ``yolo_loss`` and ``deform_conv2d`` (v1 and v2, the
``DeformConv2D`` layer) with their gradients.

Floating outputs agree at rtol 1e-5, atol 1e-5 (``yolo_loss`` and the
deformable convolution's gradients at 1e-4 of their largest value, as
sums over the grid in another order); indices, labels and counts
exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.vision import detection as JD
from paddle_tpu.vision import ops as JO
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.vision import detection as TD
from paddle_tpu_torch.vision import ops as TO

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev, threads = core._state.expected_place, torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    core._state.expected_place = prev
    torch.set_num_threads(threads)


def _np(t):
    return np.asarray(t.numpy())


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [_np(out)]


def _both(name, arrays, grads=(), ops=False, **kw):
    """``name`` of both packages' detection (or ``ops``) modules on the
    same numpy ``arrays`` (lists pass as lists of tensors); with
    ``grads``, the inputs' gradients of sum(first output * g)."""
    res, g = [], None
    for mod, M in (((P, JO), (pt, TO)) if ops else ((P, JD), (pt, TD))):
        def conv(a, i):
            if a is None:
                return None
            if isinstance(a, list):
                return [mod.to_tensor(v) for v in a]
            return mod.to_tensor(a, stop_gradient=i not in grads)
        ts = [conv(a, i) for i, a in enumerate(arrays)]
        out = getattr(M, name)(*ts, **kw)
        got = _flat(out)
        if grads:
            first = out[0] if isinstance(out, (tuple, list)) else out
            if g is None:
                g = np.asarray(np.random.RandomState(3).randn(
                    *got[0].shape), np.float32)
            (first * mod.to_tensor(g)).sum().backward()
            got += [_np(ts[i].grad) for i in grads]
        res.append(got)
    return res


def _close(ref, got, tol=TOL, rel=None):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape, (r.shape, g.shape)
        if r.dtype.kind != "f":
            np.testing.assert_array_equal(g, r)
        elif rel is not None:
            scale = max(float(np.abs(r).max()), 1e-30)
            np.testing.assert_allclose(g, r, rtol=0, atol=rel * scale)
        else:
            np.testing.assert_allclose(g, r, **tol)


def _boxes(rng, *shape, scale=1.0, lo=0.02, hi=0.4):
    xy = rng.uniform(0, 0.6, shape + (2,))
    wh = rng.uniform(lo, hi, shape + (2,))
    return (np.concatenate([xy, xy + wh], -1) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# proposals and targets
# --------------------------------------------------------------------------

def _rpn_inputs(rng, N=2, A=3, H=5, W=6, ties=False):
    anchors = np.asarray(JD.anchor_generator(
        P.zeros([1, 4, H, W]), anchor_sizes=[16, 32, 64],
        aspect_ratios=[1.0], stride=[16.0, 16.0])[0].numpy())
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (H, W, A, 1))
    if ties:
        scores = rng.choice([0.2, 0.5, 0.5, 0.8], (N, A, H, W))
    else:
        scores = rng.uniform(0, 1, (N, A, H, W))
    deltas = rng.randn(N, 4 * A, H, W) * 0.2
    info = np.array([[H * 16, W * 16, 1.0], [H * 16 - 9, W * 16, 1.5]][:N],
                    np.float32)
    return (scores.astype(np.float32), deltas.astype(np.float32), info,
            anchors, var)


@pytest.mark.parametrize("kw", [
    dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.5),
    dict(ties=True, pre_nms_top_n=40, post_nms_top_n=30, nms_thresh=0.6),
    dict(pre_nms_top_n=500, post_nms_top_n=200, min_size=8.0)],
    ids=["default", "ties", "padded"])
def test_generate_proposals_matches_reference(kw):
    """RoIs, probabilities and counts; ``ties`` quantises the scores so
    the pre-NMS cut and the NMS rank among equal scores, ``padded`` asks
    for more than the anchors give."""
    kw = dict(kw)
    rng = np.random.RandomState(10)
    args = list(_rpn_inputs(rng, ties=kw.pop("ties", False)))
    ref, got = _both("generate_proposals", args, return_rois_num=True, **kw)
    _close(ref, got)
    assert got[2].dtype == np.int32 and got[2].max() > 0


@pytest.mark.parametrize("case", ["plain", "crowd_info"])
def test_rpn_target_assign_matches_reference(case):
    rng = np.random.RandomState(11)
    anchors = _boxes(rng, 60, scale=100.0)
    gt = _boxes(rng, 2, 4, scale=100.0, lo=0.1, hi=0.4)
    gt[1, 3] = 0.0
    args = [None, None, anchors, None, gt]
    kw = dict(rpn_batch_size_per_im=16, rpn_positive_overlap=0.5,
              rpn_negative_overlap=0.3)
    if case == "crowd_info":
        args += [np.array([[0, 1, 0, 0], [0, 0, 0, 0]], np.int32),
                 np.array([[90.0, 80.0, 1.0], [70.0, 100.0, 1.0]],
                          np.float32)]
    _close(*_both("rpn_target_assign", args, **kw))


def test_retinanet_target_assign_matches_reference():
    rng = np.random.RandomState(12)
    anchors = _boxes(rng, 50, scale=100.0)
    gt = _boxes(rng, 2, 3, scale=100.0, lo=0.1, hi=0.4)
    gt[0, 2] = 0.0
    lbl = rng.randint(1, 5, (2, 3)).astype(np.int32)
    crowd = np.array([[0, 0, 0], [1, 0, 0]], np.int32)
    for c in (None, crowd):
        args = [np.zeros((2, 50, 4), np.float32),
                np.zeros((2, 50, 4), np.float32), anchors, None, gt, lbl, c,
                None]
        _close(*_both("retinanet_target_assign", args, num_classes=4))


def test_locality_aware_nms_matches_reference():
    rng = np.random.RandomState(13)
    base = _boxes(rng, 2, 6, scale=100.0)
    boxes = np.concatenate([base, base + rng.uniform(-2, 2, base.shape)
                            .astype(np.float32)], 1)
    scores = rng.uniform(0, 1, (2, 1, 12)).astype(np.float32)
    _close(*_both("locality_aware_nms", [boxes, scores],
                  score_threshold=0.1, nms_top_k=10, keep_top_k=8,
                  nms_threshold=0.3))


def test_fpn_distribute_and_collect_match_reference():
    rng = np.random.RandomState(14)
    rois = _boxes(rng, 20, scale=600.0, lo=0.01, hi=0.6)
    rois[17:] = 0.0
    for num in (None, np.array([17], np.int32)):
        res = []
        for mod, D in ((P, JD), (pt, TD)):
            res.append(_flat(D.distribute_fpn_proposals(
                mod.to_tensor(rois), 2, 5, 4, 224, rois_num=None
                if num is None else mod.to_tensor(num))))
        _close(*res)
    lv_r = [_boxes(rng, n, scale=300.0) for n in (6, 4, 3)]
    lv_s = [rng.choice([0.3, 0.6, 0.9], (n,)).astype(np.float32)
            for n in (6, 4, 3)]
    nums = [np.int32(5), np.int32(4), np.int32(2)]
    for counts in (None, nums):
        res = []
        for mod, D in ((P, JD), (pt, TD)):
            T = mod.to_tensor
            out = D.collect_fpn_proposals(
                [T(r) for r in lv_r], [T(s) for s in lv_s], 2, 4, 10,
                rois_num_per_level=None if counts is None else
                [T(c) for c in counts])
            res.append(_flat(out))
        _close(*res)


def test_retinanet_detection_output_matches_reference():
    rng = np.random.RandomState(15)
    L, C = 2, 3
    Ms = (12, 5)
    deltas = [rng.randn(2, m, 4).astype(np.float32) * 0.2 for m in Ms]
    scores = [rng.choice([0.02, 0.3, 0.3, 0.7], (2, m, C)).astype(
        np.float32) for m in Ms]
    anchors = [_boxes(rng, m, scale=120.0) for m in Ms]
    info = np.array([[120, 120, 1.0], [100, 90, 0.8]], np.float32)
    res = []
    for mod, D in ((P, JD), (pt, TD)):
        T = mod.to_tensor
        res.append(_flat(D.retinanet_detection_output(
            [T(d) for d in deltas], [T(s) for s in scores],
            [T(a) for a in anchors], T(info), score_threshold=0.05,
            nms_top_k=8, keep_top_k=12, nms_threshold=0.4)))
    _close(*res)


def test_roi_perspective_transform_matches_reference():
    rng = np.random.RandomState(16)
    x = rng.randn(2, 3, 12, 14).astype(np.float32)
    quads = np.array([[1, 1, 9, 2, 10, 8, 2, 7], [3, 2, 12, 3, 11, 10, 2, 9],
                      [0, 0, 13, 0, 13, 11, 0, 11]], np.float32)
    for num in (None, np.array([1, 2], np.int32)):
        res = []
        for mod, D in ((P, JD), (pt, TD)):
            xt = mod.to_tensor(x, stop_gradient=False)
            out = D.roi_perspective_transform(
                xt, mod.to_tensor(quads), 5, 7, spatial_scale=1.0,
                rois_num=None if num is None else mod.to_tensor(num))
            out[0].sum().backward()
            res.append(_flat(out) + [_np(xt.grad)])
        _close(*res)


@pytest.mark.parametrize("case", ["default", "agnostic", "cascade",
                                  "small"])
def test_generate_proposal_labels_matches_reference(case):
    rng = np.random.RandomState(17)
    rois = _boxes(rng, 2, 30, scale=100.0)
    gt = _boxes(rng, 2, 3, scale=100.0, lo=0.1, hi=0.4)
    gt[1, 2] = 0.0
    rois[:, :6] = gt[:, [0, 0, 1, 1, 2, 2]] + rng.uniform(
        -3, 3, (2, 6, 4)).astype(np.float32)
    cls = rng.randint(1, 4, (2, 3)).astype(np.int32)
    crowd = np.array([[0, 0, 1], [0, 0, 0]], np.int32)
    info = np.array([[100, 100, 1.0]] * 2, np.float32)
    kw = dict(batch_size_per_im=16, fg_fraction=0.25, class_nums=4,
              fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0)
    args = [rois, cls, crowd, gt, info]
    if case == "agnostic":
        kw["is_cls_agnostic"] = True
    elif case == "cascade":
        kw.update(is_cascade_rcnn=True, return_max_overlap=True,
                  max_overlap=None)
        mo = rng.uniform(0, 1, (2, 30)).astype(np.float32)
        mo[:, :2] = 1.0
        res = []
        for mod, D in ((P, JD), (pt, TD)):
            T = mod.to_tensor
            kw["max_overlap"] = T(mo)
            res.append(_flat(D.generate_proposal_labels(
                *[T(a) for a in args], **kw)))
        _close(*res)
        return
    elif case == "small":
        kw["batch_size_per_im"] = 64
    _close(*_both("generate_proposal_labels", args, **kw))


# --------------------------------------------------------------------------
# vision.ops
# --------------------------------------------------------------------------

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


def _yolo_inputs(rng, N=2, B=5, H=4, W=5, cls=3, S=3):
    x = rng.randn(N, S * (5 + cls), H, W).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.1, 0.9, (N, B, 2)),
                         rng.uniform(0.05, 0.5, (N, B, 2))], -1)
    gt[0, -1] = 0.0
    lbl = rng.randint(0, cls, (N, B)).astype(np.int32)
    return x, gt.astype(np.float32), lbl


@pytest.mark.parametrize("kw", [dict(), dict(clip_bbox=False,
                                             scale_x_y=1.05)],
                         ids=["default", "scale_xy"])
def test_yolo_box_matches_reference(kw):
    rng = np.random.RandomState(18)
    x, _, _ = _yolo_inputs(rng)
    size = np.array([[128, 160], [100, 90]], np.int32)
    _close(*_both("yolo_box", [x, size], ops=True, anchors=ANCHORS[:6],
                  class_num=3, conf_thresh=0.3, downsample_ratio=32, **kw))


@pytest.mark.parametrize("kw", [
    dict(), dict(use_label_smooth=False), dict(gt_score=True),
    dict(scale_x_y=1.1, ignore_thresh=0.3)],
    ids=["smooth", "no_smooth", "gt_score", "scale_xy"])
def test_yolo_loss_matches_reference(kw):
    """The per-image loss [N] and the head's gradient; label smoothing
    and ``gt_score`` change the result."""
    kw = dict(kw)
    rng = np.random.RandomState(19)
    x, gt, lbl = _yolo_inputs(rng)
    score = (rng.uniform(0.3, 1, lbl.shape).astype(np.float32)
             if kw.pop("gt_score", False) else None)
    kw.setdefault("ignore_thresh", 0.5)
    res, g = [], np.float32([0.7, -1.3])
    for mod, O in ((P, JO), (pt, TO)):
        T = mod.to_tensor
        xt = T(x, stop_gradient=False)
        out = O.yolo_loss(xt, T(gt), T(lbl), anchors=ANCHORS,
                          anchor_mask=[3, 4, 5], class_num=3,
                          downsample_ratio=16,
                          gt_score=None if score is None else T(score), **kw)
        (out * T(g)).sum().backward()
        res.append([_np(out), _np(xt.grad)])
    assert res[1][0].shape == (2,)
    _close(*res, rel=1e-5)


@pytest.mark.parametrize("case", ["v1", "v2", "groups", "stride_dil"])
def test_deform_conv2d_matches_reference(case):
    """Outputs and the gradients of x, offset, weight (and mask): samples
    outside the image read zero, offsets that land on integers included."""
    rng = np.random.RandomState(20)
    N, Cin, H, W, Cout, k = 2, 4, 7, 6, 6, 3
    kw = dict(padding=1)
    dg, groups = 1, 1
    if case == "groups":
        dg, groups = 2, 2
    if case == "stride_dil":
        kw = dict(stride=2, padding=2, dilation=2)
    x = rng.randn(N, Cin, H, W).astype(np.float32)
    s, p = kw.get("stride", 1), kw["padding"]
    d = kw.get("dilation", 1)
    Ho = (H + 2 * p - (d * (k - 1) + 1)) // s + 1
    Wo = (W + 2 * p - (d * (k - 1) + 1)) // s + 1
    off = (rng.randn(N, 2 * dg * k * k, Ho, Wo) * 1.5).astype(np.float32)
    off[:, :4] = np.round(off[:, :4])
    w = rng.randn(Cout, Cin // groups, k, k).astype(np.float32) * 0.3
    b = rng.randn(Cout).astype(np.float32)
    args = [x, off, w, b]
    grads = (0, 1, 2)
    if case != "v1":
        mask = rng.uniform(0, 1, (N, dg * k * k, Ho, Wo)).astype(np.float32)
        kw["mask"] = None
        res = []
        for mod, O in ((P, JO), (pt, TO)):
            ts = [mod.to_tensor(a, stop_gradient=False) for a in args]
            m = mod.to_tensor(mask, stop_gradient=False)
            out = O.deform_conv2d(*ts, mask=m, deformable_groups=dg,
                                  groups=groups, **{k_: v for k_, v in
                                                    kw.items()
                                                    if k_ != "mask"})
            out.sum().backward()
            res.append([_np(out)] + [_np(t.grad) for t in ts + [m]])
        _close(*res, rel=1e-5)
        return
    _close(*_both("deform_conv2d", args, grads=grads, ops=True, **kw),
           rel=1e-5)


def test_deform_conv2d_layer_matches_reference():
    """``DeformConv2D``: the reference's parameter names and shapes; its
    weights carried across; the forward with a mask."""
    rng = np.random.RandomState(21)
    ref = P.vision.ops.DeformConv2D(4, 5, 3, padding=1)
    got = pt.vision.ops.DeformConv2D(4, 5, 3, padding=1)
    rsd = ref.state_dict()
    assert list(rsd) == list(got.state_dict())
    got.set_state_dict({k: _np(v) for k, v in rsd.items()})
    x = rng.randn(1, 4, 5, 5).astype(np.float32)
    off = rng.randn(1, 18, 5, 5).astype(np.float32)
    mask = rng.uniform(0, 1, (1, 9, 5, 5)).astype(np.float32)
    outs = [_np(m(mod.to_tensor(x), mod.to_tensor(off), mod.to_tensor(mask)))
            for mod, m in ((P, ref), (pt, got))]
    _close([outs[0]], [outs[1]])
