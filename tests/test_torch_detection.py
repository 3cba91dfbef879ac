"""The port's one-stage detection family against the JAX package, on the
CPU: priors and anchors, the box maths, matching, NMS (``multiclass_nms``
with ``return_index``, ``matrix_nms``), ``ssd_loss`` with its gradients,
``multi_box_head`` (dygraph and a static program) and
``fluid.layers.detection_output``.

Inputs are drawn with numpy and go to both packages.  Floating outputs
agree at rtol 1e-5, atol 1e-5 (fp32, sums in another order); indices,
labels, counts and kept rows exactly, on tie sets too (quantised
scores, duplicated boxes, the -1e9 padded slots), and under the adaptive
``nms_eta``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.vision import detection as JD
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.vision import detection as TD

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


def _outs(out):
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res += _outs(o)
        return res
    return [_np(out)]


def _both(name, arrays, grads=(), **kw):
    """``name`` of both detection modules on the same numpy ``arrays``
    (None passes through); returns (reference, port) output lists, with
    the gradients of sum(first output * g) for the inputs in ``grads``."""
    res = []
    g = None
    for mod, D in ((P, JD), (pt, TD)):
        ts = [None if a is None else mod.to_tensor(
            a, stop_gradient=i not in grads) for i, a in enumerate(arrays)]
        out = getattr(D, name)(*ts, **kw)
        got = _outs(out)
        if grads:
            first = out[0] if isinstance(out, (tuple, list)) else out
            if g is None:
                g = np.asarray(np.random.RandomState(3).randn(
                    *got[0].shape), np.float32)
            (first * mod.to_tensor(g)).sum().backward()
            got += [_np(ts[i].grad) for i in grads]
        res.append(got)
    return res


def _close(ref, got, tol=TOL):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape, (r.shape, g.shape)
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, **tol)
        else:
            np.testing.assert_array_equal(g, r)


def _boxes(rng, *shape, scale=1.0, lo=0.02, hi=0.4):
    """Random xyxy boxes [*shape, 4] inside [0, scale]."""
    xy = rng.uniform(0, 0.6, shape + (2,))
    wh = rng.uniform(lo, hi, shape + (2,))
    return (np.concatenate([xy, xy + wh], -1) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# priors and anchors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(min_sizes=[60.0], max_sizes=[150.0], aspect_ratios=[2.0, 3.0],
         flip=True),
    dict(min_sizes=[60.0, 90.0], max_sizes=[], aspect_ratios=[2.0],
         flip=True, clip=True),
    dict(min_sizes=[30.0], max_sizes=None, aspect_ratios=[1.0, 2.0],
         steps=(8.0, 8.0), offset=0.25),
    dict(min_sizes=[60.0], max_sizes=[150.0], aspect_ratios=[2.0],
         flip=True, min_max_aspect_ratios_order=True),
], ids=["ssd", "empty_max_sizes", "steps", "minmax_order"])
def test_prior_box_matches_reference(kw):
    """``prior_box`` (an empty ``max_sizes`` adds no sqrt(min max) box,
    as (ap)'s first map passes it)."""
    feat, img = np.zeros((1, 8, 5, 6), np.float32), np.zeros(
        (1, 3, 300, 300), np.float32)
    ref, got = _both("prior_box", [feat, img], **kw)
    _close(ref, got, tol=dict(rtol=0, atol=0))
    if kw["max_sizes"] == []:
        assert got[0].shape[2] == 2 * 3


def test_density_prior_and_anchor_generator_match_reference():
    feat, img = np.zeros((1, 8, 4, 5), np.float32), np.zeros(
        (1, 3, 64, 80), np.float32)
    for flat in (False, True):
        ref, got = _both("density_prior_box", [feat, img],
                         densities=[2, 1], fixed_sizes=[16.0, 32.0],
                         fixed_ratios=[1.0, 2.0], clip=True,
                         flatten_to_2d=flat)
        _close(ref, got, tol=dict(rtol=0, atol=0))
    ref, got = _both("anchor_generator", [feat],
                     anchor_sizes=[32, 64, 128, 256, 512],
                     aspect_ratios=[0.5, 1.0, 2.0], stride=[16.0, 16.0])
    _close(ref, got, tol=dict(rtol=0, atol=0))


# --------------------------------------------------------------------------
# box maths
# --------------------------------------------------------------------------

def test_iou_box_clip_and_polygon_match_reference():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    _close(*_both("iou_similarity", [a, b]))
    boxes = _boxes(rng, 2, 6, scale=500.0) - 50.0
    for info in (np.array([[400, 300, 1.0], [600, 500, 1.5]], np.float32),
                 np.array([400, 300, 2.0], np.float32),
                 np.array([400, 300], np.float32)):
        _close(*_both("box_clip", [boxes, info]))
    _close(*_both("polygon_box_transform",
                  [rng.randn(2, 8, 3, 4).astype(np.float32)]))


@pytest.mark.parametrize("case", ["encode", "encode_novar", "decode0",
                                  "decode1", "decode2d", "unnormalized"])
def test_box_coder_matches_reference(case):
    rng = np.random.RandomState(1)
    pb = _boxes(rng, 6)
    pv = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (6, 1))
    if case.startswith("encode"):
        args = [pb, None if case == "encode_novar" else pv, _boxes(rng, 4)]
        kw = dict(code_type="encode_center_size")
    elif case == "decode0":
        args, kw = [pb, pv, rng.randn(3, 6, 4).astype(np.float32) * 0.5], {}
    elif case == "decode1":
        args = [_boxes(rng, 3), np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                        (3, 1)),
                rng.randn(3, 6, 4).astype(np.float32) * 0.5]
        kw = dict(axis=1)
    elif case == "decode2d":
        args, kw = [pb, pv, rng.randn(6, 4).astype(np.float32) * 0.5], {}
    else:
        args = [pb * 100, None, _boxes(rng, 4) * 100]
        kw = dict(code_type="encode_center_size", box_normalized=False)
    if not case.startswith("encode") and case != "unnormalized":
        kw["code_type"] = "decode_center_size"
    _close(*_both("box_coder", args, **kw))


# --------------------------------------------------------------------------
# matching
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "per_prediction",
                                  "zeros"])
def test_bipartite_match_matches_reference(case):
    """Greedy matching takes the first maximum of the flattened matrix:
    ``ties`` repeats values across rows and columns."""
    rng = np.random.RandomState(2)
    if case == "ties":
        d = rng.choice([0.0, 0.3, 0.6, 0.6, 0.9], (5, 8)).astype(np.float32)
    elif case == "zeros":
        d = np.zeros((3, 4), np.float32)
        d[1, 2] = 0.5
    else:
        d = rng.uniform(0, 1, (4, 9)).astype(np.float32)
    kw = dict(match_type="per_prediction", dist_threshold=0.3) \
        if case == "per_prediction" else {}
    ref, got = _both("bipartite_match", [d], **kw)
    assert got[0].dtype == np.int32
    _close(ref, got)


def test_target_assign_matches_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 3).astype(np.float32)
    mi = np.array([2, -1, 0, 4, -1, 1], np.int32)
    _close(*_both("target_assign", [x, mi], mismatch_value=-2))
    _close(*_both("target_assign", [x, mi, np.array([[1], [4]], np.int32)]))


# --------------------------------------------------------------------------
# NMS
# --------------------------------------------------------------------------

def _nms_inputs(rng, B=2, C=4, N=30, ties=False):
    boxes = _boxes(rng, B, N)
    if ties:
        h = N // 3
        boxes[:, h:2 * h] = boxes[:, :h]          # duplicates: IoU 1
        scores = rng.choice([0.05, 0.3, 0.3, 0.6, 0.9], (B, C, N))
    else:
        scores = rng.uniform(0, 1, (B, C, N))
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(), dict(ties=True), dict(ties=True, nms_top_k=7, keep_top_k=12),
    dict(nms_eta=0.7, nms_threshold=0.8), dict(ties=True, nms_eta=0.5,
                                               nms_threshold=0.9),
    dict(background_label=-1, keep_top_k=200, score_threshold=0.5),
    dict(N=3, keep_top_k=20),
], ids=["random", "ties", "ties_topk", "eta", "ties_eta", "no_bg_padded",
        "few_boxes"])
def test_multiclass_nms_matches_reference(case):
    """Rows and kept indices exactly equal (label -1 padding), on tie sets
    (quantised scores, duplicated boxes, the -1e9 padded slots), with
    ``nms_top_k`` cutting a tie set and under the adaptive ``nms_eta``."""
    case = dict(case)
    rng = np.random.RandomState(4)
    boxes, scores = _nms_inputs(rng, N=case.pop("N", 30),
                                ties=case.pop("ties", False))
    kw = dict(score_threshold=0.1, nms_top_k=400, keep_top_k=40,
              nms_threshold=0.4, return_index=True)
    kw.update(case)
    (r_rows, r_idx), (g_rows, g_idx) = _both("multiclass_nms",
                                             [boxes, scores], **kw)
    np.testing.assert_array_equal(g_idx, r_idx)
    np.testing.assert_array_equal(g_rows, r_rows)
    assert (g_rows[..., 0] >= 0).any() and g_idx.dtype == np.int32


@pytest.mark.parametrize("kw", [
    dict(), dict(use_gaussian=True, gaussian_sigma=2.0),
    dict(nms_top_k=5, post_threshold=0.2), dict(background_label=-1)],
    ids=["linear", "gaussian", "topk", "no_bg"])
def test_matrix_nms_matches_reference(kw):
    rng = np.random.RandomState(5)
    boxes, scores = _nms_inputs(rng, N=16, ties=True)
    _close(*_both("matrix_nms", [boxes, scores], score_threshold=0.1,
                  keep_top_k=25, **kw))
    _close(*_both("matrix_nms", [boxes, scores[:, :1]], score_threshold=0.1,
                  keep_top_k=5))


# --------------------------------------------------------------------------
# ssd_loss, multi_box_head, detection_output
# --------------------------------------------------------------------------

def _ssd_inputs(rng, B=3, N=40, C=5, G=4):
    priors = _boxes(rng, N)
    loc = rng.randn(B, N, 4).astype(np.float32) * 0.3
    conf = rng.randn(B, N, C).astype(np.float32)
    gt = _boxes(rng, B, G, lo=0.1, hi=0.5)
    gt[0, 2:] = 0.0                                  # padded gt rows
    lbl = rng.randint(1, C, (B, G)).astype(np.int64)
    return loc, conf, gt, lbl, priors


@pytest.mark.parametrize("kw", [
    dict(), dict(with_var=True, neg_pos_ratio=2.5, overlap_threshold=0.3),
    dict(normalize=False, sample_size=3, loc_loss_weight=0.5),
    dict(neg_overlap=0.2, background_label=0)],
    ids=["defaults", "variance", "unnormalized", "neg_overlap"])
def test_ssd_loss_matches_reference(kw):
    """The loss and its gradients with respect to the locations and the
    confidences."""
    kw = dict(kw)
    rng = np.random.RandomState(6)
    loc, conf, gt, lbl, priors = _ssd_inputs(rng)
    var = (np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (priors.shape[0], 1))
           if kw.pop("with_var", False) else None)
    ref, got = _both("ssd_loss", [loc, conf, gt, lbl, priors, var],
                     grads=(0, 1), **kw)
    _close(ref, got)


def test_ssd_loss_two_gts_with_one_best_prior():
    """Two gts whose best prior is the same: the force-match goes to the
    larger IoU (then the lower gt), not to a scatter's arbitrary order;
    and the hard negatives keep every tie at the threshold (equal
    confidences)."""
    priors = np.array([[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                       [0.0, 0.5, 0.5, 1.0], [0.5, 0.0, 1.0, 0.5],
                       [0.2, 0.2, 0.4, 0.4], [0.6, 0.6, 0.7, 0.7]],
                      np.float32)
    gt = np.array([[[0.0, 0.0, 0.45, 0.45], [0.05, 0.05, 0.5, 0.5],
                    [0.1, 0.1, 0.2, 0.2]],
                   [[0.0, 0.0, 0.45, 0.45], [0.0, 0.0, 0.45, 0.45],
                    [0.0, 0.0, 0.0, 0.0]]], np.float32)
    lbl = np.array([[1, 2, 3], [2, 1, 0]], np.int64)
    loc = np.zeros((2, 6, 4), np.float32)
    conf = np.zeros((2, 6, 4), np.float32)
    conf[:, :, 0] = 1.0                               # tied negatives
    for thr in (0.5, 0.95):
        ref, got = _both("ssd_loss", [loc, conf, gt, lbl, priors],
                         grads=(0, 1), overlap_threshold=thr)
        _close(ref, got)


def _head_program(mod, maps, kw):
    """multi_box_head in a static program: (main, startup, outputs)."""
    mod.enable_static()
    try:
        main, startup = mod.static.Program(), mod.static.Program()
        with mod.static.program_guard(main, startup):
            xs = [mod.static.data(f"m{i}", [None] + list(m.shape[1:]),
                                  "float32") for i, m in enumerate(maps)]
            im = mod.static.data("img", [None, 3, 60, 60], "float32")
            res = mod.static.nn.multi_box_head(xs, im, **kw)
    finally:
        mod.disable_static()
    return main, startup, list(res)


def _head_run(mod, prog, maps):
    main, _, res = prog
    feed = {f"m{i}": m for i, m in enumerate(maps)}
    feed["img"] = np.zeros((maps[0].shape[0], 3, 60, 60), np.float32)
    mod.enable_static()
    try:
        return [np.asarray(o) for o in
                mod.static.Executor().run(main, feed=feed, fetch_list=res)]
    finally:
        mod.disable_static()


@pytest.mark.parametrize("kw", [
    dict(base_size=60, num_classes=4, aspect_ratios=[[2.0], [2.0, 3.0],
                                                     [2.0]],
         min_sizes=[12.0, 24.0, 40.0], max_sizes=[[], 40.0, 55.0],
         flip=True, offset=0.5),
    dict(base_size=60, num_classes=3, aspect_ratios=[[2.0], [2.0], [2.0]],
         min_ratio=20, max_ratio=90, kernel_size=3, pad=1)],
    ids=["explicit", "schedule"])
def test_multi_box_head_matches_reference(kw):
    """``static.nn.multi_box_head`` in a static program of each package,
    the builder's conv weights carried across: the locations,
    confidences and priors at batch 1 (an empty ``max_sizes`` entry; the
    default ratio schedule when ``min_sizes`` is None).  The reference
    bakes the build's placeholder batch (1) into its reshapes; the port
    keeps the fed batch, so at batch 2 its outputs are the two images'
    batch-1 outputs stacked."""
    rng = np.random.RandomState(8)
    maps = [rng.randn(2, 8, s, s).astype(np.float32) for s in (5, 3, 1)]
    one = [m[:1] for m in maps]
    outs, params = [], None
    for mod in (P, pt):
        prog = _head_program(mod, maps, kw)
        mod.enable_static()
        try:
            mod.static.Executor().run(prog[1])
        finally:
            mod.disable_static()
        if params is None:
            params = [_np(p) for p in prog[0].all_parameters()]
        else:
            for p, v in zip(prog[0].all_parameters(), params):
                p.set_value(v)
        outs.append(_head_run(mod, prog, one))
    assert len(params) == 12             # 2 convs a map, weight and bias
    _close(*outs)
    two = _head_run(pt, prog, maps)
    per = [_head_run(pt, prog, [m[i:i + 1] for m in maps]) for i in (0, 1)]
    for j in (0, 1):
        assert two[j].shape[0] == 2
        np.testing.assert_allclose(two[j], np.concatenate(
            [per[0][j], per[1][j]]), **TOL)
    for j in (2, 3):
        np.testing.assert_array_equal(two[j], per[0][j])


def test_ssd_loss_and_detection_output_through_fluid():
    """``fluid.layers`` spells the family: ``ssd_loss``, and
    ``detection_output`` on softmaxed scores (decode, then
    ``multiclass_nms``; ``nms_eta`` is not passed on, as in the
    reference)."""
    rng = np.random.RandomState(9)
    loc, conf, gt, lbl, priors = _ssd_inputs(rng, C=4)
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (priors.shape[0], 1))
    sm = np.exp(conf) / np.exp(conf).sum(-1, keepdims=True)
    outs = []
    for mod in (P, pt):
        L = mod.fluid.layers
        T = mod.to_tensor
        loss = L.ssd_loss(T(loc), T(conf), T(gt), T(lbl), T(priors))
        det = L.detection_output(T(loc), T(sm), T(priors), T(var),
                                 nms_threshold=0.45, nms_top_k=20,
                                 keep_top_k=15, score_threshold=0.05,
                                 nms_eta=0.5)
        outs.append([_np(loss), _np(det)])
    _close(*outs)
    np.testing.assert_array_equal(outs[1][1][..., 0], outs[0][1][..., 0])
    for name in ("yolo_box", "yolov3_loss", "generate_proposal_labels",
                 "retinanet_detection_output", "box_clip"):
        assert callable(getattr(pt.fluid.layers, name))
    with pytest.raises(NotImplementedError, match="item 4"):
        pt.fluid.layers.fc
