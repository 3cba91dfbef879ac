"""The ``static.nn`` builders over the rest of ``nn`` against the JAX
package's, on the CPU: ``group_norm``, ``instance_norm``,
``spectral_norm``, ``bilinear_tensor_product``, ``data_norm``,
``row_conv``, ``nce`` (its negatives from a one-class ``custom_dist``,
so both packages draw the same ones), ``crf_decoding`` and the sixteen
``sequence_*`` ops.  Each runs in a static program in each package with
the same numpy parameters (in creation order) and feeds; the fetches
must match at 1e-5 of max|ref| (paths exactly).
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import core

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _program(m, build, feed, seed=0):
    m.enable_static()
    try:
        main, startup = m.static.Program(), m.static.Program()
        with m.static.program_guard(main, startup):
            fetch = build(m)
        rng = np.random.RandomState(seed)
        params = main.all_parameters()
        for p in params:
            p.set_value((0.3 * rng.standard_normal(tuple(p.shape))).astype(
                np.float32))
        out = m.static.Executor().run(main, feed=feed, fetch_list=fetch)
        return out, params
    finally:
        m.disable_static()


R = np.random.RandomState(12)
X4 = R.standard_normal((2, 4, 5, 5)).astype(np.float32)
SEQ = R.standard_normal((3, 6, 4)).astype(np.float32)
LENS = np.array([6, 2, 4], np.int32)
FLAT = R.standard_normal((12, 4)).astype(np.float32)
IDS = R.randint(0, 7, (3, 6)).astype(np.int32)
EMIS = R.standard_normal((3, 6, 5)).astype(np.float32)
LAB = R.randint(0, 9, (3, 1)).astype(np.int64)
W2 = R.standard_normal((3, 5)).astype(np.float32)


def _data(m, name, a):
    return m.static.data(name, list(a.shape), str(a.dtype))


def _seq(op, *extra):
    return (lambda m: [getattr(m.static.nn, op)(
        _data(m, "x", SEQ), _data(m, "n", LENS), *extra)],
        {"x": SEQ, "n": LENS})


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


BUILDERS = {
    "group_norm": (lambda m: [m.static.nn.group_norm(
        _data(m, "x", X4), 2, act="relu")], {"x": X4}),
    "instance_norm": (lambda m: [m.static.nn.instance_norm(
        _data(m, "x", X4))], {"x": X4}),
    "spectral_norm": (lambda m: [m.static.nn.spectral_norm(
        _data(m, "w", W2), 0, 2)], {"w": W2}),
    "bilinear_tensor_product": (lambda m: [
        m.static.nn.bilinear_tensor_product(
            _data(m, "a", W2), _data(m, "b", W2[:, :4].copy()), 3,
            act="tanh")], {"a": W2, "b": W2[:, :4].copy()}),
    "data_norm": (lambda m: [m.static.nn.data_norm(
        _data(m, "x", FLAT), act="sigmoid")],
        {"x": FLAT}),
    "row_conv": (lambda m: [m.static.nn.row_conv(_data(m, "x", SEQ), 2)],
                 {"x": SEQ}),
    "nce": (lambda m: [m.static.nn.nce(
        _data(m, "x", W2[:, :4].copy()), _data(m, "y", LAB), 9,
        num_neg_samples=3, custom_dist=[0, 0, 0, 0, 1, 0, 0, 0, 0])],
        {"x": W2[:, :4].copy(), "y": LAB}),
    "crf_decoding": (lambda m: [m.static.nn.crf_decoding(
        _data(m, "e", EMIS), m.static.nn.create_parameter([7, 5], "float32"),
        _data(m, "n", LENS))], {"e": EMIS, "n": LENS}),
    "crf_decoding:full": (lambda m: [m.static.nn.crf_decoding(
        _data(m, "e", EMIS), m.static.nn.create_parameter(
            [7, 5], "float32"))], {"e": EMIS}),
    "sequence_pad": (lambda m: [m.static.nn.sequence_pad(
        _data(m, "x", FLAT), _data(m, "n", LENS), 0.0, 6)],
        {"x": FLAT, "n": LENS}),
    "sequence_unpad": _seq("sequence_unpad"),
    "sequence_pool": _seq("sequence_pool", "max"),
    "sequence_softmax": (lambda m: [m.static.nn.sequence_softmax(
        _data(m, "x", SEQ[..., 0].copy()), _data(m, "n", LENS))],
        {"x": SEQ[..., 0].copy(), "n": LENS}),
    "sequence_reverse": _seq("sequence_reverse"),
    "sequence_expand": (lambda m: [m.static.nn.sequence_expand(
        _data(m, "x", W2), m.to_tensor(LENS))], {"x": W2}),
    "sequence_expand_as": (lambda m: [m.static.nn.sequence_expand_as(
        _data(m, "x", W2), _data(m, "n", LENS), 6)], {"x": W2, "n": LENS}),
    "sequence_concat": (lambda m: [_first(m.static.nn.sequence_concat(
        [_data(m, "x", SEQ), _data(m, "y", SEQ)],
        [m.to_tensor(LENS), m.to_tensor(LENS)]))], {"x": SEQ, "y": SEQ}),
    "sequence_enumerate": (lambda m: [m.static.nn.sequence_enumerate(
        _data(m, "i", IDS), 2)], {"i": IDS}),
    "sequence_erase": (lambda m: list(m.static.nn.sequence_erase(
        _data(m, "i", IDS), _data(m, "n", LENS), [3])),
        {"i": IDS, "n": LENS}),
    "sequence_conv": (lambda m: [m.static.nn.sequence_conv(
        _data(m, "x", SEQ), _data(m, "n", LENS),
        m.static.nn.create_parameter([12, 5], "float32"))],
        {"x": SEQ, "n": LENS}),
    "sequence_first_step": _seq("sequence_first_step"),
    "sequence_last_step": _seq("sequence_last_step"),
    "sequence_reshape": (lambda m: list(m.static.nn.sequence_reshape(
        _data(m, "x", SEQ), _data(m, "n", LENS), 8)), {"x": SEQ, "n": LENS}),
    "sequence_slice": (lambda m: list(m.static.nn.sequence_slice(
        _data(m, "x", SEQ), _data(m, "n", LENS),
        m.to_tensor(np.array([1, 0, 2], np.int32)),
        m.to_tensor(np.array([3, 2, 1], np.int32)))),
        {"x": SEQ, "n": LENS}),
    "sequence_scatter": (lambda m: [m.static.nn.sequence_scatter(
        _data(m, "x", W2), m.to_tensor(np.array(
            [[0, 4, 2], [1, 1, 3], [2, 0, 0]], np.int32)),
        _data(m, "u", W2[:, :3].copy()), m.to_tensor(np.array(
            [3, 2, 1], np.int32)))], {"x": W2, "u": W2[:, :3].copy()}),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_static_nn_builder_matches_reference(name):
    build, feed = BUILDERS[name]
    ref, rp = _program(P, build, feed)
    got, gp = _program(pt, build, feed)
    assert [tuple(p.shape) for p in gp] == [tuple(p.shape) for p in rp]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape, (g.shape, r.shape)
        if r.dtype.kind == "f":
            scale = max(float(np.abs(r).max()), 1e-30)
            np.testing.assert_allclose(g, r, rtol=0, atol=TOL * scale)
        else:
            np.testing.assert_array_equal(g, r)


def test_not_ported_holds_only_the_vision_ops():
    """Every builder is ported: the vision ops' two are the functions of
    ``vision.ops`` and ``vision.detection``, as in the reference."""
    assert pt.static.nn.NOT_PORTED == {}
    assert pt.static.nn.deform_conv2d is pt.vision.ops.deform_conv2d
    assert pt.static.nn.multi_box_head is \
        pt.vision.detection.multi_box_head
    for name in ("group_norm", "data_norm", "nce", "crf_decoding",
                 "sequence_pool", "sequence_scatter"):
        assert name not in pt.static.nn.NOT_PORTED
