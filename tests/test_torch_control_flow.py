"""The port's control flow (``static.cond``, ``while_loop``, ``case``,
``switch_case``) against the JAX package's, on the CPU: the cases of the
reference's ``tests/test_control_flow.py`` in eager mode (values and
gradients through the tape), under ``jit.to_static``, and recorded into
a static ``Program`` and replayed by the ``Executor``.  Every case runs
the same code and numpy inputs through both packages; outputs (and
gradients) must match at 1e-6 of max|ref|, integer outputs exactly.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import core

TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _np(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


# ---------------------------------------------------------------- eager ----

def cond_eager(m):
    x = m.to_tensor(3.0)
    return [m.static.cond(x > 2, lambda: x * 2, lambda: x - 1),
            m.static.cond(x > 5, lambda: x * 2, lambda: x - 1)]


def cond_eager_grad(m):
    x = m.to_tensor(3.0, stop_gradient=False)
    y = m.to_tensor(1.0, stop_gradient=False)
    out = m.static.cond(x > 0, lambda: x * x * y, lambda: y)
    return [out] + list(m.grad([out], [x, y], allow_unused=True))


def cond_eager_multi_output(m):
    x = m.to_tensor([1.0, 2.0])
    return list(m.static.cond(m.to_tensor(True), lambda: (x + 1, x * 2),
                              lambda: (x - 1, x / 2)))


def while_loop_eager(m):
    i = m.to_tensor(0)
    s = m.to_tensor(0.0)
    return m.static.while_loop(lambda i, s: i < 5,
                               lambda i, s: (i + 1, s + 2.0), [i, s])


def while_loop_eager_grad(m):
    x = m.to_tensor(2.0, stop_gradient=False)
    i = m.to_tensor(0)
    _, y = m.static.while_loop(lambda i, y: i < 3,
                               lambda i, y: (i + 1, y * x),
                               [i, m.to_tensor(1.0)])
    return [y] + list(m.grad([y], [x]))


def case_eager(m):
    x = m.to_tensor(1.0)
    a = m.static.case([(m.to_tensor(False), lambda: x + 1),
                       (m.to_tensor(True), lambda: x + 10)],
                      default=lambda: x - 100)
    b = m.static.case([(m.to_tensor(False), lambda: x + 1),
                       (m.to_tensor(False), lambda: x + 10)],
                      default=lambda: x - 100)
    return [a, b]


def switch_case_eager(m):
    x = m.to_tensor([1.0, 2.0])
    fns = [lambda: x + 1, lambda: x * 2, lambda: x * 3]
    return [m.static.switch_case(m.to_tensor(1), fns),
            m.static.switch_case(m.to_tensor(7), fns),
            m.static.switch_case(m.to_tensor(0), {0: lambda: x - 5,
                                                  3: lambda: x + 5})]


# --------------------------------------------------------------- traced ----

def cond_traced(m):
    class Net(m.nn.Layer):
        def forward(self, x):
            return m.static.cond(x.sum() > 0, lambda: x * 2, lambda: -x)
    net = m.jit.to_static(Net())
    return [net(m.to_tensor([1.0, 2.0])), net(m.to_tensor([-1.0, -2.0]))]


def while_loop_traced(m):
    class Net(m.nn.Layer):
        def forward(self, x):
            i = m.zeros([], "int32")
            _, y = m.static.while_loop(lambda i, y: i < 4,
                                       lambda i, y: (i + 1, y + x),
                                       [i, x * 0])
            return y
    return [m.jit.to_static(Net())(m.to_tensor([1.5, 2.5]))]


def switch_case_traced(m):
    class Net(m.nn.Layer):
        def forward(self, idx, x):
            return m.static.switch_case(idx, [lambda: x + 1, lambda: x * 10,
                                              lambda: x - 1])
    net = m.jit.to_static(Net())
    return [net(m.to_tensor(k), m.to_tensor(2.0)) for k in (0, 1, 2, 5)]


def case_traced(m):
    def fn(x):
        return m.static.case([(x.sum() > 10, lambda: x * 0),
                              (x.sum() > 0, lambda: x + 1)],
                             default=lambda: x - 1)
    sfn = m.jit.to_static(fn)
    return [sfn(m.to_tensor([1.0, 2.0])), sfn(m.to_tensor([-3.0, 1.0])),
            sfn(m.to_tensor([9.0, 3.0]))]


# ------------------------------------------------------- static program ----

def _static(m, build, feeds):
    """Build a program with ``build(m)`` (returns fetch vars), then run it
    once per feed dict; returns every fetch of every run."""
    m.enable_static()
    try:
        main, startup = m.static.Program(), m.static.Program()
        with m.static.program_guard(main, startup):
            fetch, params = build(m)
        rng = np.random.RandomState(0)
        for p in params:
            p.set_value(rng.standard_normal(tuple(p.shape)).astype(
                np.float32))
        exe = m.static.Executor()
        return [r for f in feeds
                for r in exe.run(main, feed=f, fetch_list=fetch)]
    finally:
        m.disable_static()


def _f(*v):
    return np.array(v, np.float32)


def cond_static(m):
    def build(m):
        x = m.static.data("x", [2], "float32")
        out = m.static.cond(x.sum() > 0, lambda: x * 2, lambda: -x)
        return [out], []
    return _static(m, build, [{"x": _f(1, 2)}, {"x": _f(-1, -2)}])


def while_loop_static(m):
    def build(m):
        x = m.static.data("x", [2], "float32")
        i = m.zeros([], "int32")
        acc = m.zeros([2], "float32")
        i_f, acc_f = m.static.while_loop(lambda i, a: i < 3,
                                         lambda i, a: (i + 1, a + x),
                                         [i, acc])
        return [i_f, acc_f], []
    return _static(m, build, [{"x": _f(1, 2)}, {"x": _f(0.5, -4)}])


def while_loop_static_fixed_point(m):
    """A few steps of a fixed-point iteration x <- cos(x) until the step
    is below a threshold or 50 steps ran."""
    def build(m):
        x = m.static.data("x", [3], "float32")
        i = m.zeros([], "int32")
        d = m.ones([], "float32")
        i_f, x_f, _ = m.static.while_loop(
            lambda i, x, d: m.logical_and(i < 50, d > 1e-4),
            lambda i, x, d: (i + 1, m.cos(x), m.max(m.abs(m.cos(x) - x))),
            [i, x, d])
        return [i_f, x_f], []
    return _static(m, build, [{"x": _f(0.1, 1.0, 2.0)}])


def switch_case_static(m):
    def build(m):
        idx = m.static.data("idx", [], "int64")
        x = m.static.data("x", [2], "float32")
        out = m.static.switch_case(idx, [lambda: x + 1, lambda: x * 10])
        return [out], []
    return _static(m, build, [{"idx": np.array(k, np.int64), "x": _f(1, 2)}
                              for k in (1, 0, 4)])


def case_static(m):
    def build(m):
        x = m.static.data("x", [2], "float32")
        out = m.static.case([(x.sum() > 10, lambda: x * 0),
                             (x.sum() > 0, lambda: x + 1)],
                            default=lambda: x - 1)
        return [out], []
    return _static(m, build, [{"x": _f(1, 2)}, {"x": _f(-3, 1)},
                              {"x": _f(9, 3)}])


def cond_static_passthrough(m):
    def build(m):
        x = m.static.data("x", [2], "float32")
        y = m.static.data("y", [2], "float32")
        out = m.static.cond(x.sum() > 0, lambda: x, lambda: y)
        z = x + 1.0          # reads the fed x, not the cond's output
        return [out, z], []
    return _static(m, build, [{"x": _f(1, 2), "y": _f(5, 6)},
                              {"x": _f(-1, -2), "y": _f(5, 6)}])


def while_loop_static_passthrough(m):
    def build(m):
        x = m.static.data("x", [2], "float32")
        i = m.zeros([], "int32")
        _, x_same = m.static.while_loop(lambda i, a: i < 3,
                                        lambda i, a: (i + 1, a), [i, x])
        return [x_same, x * 10.0], []
    return _static(m, build, [{"x": _f(1, 2)}])


def cond_static_chained(m):
    def build(m):
        x = m.static.data("x", [2], "float32")
        y = m.static.data("y", [2], "float32")
        out = m.static.cond(x.sum() > 0, lambda: x, lambda: y)
        res = m.static.cond(x.sum() > 100, lambda: out * 0.0,
                            lambda: out + 1.0)
        return [res], []
    return _static(m, build, [{"x": _f(1, 2), "y": _f(5, 6)},
                              {"x": _f(-1, -2), "y": _f(5, 6)}])


def cond_static_parameter(m):
    def build(m):
        x = m.static.data("x", [2], "float32")
        lin = m.nn.Linear(2, 2)
        out = m.static.cond(x.sum() > 0, lambda: lin(x), lambda: x)
        return [out], [lin.weight, lin.bias]
    return _static(m, build, [{"x": _f(1, 1)}, {"x": _f(-1, -1)}])


def cond_static_gradients(m):
    """``static.gradients`` of a cond's output with respect to its feed,
    through the branch each feed takes."""
    def build(m):
        x = m.static.data("x", [2], "float32")
        x.stop_gradient = False
        out = m.static.cond(x.sum() > 0, lambda: x * x, lambda: x * 3.0)
        g, = m.static.gradients([out], [x])
        return [out, g], []
    return _static(m, build, [{"x": _f(1, 2)}, {"x": _f(-1, -2)}])


CASES = [cond_eager, cond_eager_grad, cond_eager_multi_output,
         while_loop_eager, while_loop_eager_grad, case_eager,
         switch_case_eager, cond_traced, while_loop_traced,
         switch_case_traced, case_traced, cond_static, while_loop_static,
         while_loop_static_fixed_point, switch_case_static, case_static,
         cond_static_passthrough, while_loop_static_passthrough,
         cond_static_chained, cond_static_parameter, cond_static_gradients]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_control_flow_matches_reference(case):
    ref = [_np(x) for x in case(P)]
    got = [_np(x) for x in case(pt)]
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (case.__name__, k, g.shape, r.shape)
        if r.dtype.kind == "f":
            scale = max(float(np.abs(r).max()), 1e-30)
            np.testing.assert_allclose(g, r, rtol=0, atol=TOL * scale,
                                       err_msg=f"{case.__name__} {k}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=case.__name__)


def test_cond_checks_branch_structure():
    x = pt.to_tensor([1.0])
    pt.enable_static()
    try:
        with pt.static.program_guard(pt.static.Program()):
            with pytest.raises(ValueError):
                pt.static.cond(x.sum() > 0, lambda: (x, x), lambda: x)
    finally:
        pt.disable_static()
    with pytest.raises(ValueError):
        pt.static.while_loop(lambda i: i < 1, lambda i: i + 1, [])
    with pytest.raises(TypeError):
        pt.static.case([(x.sum() > 0, 3)])
