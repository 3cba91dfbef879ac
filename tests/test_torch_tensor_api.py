"""The port's eager tensor API (``paddle_tpu_torch.*`` ops, the Tensor's
methods and operators) against the JAX package's, op by op, on the CPU.

Every case draws its inputs from a numpy ``RandomState`` seeded by the
case's name, so no result depends on the order in which tests run; the
same arrays go through ``paddle_tpu`` and ``paddle_tpu_torch`` and the
outputs must have the reference's shapes and dtypes (x64 off: index and
count outputs int32), float values within 1e-5 of max|ref| (1e-4 for
linear algebra, as the reference's own linalg tests), integer, bool
and index values exact.  Decompositions whose factors are defined up to
signs or order (``svd``, ``eigh``, ``eig``) are compared through their
values and reconstructions.  Each differentiable case also holds the
gradient of sum(out * w), w drawn from the seed, against
``paddle_tpu.grad`` at 1e-5 of max|ref grad|.  The reference computes a
case's outputs and gradients from one forward, sixteen cases to one XLA
compile where they trace (``tests/op_reference.py``).

The coverage guards hold every public name of the reference's nine
tensor modules, every public Tensor method and dunder, and the
top-level dtypes and switches, against the port; the random ops, whose
JAX draws cannot be reproduced, are held in shape, dtype, range,
seeding and moments instead, and static mode and ``auto_cast`` through
a few of the new ops.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.tensor import (attribute as r_attr, creation as r_cre,
                               linalg as r_lin, logic as r_log,
                               manipulation as r_man, math as r_math,
                               random as r_rand, search as r_search,
                               stat as r_stat)
from paddle_tpu_torch.framework import core
from tools.op_sweep import (RANDOM_CASES, TENSOR_API_NAMES, TENSOR_CASES,
                            TOL, R, _seed,
                            arrays, check, check_draw, check_grads, flat,
                            grads, run)

import op_reference


@pytest.fixture(autouse=True)
def _cpu():
    """The CPU as the default place, restored after."""
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


CASES = TENSOR_CASES
GRAD_CASES = [c for c in CASES if c.grad]
# the reference's outputs and gradients of every case, from one forward
# each, shared by the value and the gradient test of a case
_reference = op_reference.lazy(CASES)


def test_case_names_unique():
    names = [c.name for c in CASES]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_op_matches_reference(case):
    _, got = run(pt, case, arrays(case))
    check(_reference(case)[0], flat(got), case.tol, case.name)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c.name for c in GRAD_CASES])
def test_grad_matches_reference(case):
    check_grads(_reference(case)[1], grads(pt, case, arrays(case)), TOL,
                case.name)


# --------------------------------------------------------------------------
# coverage guards
# --------------------------------------------------------------------------

REF_MODULES = (r_cre, r_math, r_man, r_log, r_search, r_stat, r_lin, r_rand,
               r_attr)
# names of the reference's modules that are imports, not its functions
_NOT_OPS = {"annotations", "call", "Tensor", "to_tensor"}


def _public(mod):
    import inspect
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and callable(v)
                  and not inspect.isclass(v) and not inspect.ismodule(v)
                  and n not in _NOT_OPS
                  and getattr(v, "__module__", "").startswith("paddle_tpu."))


REF_NAMES = sorted({n for m in REF_MODULES for n in _public(m)})


def test_every_reference_tensor_function_is_ported():
    missing = [n for n in REF_NAMES if not callable(getattr(pt, n, None))]
    assert not missing, missing
    assert len(REF_NAMES) >= 240
    # the card sweep (chip_smoke.py (ad)) reads the list from op_sweep
    assert tuple(REF_NAMES) == TENSOR_API_NAMES


# the ops held in value by the cases above (the random ops by the tests
# below)
_COVERED_BY_RANDOM = {"bernoulli", "check_shape", "exponential_",
                      "multinomial", "normal", "normal_", "poisson", "rand",
                      "randint", "randint_like", "randn", "randperm",
                      "shuffle", "standard_normal", "uniform", "uniform_"}


def test_every_reference_tensor_function_is_held_in_value():
    held = {c.name.split(":")[0] for c in CASES}
    missing = [n for n in REF_NAMES
               if n not in held and n not in _COVERED_BY_RANDOM]
    assert not missing, missing


def test_every_reference_tensor_method_is_bound():
    ref = [n for n in dir(P.Tensor) if not n.startswith("_")]
    missing = [n for n in ref if not hasattr(pt.Tensor, n)]
    assert not missing, missing
    assert len(ref) >= 250


def test_every_reference_dunder_is_bound():
    ref = [n for n in dir(P.Tensor) if n.startswith("__")
           and getattr(P.Tensor, n) is not getattr(object, n, None)
           and n not in ("__doc__", "__module__", "__slots__", "__weakref__",
                         "__init_subclass__", "__subclasshook__",
                         "__dict__")]
    missing = [n for n in ref if getattr(pt.Tensor, n, None) is None
               or getattr(pt.Tensor, n) is getattr(object, n, None)]
    assert not missing, missing


def test_tensor_modules_and_op_tables_import_neither_jax_nor_paddle_tpu():
    """The new tensor and nn modules and ``tools/op_sweep.py`` (which
    ``chip_smoke.py`` imports on the card), in a fresh interpreter, leave
    ``jax`` and ``paddle_tpu`` out of ``sys.modules``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "from paddle_tpu_torch.tensor import (attribute, creation, linalg, "
        "logic, manipulation, math, random, search, stat)\n"
        "from paddle_tpu_torch.nn.functional import activation, loss\n"
        "from paddle_tpu_torch.nn.layer import activation as a2, loss as l2\n"
        "from tools import op_sweep\n"
        "bad = [k for k in ('jax', 'jaxlib', 'paddle_tpu') if k in sys.modules]\n"
        "bad += [k for k in sys.modules if k.startswith(('jax.', 'paddle_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    p = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_top_level_dtypes_and_switches():
    for n in ("float16 bfloat16 float32 float64 int8 int16 int32 int64 "
              "uint8 bool complex64 complex128").split():
        assert str(getattr(pt, n)).replace("torch.", "") == str(
            getattr(P, n)), n
    x = pt.to_tensor(np.ones(2, np.float32))
    assert x.dtype == pt.float32
    assert pt.arange(3).dtype == pt.int32
    for n in ("enable_grad", "set_grad_enabled", "is_grad_enabled",
              "get_rng_state", "set_rng_state", "set_default_dtype",
              "get_default_dtype", "create_array", "array_write",
              "array_read", "array_length", "Parameter", "Tensor", "linalg",
              "inverse", "shape", "rank"):
        assert hasattr(pt, n), n
    assert pt.tensor.__name__ == "paddle_tpu_torch.tensor"
    assert pt.is_grad_enabled()
    with pt.set_grad_enabled(False):
        assert not pt.is_grad_enabled()
        with pt.enable_grad():
            assert pt.is_grad_enabled()
    assert pt.get_default_dtype() == torch.float32


def test_default_dtype_switch():
    try:
        pt.set_default_dtype("bfloat16")
        P.set_default_dtype("bfloat16")
        for m in (P, pt):
            assert "bfloat16" in str(m.full([2], 1).dtype)
            assert "bfloat16" in str(m.to_tensor([1.5]).dtype)
    finally:
        pt.set_default_dtype("float32")
        P.set_default_dtype("float32")


def test_tensor_arrays():
    for m in (P, pt):
        arr = m.create_array("float32")
        x = m.to_tensor(np.ones(2, np.float32))
        m.array_write(x, m.to_tensor(np.array(2, np.int32)), arr)
        assert len(arr) == 3 and arr[0] is None
        assert m.array_read(arr, 2) is x
        n = m.array_length(arr)
        assert int(n) == 3 and "int32" in str(n.dtype)


# --------------------------------------------------------------------------
# __setitem__ and the in-place APIs: the gradient the reference gives
# --------------------------------------------------------------------------

def _setitem_grads(m):
    rng = R(7)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    x = m.to_tensor(a, stop_gradient=False)
    v = m.to_tensor(np.float32(3.0), stop_gradient=False)
    x[0] = v                     # a leaf, rebound
    (x * x).sum().backward()
    y_src = m.to_tensor(a, stop_gradient=False)
    y = y_src * 2
    y[1, 1:] = v * 0.5           # an intermediate
    y.sum().backward()
    return [x.grad.numpy(), v.grad.numpy(), y_src.grad.numpy(),
            x.stop_gradient, x.is_leaf]


def test_setitem_gradients_match_reference():
    ref, got = _setitem_grads(P), _setitem_grads(pt)
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL)
    assert ref[3:] == got[3:]


def test_inplace_on_leaf_keeps_its_grad():
    for m in (P, pt):
        x = m.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
        x.add_(m.to_tensor(np.array([1.0, 1.0], np.float32)))
        (x * x).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [4.0, 6.0])


def _rebound_setitem(m, x, y, w):
    x[1] = y[0]                  # a leaf rebound
    return (x * w).sum(), [x, y]


def _rebound_twice(m, x, y, w):
    x.add_(y)
    x.add_(y * y)
    return (x * x).sum(), [x, y]


def _read_before_rebind(m, x, y, w):
    a = x * 3.0                  # x's first value, read
    x[0] = y[1]
    return (a * x).sum(), [x, y]


def _intermediate_rebound(m, x, y, w):
    h = x * 2.0
    h[2] = y[0]
    h.scale_(3.0)
    return (h * w).sum(), [h, x]


REBOUND = [_rebound_setitem, _rebound_twice, _read_before_rebind,
           _intermediate_rebound]


@pytest.mark.parametrize("create_graph", [False, True])
@pytest.mark.parametrize("fn", REBOUND, ids=[f.__name__[1:] for f in REBOUND])
def test_grad_of_rebound_tensor_matches_reference(fn, create_graph):
    """``paddle.grad`` with respect to a tensor that an in-place API
    rebound: the sum of the grads of every value it held, as the
    reference's tape gives it.  With ``create_graph`` the port's grads
    are held against the reference's plain ones: the reference's
    create-graph pass rebuilds each vjp at its parents' current values,
    which a rebind has changed (ROADMAP Queue 3)."""
    rng = R(_seed(fn.__name__))
    a, b, w = (rng.standard_normal(4).astype(np.float32) for _ in range(3))

    def grads(m, create_graph):
        out, wrt = fn(m, m.to_tensor(a, stop_gradient=False),
                      m.to_tensor(b, stop_gradient=False), m.to_tensor(w))
        return [np.asarray(g.numpy())
                for g in m.grad(out, wrt, create_graph=create_graph)]
    for r, g in zip(grads(P, False), grads(pt, create_graph)):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=TOL * np.abs(r).max())


def test_integer_outputs_stop_gradient():
    for m in (P, pt):
        x = m.to_tensor(np.array([[3.0, 1.0], [2.0, 5.0]], np.float32),
                        stop_gradient=False)
        assert m.argsort(x).stop_gradient
        assert m.argmax(x).stop_gradient
        assert m.topk(x, 1)[1].stop_gradient
        assert not m.topk(x, 1)[0].stop_gradient
        assert not m.sort(x).stop_gradient
        assert m.unique(x).stop_gradient
        assert m.mode(x)[0].stop_gradient


def test_tensor_pickles():
    import pickle
    x = pt.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    y = pickle.loads(pickle.dumps(x))
    np.testing.assert_array_equal(y.numpy(), x.numpy())
    assert y.dtype == x.dtype and y.name == x.name


def test_tensor_moves_and_views():
    x = pt.to_tensor(np.arange(4, dtype=np.float32))
    assert x.cpu() is x
    assert x.to("cpu") is x
    assert x.to("float16").dtype == pt.float16
    assert x.to(pt.CPUPlace(), "int32").dtype == pt.int32
    y = x.clone()
    y.fill_(2.0)
    np.testing.assert_array_equal(y.numpy(), [2.0] * 4)
    y.zero_()
    y.copy_(np.float32(5.0))
    np.testing.assert_array_equal(y.numpy(), [5.0] * 4)
    np.testing.assert_array_equal(np.array(x.get_tensor()), x.numpy())
    x.get_tensor().set(np.ones(4, np.float32))
    np.testing.assert_array_equal(x.numpy(), [1.0] * 4)
    z = x.detach_()
    assert z is x and x.stop_gradient


# --------------------------------------------------------------------------
# random ops: shape, dtype, range, seeding, moments (the reference's JAX
# draws cannot be reproduced: ROADMAP Queue 3)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,fn,dtype,rng,moments", RANDOM_CASES,
                         ids=[r[0] for r in RANDOM_CASES])
def test_random_op(name, fn, dtype, rng, moments):
    ref = fn(P)
    pt.seed(5)
    a = fn(pt)
    pt.seed(5)
    b = fn(pt)
    c = fn(pt)
    assert a.shape == list(ref.shape)
    assert str(a.dtype).replace("torch.", "") == str(ref.dtype) == dtype
    np.testing.assert_array_equal(b.numpy(), a.numpy())   # one seed, one draw
    assert not np.array_equal(c.numpy(), a.numpy())       # the stream moves
    check_draw(a.numpy(), rng, moments)
    # the reference's draws come from the same distribution
    if moments is not None:
        from tools.op_sweep import two_sample
        two_sample(np.asarray(ref.numpy()), a.numpy())


def test_random_shuffle_keeps_rows():
    pt.seed(3)
    x = pt.to_tensor(np.arange(12, dtype=np.float32).reshape(6, 2))
    y = pt.shuffle(x).numpy()
    assert sorted(map(tuple, y.tolist())) == sorted(map(tuple, x.tolist()))


def test_uniform_seed_argument_repeats():
    for m in (P, pt):
        a = m.uniform([5], seed=11).numpy()
        b = m.uniform([5], seed=11).numpy()
        np.testing.assert_array_equal(a, b)


def test_rng_state_round_trip():
    pt.seed(9)
    st = pt.get_rng_state()
    a = pt.rand([6]).numpy()
    pt.set_rng_state(st)
    np.testing.assert_array_equal(pt.rand([6]).numpy(), a)


def test_check_shape():
    for m in (P, pt):
        m.check_shape([2, 3])
        with pytest.raises(TypeError):
            m.check_shape([2.5])
        with pytest.raises(ValueError):
            m.check_shape([-1])


# --------------------------------------------------------------------------
# auto_cast picks the reference's ops; static mode records the new ops
# --------------------------------------------------------------------------

AMP_CASES = [
    ("bmm", lambda m, x: m.bmm(x, x)),
    ("log_softmax", lambda m, x: m.nn.functional.log_softmax(x)),
    ("mv", lambda m, x: m.mv(x[0], x[0, 0])),
    ("addmm", lambda m, x: m.addmm(x[0], x[0], x[0])),
    ("bce_with_logits", lambda m, x: m.nn.functional
     .binary_cross_entropy_with_logits(x, m.full(x.shape, 0.5, "bfloat16"))),
    ("matmul", lambda m, x: m.matmul(x.astype("float32"), x)),
    ("sum", lambda m, x: m.sum(x)),
    ("where", lambda m, x: m.where(x > 0, x, 0.0)),
]


@pytest.mark.parametrize("name,fn", AMP_CASES, ids=[a[0] for a in AMP_CASES])
def test_auto_cast_dtypes_match_reference(name, fn):
    arr = R(_seed(name)).standard_normal((2, 3, 3)).astype(np.float32)
    dts = []
    for m in (P, pt):
        for dt in ("float32", "bfloat16"):
            x = m.to_tensor(arr).astype(dt)
            with m.amp.auto_cast(dtype="bfloat16"):
                out = fn(m, x)
            dts.append(str(out.dtype).replace("torch.", ""))
    assert dts[:2] == dts[2:], dts


def _static_program(m):
    m.enable_static()
    try:
        main, startup = m.static.Program(), m.static.Program()
        with m.static.program_guard(main, startup):
            x = m.static.data("x", [None, 4], "float32")
            y = m.where(x > 0, m.sqrt(m.abs(x)), m.exp(x))
            y = m.concat([m.cumsum(y, 1), m.flip(y, 1)], 0)
            z = m.topk(y, 2)[0]
            s = m.sum(m.clip(z, -1.0, 1.5)) + m.std(y)
            r = m.rand([3])
        exe = m.static.Executor()
        exe.run(startup)
        return exe, main, s, r
    finally:
        m.disable_static()


def test_static_replay_matches_eager():
    arr = R(4).standard_normal((3, 4)).astype(np.float32)
    exe, main, s, r = _static_program(pt)
    got, r1 = exe.run(main, feed={"x": arr}, fetch_list=[s, r])
    _, r2 = exe.run(main, feed={"x": arr}, fetch_list=[s, r])
    x = pt.to_tensor(arr)
    y = pt.where(x > 0, pt.sqrt(pt.abs(x)), pt.exp(x))
    y = pt.concat([pt.cumsum(y, 1), pt.flip(y, 1)], 0)
    eager = pt.sum(pt.clip(pt.topk(y, 2)[0], -1.0, 1.5)) + pt.std(y)
    np.testing.assert_allclose(np.asarray(got), eager.numpy(), rtol=1e-6)
    rexe, rmain, rs, _ = _static_program(P)
    ref = rexe.run(rmain, feed={"x": arr}, fetch_list=[rs])[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=TOL * abs(float(np.asarray(ref))))
    # the random op draws afresh at each run
    assert np.asarray(r1).shape == (3,)
    assert not np.array_equal(np.asarray(r1), np.asarray(r2))
