"""The op tables of the eager tensor API, the activations and the losses,
and the runners that hold one package's outputs and gradients against
another's, shared by the CPU tests (``tests/test_torch_tensor_api.py``,
``test_torch_activations.py``, ``test_torch_losses.py``: the JAX package
against the port) and by ``chip_smoke.py``'s phase (ad) and
``tests/test_torch_cuda.py`` (the port on the card against the port on
the CPU).  It imports numpy only; the package under test comes in as an
argument (``mod``: ``paddle_tpu`` or ``paddle_tpu_torch``).

Each :class:`Case` is ``fn(mod, *tensors)`` on inputs drawn from
``specs`` by a numpy ``RandomState`` seeded by the case's name, so no
draw depends on which cases ran before.  :func:`run` makes the tensors
(floating ones require grad when asked) on the default place and calls
the case; :func:`flat` turns its outputs into (numpy array, dtype name)
pairs; :func:`check` compares two such lists (dtypes equal, shapes
equal, float values within ``tol`` of max|ref|, the rest exact);
:func:`grads` is the gradient of sum(out * w) over the case's float
outputs, w drawn from the seed, with respect to its float inputs (taken
as ``paddle.grad`` with ``w`` as the outputs' cotangents);
:func:`outputs_and_grads` gives the outputs and the gradients of one
forward.
"""
import os
import pickle
import tempfile
import zlib

import numpy as np

TOL = 1e-5
LINALG_TOL = 1e-4      # linear algebra and ctc_loss: the reference's own
R = np.random.RandomState


# the public functions of the reference's nine tensor modules
# (paddle_tpu/tensor/{creation,math,manipulation,logic,search,stat,linalg,
# random,attribute}.py); tests/test_torch_tensor_api.py holds this list
# equal to them
TENSOR_API_NAMES = tuple("""
abs acos acosh add add_n addmm all allclose amax amin angle any arange
argmax argmin argsort as_complex as_real asin asinh assign atan atan2 atanh
bernoulli bitwise_and bitwise_not bitwise_or bitwise_xor bmm
broadcast_shape broadcast_tensors broadcast_to bucketize cast ceil
check_shape cholesky cholesky_solve chunk clip clone complex concat cond
conj corrcoef cos cosh count_nonzero cov crop crop_tensor cross cumprod
cumsum deg2rad det diag diag_embed diagonal diff digamma dist divide dot
eig eigh eigvals eigvalsh empty empty_like equal equal_all erf exp expand
expand_as expm1 exponential_ eye flatten flatten_ flip floor floor_divide
floor_mod fmax fmin full full_like gather gather_nd gcd greater_equal
greater_than histogram imag increment index_sample index_select inner inv
is_complex is_empty is_floating_point is_integer is_tensor isclose isfinite
isinf isnan kron kthvalue lcm lerp less_equal less_than lgamma linspace log
log10 log1p log2 logical_and logical_not logical_or logical_xor logspace
logsumexp lstsq masked_select matmul matrix_power matrix_rank max maximum
mean median meshgrid min minimum mm mod mode moveaxis multi_dot multinomial
multiplex multiply mv nan_to_num nanmedian neg nonzero norm normal normal_
not_equal numel ones ones_like outer pinv poisson pow prod put_along_axis
qr quantile rad2deg rand randint randint_like randn randperm rank real
reciprocal remainder repeat_interleave reshape reshape_ reverse roll rot90
round rsqrt scale scatter scatter_ scatter_nd scatter_nd_add searchsorted
shape shard_index shuffle sigmoid sign sin sinh slice slogdet solve sort
split sqrt square squeeze squeeze_ stack standard_normal stanh std
strided_slice subtract sum svd t take_along_axis tan tanh tanh_ tile tolist
topk trace transpose triangular_solve tril triu trunc unbind uniform
uniform_ unique unique_consecutive unsqueeze unsqueeze_ unstack var where
zeros zeros_like
""".split())


def _seed(name):
    return zlib.crc32(name.encode()) % 2 ** 31


# --------------------------------------------------------------------------
# input specs: ("f", shape[, scale]) N(0, scale^2) floats; ("u", shape, lo,
# hi) uniform floats; ("i", shape, lo, hi) int32 in [lo, hi); ("b", shape)
# bools; ("spd", n) a symmetric positive definite matrix; ("a", array) as
# given; ("dir", (n, c)) rows of probabilities, ("logdir", (n, c)) their
# logs; ("sign", shape) +-1 floats; ("01", shape) 0/1 floats.  The dtype
# axis: (integer dtype name, shape, lo, hi) integers of that dtype in
# [lo, hi); ("float16", shape[, scale]) and ("bfloat16", shape[, scale])
# N(0, scale^2) floats rounded to the dtype (a bfloat16 draw is a float32
# array whose tensor :func:`run` casts to bfloat16: numpy has no
# bfloat16); ("bool", shape) bools
# --------------------------------------------------------------------------

INT_KINDS = ("uint8", "int8", "int16", "int32")


def _bf16_round(a):
    """float32 ``a`` rounded to the nearest bfloat16 (ties to even)."""
    b = a.astype(np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(
        0xFFFF0000)
    return b.view(np.float32)


def _draw(spec, rng):
    kind = spec[0]
    if kind == "f":
        scale = spec[2] if len(spec) > 2 else 1.0
        return (rng.standard_normal(spec[1]) * scale).astype(np.float32)
    if kind == "u":
        return rng.uniform(spec[2], spec[3], spec[1]).astype(np.float32)
    if kind == "i":
        return rng.randint(spec[2], spec[3], spec[1]).astype(np.int32)
    if kind == "b":
        return rng.rand(*spec[1]) > 0.5
    if kind == "spd":
        a = rng.standard_normal((spec[1], spec[1]))
        return (a @ a.T + spec[1] * np.eye(spec[1])).astype(np.float32)
    if kind == "a":
        return np.asarray(spec[1])
    if kind == "dir":
        return rng.dirichlet(np.ones(spec[1][-1]), spec[1][0]).astype(
            np.float32)
    if kind == "logdir":
        return np.log(rng.dirichlet(np.ones(spec[1][-1]),
                                    spec[1][0])).astype(np.float32)
    if kind == "sign":
        return np.where(rng.rand(*spec[1]) > 0.5, 1.0, -1.0).astype(
            np.float32)
    if kind == "01":
        return (rng.rand(*spec[1]) > 0.5).astype(np.float32)
    if kind in INT_KINDS:
        return rng.randint(spec[2], spec[3], spec[1]).astype(kind)
    if kind in ("float16", "bfloat16"):
        scale = spec[2] if len(spec) > 2 else 1.0
        a = (rng.standard_normal(spec[1]) * scale).astype(np.float32)
        return a.astype(np.float16) if kind == "float16" else _bf16_round(a)
    if kind == "bool":
        return rng.rand(*spec[1]) > 0.5
    raise ValueError(kind)


class Case:
    """``fn(mod, *tensors)`` on inputs drawn from ``specs``; ``grad``:
    also hold the gradient; ``post(mod, outs)``: map the outputs to what
    is compared (default: as they are)."""

    def __init__(self, name, fn, specs, grad=True, tol=TOL, post=None):
        self.name, self.fn, self.specs = name, fn, specs
        self.grad, self.tol, self.post = grad, tol, post

    def __repr__(self):
        return self.name


def arrays(case):
    rng = R(_seed(case.name))
    return [_draw(s, rng) for s in case.specs]


def _tensors(mod, arrays, grad=False, specs=()):
    """The arrays as tensors on the default place; a ``bfloat16`` spec's
    array cast to bfloat16 (it then requires no grad)."""
    out = []
    kinds = [s[0] for s in specs] + [None] * (len(arrays) - len(specs))
    for a, kind in zip(arrays, kinds):
        t = mod.to_tensor(a)
        if kind == "bfloat16":
            t = t.astype("bfloat16")
        elif grad and np.issubdtype(a.dtype, np.floating):
            t = mod.to_tensor(a, stop_gradient=False)
        out.append(t)
    return out


def _is_tensor(x):
    return hasattr(x, "numpy") and hasattr(x, "stop_gradient")


def flat(out):
    """Outputs -> a list of (numpy array, dtype name) and python values."""
    return [(np.asarray(v.numpy()), n) if _is_tensor(v) else (v, n)
            for v, n in flat_tensors(out)]


def flat_tensors(out):
    """Outputs -> a list of (tensor, dtype name), a bfloat16 tensor cast
    to float32, and (python value, its type's name)."""
    if isinstance(out, (list, tuple)):
        return [p for o in out for p in flat_tensors(o)]
    if _is_tensor(out):
        name = str(out.dtype).replace("torch.", "")
        return [(out.astype("float32") if name == "bfloat16" else out, name)]
    return [(out, type(out).__name__)]


def check(ref, got, tol, what):
    """Raises unless ``got`` matches ``ref``; returns the largest float
    difference over max|ref| (0.0 for exact outputs)."""
    assert len(ref) == len(got), (what, len(ref), len(got))
    worst = 0.0
    for k, ((r, rd), (g, gd)) in enumerate(zip(ref, got)):
        assert rd == gd, (what, k, rd, gd)
        if not isinstance(r, np.ndarray):
            assert r == g, (what, k, r, g)
            continue
        assert r.shape == g.shape, (what, k, r.shape, g.shape)
        if r.dtype.kind in "fc" and r.size:
            # inf and nan where the reference has them, the rest within
            # tol of the largest finite |ref|
            fin = np.isfinite(r)
            assert (np.isfinite(g) == fin).all(), (what, k, "non-finite")
            np.testing.assert_array_equal(g[~fin], r[~fin],
                                          err_msg=f"{what} output {k}")
            if fin.any():
                scale = max(float(np.abs(r[fin]).max()), 1e-30)
                np.testing.assert_allclose(g[fin], r[fin], rtol=0,
                                           atol=tol * scale,
                                           err_msg=f"{what} output {k}")
                worst = max(worst, float(np.abs(g[fin] - r[fin]).max())
                            / scale)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{what} output {k}")
    return worst


def run(mod, case, arrays, grad=False):
    xs = _tensors(mod, arrays, grad, case.specs)
    out = case.fn(mod, *xs)
    if case.post is not None:
        out = case.post(mod, out)
    return xs, out


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------

F34 = ("f", (3, 4))
F4 = ("f", (4,))
I34 = ("i", (3, 4), -5, 6)
B34 = ("b", (3, 4))
POS = ("u", (3, 4), 0.2, 3.0)
UNIT = ("u", (3, 4), -0.9, 0.9)


def _unary(name, spec=F34, grad=True):
    op = name.split(":")[0]
    return Case(name, lambda m, x: getattr(m, op)(x), [spec], grad)


def _binary(name, a=F34, b=F4, grad=True):
    op = name.split(":")[0]
    return Case(name, lambda m, x, y: getattr(m, op)(x, y), [a, b], grad)


def _sorted_eig(mod, out):
    """Eigenvalues ordered by (real, imag), and A V = V diag(w)'s real
    part as |V diag(w)| (V is defined up to a phase per column)."""
    w, v = out
    w = np.asarray(w.numpy())
    v = np.asarray(v.numpy())
    order = np.lexsort((w.imag, w.real))
    return [mod.to_tensor(w[order].real.astype(np.float32)),
            mod.to_tensor(np.abs(v[:, order] * w[order]).astype(np.float32))]


def _svd_post(mod, out):
    u, s, vt = out
    return [s, mod.matmul(u * s.unsqueeze(0), vt)]


def _eigh_post(mod, out):
    w, v = out
    return [w, mod.matmul(v * w.unsqueeze(0), v.t())]


def _qr_post(mod, out):
    q, r = out
    return [mod.matmul(q, r), mod.abs(r)]


CREATION = [
    Case("zeros", lambda m: m.zeros([2, 3]), [], False),
    Case("zeros:int", lambda m: m.zeros([2, 3], "int64"), [], False),
    Case("ones", lambda m: m.ones([3], "float32"), [], False),
    Case("full", lambda m: m.full([2, 3], 7), [], False),
    Case("full:int", lambda m: m.full([2], 7, "int32"), [], False),
    Case("empty", lambda m: m.empty([2, 2]), [], False),
    Case("zeros_like", lambda m, x: m.zeros_like(x), [F34], False),
    Case("ones_like", lambda m, x: m.ones_like(x, "int32"), [F34], False),
    Case("full_like", lambda m, x: m.full_like(x, 2.5), [F34], False),
    Case("empty_like", lambda m, x: m.empty_like(x), [I34], False),
    Case("arange", lambda m: m.arange(5), [], False),
    Case("arange:float", lambda m: m.arange(0, 1, 0.25), [], False),
    Case("arange:dtype", lambda m: m.arange(2, 10, 3, "float32"), [], False),
    Case("linspace", lambda m: m.linspace(0, 1, 5), [], False),
    Case("logspace", lambda m: m.logspace(0, 2, 3), [], False),
    Case("eye", lambda m: m.eye(3), [], False),
    Case("eye:rect", lambda m: m.eye(2, 4, "int32"), [], False),
    Case("diag", lambda m, x: m.diag(x), [F4]),
    Case("diag:pad", lambda m, x: m.diag(x, 1, 9.0), [F4]),
    Case("diag:2d", lambda m, x: m.diag(x, -1), [F34]),
    Case("diag_embed", lambda m, x: m.diag_embed(x, 1), [F34]),
    Case("diag_embed:dims", lambda m, x: m.diag_embed(x, -1, 0, 2), [F34]),
    Case("tril", lambda m, x: m.tril(x, 1), [F34]),
    Case("triu", lambda m, x: m.triu(x, -1), [F34]),
    Case("meshgrid", lambda m, x, y: m.meshgrid(x, y), [F4, ("f", (3,))]),
    Case("assign", lambda m, x: m.assign(x), [F34], False),
    Case("assign:numpy", lambda m: m.assign(np.ones((2, 2))), [], False),
    Case("clone", lambda m, x: m.clone(x), [F34]),
    Case("numel", lambda m, x: m.numel(x), [F34], False),
    Case("tolist", lambda m, x: m.tolist(x), [I34], False),
    Case("complex", lambda m, x, y: m.complex(x, y), [F34, F34], False),
    Case("to_tensor", lambda m: m.to_tensor([[1, 2], [3, 4]]), [], False),
    Case("to_tensor:float", lambda m: m.to_tensor([1.5, 2.0]), [], False),
]

UNARY_F = [("abs", F34), ("ceil", F34), ("floor", F34), ("trunc", F34),
           ("exp", F34), ("expm1", F34), ("log", POS), ("log2", POS),
           ("log10", POS), ("log1p", POS), ("sqrt", POS), ("rsqrt", POS),
           ("square", F34), ("sin", F34), ("cos", F34), ("tan", UNIT),
           ("asin", UNIT), ("acos", UNIT), ("atan", F34), ("sinh", F34),
           ("cosh", F34), ("tanh", F34), ("asinh", F34),
           ("acosh", ("u", (3, 4), 1.1, 3.0)), ("atanh", UNIT),
           ("erf", F34), ("reciprocal", POS), ("sign", F34), ("neg", F34),
           ("digamma", POS), ("lgamma", POS), ("sigmoid", F34),
           ("stanh", F34), ("isfinite", F34), ("isinf", F34),
           ("isnan", F34), ("deg2rad", F34), ("rad2deg", F34),
           ("angle", F34), ("conj", F34), ("real", F34), ("imag", F34)]
NO_GRAD = {"ceil", "floor", "trunc", "sign", "isfinite", "isinf", "isnan",
           "angle", "imag"}

MATH = [_unary(n, s, n not in NO_GRAD) for n, s in UNARY_F] + [
    Case("abs:int", lambda m, x: m.abs(x), [I34], False),
    Case("round", lambda m, x: m.round(x),
         [("a", np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.4, -0.6],
                         np.float32))], False),
    Case("round:int", lambda m, x: m.round(x), [I34], False),
    Case("sqrt:int", lambda m, x: m.sqrt(x), [("i", (3, 4), 0, 9)], False),
    Case("reciprocal:int", lambda m, x: m.reciprocal(x),
         [("i", (3, 4), 1, 9)], False),
    Case("exp:int", lambda m, x: m.exp(x), [I34], False),
    Case("neg:int", lambda m, x: m.neg(x), [I34], False),
    Case("square:int", lambda m, x: m.square(x), [I34], False),
    Case("sign:int", lambda m, x: m.sign(x), [I34], False),
    Case("floor:int", lambda m, x: m.floor(x), [I34], False),
    Case("ceil:int", lambda m, x: m.ceil(x), [I34], False),
    Case("trunc:int", lambda m, x: m.trunc(x), [I34], False),
    Case("sin:int", lambda m, x: m.sin(x), [I34], False),
    Case("deg2rad:int", lambda m, x: m.deg2rad(x), [I34], False),
    Case("stanh:args", lambda m, x: m.stanh(x, 0.5, 2.0), [F34]),
] + [_binary(n) for n in ("add", "subtract", "multiply", "divide",
                          "maximum", "minimum", "fmax", "fmin", "atan2")] + [
    _binary("pow", POS, ("f", (4,))),
    _binary("mod", F34, ("u", (4,), 0.5, 2.0), False),
    _binary("remainder", F34, ("u", (4,), -2.0, -0.5), False),
    _binary("floor_mod", I34, ("i", (4,), 1, 4), False),
    _binary("floor_divide", F34, ("u", (4,), 0.5, 2.0), False),
    _binary("floor_divide:int", I34, ("i", (4,), 1, 4), False),
    Case("divide:int", lambda m, x, y: m.divide(x, y),
         [("a", np.array([-7, 7, -3, 3, 0], np.int32)),
          ("a", np.array([2, -2, 2, 2, 3], np.int32))], False),
    Case("divide:int_scalar", lambda m, x: m.divide(x, 2), [I34], False),
    Case("divide:bool", lambda m, x, y: m.divide(x, y), [B34, B34], False),
    Case("add:int_float", lambda m, x, y: m.add(x, y), [I34, F4]),
    Case("add:bool_int", lambda m, x, y: m.add(x, y), [B34, I34], False),
    Case("add:bool", lambda m, x, y: m.add(x, y), [B34, B34], False),
    Case("add:scalar", lambda m, x: m.add(x, 2), [I34], False),
    Case("multiply:scalar", lambda m, x: m.multiply(x, 2.5), [I34], False),
    Case("maximum:int_scalar", lambda m, x: m.maximum(x, 2.5), [I34], False),
    Case("pow:int", lambda m, x: m.pow(x, 2), [I34], False),
    Case("pow:half", lambda m, x: m.pow(x, 0.5), [("i", (3, 4), 0, 9)],
         False),
    Case("scale", lambda m, x: m.scale(x, 2.0, 1.0), [F34]),
    Case("scale:before", lambda m, x: m.scale(x, 2.0, 1.0, False), [F34]),
    Case("scale:act", lambda m, x: m.scale(x, 2.0, -1.0, act="relu"),
         [F34]),
    Case("scale:int", lambda m, x: m.scale(x, 2), [I34], False),
    Case("multiplex", lambda m, a, b, i: m.multiplex([a, b], i),
         [F34, F34, ("i", (3, 1), 0, 2)]),
    Case("sum", lambda m, x: m.sum(x, 1), [F34]),
    Case("sum:int", lambda m, x: m.sum(x), [I34], False),
    Case("sum:bool", lambda m, x: m.sum(x, 0), [B34], False),
    Case("sum:dtype", lambda m, x: m.sum(x, [0, 1], "float32", True), [I34],
         False),
    Case("mean", lambda m, x: m.mean(x, -1, True), [F34]),
    Case("mean:int", lambda m, x: m.mean(x), [I34], False),
    Case("prod", lambda m, x: m.prod(x, 1), [F34]),
    Case("prod:all", lambda m, x: m.prod(x, keepdim=True), [("u", (2, 3),
                                                            0.5, 1.5)]),
    Case("prod:int", lambda m, x: m.prod(x, 0), [I34], False),
    Case("max", lambda m, x: m.max(x, 0), [F34]),
    Case("max:all", lambda m, x: m.max(x), [F34]),
    Case("max:int", lambda m, x: m.max(x, [0, 1], True), [I34], False),
    Case("min", lambda m, x: m.min(x, -1, True), [F34]),
    Case("amax", lambda m, x: m.amax(x, 1), [F34]),
    Case("amin", lambda m, x: m.amin(x, 0), [F34]),
    Case("logsumexp", lambda m, x: m.logsumexp(x, 1), [F34]),
    Case("logsumexp:all", lambda m, x: m.logsumexp(x), [F34]),
    Case("cumsum", lambda m, x: m.cumsum(x, 1), [F34]),
    Case("cumsum:flat", lambda m, x: m.cumsum(x), [F34]),
    Case("cumsum:int", lambda m, x: m.cumsum(x, 0), [I34], False),
    Case("cumsum:bool", lambda m, x: m.cumsum(x, 1), [B34], False),
    Case("cumprod", lambda m, x: m.cumprod(x, 1), [UNIT]),
    Case("cumprod:int", lambda m, x: m.cumprod(x, 0), [I34], False),
    Case("count_nonzero", lambda m, x: m.count_nonzero(x, 1), [I34], False),
    Case("count_nonzero:all", lambda m, x: m.count_nonzero(x), [I34], False),
    Case("clip", lambda m, x: m.clip(x, -0.5, 0.5), [F34]),
    Case("clip:int", lambda m, x: m.clip(x, -2, 2), [I34], False),
    Case("clip:int_float", lambda m, x: m.clip(x, 0.5, 1.5), [I34], False),
    Case("clip:lower", lambda m, x: m.clip(x, min=0.0), [F34]),
    Case("nan_to_num", lambda m, x: m.nan_to_num(x / 0.0 * x),
         [("a", np.array([1.0, -1.0, 0.0], np.float32))], False),
    Case("matmul", lambda m, x, y: m.matmul(x, y, transpose_y=True),
         [F34, ("f", (5, 4))]),
    Case("matmul:tx", lambda m, x, y: m.matmul(x, y, True), [F34,
                                                            ("f", (3, 2))]),
    Case("mm", lambda m, x, y: m.mm(x, y), [F34, ("f", (4, 2))]),
    Case("matmul:int_float", lambda m, x, y: m.matmul(x, y),
         [I34, ("f", (4, 2))]),
    Case("dot", lambda m, x, y: m.dot(x, y), [F34, F34]),
    Case("bmm", lambda m, x, y: m.bmm(x, y), [("f", (2, 3, 4)),
                                              ("f", (2, 4, 5))]),
    Case("mv", lambda m, x, y: m.mv(x, y), [F34, F4]),
    Case("addmm", lambda m, i, x, y: m.addmm(i, x, y, 0.5, 2.0),
         [("f", (3, 2)), F34, ("f", (4, 2))]),
    Case("inner", lambda m, x, y: m.inner(x, y), [F34, ("f", (2, 4))]),
    Case("outer", lambda m, x, y: m.outer(x, y), [F4, ("f", (3,))]),
    Case("kron", lambda m, x, y: m.kron(x, y), [("f", (2, 3)),
                                                ("f", (2, 2))]),
    Case("multi_dot", lambda m, a, b, c: m.multi_dot([a, b, c]),
         [F34, ("f", (4, 5)), ("f", (5, 2))]),
    Case("trace", lambda m, x: m.trace(x, 1), [F34]),
    Case("trace:int", lambda m, x: m.trace(x), [I34], False),
    Case("diagonal", lambda m, x: m.diagonal(x, -1), [F34]),
    Case("diagonal:axes", lambda m, x: m.diagonal(x, 0, 1, 2),
         [("f", (2, 3, 3))]),
    Case("increment", lambda m, x: m.increment(x * 1.0, 2.0), [F34]),
    Case("all", lambda m, x: m.all(x, 1), [B34], False),
    Case("all:all", lambda m, x: m.all(x), [B34], False),
    Case("any", lambda m, x: m.any(x, 0, True), [B34], False),
    Case("any:int", lambda m, x: m.any(x), [I34], False),
    Case("broadcast_shape", lambda m: m.broadcast_shape([3, 1, 4], [2, 1]),
         [], False),
    Case("lerp", lambda m, x, y: m.lerp(x, y, 0.3), [F34, F34]),
    Case("lerp:tensor", lambda m, x, y, w: m.lerp(x, y, w), [F34, F34, F4]),
    Case("gcd", lambda m, x, y: m.gcd(x, y), [("i", (3, 4), 0, 30),
                                              ("i", (3, 4), 1, 30)], False),
    Case("lcm", lambda m, x, y: m.lcm(x, y), [("i", (3, 4), 1, 12),
                                              ("i", (3, 4), 1, 12)], False),
    Case("diff", lambda m, x: m.diff(x), [F34]),
    Case("diff:n2", lambda m, x: m.diff(x, 2, 0), [("f", (4, 3))]),
    Case("diff:edges", lambda m, x, p: m.diff(x, 1, -1, p, 1.0),
         [F34, ("f", (3, 1))]),
    Case("add_n", lambda m, x, y, z: m.add_n([x, y, z]), [F34, F34, F34]),
    Case("add_n:one", lambda m, x: m.add_n(x), [F34]),
    Case("cast", lambda m, x: m.cast(x, "int32"), [F34], False),
    Case("cast:int64", lambda m, x: m.cast(x, "int64"), [F34], False),
    Case("cast:float", lambda m, x: m.cast(x, "float16"), [F34], False),
    Case("cast:bf16", lambda m, x: m.cast(x, "bfloat16"), [F34]),
    Case("tanh_", lambda m, x: m.tanh_(x * 1.0), [F34]),
    Case("amax:int", lambda m, x: m.amax(x), [I34], False),
]

MANIP = [
    Case("reshape", lambda m, x: m.reshape(x, [2, -1]), [F34]),
    Case("reshape:zero", lambda m, x: m.reshape(x, [0, 2, 2]), [F34]),
    Case("reshape_", lambda m, x: m.reshape_(x * 1.0, [4, 3]), [F34]),
    Case("transpose", lambda m, x: m.transpose(x, [2, 0, 1]),
         [("f", (2, 3, 4))]),
    Case("t", lambda m, x: m.t(x), [F34]),
    Case("t:1d", lambda m, x: m.t(x), [F4]),
    Case("concat", lambda m, x, y: m.concat([x, y], 1), [F34, ("f", (3, 2))]),
    Case("concat:promote", lambda m, x, y: m.concat([x, y]), [F34, I34]),
    Case("stack", lambda m, x, y: m.stack([x, y], 1), [F34, F34]),
    Case("split", lambda m, x: m.split(x, 2, 1), [F34]),
    Case("split:sections", lambda m, x: m.split(x, [1, -1], 1), [F34]),
    Case("chunk", lambda m, x: m.chunk(x, 3, 0), [F34]),
    Case("unstack", lambda m, x: m.unstack(x, 1), [F34]),
    Case("unbind", lambda m, x: m.unbind(x), [F34]),
    Case("squeeze", lambda m, x: m.squeeze(x), [("f", (3, 1, 4, 1))]),
    Case("squeeze:axis", lambda m, x: m.squeeze(x, [1, 2]),
         [("f", (3, 1, 4, 1))]),
    Case("squeeze_", lambda m, x: m.squeeze_(x * 1.0, -1), [("f", (3, 1, 4, 1))]),
    Case("unsqueeze", lambda m, x: m.unsqueeze(x, [0, -1]), [F34]),
    Case("unsqueeze_", lambda m, x: m.unsqueeze_(x * 1.0, 1), [F34]),
    Case("flatten", lambda m, x: m.flatten(x, 1), [("f", (2, 3, 4))]),
    Case("flatten_", lambda m, x: m.flatten_(x * 1.0, 0, 1), [("f", (2, 3, 4))]),
    Case("gather", lambda m, x, i: m.gather(x, i), [F34, ("i", (5,), 0, 3)]),
    Case("gather:axis", lambda m, x, i: m.gather(x, i, 1),
         [F34, ("i", (2, 2), 0, 4)]),
    Case("gather_nd", lambda m, x, i: m.gather_nd(x, i),
         [("f", (3, 4, 2)), ("i", (5, 2), 0, 3)]),
    Case("scatter", lambda m, x, i, u: m.scatter(x, i, u),
         [F34, ("a", np.array([2, 0], np.int32)), ("f", (2, 4))]),
    Case("scatter:add", lambda m, x, i, u: m.scatter(x, i, u, False),
         [F34, ("a", np.array([2, 0, 2], np.int32)), ("f", (3, 4))]),
    Case("scatter_", lambda m, x, i, u: m.scatter_(x * 1.0, i, u),
         [F34, ("a", np.array([1], np.int32)), ("f", (1, 4))]),
    Case("scatter_nd_add", lambda m, x, i, u: m.scatter_nd_add(x, i, u),
         [F34, ("a", np.array([[0, 1], [2, 3], [0, 1]], np.int32)),
          ("f", (3,))]),
    Case("scatter_nd", lambda m, i, u: m.scatter_nd(i, u, [3, 4]),
         [("a", np.array([[1], [2], [1]], np.int32)), ("f", (3, 4))]),
    Case("slice", lambda m, x: m.slice(x, [0, 1], [1, 0], [3, -1]), [F34]),
    Case("strided_slice", lambda m, x: m.strided_slice(
        x, [0, 1], [0, 3], [3, 0], [2, -1]), [F34]),
    Case("tile", lambda m, x: m.tile(x, [2, 1]), [F34]),
    Case("expand", lambda m, x: m.expand(x, [2, -1, 4]), [("f", (3, 1))]),
    Case("expand_as", lambda m, x, y: m.expand_as(x, y), [F4, F34]),
    Case("broadcast_to", lambda m, x: m.broadcast_to(x, [2, 3, 4]), [F4]),
    Case("broadcast_tensors", lambda m, x, y: m.broadcast_tensors([x, y]),
         [("f", (3, 1)), F4]),
    Case("flip", lambda m, x: m.flip(x, [0, 1]), [F34]),
    Case("reverse", lambda m, x: m.reverse(x, 1), [F34]),
    Case("roll", lambda m, x: m.roll(x, 2, 1), [F34]),
    Case("roll:flat", lambda m, x: m.roll(x, -3), [F34]),
    Case("rot90", lambda m, x: m.rot90(x, 3), [F34]),
    Case("unique", lambda m, x: m.unique(x, True, True, True),
         [("i", (3, 4), 0, 5)], False),
    Case("unique:plain", lambda m, x: m.unique(x), [("i", (6,), 0, 4)],
         False),
    Case("unique:float", lambda m, x: m.unique(x, return_counts=True),
         [("a", np.array([2.5, 1.0, 2.5, -1.0], np.float32))], False),
    Case("unique:axis", lambda m, x: m.unique(x, return_inverse=True,
                                              axis=0),
         [("a", np.array([[1, 2], [0, 1], [1, 2]], np.int32))], False),
    Case("unique_consecutive", lambda m, x: m.unique_consecutive(x, True,
                                                                 True),
         [("a", np.array([1, 1, 2, 2, 2, 1, 3, 3], np.int32))], False),
    Case("unique_consecutive:plain", lambda m, x: m.unique_consecutive(x),
         [("a", np.array([[1, 1], [2, 1]], np.int32))], False),
    Case("masked_select", lambda m, x, b: m.masked_select(x, b), [F34, B34],
         False),
    Case("index_select", lambda m, x, i: m.index_select(x, i, 1),
         [F34, ("i", (5,), 0, 4)]),
    Case("index_sample", lambda m, x, i: m.index_sample(x, i),
         [F34, ("i", (3, 2), 0, 4)]),
    Case("shard_index", lambda m, x: m.shard_index(x, 20, 2, 1),
         [("i", (4, 1), 0, 20)], False),
    Case("moveaxis", lambda m, x: m.moveaxis(x, 0, -1), [("f", (2, 3, 4))]),
    Case("take_along_axis", lambda m, x, i: m.take_along_axis(x, i, 1),
         [F34, ("i", (3, 2), 0, 4)]),
    Case("put_along_axis", lambda m, x, i, v: m.put_along_axis(x, i, v, 1),
         [F34, ("a", np.array([[0], [2], [3]], np.int32)), ("f", (3, 1))]),
    Case("put_along_axis:add", lambda m, x, i: m.put_along_axis(
        x, i, 2.0, 0, "add"), [F34, ("a", np.array([[0, 1, 2, 0]],
                                                   np.int32))]),
    Case("put_along_axis:mul", lambda m, x, i, v: m.put_along_axis(
        x, i, v, 1, "multiply"), [F34, ("a", np.array([[1], [0], [2]],
                                                      np.int32)),
                                  ("f", (3, 1))], False),
    Case("as_complex", lambda m, x: m.as_complex(x), [("f", (3, 2))], False),
    Case("as_real", lambda m, x: m.as_real(m.as_complex(x)), [("f", (3, 2))],
         False),
    Case("repeat_interleave", lambda m, x: m.repeat_interleave(x, 2, 0),
         [F34]),
    Case("repeat_interleave:flat", lambda m, x: m.repeat_interleave(x, 3),
         [F4]),
    Case("repeat_interleave:tensor", lambda m, x, r: m.repeat_interleave(
        x, r, 0), [("f", (3,)), ("a", np.array([1, 0, 2], np.int32))]),
    Case("crop", lambda m, x: m.crop(x, [2, -1], [1, 1]), [F34]),
    Case("crop_tensor", lambda m, x: m.crop_tensor(x, [2, 2]), [F34]),
]

LOGIC = [_binary(n, F34, F4, False) for n in (
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal")] + [_binary(n, B34, B34, False) for n in (
        "logical_and", "logical_or", "logical_xor")] + [
    _binary(n, I34, I34, False) for n in (
        "bitwise_and", "bitwise_or", "bitwise_xor")] + [
    Case("logical_not", lambda m, x: m.logical_not(x), [B34], False),
    Case("logical_and:int", lambda m, x, y: m.logical_and(x, y), [I34, B34],
         False),
    Case("bitwise_not", lambda m, x: m.bitwise_not(x), [I34], False),
    Case("bitwise_not:bool", lambda m, x: m.bitwise_not(x), [B34], False),
    Case("equal:int_float", lambda m, x, y: m.equal(x, y), [I34, F4], False),
    Case("less_than:scalar", lambda m, x: m.less_than(x, 0.5), [F34], False),
    Case("equal_all", lambda m, x: m.equal_all(x, x), [F34], False),
    Case("equal_all:differ", lambda m, x, y: m.equal_all(x, y), [F34, F34],
         False),
    Case("equal_all:shape", lambda m, x, y: m.equal_all(x, y), [F34, F4],
         False),
    Case("allclose", lambda m, x, y: m.allclose(x, x + y * 1e-7),
         [F34, F34], False),
    Case("allclose:far", lambda m, x, y: m.allclose(x, y), [F34, F34],
         False),
    Case("isclose", lambda m, x, y: m.isclose(x, x + y * 1e-3, 1e-3, 1e-4),
         [F34, F34], False),
    Case("is_empty", lambda m, x: m.is_empty(x), [F34], False),
    Case("is_empty:empty", lambda m, x: m.is_empty(x), [("f", (0, 3))],
         False),
    Case("is_tensor", lambda m, x: (m.is_tensor(x), m.is_tensor(1)), [F34],
         False),
]

SEARCH = [
    Case("argmax", lambda m, x: m.argmax(x), [F34], False),
    Case("argmax:axis", lambda m, x: m.argmax(x, 1, True), [F34], False),
    Case("argmax:ties", lambda m, x: m.argmax(x, 0), [("i", (5, 3), 0, 2)],
         False),
    Case("argmin", lambda m, x: m.argmin(x, 0, dtype="int32"), [F34], False),
    Case("argsort", lambda m, x: m.argsort(x, 1), [F34], False),
    Case("argsort:ties", lambda m, x: m.argsort(x, 1, True),
         [("i", (3, 6), 0, 3)], False),
    Case("sort", lambda m, x: m.sort(x, 0, True), [F34]),
    Case("sort:int", lambda m, x: m.sort(x), [I34], False),
    Case("topk", lambda m, x: m.topk(x, 2), [F34]),
    Case("topk:small", lambda m, x: m.topk(x, 2, 0, False), [F34]),
    Case("topk:ties", lambda m, x: m.topk(x, 3), [("i", (3, 6), 0, 3)],
         False),
    Case("where", lambda m, c, x, y: m.where(c, x, y), [B34, F34, F4]),
    Case("where:scalar", lambda m, c, x: m.where(c, x, 0.0), [B34, F34]),
    Case("where:int_float", lambda m, c, x: m.where(c, x, 2.5), [B34, I34],
         False),
    Case("where:nonzero", lambda m, c: m.where(c), [B34], False),
    Case("nonzero", lambda m, x: m.nonzero(x), [I34], False),
    Case("nonzero:tuple", lambda m, x: m.nonzero(x, True), [B34], False),
    Case("searchsorted", lambda m, s, v: m.searchsorted(s, v),
         [("a", np.array([0.0, 1.0, 2.0, 3.0], np.float32)),
          ("u", (5,), -1.0, 4.0)], False),
    Case("searchsorted:right", lambda m, s, v: m.searchsorted(
        s, v, True, True), [("a", np.array([1, 2, 2, 4], np.int32)),
                            ("i", (6,), 0, 5)], False),
    Case("bucketize", lambda m, x, s: m.bucketize(x, s),
         [("u", (3, 2), -1.0, 4.0),
          ("a", np.array([0.0, 1.0, 3.0], np.float32))], False),
    Case("kthvalue", lambda m, x: m.kthvalue(x, 2), [F34]),
    Case("kthvalue:keep", lambda m, x: m.kthvalue(x, 1, 0, True), [F34]),
    Case("mode", lambda m, x: m.mode(x), [("i", (3, 7), 0, 3)], False),
    Case("mode:float", lambda m, x: m.mode(x, 0, True),
         [("a", np.array([[1.5, 2.0], [1.5, 3.0], [2.0, 3.0]],
                         np.float32))], False),
    # long rows: a vocabulary-sized row of token ids, ties among values
    Case("mode:long", lambda m, x: m.mode(x, 1), [("i", (4, 8192), 0, 600)],
         False),
    Case("masked_select:search", lambda m, x, b: m.masked_select(x, b),
         [I34, B34], False),
]

STAT = [
    Case("std", lambda m, x: m.std(x), [F34]),
    Case("std:axis", lambda m, x: m.std(x, 1, False, True), [F34]),
    Case("var", lambda m, x: m.var(x, 0), [F34]),
    Case("var:int", lambda m, x: m.var(x), [I34], False),
    Case("median", lambda m, x: m.median(x), [F34]),
    Case("median:axis", lambda m, x: m.median(x, 1, True), [("f", (3, 5))]),
    Case("median:even", lambda m, x: m.median(x, 0), [F34]),
    Case("median:int", lambda m, x: m.median(x), [I34], False),
    Case("nanmedian", lambda m, x: m.nanmedian(x, 1),
         [("a", np.array([[1.0, np.nan, 3.0, 2.0], [np.nan] * 4,
                          [5.0, 1.0, np.nan, np.nan]], np.float32))], False),
    Case("nanmedian:all", lambda m, x: m.nanmedian(x), [F34]),
    Case("quantile", lambda m, x: m.quantile(x, 0.3, 1), [F34]),
    Case("quantile:list", lambda m, x: m.quantile(x, [0.1, 0.5, 0.9]),
         [F34]),
    Case("quantile:keep", lambda m, x: m.quantile(x, [0.25, 0.75], 0, True),
         [F34]),
    Case("numel:stat", lambda m, x: m.numel(x), [I34], False),
]

SQ = ("f", (4, 4))
LINALG = [
    Case("norm", lambda m, x: m.norm(x), [F34], tol=LINALG_TOL),
    Case("norm:p1", lambda m, x: m.norm(x, 1), [F34], tol=LINALG_TOL),
    Case("norm:inf", lambda m, x: m.norm(x, float("inf"), 1),
         [F34], tol=LINALG_TOL),
    Case("norm:fro_axes", lambda m, x: m.norm(x, "fro", [0, 1], True),
         [F34], tol=LINALG_TOL),
    Case("norm:p3", lambda m, x: m.norm(x, 3, 0), [F34], tol=LINALG_TOL),
    Case("norm:p0", lambda m, x: m.norm(x, 0, 1), [I34], False),
    Case("dist", lambda m, x, y: m.dist(x, y), [F34, F34], tol=LINALG_TOL),
    Case("dist:inf", lambda m, x, y: m.dist(x, y, float("inf")),
         [F34, F34], tol=LINALG_TOL),
    Case("cross", lambda m, x, y: m.cross(x, y), [("f", (2, 3)),
                                                  ("f", (2, 3))],
         tol=LINALG_TOL),
    Case("t:linalg", lambda m, x: m.linalg.t(x), [F34]),
    Case("cholesky", lambda m, x: m.cholesky(x), [("spd", 4)],
         tol=LINALG_TOL),
    Case("cholesky:upper", lambda m, x: m.cholesky(x, True), [("spd", 3)],
         tol=LINALG_TOL),
    Case("histogram", lambda m, x: m.histogram(x, 5), [F34], False),
    Case("histogram:range", lambda m, x: m.histogram(x, 4, -1, 1), [F34],
         False),
    Case("matrix_power", lambda m, x: m.matrix_power(x, 3), [SQ],
         tol=LINALG_TOL),
    Case("matrix_power:inv", lambda m, x: m.matrix_power(x, -1), [("spd", 3)],
         tol=LINALG_TOL),
    Case("svd", lambda m, x: m.svd(x), [F34], False, LINALG_TOL, _svd_post),
    Case("svd:values", lambda m, x: m.svd(x)[1], [F34], tol=LINALG_TOL),
    Case("qr", lambda m, x: m.qr(x), [("f", (4, 3))], False, LINALG_TOL,
         _qr_post),
    Case("eig", lambda m, x: m.eig(x), [SQ], False, LINALG_TOL, _sorted_eig),
    Case("eigh", lambda m, x: m.eigh(x), [("spd", 4)], False, LINALG_TOL,
         _eigh_post),
    Case("eigvals", lambda m, x: m.eigvals(x), [("spd", 3)], False,
         LINALG_TOL, lambda m, w: m.to_tensor(np.sort(
             np.asarray(w.numpy()).real).astype(np.float32))),
    Case("eigvalsh", lambda m, x: m.eigvalsh(x), [("spd", 4)],
         tol=LINALG_TOL),
    Case("inv", lambda m, x: m.inv(x), [("spd", 4)], tol=LINALG_TOL),
    Case("inverse", lambda m, x: m.inverse(x), [("spd", 3)], tol=LINALG_TOL),
    Case("pinv", lambda m, x: m.pinv(x), [F34], tol=LINALG_TOL),
    Case("det", lambda m, x: m.det(x), [SQ], tol=LINALG_TOL),
    Case("slogdet", lambda m, x: m.slogdet(x), [SQ], tol=LINALG_TOL),
    Case("solve", lambda m, x, y: m.solve(x, y), [("spd", 4), ("f", (4, 2))],
         tol=LINALG_TOL),
    Case("triangular_solve", lambda m, x, y: m.triangular_solve(
        m.triu(x) + m.eye(4) * 3, y), [SQ, ("f", (4, 2))], tol=LINALG_TOL),
    Case("triangular_solve:lower_t", lambda m, x, y: m.triangular_solve(
        m.tril(x) + m.eye(4) * 3, y, False, True), [SQ, ("f", (4, 2))],
         tol=LINALG_TOL),
    Case("triangular_solve:unit", lambda m, x, y: m.triangular_solve(
        x, y, unitriangular=True), [SQ, ("f", (4, 2))], tol=LINALG_TOL),
    Case("cholesky_solve", lambda m, b, a: m.cholesky_solve(
        b, m.cholesky(a)), [("f", (4, 2)), ("spd", 4)], tol=LINALG_TOL),
    Case("lstsq", lambda m, x, y: m.lstsq(x, y), [("f", (5, 3)),
                                                  ("f", (5, 2))],
         False, LINALG_TOL),
    Case("lstsq:vec", lambda m, x, y: m.lstsq(x, y)[0], [("f", (5, 3)),
                                                        ("f", (5,))],
         tol=LINALG_TOL),
    Case("matrix_rank", lambda m, x: m.matrix_rank(x), [F34], False),
    Case("matrix_rank:low", lambda m, x: m.matrix_rank(
        m.matmul(x, x, transpose_y=True)), [("f", (4, 2))], False),
    Case("cond", lambda m, x: m.cond(x), [("spd", 4)], tol=LINALG_TOL),
    Case("cov", lambda m, x: m.cov(x), [F34], tol=LINALG_TOL),
    Case("cov:cols", lambda m, x: m.cov(x, False, False), [F34],
         tol=LINALG_TOL),
    Case("corrcoef", lambda m, x: m.corrcoef(x), [F34], tol=LINALG_TOL),
]

ATTR = [
    Case("shape", lambda m, x: m.shape(x), [F34], False),
    Case("rank", lambda m, x: m.rank(x), [("f", (2, 3, 4))], False),
    Case("is_complex", lambda m, x: (m.is_complex(x),
                                     m.is_complex(m.as_complex(x))),
         [("f", (3, 2))], False),
    Case("is_floating_point", lambda m, x, i: (m.is_floating_point(x),
                                               m.is_floating_point(i)),
         [F34, I34], False),
    Case("is_integer", lambda m, x, i, b: (m.is_integer(x), m.is_integer(i),
                                           m.is_integer(b)),
         [F34, I34, B34], False),
]


def _setitem(key):
    def fn(m, x, v):
        y = x * 1.0
        y[key] = v
        return y
    return fn


def _iop(op):
    def fn(m, x, y):
        z = x * 1.0
        if op == "+":
            z += y
        elif op == "-":
            z -= y
        elif op == "*":
            z *= y
        else:
            z /= y
        return z
    return fn


OPERATORS = [
    Case("op:add", lambda m, x, y: x + y, [F34, F4]),
    Case("op:radd", lambda m, x: 2 + x, [I34], False),
    Case("op:sub", lambda m, x, y: x - y, [F34, F4]),
    Case("op:rsub", lambda m, x: 2.5 - x, [F34]),
    Case("op:rsub_bf16", lambda m, x: 2.5 - x.astype("bfloat16"), [F34],
         False),
    Case("op:mul", lambda m, x, y: x * y, [F34, F4]),
    Case("op:rmul", lambda m, x: 3 * x, [I34], False),
    Case("op:truediv", lambda m, x, y: x / y, [F34, POS]),
    Case("op:truediv_int", lambda m, x: x / 2, [I34], False),
    Case("op:rtruediv", lambda m, x: 1.0 / x, [POS]),
    Case("op:floordiv", lambda m, x: x // 3, [I34], False),
    Case("op:rfloordiv", lambda m, x: 7 // x, [("i", (3, 4), 1, 5)], False),
    Case("op:mod", lambda m, x: x % 3, [I34], False),
    Case("op:rmod", lambda m, x: 7.5 % x, [POS], False),
    Case("op:pow", lambda m, x: x ** 2, [F34]),
    Case("op:rpow", lambda m, x: 2 ** x, [F34]),
    Case("op:rpow_int", lambda m, x: 2 ** x, [("i", (3, 4), 0, 5)], False),
    Case("op:matmul", lambda m, x, y: x @ y, [F34, ("f", (4, 2))]),
    Case("op:rmatmul", lambda m, x, y: x.__rmatmul__(y), [F34,
                                                          ("f", (2, 3))]),
    Case("op:neg", lambda m, x: -x, [F34]),
    Case("op:abs", lambda m, x: abs(x), [F34]),
    Case("op:eq", lambda m, x, y: x == y, [I34, I34], False),
    Case("op:ne", lambda m, x: x != 0, [I34], False),
    Case("op:lt", lambda m, x, y: x < y, [F34, F4], False),
    Case("op:le", lambda m, x: x <= 0.5, [F34], False),
    Case("op:gt", lambda m, x: x > 0, [I34], False),
    Case("op:ge", lambda m, x, y: x >= y, [F34, F34], False),
    Case("op:invert", lambda m, x: ~x, [I34], False),
    Case("op:invert_bool", lambda m, x: ~x, [B34], False),
    Case("op:and", lambda m, x, y: x & y, [B34, B34], False),
    Case("op:and_int", lambda m, x, y: x & y, [I34, I34], False),
    Case("op:or", lambda m, x, y: x | y, [B34, B34], False),
    Case("op:xor", lambda m, x, y: x ^ y, [I34, I34], False),
    Case("op:iadd", _iop("+"), [F34, F4]),
    Case("op:isub", _iop("-"), [F34, F4]),
    Case("op:imul", _iop("*"), [F34, F4]),
    Case("op:itruediv", _iop("/"), [F34, POS]),
    Case("op:getitem", lambda m, x: x[1:, ::2], [F34]),
    Case("op:getitem_int", lambda m, x: x[-1], [F34]),
    Case("op:getitem_list", lambda m, x: x[[2, 0]], [F34]),
    Case("op:getitem_mask", lambda m, x, b: x[b], [F34, B34]),
    Case("op:getitem_tensor", lambda m, x, i: x[i], [F34,
                                                    ("i", (2,), 0, 3)]),
    Case("op:setitem", _setitem((0, slice(1, 3))), [F34, ("f", (2,))]),
    Case("op:setitem_row", _setitem(1), [F34, F4]),
    Case("op:setitem_scalar", lambda m, x: _setitem(
        (slice(None), 2))(m, x, 5.0), [F34]),
    Case("op:setitem_mask", lambda m, x: _setitem_mask(m, x), [F34]),
    Case("op:iter", lambda m, x: list(x), [F34]),
    Case("op:T", lambda m, x: x.T, [("f", (2, 3, 4))]),
    Case("op:scalars", lambda m, x: (bool(x[0, 0] > 0), int(x[0, 0]),
                                     float(x[1, 1]), [1, 2, 3][x[0, 1]]),
         [("i", (2, 2), 0, 3)], False),
    Case("op:len", lambda m, x: len(x), [F34], False),
]


def _setitem_mask(m, x):
    y = x * 1.0
    y[y > 0] = 0.0
    return y


METHODS = [
    Case("method:reshape", lambda m, x: x.reshape([4, 3]).unsqueeze(0)
         .squeeze(0).flatten(), [F34]),
    Case("method:reductions", lambda m, x: (x.sum(1), x.mean(), x.max(0),
                                            x.min(), x.prod(1), x.std(),
                                            x.var(1), x.logsumexp(1),
                                            x.cumsum(0), x.norm()), [F34]),
    Case("method:math", lambda m, x: (x.abs().sqrt(), x.exp().log(),
                                      x.tanh(), x.sigmoid(),
                                      x.clip(-0.5, 0.5), x.pow(2),
                                      x.scale(2.0), x.square(),
                                      x.reciprocal(), x.sign()), [POS]),
    Case("method:inplace", lambda m, x, y: _inplace_chain(x, y), [F34, F34]),
    Case("method:search", lambda m, x: (x.argmax(1), x.argsort(0),
                                        x.topk(2)[1], x.sort(1),
                                        x.kthvalue(2)[0]), [F34], False),
    Case("method:logic", lambda m, x, y: (x.equal(y), x.greater_than(y),
                                          x.isclose(y), x.allclose(y),
                                          x.equal_all(y),
                                          x.logical_not()), [F34, F34],
         False),
    Case("method:manip", lambda m, x: (x.transpose([1, 0]), x.tile([1, 2]),
                                       x.expand([2, 3, 4]), x.flip(0),
                                       x.roll(1, 0), x.gather(
                                           m.to_tensor([0, 2])),
                                       x.unbind(1)[0], x.split(2, 1)[1],
                                       x.chunk(2, 1)[0], x.t(),
                                       x.moveaxis(0, 1), x.rot90()),
         [F34]),
    Case("method:longtail", lambda m, x: (x.stack(0), x.slice(
        [0], [1], [3]), x.strided_slice([1], [0], [4], [2]), x.reverse(1),
        x.mul(x), x.add_n(), x.floor_mod(2.0), x.inverse()), [("spd", 4)]),
    Case("method:longtail_inplace", lambda m, x: (
        (x * 1.0).ceil_(), (x * 1.0).floor_(), (x * 1.0).round_(),
        (x.abs() + 1.0).rsqrt_()), [F34], False),
    Case("method:creation", lambda m, x: (x.tril(), x.triu(1), x.diag(),
                                          x.numel(), x.diagonal()), [SQ]),
    Case("method:attrs", lambda m, x: (x.ndim, x.ndimension, x.rank,
                                       x.size, x.shape, x.is_floating_point(),
                                       x.is_integer(), x.is_complex(),
                                       x.is_tensor()),
         [F34], False),
    Case("method:cast", lambda m, x: (x.astype("int32"), x.cast("float16"),
                                      x.clone(), x.detach()), [F34], False),
    Case("method:complex", lambda m, x: (x.as_complex().real(),
                                         x.as_complex().imag(),
                                         x.as_complex().conj().as_real(),
                                         x.as_complex().angle()),
         [("f", (3, 2))], False),
]


def _inplace_chain(x, y):
    z = x * 1.0
    z.add_(y)
    z.subtract_(0.5)
    z.multiply_(y)
    z.scale_(2.0, 1.0)
    z.clip_(-3.0, 3.0)
    z.tanh_()
    w = x * 1.0
    w.exp_()
    w.sqrt_()
    w.reciprocal_()
    return z, w


# --------------------------------------------------------------------------
# the dtype axis: bool, uint8, int8, int16, int32, float16 and bfloat16
# inputs, where the port once differed from the reference (each case
# names its dtype after the colon)
# --------------------------------------------------------------------------

U8 = ("uint8", (3, 4), 0, 256)
I8 = ("int8", (3, 4), -128, 128)
I16 = ("int16", (3, 4), -3000, 3000)
I32 = ("int32", (3, 4), -50, 50)
H34 = ("float16", (3, 4))
BF34 = ("bfloat16", (3, 4))
BOOL = ("bool", (3, 4))
INT_SQ = ("a", np.array([[4, 1, 0, 2], [1, 5, 1, 0], [0, 1, 6, 1],
                         [2, 0, 1, 7]], np.int32))
# out-of-range, infinite and NaN floats: a cast saturates and maps NaN to 0
WILD = ("a", np.array([-2.0, 300.0, 1e10, -1e10, np.nan, np.inf, -np.inf,
                       2.7, -2.7, 127.5, 65535.0, -129.0], np.float32))


def _save_load(m, x):
    with tempfile.TemporaryDirectory() as d:
        m.save({"w": x}, os.path.join(d, "w.pdparams"))
        return m.load(os.path.join(d, "w.pdparams"))["w"]


def _zero_divisor(name, dt):
    """``op(a, b)`` on integers of ``dt`` whose divisor holds zeros."""
    op = name.split(":")[0]
    return Case(name, lambda m, x, y: getattr(m, op)(x, y),
                [(dt, (3, 4), -20 if dt != "uint8" else 0, 20),
                 (dt, (3, 4), -2 if dt != "uint8" else 0, 3)], False)


DTYPES = [
    # bfloat16 read to the host, pickled and saved
    Case("item:bfloat16", lambda m, x: x.item(), [("bfloat16", (1,))],
         False),
    Case("tolist:bfloat16", lambda m, x: x.tolist(), [BF34], False),
    Case("pickle:bfloat16", lambda m, x: pickle.loads(pickle.dumps(x)),
         [BF34], False),
    Case("save:bfloat16", _save_load, [BF34], False),
    # int32, not int64, past x64-off; uint32 for unsigned sums
    Case("dot:int32", lambda m, x, y: m.dot(x, y), [I32, I32], False),
    Case("dot:uint8", lambda m, x, y: m.dot(x, y), [U8, U8], False),
    Case("dot:int8", lambda m, x, y: m.dot(x, y), [I8, I8], False),
    Case("dot:bool", lambda m, x, y: m.dot(x, y), [BOOL, BOOL], False),
    Case("square:bool", lambda m, x: m.square(x), [BOOL], False),
    Case("add_n:bool", lambda m, x: m.add_n([x]), [BOOL], False),
    Case("sum:uint8", lambda m, x: m.sum(x), [U8], False),
    Case("sum:int8", lambda m, x: m.sum(x, 1), [I8], False),
    Case("sum:int16", lambda m, x: m.sum(x), [I16], False),
    Case("sum:float16", lambda m, x: m.sum(x, 0), [H34], False),
    Case("prod:uint8", lambda m, x: m.prod(x, 1), [("uint8", (3, 4), 0, 9)],
         False),
    Case("prod:int16", lambda m, x: m.prod(x), [("int16", (3, 4), -9, 9)],
         False),
    Case("trace:uint8", lambda m, x: m.trace(x), [U8], False),
    Case("cumsum:uint8", lambda m, x: m.cumsum(x, 1), [U8], False),
    Case("cumsum:int8", lambda m, x: m.cumsum(x), [I8], False),
    Case("cumsum:int16", lambda m, x: m.cumsum(x, 0), [I16], False),
    Case("cumprod:int8", lambda m, x: m.cumprod(x, 1), [I8], False),
    # divide truncates only when both operands are integers
    Case("divide:bool_int32", lambda m, x, y: m.divide(x, y),
         [("a", np.array([True, False, True])),
          ("a", np.array([2, 2, 4], np.int32))], False),
    Case("divide:int32_bool", lambda m, x, y: m.divide(x, y),
         [("a", np.array([2, 2, 4], np.int32)),
          ("a", np.array([True, False, True]))], False),
    Case("divide:uint8_bool", lambda m, x, y: m.divide(x, y), [U8, BOOL],
         False),
    _zero_divisor("divide:int32_zero", "int32"),
    _zero_divisor("divide:uint8_zero", "uint8"),
    _zero_divisor("floor_divide:int32_zero", "int32"),
    _zero_divisor("floor_divide:uint8_zero", "uint8"),
    _zero_divisor("remainder:int32_zero", "int32"),
    _zero_divisor("remainder:int16_zero", "int16"),
] + [_binary(f"{n}:bool", BOOL, BOOL, False)
     for n in ("pow", "floor_divide", "remainder", "mod", "floor_mod")] + [
    Case("matmul:bool", lambda m, x, y: m.matmul(x, y),
         [BOOL, ("bool", (4, 2))], False),
    Case("mm:bool", lambda m, x, y: m.mm(x, y), [BOOL, ("bool", (4, 3))],
         False),
    Case("inner:bool", lambda m, x, y: m.inner(x, y),
         [BOOL, ("bool", (2, 4))], False),
    Case("multi_dot:bool", lambda m, x, y, z: m.multi_dot([x, y, z]),
         [BOOL, ("bool", (4, 2)), ("bool", (2, 3))], False),
    Case("abs:bool", lambda m, x: m.abs(x), [BOOL], False),
    Case("abs:int8", lambda m, x: m.abs(x), [I8], False),
    Case("argmax:bool", lambda m, x: m.argmax(x, 1), [BOOL], False),
    Case("argmin:bool", lambda m, x: m.argmin(x), [BOOL], False),
    Case("svd:int32", lambda m, x: m.svd(x), [INT_SQ], False, LINALG_TOL,
         _svd_post),
    Case("qr:int32", lambda m, x: m.qr(x), [INT_SQ], False, LINALG_TOL,
         _qr_post),
    Case("pinv:int32", lambda m, x: m.pinv(x), [INT_SQ], False, LINALG_TOL),
    Case("matrix_rank:int32", lambda m, x: m.matrix_rank(x), [INT_SQ],
         False),
    Case("cond:int32", lambda m, x: m.cond(x), [INT_SQ], False, LINALG_TOL),
    Case("cov:bool", lambda m, x: m.cov(x),
         [("a", np.array([[True, False, True, True],
                          [False, False, True, False]]))], False, LINALG_TOL),
    Case("corrcoef:bool", lambda m, x: m.corrcoef(x),
         [("a", np.array([[True, False, True, True],
                          [False, False, True, False]]))], False, LINALG_TOL),
    # casts saturate and map NaN to 0, from every float width
] + [Case(f"cast:{dt}", lambda m, x, dt=dt: m.cast(x, dt), [WILD], False)
     for dt in ("uint8", "int8", "int16", "int32", "bool", "float16")] + [
    Case("astype:uint8", lambda m, x: x.astype("uint8"), [WILD], False),
    Case("cast:float16_int16", lambda m, x: m.cast(x.astype("float16"),
                                                   "int16"), [WILD], False),
    Case("cast:bfloat16_uint8", lambda m, x: m.cast(x.astype("bfloat16"),
                                                    "uint8"), [WILD], False),
    Case("cast:bfloat16_int32", lambda m, x: x.astype("bfloat16").astype(
        "int32"), [WILD], False),
    Case("cast:int32_uint8", lambda m, x: m.cast(x, "uint8"), [I16], False),
    Case("digamma:poles", lambda m, x: m.digamma(x),
         [("a", np.array([0.0, -1.0, -2.5, 1.5, -0.0], np.float32))], False),
    # everyday ops over the small and 16-bit dtypes
    Case("add:uint8", lambda m, x, y: m.add(x, y), [U8, U8], False),
    Case("multiply:int8", lambda m, x, y: m.multiply(x, y), [I8, I8], False),
    Case("subtract:int16_int32", lambda m, x, y: m.subtract(x, y),
         [I16, I32], False),
    Case("exp:float16", lambda m, x: m.exp(x), [H34], False),
    Case("mean:bfloat16", lambda m, x: m.mean(x, 1), [BF34], False),
    Case("matmul:float16", lambda m, x, y: m.matmul(x, y),
         [H34, ("float16", (4, 2))], False, 1e-2),
    Case("max:uint8", lambda m, x: m.max(x, 0), [U8], False),
    Case("equal:int8_int16", lambda m, x, y: m.equal(x, y),
         [("int8", (3, 4), -2, 2), ("int16", (3, 4), -2, 2)], False),
]

TENSOR_CASES = (CREATION + MATH + MANIP + LOGIC + SEARCH + STAT + LINALG
                + ATTR + OPERATORS + METHODS + DTYPES)

# --------------------------------------------------------------------------
# activations (nn.functional): inputs N(0, 9), so the thresholds bite
# --------------------------------------------------------------------------

X = ("f", (3, 4, 5), 3.0)


def _act(name, fn, specs=(X,)):
    return Case(name, lambda m, *xs: fn(m.nn.functional, *xs), list(specs))


ACT_CASES = [
    _act("relu", lambda F, x: F.relu(x)),
    _act("relu6", lambda F, x: F.relu6(x * 3)),
    _act("sigmoid", lambda F, x: F.sigmoid(x)),
    _act("tanh", lambda F, x: F.tanh(x)),
    _act("silu", lambda F, x: F.silu(x)),
    _act("log_sigmoid", lambda F, x: F.log_sigmoid(x)),
    _act("tanhshrink", lambda F, x: F.tanhshrink(x)),
    _act("softsign", lambda F, x: F.softsign(x)),
    _act("gelu", lambda F, x: F.gelu(x)),
    _act("gelu:tanh", lambda F, x: F.gelu(x, True)),
    _act("elu", lambda F, x: F.elu(x, 0.7)),
    _act("selu", lambda F, x: F.selu(x)),
    _act("leaky_relu", lambda F, x: F.leaky_relu(x, 0.2)),
    _act("prelu", lambda F, x, w: F.prelu(x, w),
         (X, ("u", (4,), 0.1, 0.5))),
    _act("prelu:nhwc", lambda F, x, w: F.prelu(x, w, "NHWC"),
         (("f", (3, 5, 4), 3.0), ("u", (4,), 0.1, 0.5))),
    _act("prelu:one", lambda F, x, w: F.prelu(x, w),
         (X, ("u", (1,), 0.1, 0.5))),
    _act("rrelu", lambda F, x: F.rrelu(x, 0.1, 0.3)),
    _act("hardshrink", lambda F, x: F.hardshrink(x, 1.0)),
    _act("hardtanh", lambda F, x: F.hardtanh(x, -2.0, 1.5)),
    _act("hardsigmoid", lambda F, x: F.hardsigmoid(x)),
    _act("hardswish", lambda F, x: F.hardswish(x)),
    _act("swish", lambda F, x: F.swish(x)),
    _act("mish", lambda F, x: F.mish(x)),
    _act("softplus", lambda F, x: F.softplus(x, 2.0, 5.0)),
    _act("softshrink", lambda F, x: F.softshrink(x, 0.7)),
    _act("thresholded_relu", lambda F, x: F.thresholded_relu(x, 0.5)),
    _act("maxout", lambda F, x: F.maxout(x[..., :4], 2, 2)),
    _act("maxout:axis1", lambda F, x: F.maxout(x[:, :4], 2, 1)),
    _act("softmax", lambda F, x: F.softmax(x, 1)),
    _act("log_softmax", lambda F, x: F.log_softmax(x, -1)),
    _act("log_softmax:dtype", lambda F, x: F.log_softmax(x, 0, "float32")),
    _act("glu", lambda F, x: F.glu(x[..., :4], -1)),
    _act("glu:axis1", lambda F, x: F.glu(x[:, :4], 1)),
    _act("relu_", lambda F, x: F.relu_(x * 1.0)),
    _act("elu_", lambda F, x: F.elu_(x * 1.0, 0.5)),
    _act("softmax_", lambda F, x: F.softmax_(x * 1.0, 0)),
    _act("tanh_", lambda F, x: F.tanh_(x * 1.0)),
]

# --------------------------------------------------------------------------
# losses (nn.functional), in each reduction mode and with their weights
# --------------------------------------------------------------------------

NC = (6, 5)
LX, LY, LZ = ("f", NC), ("f", NC), ("f", NC)
LP = ("u", NC, 0.05, 0.95)          # probabilities
LT = ("01", NC)                     # 0/1 targets
LW = ("u", (5,), 0.5, 2.0)          # class weights
LS = ("f", (6,))
LSIGN = ("sign", (6,))
LSIGN2 = ("sign", NC)
CTC_LABELS = np.array([[3, 1, 4], [2, 2, 1], [4, 1, 1]], np.int32)
CTC_IN = np.array([7, 6, 5], np.int64)
CTC_LAB = np.array([3, 2, 1], np.int64)
CTC = [("f", (7, 3, 5)), ("a", CTC_LABELS), ("a", CTC_IN), ("a", CTC_LAB)]


def _loss(name, fn, specs, tol=TOL):
    return Case(name, lambda m, *xs: fn(m.nn.functional, *xs), list(specs),
                tol=tol)


def _hsig(classes, bias):
    specs = [("f", (6, 4)), ("i", (6, 1), 0, classes),
             ("f", (classes - 1, 4))] + ([("f", (classes - 1,))]
                                         if bias else [])
    return (lambda F, x, y, w, *b: F.hsigmoid_loss(
        x, y, classes, w, b[0] if b else None)), specs


LOSS_CASES = []
for _r in ("none", "mean", "sum"):
    LOSS_CASES += [
        _loss(f"smooth_l1_loss:{_r}", lambda F, x, y, r=_r:
              F.smooth_l1_loss(x, y, r, 0.7), (LX, LY)),
        _loss(f"binary_cross_entropy:{_r}", lambda F, p, t, r=_r:
              F.binary_cross_entropy(p, t, reduction=r), (LP, LT)),
        _loss(f"binary_cross_entropy:weight_{_r}", lambda F, p, t, w, r=_r:
              F.binary_cross_entropy(p, t, w, r), (LP, LT, LW)),
        _loss(f"binary_cross_entropy_with_logits:{_r}", lambda F, x, t,
              r=_r: F.binary_cross_entropy_with_logits(x, t, reduction=r),
              (LX, LT)),
        _loss(f"binary_cross_entropy_with_logits:weights_{_r}",
              lambda F, x, t, w, r=_r: F.binary_cross_entropy_with_logits(
                  x, t, w, r, w * 2.0), (LX, LT, LW)),
        _loss(f"binary_cross_entropy_with_logits:pos_weight_{_r}",
              lambda F, x, p, w, r=_r: F.binary_cross_entropy_with_logits(
                  x * 8.0, p, reduction=r, pos_weight=w), (LX, LP, LW)),
        _loss(f"kl_div:{_r}", lambda F, lp, q, r=_r: F.kl_div(lp, q, r),
              (("logdir", NC), ("dir", NC))),
        _loss(f"margin_ranking_loss:{_r}", lambda F, a, b, s, r=_r:
              F.margin_ranking_loss(a, b, s, 0.3, r), (LS, LS, LSIGN)),
        _loss(f"hinge_embedding_loss:{_r}", lambda F, x, s, r=_r:
              F.hinge_embedding_loss(x, s, 0.8, r), (LX, LSIGN2)),
        _loss(f"cosine_embedding_loss:{_r}", lambda F, a, b, s, r=_r:
              F.cosine_embedding_loss(a, b, s, 0.1, r), (LX, LY, LSIGN)),
        _loss(f"triplet_margin_loss:{_r}", lambda F, a, p, n, r=_r:
              F.triplet_margin_loss(a, p, n, 1.5, reduction=r),
              (LX, LY, LZ)),
        _loss(f"sigmoid_focal_loss:{_r}", lambda F, x, t, r=_r:
              F.sigmoid_focal_loss(x, t, reduction=r), (LX, LT)),
        _loss(f"ctc_loss:{_r}", lambda F, lp, lb, il, ll, r=_r:
              F.ctc_loss(lp, lb, il, ll, 0, r), CTC, LINALG_TOL),
    ]
LOSS_CASES += [
    _loss("kl_div:batchmean", lambda F, lp, q: F.kl_div(lp, q, "batchmean"),
          (("logdir", NC), ("dir", NC))),
    _loss("triplet_margin_loss:swap_p1", lambda F, a, p, n:
          F.triplet_margin_loss(a, p, n, 1.0, 1.0, 1e-6, True),
          (LX, LY, LZ)),
    _loss("sigmoid_focal_loss:normalizer", lambda F, x, t, n:
          F.sigmoid_focal_loss(x, t, n, 0.4, 1.5, "mean"),
          (LX, LT, ("u", (), 2.0, 4.0))),
    _loss("ctc_loss:norm_by_times", lambda F, lp, lb, il, ll:
          F.ctc_loss(lp, lb, il, ll, 0, "mean", True), CTC, LINALG_TOL),
    _loss("square_error_cost", lambda F, x, y: F.square_error_cost(x, y),
          (LX, LY)),
    _loss("log_loss", lambda F, p, t: F.log_loss(p, t), (LP, LT)),
    _loss("log_loss:epsilon", lambda F, p, t: F.log_loss(p, t, 1e-2),
          (LP, LT)),
    _loss("npair_loss", lambda F, a, p, y: F.npair_loss(a, p, y),
          (LX, LY, ("i", (6,), 0, 3))),
    _loss("npair_loss:l2", lambda F, a, p, y: F.npair_loss(a, p, y, 0.05),
          (LX, LY, ("i", (6,), 0, 3))),
    _loss("dice_loss", lambda F, p, y: F.dice_loss(p, y),
          (("dir", NC), ("i", (6, 1), 0, 5))),
    _loss("hsigmoid_loss", *_hsig(5, True)),
    _loss("hsigmoid_loss:no_bias", *_hsig(5, False)),
    _loss("hsigmoid_loss:classes_8", *_hsig(8, True)),
]

# the loss layers, over the same inputs
LOSS_LAYER_CASES = [
    Case("BCELoss", lambda m, p, t, w: m.nn.BCELoss(w, "sum")(p, t),
         [LP, LT, LW]),
    Case("BCEWithLogitsLoss", lambda m, x, t, w: m.nn.BCEWithLogitsLoss(
        pos_weight=w)(x, t), [LX, LT, LW]),
    Case("KLDivLoss", lambda m, lp, q: m.nn.KLDivLoss("batchmean")(lp, q),
         [("logdir", NC), ("dir", NC)]),
    Case("SmoothL1Loss", lambda m, x, y: m.nn.SmoothL1Loss("sum", 0.5)(x, y),
         [LX, LY]),
    Case("MarginRankingLoss", lambda m, a, b, s: m.nn.MarginRankingLoss(
        0.2)(a, b, s), [LS, LS, LSIGN]),
    Case("TripletMarginLoss", lambda m, a, p, n: m.nn.TripletMarginLoss(
        swap=True, reduction="none")(a, p, n), [LX, LY, LZ]),
    Case("CosineEmbeddingLoss", lambda m, a, b, s: m.nn.CosineEmbeddingLoss(
        0.2)(a, b, s), [LX, LY, LSIGN]),
    Case("HingeEmbeddingLoss", lambda m, x, s: m.nn.HingeEmbeddingLoss(
        0.5, "sum")(x, s), [LX, LSIGN2]),
    Case("CTCLoss", lambda m, lp, lb, il, ll: m.nn.CTCLoss(0, "sum")(
        lp, lb, il, ll), CTC, tol=LINALG_TOL),
]

# --------------------------------------------------------------------------
# the rest of nn.functional: extension, common, norm, sequence, vision
# --------------------------------------------------------------------------

IMG = ("f", (2, 4, 5, 6))           # NCHW
VOL = ("f", (2, 3, 4, 5, 4))        # NCDHW
SEQX = ("f", (3, 6, 4))             # padded [B, T, H]
SEQL = ("a", np.array([6, 2, 4], np.int32))
IDS = ("i", (3, 6), 0, 7)


def _nn(name, fn, specs, grad=True, tol=TOL):
    return Case(name, lambda m, *xs: fn(m.nn.functional, *xs), list(specs),
                grad, tol)


def _interp_cases():
    cases = []
    for mode, x, size in (("nearest", IMG, [7, 4]), ("bilinear", IMG, [9, 4]),
                          ("bicubic", IMG, [8, 3]), ("area", IMG, [3, 4]),
                          ("linear", ("f", (2, 3, 7)), [11]),
                          ("trilinear", VOL, [6, 3, 5])):
        for ac in (False, True):
            for am in (0, 1):
                if mode == "area" and (ac or am):
                    continue
                cases.append(_nn(
                    f"interpolate:{mode}_ac{int(ac)}_am{am}",
                    lambda F, a, mode=mode, size=size, ac=ac, am=am:
                    F.interpolate(a, size, mode=mode, align_corners=ac,
                                  align_mode=am,
                                  data_format="NCW" if a.ndim == 3 else
                                  "NCDHW" if a.ndim == 5 else "NCHW"),
                    (x,)))
    cases += [
        _nn("interpolate:area_uneven", lambda F, a: F.interpolate(
            a, [2, 4], mode="area"), (IMG,)),
        _nn("interpolate:scale_nhwc", lambda F, a: F.interpolate(
            a, scale_factor=[1.5, 2.0], mode="bilinear",
            data_format="NHWC"), (IMG,)),
        _nn("interpolate:nearest_down", lambda F, a: F.interpolate(
            a, [3, 4]), (IMG,)),
        _nn("upsample", lambda F, a: F.upsample(a, scale_factor=2,
                                                mode="bilinear",
                                                align_corners=True), (IMG,)),
    ]
    return cases


def _grid_cases():
    cases = []
    for mode in ("bilinear", "nearest"):
        for pm in ("zeros", "border", "reflection"):
            for ac in (True, False):
                cases.append(_nn(
                    f"grid_sample:{mode}_{pm}_ac{int(ac)}",
                    lambda F, x, g, mode=mode, pm=pm, ac=ac: F.grid_sample(
                        x, g, mode, pm, ac),
                    (IMG, ("u", (2, 3, 7, 2), -1.3, 1.3))))
    return cases


def _seq(name, fn, specs, grad=True):
    return _nn(f"sequence_{name}", fn, specs, grad)


NN_CASES = [
    # extension
    _nn("sequence_mask", lambda F, n: F.sequence_mask(n, 7), (SEQL,), False),
    _nn("sequence_mask:no_maxlen", lambda F, n: F.sequence_mask(
        n, dtype="float32"), (SEQL,), False),
    _nn("gather_tree", lambda F, i, p: F.gather_tree(i, p),
        (("i", (5, 2, 3), 0, 9), ("i", (5, 2, 3), 0, 3)), False),
    _nn("temporal_shift", lambda F, x: F.temporal_shift(x, 2, 0.25),
        (("f", (4, 8, 3, 3)),)),
    _nn("temporal_shift:nhwc", lambda F, x: F.temporal_shift(
        x, 2, 0.5, "NHWC"), (("f", (4, 3, 3, 8)),)),
    # common
    _nn("dropout2d:eval", lambda F, x: F.dropout2d(x, 0.4, training=False),
        (IMG,)),
    _nn("dropout3d:eval", lambda F, x: F.dropout3d(x, 0.4, training=False),
        (VOL,)),
    _nn("alpha_dropout:eval", lambda F, x: F.alpha_dropout(
        x, 0.4, training=False), (IMG,)),
    _nn("pad:constant", lambda F, x: F.pad(x, [1, 2, 0, 3], value=0.5),
        (IMG,)),
    _nn("pad:full_form", lambda F, x: F.pad(x, [0, 1, 1, 0, 2, 1, 1, 2]),
        (IMG,)),
    _nn("pad:reflect", lambda F, x: F.pad(x, [2, 1, 3, 2], "reflect"),
        (IMG,)),
    _nn("pad:replicate", lambda F, x: F.pad(x, [2, 1, 3, 2], "replicate"),
        (IMG,)),
    _nn("pad:circular", lambda F, x: F.pad(x, [2, 1, 3, 2], "circular"),
        (IMG,)),
    _nn("pad:nhwc", lambda F, x: F.pad(x, [1, 2, 2, 1], "reflect",
                                      data_format="NHWC"), (IMG,)),
    _nn("pad:ncdhw", lambda F, x: F.pad(x, [1, 0, 2, 1, 0, 1], "replicate",
                                       data_format="NCDHW"), (VOL,)),
    _nn("zeropad2d", lambda F, x: F.zeropad2d(x, [1, 0, 2, 1]), (IMG,)),
] + _interp_cases() + [
    _nn("bilinear", lambda F, a, b, w, c: F.bilinear(a, b, w, c),
        (("f", (4, 3)), ("f", (4, 5)), ("f", (2, 3, 5)), ("f", (2,)))),
    _nn("bilinear:no_bias", lambda F, a, b, w: F.bilinear(a, b, w),
        (("f", (4, 3)), ("f", (4, 5)), ("f", (2, 3, 5)))),
    _nn("cosine_similarity", lambda F, a, b: F.cosine_similarity(a, b),
        (("f", (4, 6)), ("f", (4, 6)))),
    _nn("cosine_similarity:axis", lambda F, a, b: F.cosine_similarity(
        a, b, -1, 1e-6), (("f", (3, 4, 5)), ("f", (3, 4, 5)))),
    _nn("pairwise_distance", lambda F, a, b: F.pairwise_distance(a, b),
        (("f", (4, 6)), ("f", (4, 6)))),
    _nn("pairwise_distance:p1_keepdim", lambda F, a, b: F.pairwise_distance(
        a, b, 1.0, 1e-6, True), (("f", (4, 6)), ("f", (4, 6)))),
    _nn("pairwise_distance:p3", lambda F, a, b: F.pairwise_distance(
        a, b, 3.0), (("f", (4, 6)), ("f", (4, 6)))),
    _nn("one_hot", lambda F, i: F.one_hot(i, 9), (IDS,), False),
    _nn("label_smooth", lambda F, y: F.label_smooth(y, epsilon=0.2),
        (("dir", (5, 6)),)),
    _nn("label_smooth:prior", lambda F, y, p: F.label_smooth(y, p, 0.3),
        (("dir", (5, 6)), ("dir", (1, 6)))),
    _nn("unfold", lambda F, x: F.unfold(x, [2, 3], 1, 1), (IMG,)),
    _nn("unfold:strided", lambda F, x: F.unfold(x, 2, [2, 1], [1, 0, 0, 1],
                                               [1, 2]), (IMG,)),
    _nn("fold", lambda F, x: F.fold(x, [4, 5], 2, 1, 0), (("f", (2, 12, 12)),)),
    _nn("fold:padded", lambda F, x: F.fold(x, [5, 5], [2, 2], 2, 1, 1),
        (("f", (2, 8, 9)),)),
    _nn("pixel_shuffle", lambda F, x: F.pixel_shuffle(x, 2),
        (("f", (2, 8, 3, 2)),)),
    _nn("pixel_shuffle:nhwc", lambda F, x: F.pixel_shuffle(x, 2, "NHWC"),
        (("f", (2, 3, 2, 8)),)),
    _nn("pixel_unshuffle", lambda F, x: F.pixel_unshuffle(x, 2),
        (("f", (2, 2, 4, 6)),)),
    _nn("pixel_unshuffle:nhwc", lambda F, x: F.pixel_unshuffle(
        x, 2, "NHWC"), (("f", (2, 4, 6, 2)),)),
    _nn("channel_shuffle", lambda F, x: F.channel_shuffle(x, 2), (IMG,)),
    _nn("channel_shuffle:nhwc", lambda F, x: F.channel_shuffle(
        x, 3, "NHWC"), (("f", (2, 3, 2, 6)),)),
    # norm
    _nn("normalize", lambda F, x: F.normalize(x), (IMG,)),
    _nn("normalize:p1_axis", lambda F, x: F.normalize(x, 1, -1), (IMG,)),
    _nn("group_norm", lambda F, x, w, b: F.group_norm(x, 2, 1e-5, w, b),
        (IMG, ("f", (4,)), ("f", (4,)))),
    _nn("group_norm:nhwc", lambda F, x, w, b: F.group_norm(
        x, 3, 1e-5, w, b, "NHWC"), (IMG, ("f", (6,)), ("f", (6,)))),
    _nn("group_norm:no_affine", lambda F, x: F.group_norm(x, 4), (IMG,)),
    _nn("instance_norm", lambda F, x, w, b: F.instance_norm(
        x, weight=w, bias=b), (IMG, ("f", (4,)), ("f", (4,)))),
    _nn("instance_norm:nhwc", lambda F, x: F.instance_norm(
        x, data_format="NHWC"), (IMG,)),
    _nn("local_response_norm", lambda F, x: F.local_response_norm(x, 3),
        (("f", (2, 7, 3, 3)),)),
    _nn("local_response_norm:even_nhwc", lambda F, x: F.local_response_norm(
        x, 4, 1e-3, 0.6, 2.0, "NHWC"), (("f", (2, 3, 3, 7)),)),
    # sequence (padded + lengths)
    _seq("pad", lambda F, x, n: F.sequence_pad(x, n, 0.5),
         (("f", (12, 4)), SEQL)),
    _seq("pad:maxlen", lambda F, x, n: F.sequence_pad(x, n, maxlen=8),
         (("f", (12, 4)), SEQL)),
    _seq("unpad", lambda F, x, n: F.sequence_unpad(x, n), (SEQX, SEQL)),
    _seq("pool:sum", lambda F, x, n: F.sequence_pool(x, n), (SEQX, SEQL)),
    _seq("pool:average", lambda F, x, n: F.sequence_pool(x, n, "average"),
         (SEQX, SEQL)),
    _seq("pool:sqrt", lambda F, x, n: F.sequence_pool(x, n, "sqrt"),
         (SEQX, SEQL)),
    _seq("pool:max", lambda F, x, n: F.sequence_pool(x, n, "max"),
         (SEQX, SEQL)),
    _seq("first_step", lambda F, x, n: F.sequence_first_step(x, n),
         (SEQX, SEQL)),
    _seq("last_step", lambda F, x, n: F.sequence_last_step(x, n),
         (SEQX, SEQL)),
    _seq("softmax", lambda F, x, n: F.sequence_softmax(x, n),
         (("f", (3, 6)), SEQL)),
    _seq("reverse", lambda F, x, n: F.sequence_reverse(x, n), (SEQX, SEQL)),
    _seq("expand", lambda F, x, n: F.sequence_expand(x, n),
         (("f", (3, 4)), SEQL)),
    _seq("expand_as", lambda F, x, n: F.sequence_expand_as(x, n, 7),
         (("f", (3, 4)), SEQL)),
    _seq("concat", lambda F, a, b, n, k: F.sequence_concat([a, b], [n, k]),
         (SEQX, ("f", (3, 3, 4)), SEQL, ("a", np.array([1, 3, 0],
                                                       np.int32)))),
    _seq("enumerate", lambda F, i: F.sequence_enumerate(i, 3, -1), (IDS,),
         False),
    _seq("erase", lambda F, i, n: F.sequence_erase(i, n, [2, 5]),
         (IDS, SEQL), False),
    _seq("conv", lambda F, x, n, w: F.sequence_conv(x, n, w),
         (SEQX, SEQL, ("f", (12, 5)))),
    _seq("conv:context", lambda F, x, n, w: F.sequence_conv(x, n, w, 2, 0),
         (SEQX, SEQL, ("f", (8, 5)))),
    _seq("reshape", lambda F, x, n: F.sequence_reshape(x, n, 8),
         (SEQX, SEQL)),
    _seq("slice", lambda F, x, n, o, k: F.sequence_slice(x, n, o, k),
         (SEQX, SEQL, ("a", np.array([1, 0, 2], np.int32)),
          ("a", np.array([3, 2, 2], np.int32)))),
    _seq("scatter", lambda F, x, i, u, n: F.sequence_scatter(x, i, u, n),
         (("f", (3, 6)), ("i", (3, 4), 0, 6), ("f", (3, 4)),
          ("a", np.array([4, 1, 3], np.int32)))),
    # vision
    _nn("affine_grid", lambda F, t: F.affine_grid(t, [2, 3, 4, 5]),
        (("f", (2, 2, 3)),)),
    _nn("affine_grid:no_align", lambda F, t: F.affine_grid(
        t, [2, 3, 4, 5], False), (("f", (2, 2, 3)),)),
    _nn("affine_grid:5d", lambda F, t: F.affine_grid(t, [1, 2, 3, 4, 5]),
        (("f", (1, 3, 4)),)),
] + _grid_cases()

# the reference's functions with no case in NN_CASES, and where each is
# held instead
NN_HELD_ELSEWHERE = {
    "linear": "tests/test_torch_nn.py", "embedding": "tests/test_torch_nn.py",
    "dropout": "tests/test_torch_nn.py (its mask's rate and device)",
    "layer_norm": "tests/test_torch_nn.py", "rms_norm":
    "tests/test_torch_nn.py", "batch_norm": "tests/test_torch_vision.py",
    "diag_embed": "TENSOR_CASES (the tensor API's)",
}


def _layer(name, build, specs, grad=True, tol=TOL, call=None):
    """``build(nn)`` -> a Layer whose state, if any, is drawn from the
    case's seed and set by ``set_state_dict``; ``call(layer, *xs)``
    (default: ``layer(*xs)``)."""
    def fn(m, *xs):
        layer = build(m.nn)
        sd = layer.state_dict()
        if sd:
            rng = R(_seed(name) + 7)
            layer.set_state_dict({k: rng.standard_normal(
                tuple(v.shape)).astype(np.float32) for k, v in sd.items()})
        layer.eval()
        return call(layer, *xs) if call else layer(*xs)
    return Case(name, fn, list(specs), grad, tol)


def _pl_sum(layer, x):
    out = x
    for p in layer:
        out = out * p
    return out


def _ld(nn):
    return nn.LayerDict({"a": nn.Linear(4, 3), "b": nn.Identity()})


NN_LAYER_CASES = [
    _layer("Identity", lambda nn: nn.Identity(3, k=1), (IMG,)),
    _layer("Flatten", lambda nn: nn.Flatten(1, 2), (IMG,)),
    _layer("Dropout2D", lambda nn: nn.Dropout2D(0.3), (IMG,)),
    _layer("Dropout3D", lambda nn: nn.Dropout3D(0.3), (VOL,)),
    _layer("AlphaDropout", lambda nn: nn.AlphaDropout(0.3), (IMG,)),
    _layer("Upsample", lambda nn: nn.Upsample([7, 9], mode="bicubic"),
           (IMG,)),
    _layer("UpsamplingNearest2D", lambda nn: nn.UpsamplingNearest2D(
        scale_factor=2), (IMG,)),
    _layer("UpsamplingBilinear2D", lambda nn: nn.UpsamplingBilinear2D(
        [3, 8]), (IMG,)),
    _layer("Bilinear", lambda nn: nn.Bilinear(3, 5, 2),
           (("f", (4, 3)), ("f", (4, 5)))),
    _layer("CosineSimilarity", lambda nn: nn.CosineSimilarity(0),
           (("f", (4, 6)), ("f", (4, 6)))),
    _layer("PairwiseDistance", lambda nn: nn.PairwiseDistance(1.5),
           (("f", (4, 6)), ("f", (4, 6)))),
    _layer("Pad1D", lambda nn: nn.Pad1D(2, "reflect"), (("f", (2, 3, 6)),)),
    _layer("Pad2D", lambda nn: nn.Pad2D([1, 0, 2, 1], "circular"), (IMG,)),
    _layer("Pad3D", lambda nn: nn.Pad3D(1, "replicate"), (VOL,)),
    _layer("ZeroPad2D", lambda nn: nn.ZeroPad2D(2), (IMG,)),
    _layer("PixelShuffle", lambda nn: nn.PixelShuffle(2),
           (("f", (2, 8, 3, 2)),)),
    _layer("Unfold", lambda nn: nn.Unfold([2, 2], 2), (IMG,)),
    _layer("Fold", lambda nn: nn.Fold([4, 5], 2, 1, 0),
           (("f", (2, 12, 12)),)),
    _layer("ParameterList", lambda nn: nn.ParameterList(
        [nn.Layer().create_parameter([4]) for _ in range(3)]),
        (("f", (3, 4)),), call=_pl_sum),
    _layer("LayerDict", _ld, (("f", (3, 4)),),
           call=lambda d, x: d["b"](d["a"](x))),
    _layer("GroupNorm", lambda nn: nn.GroupNorm(2, 4), (IMG,)),
    _layer("GroupNorm:no_affine", lambda nn: nn.GroupNorm(
        2, 4, weight_attr=False, bias_attr=False), (IMG,)),
    _layer("InstanceNorm1D", lambda nn: nn.InstanceNorm1D(3),
           (("f", (2, 3, 7)),)),
    _layer("InstanceNorm2D", lambda nn: nn.InstanceNorm2D(4), (IMG,)),
    _layer("InstanceNorm3D", lambda nn: nn.InstanceNorm3D(
        3, weight_attr=False), (VOL,)),
    _layer("LocalResponseNorm", lambda nn: nn.LocalResponseNorm(5),
           (("f", (2, 7, 3, 3)),)),
    _layer("SpectralNorm", lambda nn: nn.SpectralNorm([4, 6], 0, 3),
           (("f", (4, 6)),)),
    _layer("SpectralNorm:dim1", lambda nn: nn.SpectralNorm([3, 5, 2], 1),
           (("f", (3, 5, 2)),)),
    _layer("weight_norm", lambda nn: nn.utils.weight_norm(nn.Linear(4, 3)),
           (("f", (5, 4)),)),
    _layer("weight_norm:dim1", lambda nn: nn.weight_norm(nn.Linear(4, 3),
                                                        dim=1),
           (("f", (5, 4)),)),
    _layer("weight_norm:none", lambda nn: nn.weight_norm(nn.Linear(4, 3),
                                                        dim=None),
           (("f", (5, 4)),)),
    _layer("spectral_norm", lambda nn: nn.utils.spectral_norm(
        nn.Linear(4, 3), n_power_iterations=2), (("f", (5, 4)),)),
]

# --------------------------------------------------------------------------
# random ops: (name, fn(mod), dtype, (lo, hi) or None, (mean, var) or None:
# a permutation of arange when None)
# --------------------------------------------------------------------------

RANDOM_CASES = [
    ("rand", lambda m: m.rand([400, 50]), "float32", (0.0, 1.0),
     (0.5, 1 / 12)),
    ("randn", lambda m: m.randn([400, 50]), "float32", None, (0.0, 1.0)),
    ("standard_normal", lambda m: m.standard_normal([400, 50]), "float32",
     None, (0.0, 1.0)),
    ("normal", lambda m: m.normal(2.0, 3.0, [400, 50]), "float32", None,
     (2.0, 9.0)),
    ("normal:tensor", lambda m: m.normal(m.to_tensor(
        np.full((400, 50), 1.0, np.float32)), m.to_tensor(np.float32(0.5))),
     "float32", None, (1.0, 0.25)),
    ("uniform", lambda m: m.uniform([400, 50], min=-2.0, max=2.0),
     "float32", (-2.0, 2.0), (0.0, 16 / 12)),
    ("randint", lambda m: m.randint(0, 10, [400, 50]), "int32", (0, 9),
     (4.5, 99 / 12)),
    ("randint_like", lambda m: m.randint_like(m.to_tensor(
        np.zeros((400, 50), np.int32)), 3, 7), "int32", (3, 6),
     (4.5, 15 / 12)),
    ("randperm", lambda m: m.randperm(20000), "int32", (0, 19999), None),
    ("bernoulli", lambda m: m.bernoulli(m.to_tensor(
        np.full((400, 50), 0.3, np.float32))), "float32", (0.0, 1.0),
     (0.3, 0.21)),
    ("poisson", lambda m: m.poisson(m.to_tensor(
        np.full((400, 50), 4.0, np.float32))), "float32", (0.0, None),
     (4.0, 4.0)),
    ("multinomial", lambda m: m.multinomial(m.to_tensor(
        np.array([0.1, 0.2, 0.7], np.float32)), 20000, True), "int32",
     (0, 2), (1.6, 0.44)),
    ("shuffle", lambda m: m.shuffle(m.to_tensor(
        np.arange(20000, dtype=np.float32))), "float32", (0, 19999), None),
    ("exponential_", lambda m: m.zeros([400, 50]).exponential_(2.0),
     "float32", (0.0, None), (0.5, 0.25)),
    ("uniform_", lambda m: m.zeros([400, 50]).uniform_(1.0, 3.0),
     "float32", (1.0, 3.0), (2.0, 4 / 12)),
    ("normal_", lambda m: m.zeros([400, 50]).normal_(-1.0, 2.0), "float32",
     None, (-1.0, 4.0)),
]


def check_draw(x, rng, moments):
    """A draw ``x`` (numpy) within its range and, with ``moments``, its
    mean within 5 standard errors and its variance within 10%; without,
    a permutation of arange."""
    x = x.astype(np.float64)
    if rng is not None:
        lo, hi = rng
        assert x.min() >= lo and (hi is None or x.max() <= hi), (
            x.min(), x.max())
    if moments is None:
        np.testing.assert_array_equal(np.sort(x.reshape(-1)),
                                      np.arange(x.size))
        return
    mu, var = moments
    assert abs(x.mean() - mu) < 5 * np.sqrt(var / x.size), (x.mean(), mu)
    assert abs(x.var() - var) < 0.1 * var, (x.var(), var)


def two_sample(a, b):
    """Two draws of one distribution (numpy): means within 5 standard
    errors of their difference, variances within 10%."""
    a, b = a.astype(np.float64).reshape(-1), b.astype(np.float64).reshape(-1)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) < 5 * max(se, 1e-12), (a.mean(),
                                                           b.mean())
    assert abs(a.var() - b.var()) < 0.1 * max(a.var(), b.var()), (
        a.var(), b.var())


def check_grads(ref, got, tol, what):
    """Two :func:`grads` lists, each within ``tol`` of max|ref|; returns
    the largest difference over max|ref|."""
    assert len(ref) == len(got), (what, len(ref), len(got))
    worst = 0.0
    for k, (r, g) in enumerate(zip(ref, got)):
        scale = max(float(np.abs(r).max()), 1e-30) if r.size else 1.0
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} grad {k}")
        if r.size:
            worst = max(worst, float(np.abs(g - r).max()) / scale)
    return worst


# --------------------------------------------------------------------------
# the port on the card against the port on the CPU
# --------------------------------------------------------------------------

def _places(out):
    if isinstance(out, (list, tuple)):
        return [p for o in out for p in _places(o)]
    return [str(out.place)] if _is_tensor(out) else []


# reference ops with no case in the tables, and why
LEFT_OUT = {"check_shape": "validates a Python shape argument on the host; "
                           "it makes no tensor (held on the CPU by "
                           "tests/test_torch_tensor_api.py)"}
LEFT_OUT.update({n: f"held by {w}" for n, w in NN_HELD_ELSEWHERE.items()})
LEFT_OUT.update({
    "dropout2d:training": "draws from torch's generators: its masks' "
                          "structure and rate held by "
                          "tests/test_torch_nn_extra.py",
    "alpha_dropout:training": "as dropout2d's",
    "remove_weight_norm": "restores a parameter; held by "
                          "tests/test_torch_nn_extra.py",
})


def card_sweep(pt, cases):
    """Every case with its inputs on the card against the same case on
    the CPU (the port both times): outputs within the case's tolerance
    (exact for integer, bool and index outputs), every output tensor on
    the card, and the gradients within the same tolerance.  Returns
    ``(checked, failed, worst)``: the names that passed, (name, error)
    for those that did not, and name -> the largest difference over
    max|ref| of its outputs and gradients."""
    from paddle_tpu_torch.framework import core
    prev = core._state.expected_place
    checked, failed, worst = [], [], {}
    try:
        for case in cases:
            arr = arrays(case)
            try:
                pt.set_device("cpu")
                _, ref = run(pt, case, arr)
                ref_g = grads(pt, case, arr) if case.grad else None
                pt.set_device("gpu")
                _, got = run(pt, case, arr)
                off = [p for p in _places(got) if "cpu" in p]
                assert not off, f"outputs on {off}"
                err = check(flat(ref), flat(got), case.tol, case.name)
                if case.grad:
                    err = max(err, check_grads(ref_g, grads(pt, case, arr),
                                               case.tol, case.name))
                worst[case.name] = err
                checked.append(case.name)
            except Exception as e:          # collected; the caller fails
                failed.append((case.name,
                               f"{type(e).__name__}: {str(e)[:400]}"))
    finally:
        core._state.expected_place = prev
    return checked, failed, worst


def card_random(pt, cases=None):
    """Each random op drawn on the card: the reference's shape and dtype,
    the card as its place, its range and moments, one seed giving one
    draw and the stream moving on, and the same distribution as the
    CPU's draw (:func:`two_sample`).  Returns ``(checked, failed)``."""
    from paddle_tpu_torch.framework import core
    prev = core._state.expected_place
    checked, failed = [], []
    try:
        for name, fn, dtype, rng, moments in (cases or RANDOM_CASES):
            try:
                pt.set_device("cpu")
                pt.seed(7)
                host = fn(pt).numpy()
                pt.set_device("gpu")
                pt.seed(5)
                a = fn(pt)
                pt.seed(5)
                b = fn(pt)
                c = fn(pt)
                assert "cpu" not in str(a.place), a.place
                assert str(a.dtype).replace("torch.", "") == dtype, a.dtype
                assert tuple(a.shape) == host.shape, (a.shape, host.shape)
                np.testing.assert_array_equal(b.numpy(), a.numpy())
                assert not np.array_equal(c.numpy(), a.numpy())
                check_draw(a.numpy(), rng, moments)
                if moments is not None:
                    two_sample(host, a.numpy())
                checked.append(name)
            except Exception as e:          # collected; the caller fails
                failed.append((name, f"{type(e).__name__}: {str(e)[:400]}"))
    finally:
        core._state.expected_place = prev
    return checked, failed



def _float_outs(outs):
    if isinstance(outs, (list, tuple)):
        res = []
        for o in outs:
            res.extend(_float_outs(o))
        return res
    if _is_tensor(outs) and "float" in str(outs.dtype):
        return [outs]
    return []


def grads(mod, case, arrays):
    xs, out = run(mod, case, arrays, grad=True)
    return _grads_of(mod, case, arrays, xs, out)


def outputs_and_grads(mod, case, arrays):
    """One forward of the case, recorded when it is differentiable: its
    outputs (:func:`flat`) and, for a differentiable case, the
    :func:`grads` of that same forward (else ``None``)."""
    xs, out = run(mod, case, arrays, grad=case.grad)
    return flat(out), (_grads_of(mod, case, arrays, xs, out) if case.grad
                       else None)


def _grads_of(mod, case, arrays, xs, out):
    floats = [a for a in arrays if np.issubdtype(a.dtype, np.floating)]
    return [np.zeros(a.shape, np.float32) if g is None
            else np.asarray(g.numpy())
            for g, a in zip(grad_tensors(mod, case, arrays, xs, out), floats)]


def grad_tensors(mod, case, arrays, xs, out):
    """The grad of sum(out * w) over the float outputs ``out`` of a run
    on ``xs``: ``paddle.grad`` of the outputs with ``w`` as their
    cotangents, a tensor (or ``None``) for each float input; ``[]``
    without float outputs."""
    outs = _float_outs(out)
    if not outs:
        return []
    rng = R(_seed(case.name) + 1)
    ws = []
    for o in outs:
        w = mod.to_tensor(rng.standard_normal(o.shape).astype(np.float32))
        ws.append(w if str(o.dtype).endswith("float32")
                  else w.astype(o.dtype))
    srcs = [x for x, a in zip(xs, arrays)
            if np.issubdtype(a.dtype, np.floating)]
    return mod.grad(outs, srcs, grad_outputs=ws, allow_unused=True)


