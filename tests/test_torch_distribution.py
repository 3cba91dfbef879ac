"""The port's ``distribution`` against the JAX package's, on the CPU.

``log_prob``, ``probs``, ``entropy`` and ``kl_divergence`` are the
reference's formulas: equal at 1e-5 of max|ref| on the same parameters
and values (inf where the reference has inf).  Samples come from
torch's generators, not JAX's PRNG, so they are held in their shapes,
dtypes and supports, one seed giving one draw, and a two-sample moment
check against the reference's own draws (``tools/op_sweep.two_sample``).
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import core
from tools.op_sweep import two_sample

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _close(got, ref):
    g, r = np.asarray(got.numpy()), np.asarray(ref.numpy())
    assert g.shape == r.shape and str(got.dtype).endswith(str(r.dtype))
    fin = np.isfinite(r)
    np.testing.assert_array_equal(g[~fin], r[~fin])
    if fin.any():
        scale = max(np.abs(r[fin]).max(), 1e-30)
        np.testing.assert_allclose(g[fin], r[fin], rtol=0, atol=TOL * scale)


RNG = np.random.RandomState(0)
LOC = RNG.standard_normal((3, 4)).astype(np.float32)
SCALE = RNG.uniform(0.3, 2.0, (3, 4)).astype(np.float32)
LOC2 = RNG.standard_normal((3, 4)).astype(np.float32)
SCALE2 = RNG.uniform(0.3, 2.0, (4,)).astype(np.float32)
VAL = (RNG.standard_normal((3, 4)) * 2).astype(np.float32)
LOGITS = RNG.standard_normal((3, 5)).astype(np.float32)
LOGITS2 = RNG.standard_normal((3, 5)).astype(np.float32)
IDX = np.array([0, 4, 2], np.int32)


def _make(mod):
    D = mod.distribution
    return {
        "uniform": D.Uniform(mod.to_tensor(LOC - 1.5), mod.to_tensor(LOC)),
        "uniform:scalar": D.Uniform(-1.0, 2.0),
        "normal": D.Normal(mod.to_tensor(LOC), mod.to_tensor(SCALE)),
        "normal:broadcast": D.Normal(mod.to_tensor(LOC2),
                                     mod.to_tensor(SCALE2)),
        "categorical": D.Categorical(mod.to_tensor(LOGITS)),
        "categorical:1d": D.Categorical(mod.to_tensor(LOGITS[0])),
        "mvn_diag": D.MultivariateNormalDiag(mod.to_tensor(LOC),
                                             mod.to_tensor(SCALE)),
    }


def _value(mod, name):
    if name.startswith("categorical"):
        return mod.to_tensor(IDX if name == "categorical" else IDX[1])
    return mod.to_tensor(VAL)


NAMES = ["uniform", "uniform:scalar", "normal", "normal:broadcast",
         "categorical", "categorical:1d", "mvn_diag"]


@pytest.mark.parametrize("name", NAMES)
def test_log_prob_probs_entropy_match_reference(name):
    ref, got = _make(P)[name], _make(pt)[name]
    _close(got.log_prob(_value(pt, name)), ref.log_prob(_value(P, name)))
    _close(got.entropy(), ref.entropy())
    if name != "mvn_diag":
        _close(got.probs(_value(pt, name)), ref.probs(_value(P, name)))


@pytest.mark.parametrize("pair", [
    ("normal", lambda D, m: D.Normal(m.to_tensor(LOC2), m.to_tensor(SCALE))),
    ("categorical", lambda D, m: D.Categorical(m.to_tensor(LOGITS2))),
    ("mvn_diag", lambda D, m: D.MultivariateNormalDiag(
        m.to_tensor(LOC2), m.to_tensor(SCALE[::-1].copy()))),
], ids=lambda p: p[0] if isinstance(p, tuple) else "")
def test_kl_divergence_matches_reference(pair):
    name, other = pair
    res = []
    for mod in (P, pt):
        p, q = _make(mod)[name], other(mod.distribution, mod)
        res.append((p.kl_divergence(q), mod.distribution.kl_divergence(p, q)))
    _close(res[1][0], res[0][0])
    _close(res[1][1], res[0][1])


SAMPLES = [
    ("uniform", [20000], (LOC - 1.5, LOC)),
    ("normal", [20000], None),
    ("normal:broadcast", [20000], None),
    ("categorical", [20000], (0, 4)),
    ("mvn_diag", [20000], None),
]


@pytest.mark.parametrize("name,shape,support", SAMPLES,
                         ids=[s[0] for s in SAMPLES])
def test_samples_follow_the_reference_distribution(name, shape, support):
    ref, got = _make(P)[name], _make(pt)[name]
    r = np.asarray(ref.sample(shape).numpy())
    pt.seed(9)
    a = got.sample(shape)
    pt.seed(9)
    b = got.sample(shape)
    c = got.sample(shape)
    g = a.numpy()
    assert g.shape == r.shape and str(a.dtype).endswith(str(r.dtype))
    np.testing.assert_array_equal(b.numpy(), g)
    assert not np.array_equal(c.numpy(), g)
    np.testing.assert_array_equal(got.sample(shape, seed=3).numpy(),
                                  got.sample(shape, seed=3).numpy())
    if support is not None:
        lo, hi = support
        assert (g >= lo).all() and (g <= hi).all()
    # per element of the batch: the same distribution as the reference's
    for idx in np.ndindex(*g.shape[1:]):
        two_sample(r[(slice(None),) + idx], g[(slice(None),) + idx])


def test_sampling_id_matches_reference_distribution():
    p = np.tile(np.array([[0.1, 0.6, 0.3]], np.float32), (4000, 1))
    r = np.asarray(P.distribution.sampling_id(P.to_tensor(p)).numpy())
    pt.seed(2)
    g = pt.distribution.sampling_id(pt.to_tensor(p))
    assert str(g.dtype).endswith(str(r.dtype))
    two_sample(r, g.numpy())
    freq = np.bincount(g.numpy(), minlength=3) / 4000
    assert np.abs(freq - [0.1, 0.6, 0.3]).max() < 0.03, freq
