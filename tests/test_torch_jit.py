"""The port's ``jit`` (``to_static``, ``save`` / ``load``, ``functional``,
``TracedLayer``, ``ProgramTranslator``) against the JAX package's, on the
CPU, where ``to_static`` runs the forward eagerly through
``functional_call`` with the tape off (the CUDA-graph route is held on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (ag)).

The same numpy weights and inputs, drawn from a seeded ``RandomState``,
go through both packages: the pre-LN encoder of ``chip_smoke.py`` (n) at
2 layers and narrow widths at 1e-5 of max|ref|, a layer with static
kwargs (the reference's ``tests/test_train_semantics.py``), a function,
a train-mode batch norm whose running statistics the call writes back.
``save`` / ``load`` round-trip fp32 and bf16 layers.  The coverage guard
holds every public name of the reference's ``jit`` package against the
port.
"""
import os
import pickle

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.ops import dispatch

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _weights(model, seed):
    """numpy weights for every entry of ``model``'s state dict (norm
    weights near 1)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        w = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        out[k] = (1 + 0.1 * w) if "norm" in k else 0.05 * w
    return out


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


class PtEncoder(pt.nn.Layer):
    """``chip_smoke.py`` (n)'s model on the port: token and position
    embeddings, a pre-LN encoder with an RMSNorm final norm, a head."""

    def __init__(self, V, H, L, nh, F, N):
        super().__init__()
        self.word = pt.nn.Embedding(V, H)
        self.pos = pt.nn.Embedding(N, H)
        self.encoder = pt.nn.TransformerEncoder(
            pt.nn.TransformerEncoderLayer(H, nh, F, dropout=0.0,
                                          activation="gelu",
                                          normalize_before=True),
            L, norm=pt.nn.RMSNorm(H))
        self.head = pt.nn.Linear(H, V)

    def forward(self, ids):
        h = self.word(ids) + self.pos(pt.arange(ids.shape[1]))
        h = self.encoder(h)
        return h, self.head(h)


def _ref_encoder(V, H, L, nh, F, N):
    class Encoder(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = P.nn.Embedding(V, H)
            self.pos = P.nn.Embedding(N, H)
            self.encoder = P.nn.TransformerEncoder(
                P.nn.TransformerEncoderLayer(H, nh, F, dropout=0.0,
                                             activation="gelu",
                                             normalize_before=True),
                L, norm=P.nn.RMSNorm(H))
            self.head = P.nn.Linear(H, V)

        def forward(self, ids):
            h = self.word(ids) + self.pos(P.arange(ids.shape[1]))
            h = self.encoder(h)
            return h, self.head(h)
    return Encoder()


SMALL = dict(V=96, H=32, L=2, nh=4, F=64, N=16)


def test_to_static_encoder_matches_reference():
    """(n)'s encoder at 2 layers: the port's to_static against the
    reference's, on two batch shapes; the outputs stop gradients and equal
    the port's own eager forward."""
    ref = _ref_encoder(**SMALL).eval()
    got = PtEncoder(**SMALL).eval()
    w = _weights(got, 0)
    ref.set_state_dict(w)
    got.set_state_dict(w)
    r_fn, g_fn = P.jit.to_static(ref), pt.jit.to_static(got)
    rng = np.random.RandomState(1)
    for shape in ((2, 16), (3, 8)):
        ids = rng.randint(0, SMALL["V"], shape).astype(np.int32)
        rh, rl = r_fn(P.to_tensor(ids))
        gh, gl = g_fn(pt.to_tensor(ids))
        _close(gh.numpy(), rh.numpy())
        _close(gl.numpy(), rl.numpy())
        assert gh.stop_gradient and gl.stop_gradient
        with pt.no_grad():
            eh, el = got(pt.to_tensor(ids))
        np.testing.assert_array_equal(gl.numpy(), el.numpy())


def _kw_net(m):
    class Net(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = m.nn.Linear(2, 2)

        def forward(self, x, mask=None, double=False):
            out = self.lin(x)
            if mask is not None:
                out = out * mask
            if double:
                out = out * 2.0
            return out
    return Net()


def test_to_static_static_kwargs_match_reference():
    """Tensor kwargs are inputs, the rest fixes the signature (the
    reference's ``test_to_static_forwards_kwargs``)."""
    x = np.ones((2, 2), np.float32)
    mask = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
    outs = {}
    for m in (P, pt):
        net = _kw_net(m)
        net.set_state_dict(_weights(net, 2))
        sfn = m.jit.to_static(net)
        xt, mt = m.to_tensor(x), m.to_tensor(mask)
        outs[m.__name__] = [sfn(xt, mask=mt, double=True).numpy(),
                            sfn(xt, mask=mt).numpy(), sfn(xt).numpy(),
                            net(xt, mask=mt, double=True).numpy()]
    for g, r in zip(outs["paddle_tpu_torch"], outs["paddle_tpu"]):
        _close(g, r)
    g = outs["paddle_tpu_torch"]
    _close(g[0], g[3])


def test_to_static_function_matches_reference():
    """A plain function: positional tensors and a static kwarg."""
    rng = np.random.RandomState(3)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((4, 2)).astype(np.float32)
    outs = []
    for m in (P, pt):
        def fn(x, y, scale=1.0):
            return m.tanh(m.matmul(x, y)) * scale, m.sum(x, 1)
        sfn = m.jit.to_static(fn)
        outs.append([o.numpy() for o in sfn(m.to_tensor(a), m.to_tensor(b),
                                            scale=3.0)])
    for r, g in zip(*outs):
        _close(g, r)


def test_to_static_writes_back_batch_norm_statistics():
    """A train-mode batch norm under to_static: the output and the running
    statistics the call writes back equal the reference's."""
    x = np.random.RandomState(4).standard_normal((6, 3, 4, 4)).astype(
        np.float32)
    res = {}
    for m in (P, pt):
        bn = m.nn.BatchNorm2D(3)
        fn = m.jit.to_static(bn)
        out = fn(m.to_tensor(x))
        out = fn(m.to_tensor(x * 2.0))
        res[m.__name__] = [out.numpy()] + [
            v.numpy() for k, v in sorted(bn.state_dict().items())]
    for g, r in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        _close(g, r)


def test_program_translator_switch_runs_eagerly_on_the_tape():
    net = pt.nn.Linear(3, 2)
    sfn = pt.jit.to_static(net)
    x = pt.to_tensor(np.ones((1, 3), np.float32))
    assert sfn(x).stop_gradient
    tr = pt.jit.ProgramTranslator.get_instance()
    assert dispatch.cache_enabled()
    tr.enable(False)
    dispatch.reset_cache_stats()
    try:
        assert not dispatch.cache_enabled()
        out = sfn(x)
        assert not out.stop_gradient
        out.sum().backward()
        assert net.weight.grad is not None
        assert dispatch.cache_stats()["fallbacks"] == 0
    finally:
        tr.enable(True)
    assert dispatch.cache_enabled()


def test_traced_layer_passes_attributes_through():
    net = pt.nn.Linear(3, 2)
    sfn = pt.jit.to_static(net)
    assert sfn.weight is net.weight
    assert isinstance(sfn, pt.jit.TranslatedLayer)
    assert pt.jit.not_to_static(len) is len
    pt.jit.set_verbosity(3)
    pt.jit.set_code_level(100)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jit_save_load_round_trip(tmp_path, dtype):
    """``save`` writes the reference's file pair; ``load`` gives a
    TracedLayer whose outputs equal the saved model's, bf16 included."""
    model = PtEncoder(**SMALL).eval()
    model.set_state_dict(_weights(model, 5))
    model.to(dtype=dtype)
    ids = pt.to_tensor(np.random.RandomState(6).randint(
        0, SMALL["V"], (2, 16)).astype(np.int32))
    with pt.no_grad():
        want = [o.astype("float32").numpy() for o in model(ids)]
    path = str(tmp_path / "enc" / "model")
    pt.jit.save(pt.jit.to_static(model), path,
                input_spec=[pt.jit.InputSpec([None, 16], "int32")])
    assert os.path.exists(path + ".pdmodel")
    with open(path + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    assert set(state) == set(model.state_dict())
    loaded = pt.jit.load(path)
    assert isinstance(loaded, pt.jit.TracedLayer)
    assert loaded._meta["input_spec"] == [((None, 16), "int32")]
    for k, v in loaded.state_dict().items():
        assert v.dtype == model.state_dict()[k].dtype, k
    got = [o.astype("float32").numpy() for o in loaded(ids)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_functional_call_swaps_state_like_the_reference():
    """``functional_call`` with other weights swapped in gives the
    reference's output for them and leaves the layer's own in place."""
    x = np.random.RandomState(7).standard_normal((2, 3)).astype(np.float32)
    res = {}
    for m in (P, pt):
        lin = m.nn.Linear(3, 2)
        lin.set_state_dict(_weights(lin, 8))
        pv, bv = m.jit.functional.param_arrays(lin)
        other = {k: v * 2 for k, v in pv.items()}
        out, new_buf = m.jit.functional.functional_call(
            lin, other, bv, (m.to_tensor(x),))
        res[m.__name__] = (np.asarray(out), lin.weight.numpy())
        assert new_buf == {}
        assert list(m.jit.functional.collect_state(lin)[0]) == [
            "weight", "bias"]
    _close(res["paddle_tpu_torch"][0], res["paddle_tpu"][0])
    _close(res["paddle_tpu_torch"][1], res["paddle_tpu"][1])


def test_static_mode_flip_clears_the_graph_cache():
    sfn = pt.jit.to_static(pt.nn.Linear(2, 2))
    sfn._graphs["k"] = object()
    sfn._uncapturable.add("u")
    assert dispatch.cache_stats()["size"] >= 1
    pt.enable_static()
    try:
        assert not sfn._graphs
    finally:
        pt.disable_static()
    assert sfn._uncapturable == {"u"}
    dispatch.clear_cache(blacklist=True)
    assert not sfn._uncapturable
    assert set(dispatch.cache_stats()) == {
        "hits", "misses", "fallbacks", "warming", "evictions", "size",
        "blacklisted"}


def test_cpu_calls_capture_nothing():
    dispatch.reset_cache_stats()
    sfn = pt.jit.to_static(pt.nn.Linear(2, 2))
    for _ in range(3):
        sfn(pt.to_tensor(np.ones((1, 2), np.float32)))
    st = dispatch.cache_stats()
    assert (st["hits"], st["misses"], st["warming"]) == (0, 0, 0)
    assert not sfn._graphs


def test_only_host_reads_make_a_capture_fall_back():
    """A capture that breaks on one of the port's host reads (its
    ``GraphBreak``, alone or chained) runs eagerly; any other capture
    failure raises, torch's own refusal to sync a capturing stream
    included (a kernel wrapper that syncs inside a capture is a fault).
    On the CPU the host reads refuse nothing."""
    from paddle_tpu_torch.jit import api
    from paddle_tpu_torch.tensor.tensor import _readable
    brk = pt.jit.functional.GraphBreak("while_loop")
    sync = RuntimeError("CUDA error: operation not permitted when stream "
                        "is capturing")
    assert api._host_sync(brk)
    try:
        try:
            raise brk
        except RuntimeError:
            raise RuntimeError("cudaErrorStreamCaptureInvalidated")
    except RuntimeError as chained:
        assert api._host_sync(chained)
    assert not api._host_sync(sync)
    assert not api._host_sync(RuntimeError("CUDA error: out of memory"))
    assert not api._host_sync(ValueError("shapes differ"))
    t = pt.to_tensor(np.array([3.0], np.float32))
    assert _readable(t.value, "Tensor.item") is t.value
    assert t.item() == 3.0 and float(t) == 3.0 and t.tolist() == [3.0]
    assert pt.nonzero(t).shape == [1, 1]


# --------------------------------------------------------------------------
# coverage guard
# --------------------------------------------------------------------------

def _public(mod):
    import inspect
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v)
                  and n != "annotations")


def test_every_reference_jit_name_is_ported():
    from paddle_tpu.jit import api as r_api, functional as r_fx
    missing = [n for n in _public(P.jit) if not hasattr(pt.jit, n)]
    missing += [f"api.{n}" for n in _public(r_api)
                if not hasattr(pt.jit.api, n)
                and n not in ("core", "fx", "functools", "jax", "jnp", "np",
                              "os", "pickle", "Tensor", "Parameter",
                              "Layer")]
    missing += [f"functional.{n}" for n in _public(r_fx)
                if not hasattr(pt.jit.functional, n)
                and n not in ("core", "jax", "Tensor", "OrderedDict",
                              "contextlib")]
    assert not missing, missing
