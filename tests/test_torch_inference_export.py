"""The port's inference export and Predictor against the JAX package, on
the CPU (the reference's ``tests/test_inference_export.py`` and the
standalone-model cases of ``tests/test_inference_predictor.py``).

The port's artifact is ``torch.export`` of the eval forward
(``<prefix>.pt2``) beside the reference's JSON manifest; the kernels on
the path are ``torch.library`` ops, so the exported graph holds
``paddle_tpu.layer_norm``, ``paddle_tpu.flash_fwd`` and
``paddle_tpu.rms_norm`` nodes where the reference's holds its Pallas
calls, and on the CPU they run their plain versions.  ``chip_smoke.py``
(n)'s encoder at 2 layers and narrow widths, with the same numpy weights,
is exported by both packages once (a module fixture) and served by both
``Predictor``s; outputs agree at 1e-5 of max|ref| and the manifests are
equal but for ``format`` and ``platforms``.  The card route (one CUDA
graph a batch bucket) is held by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` (aj).
"""
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu.inference as JI
import paddle_tpu_torch as pt
import paddle_tpu_torch.inference as TI
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.inference.export import StandaloneModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(V=96, H=32, L=2, nh=4, F=64, N=16)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    pt.disable_static()
    P.disable_static()
    core._state.expected_place = prev


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _encoder(mod, V, H, L, nh, F, N):
    """``chip_smoke.py`` (n)'s model on ``mod``'s nn API: token and
    position embeddings, a pre-LN encoder with an RMSNorm final norm, a
    head; the port's class is module-level, so that ``jit.save`` can
    pickle it."""
    class Encoder(mod.nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = mod.nn.Embedding(V, H)
            self.pos = mod.nn.Embedding(N, H)
            self.encoder = mod.nn.TransformerEncoder(
                mod.nn.TransformerEncoderLayer(H, nh, F, dropout=0.0,
                                               activation="gelu",
                                               normalize_before=True),
                L, norm=mod.nn.RMSNorm(H))
            self.head = mod.nn.Linear(H, V)

        def forward(self, ids):
            h = self.word(ids) + self.pos(mod.arange(ids.shape[1]))
            h = self.encoder(h)
            return h, self.head(h)
    if mod is pt:
        Encoder.__qualname__ = "PtEncoder"
        globals()["PtEncoder"] = Encoder
    return Encoder().eval()


def _weights(model, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        w = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        out[k] = (1 + 0.1 * w) if "norm" in k else 0.05 * w
    return out


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """Both packages' encoders with the same weights, each exported once
    at batch 2 (the reference's export of this model does not keep a
    symbolic batch): (port net, ref net, port prefix, ref prefix, port
    manifest, ref manifest)."""
    d = tmp_path_factory.mktemp("enc")
    prev = core._state.expected_place
    pt.set_device("cpu")
    try:
        ref, got = _encoder(P, **SMALL), _encoder(pt, **SMALL)
        w = _weights(got, 0)
        ref.set_state_dict(w)
        got.set_state_dict(w)
        spec = [((2, SMALL["N"]), "int64")]
        names = dict(input_names=["ids"], output_names=["hidden", "logits"])
        tm = TI.save_inference_model(str(d / "port"), got, spec, **names)
        rm = JI.save_inference_model(str(d / "ref"), ref, spec, **names)
    finally:
        core._state.expected_place = prev
    return got, ref, str(d / "port"), str(d / "ref"), tm, rm


def _predict(mod_inference, prefix, x, cpu=True):
    cfg = mod_inference.Config(prefix)
    if cpu:
        cfg.disable_gpu()
    pred = mod_inference.create_predictor(cfg)
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(x)
    pred.run()
    return pred, [pred.get_output_handle(n).copy_to_cpu()
                  for n in pred.get_output_names()]


def test_encoder_predictor_matches_reference(encoders):
    """The port's Predictor on its artifact against the reference's on
    its own; the manifests agree but for format and platforms."""
    got, ref, tp, rp, tm, rm = encoders
    x = np.random.RandomState(3).randint(
        0, SMALL["V"], (2, SMALL["N"])).astype(np.int64)
    tpred, touts = _predict(TI, tp, x)
    _, routs = _predict(JI, rp, x)
    assert tpred.get_output_names() == ["hidden", "logits"]
    for g, r in zip(touts, routs):
        _close(g, r)
    assert (tm["format"], rm["format"]) == ("torch.export", "stablehlo")
    assert tm["platforms"] == ["cpu", "cuda"]
    strip = lambda m: {k: v for k, v in m.items()   # noqa: E731
                       if k not in ("format", "platforms")}
    assert strip(tm) == strip(rm)
    assert tm["inputs"][0]["dtype"] == "int32"     # x64 off, as there
    with pt.no_grad():
        eh, el = got(pt.to_tensor(x))
    np.testing.assert_array_equal(touts[1], el.numpy())


def test_exported_graph_holds_the_kernel_ops(encoders):
    """The artifact's graph: 2L LayerNorm, L flash forward and one
    RMSNorm op, and no aten LayerNorm or attention in their place."""
    import torch
    ep = torch.export.load(encoders[2] + ".pt2")
    n = collections.Counter(str(x.target) for x in ep.graph.nodes
                            if x.op == "call_function")
    L = SMALL["L"]
    assert n["paddle_tpu.layer_norm.default"] == 2 * L
    assert n["paddle_tpu.flash_fwd.default"] == L
    assert n["paddle_tpu.rms_norm.default"] == 1
    assert not [k for k in n if any(s in k for s in (
        "native_layer_norm", "layer_norm.default", "attention", "softmax",
        "rsqrt")) and not k.startswith("paddle_tpu.")]


def test_jit_pair_and_from_layer_serve_the_same_outputs(encoders, tmp_path):
    """The Predictor over a ``jit.save`` pair and over the Layer in memory
    give the artifact's outputs."""
    got, _, tp, _, _, _ = encoders
    x = np.random.RandomState(7).randint(
        0, SMALL["V"], (2, SMALL["N"])).astype(np.int64)
    _, want = _predict(TI, tp, x)
    pt.jit.save(got, str(tmp_path / "pair"),
                input_spec=[pt.static.InputSpec([None, SMALL["N"]],
                                                "int64")])
    cfg = TI.Config(str(tmp_path / "pair"))
    cfg.disable_gpu()
    for pred in (TI.Predictor(cfg),
                 TI.Predictor.from_layer(got, _cpu_config())):
        outs = pred.run([x])
        assert len(outs) == 2
        for g, w in zip(outs, want):
            np.testing.assert_array_equal(g, w)


def _cpu_config(prefix=None):
    cfg = TI.Config(prefix)
    cfg.disable_gpu()
    return cfg


def test_unknown_handle_and_missing_path_raise(encoders):
    pred = TI.create_predictor(_cpu_config(encoders[2]))
    with pytest.raises(KeyError):
        pred.get_input_handle("nope")
    with pytest.raises(ValueError, match="model_path"):
        TI.create_predictor(_cpu_config())


def test_cross_process_load(tmp_path):
    """A fresh interpreter that imports ``paddle_tpu_torch`` and no model
    class serves the artifact."""
    net = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                           pt.nn.Linear(8, 3)).eval()
    prefix = str(tmp_path / "xp")
    TI.save_inference_model(prefix, net, [((2, 4), "float32")])
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    np.save(str(tmp_path / "x.npy"), x)
    script = (
        "import json, numpy as np\n"
        "from paddle_tpu_torch.inference import Config, create_predictor\n"
        f"cfg = Config({prefix!r}); cfg.disable_gpu()\n"
        "pred = create_predictor(cfg)\n"
        f"out = pred.run([np.load({str(tmp_path / 'x.npy')!r})])[0]\n"
        "import sys\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'paddle_tpu')]\n"
        "print('RESULT ' + json.dumps([out.tolist(), bad]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    out, bad = json.loads(line[0][len("RESULT "):])
    assert bad == []
    with pt.no_grad():
        want = net(pt.to_tensor(x)).numpy()
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=1e-6, atol=1e-6)


def test_function_and_onnx_export_match_reference(tmp_path):
    """A function of Tensors, and ``onnx.export`` of a Layer, through
    both packages' artifacts."""
    x = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    outs = {}
    for key, mod, inf in (("ref", P, JI), ("port", pt, TI)):
        F = mod.nn.functional
        inf.save_inference_model(str(tmp_path / f"fn_{key}"),
                                 lambda t: F.softmax(t * 2.0, axis=-1),
                                 [((3, 5), "float32")])
        _, (out,) = _predict(inf, str(tmp_path / f"fn_{key}"), x)
        outs[key] = out
    _close(outs["port"], outs["ref"])
    net = pt.nn.Sequential(pt.nn.Linear(5, 2)).eval()
    meta = pt.onnx.export(net, str(tmp_path / "ox"),
                          input_spec=[((1, 5), "float32")])
    assert meta["format"] == "torch.export"
    assert os.path.exists(str(tmp_path / "ox") + ".pt2")
    with pytest.raises(ValueError, match="input_spec"):
        pt.onnx.export(net, str(tmp_path / "oy"))


def test_static_save_load_inference_model_matches_reference(tmp_path):
    """A static program frozen into the artifact, loaded and run through
    the Executor: the program's own fetch, the reference's."""
    got = {}
    xv = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    w = np.random.RandomState(1).randn(4, 2).astype(np.float32)
    for key, mod in (("ref", P), ("port", pt)):
        S = mod.static
        mod.enable_static()
        main, startup = S.Program(), S.Program()
        with S.program_guard(main, startup):
            # a static batch: the reference freezes the placeholder's shape
            x = S.data("x", [3, 4], "float32")
            lin = mod.nn.Linear(4, 2)
            lin.weight.set_value(w)
            out = mod.nn.functional.relu(lin(x)) * 2.0
        exe = S.Executor()
        exe.run(startup)
        want, = exe.run(main, feed={"x": xv}, fetch_list=[out])
        prefix = str(tmp_path / f"static_{key}")
        S.save_inference_model(prefix, [x], [out], exe, program=main)
        mod.disable_static()
        prog, feeds, fetches = S.load_inference_model(prefix)
        assert feeds == ["x"]
        res, = S.Executor().run(prog, feed={"x": xv}, fetch_list=fetches)
        np.testing.assert_allclose(res, want, rtol=1e-6, atol=1e-6)
        got[key] = res
    _close(got["port"], got["ref"])


def _export_fn(tmp_path, name, fn):
    prefix = str(tmp_path / name)
    TI.save_inference_model(prefix, fn, [((None, 4), "float32")])
    return StandaloneModel(prefix, device="cpu")


def test_dynamic_batch_buckets_and_signature_cache(tmp_path):
    """A symbolic batch: batches 5 and 7 pad to the 8-bucket, one
    signature (``standalone_compiles`` + 1), outputs sliced back; a
    repeated static shape is one signature too."""
    net = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.Tanh(),
                           pt.nn.Linear(8, 3)).eval()
    meta = TI.save_inference_model(str(tmp_path / "poly"), net,
                                   [((None, 4), "float32")])
    assert meta["dynamic_batch"] is True
    assert meta["inputs"][0]["shape"] == [-1, 4]
    m = StandaloneModel(str(tmp_path / "poly"), device="cpu")
    c0 = pt.profiler.serving_stats()["standalone_compiles"]
    rng = np.random.RandomState(1)
    for b in (5, 7, 1):
        x = rng.randn(b, 4).astype(np.float32)
        out, = m(x)
        assert tuple(out.shape) == (b, 3)
        with pt.no_grad():
            want = net(pt.to_tensor(x)).numpy()
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    assert pt.profiler.serving_stats()["standalone_compiles"] == c0 + 2
    assert m._bucket_probed and m._bucketing


@pytest.mark.parametrize("case", ["row_mixing", "inconclusive",
                                  "aggregating", "zero_batch"])
def test_bucket_probe_cases(tmp_path, case):
    """A row-mixing model (x - mean over the batch) is caught by the
    probe, answered exactly, and bucketing stays off; an all-zero last
    row leaves the probe pending and answers exactly; an output with no
    batch axis is never bucketed; batch 0 takes the exact path (where the
    reference's symbolic dims refuse it, torch's give an empty batch)."""
    import paddle_tpu_torch.tensor.math as M
    if case == "aggregating":
        m = _export_fn(tmp_path, case, lambda x: x.mean())
        out, = m(np.full((3, 4), 2.0, np.float32))
        np.testing.assert_allclose(out.numpy(), 2.0, rtol=1e-6)
        assert m._bucketing is False
        return
    if case == "zero_batch":
        m = _export_fn(tmp_path, case, lambda x: x * 2.0)
        out, = m(np.zeros((0, 4), np.float32))
        assert tuple(out.shape) == (0, 4)
        assert m._bucket_probed is False
        return
    m = _export_fn(tmp_path, case, lambda x: x - M.mean(x, 0, True))
    x = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    if case == "inconclusive":
        x[-1] = 0.0
        out, = m(x)
        np.testing.assert_allclose(out.numpy(), x - x.mean(0), rtol=1e-5,
                                   atol=1e-6)
        assert m._bucket_probed is False
        x = np.random.RandomState(6).randn(3, 4).astype(np.float32)
    out, = m(x)
    np.testing.assert_allclose(out.numpy(), x - x.mean(0), rtol=1e-5,
                               atol=1e-6)
    assert m._bucketing is False
    out2, = m(x)
    np.testing.assert_allclose(out2.numpy(), x - x.mean(0), rtol=1e-5,
                               atol=1e-6)


def test_predictor_device_selection():
    """``enable_use_gpu`` asks for the card (which raises here, as every
    entry point of the port does without one); ``disable_gpu`` the CPU;
    no choice is the card."""
    import torch
    cfg = TI.Config()
    cfg.disable_gpu()
    assert cfg.device() == torch.device("cpu")
    cfg.enable_use_gpu(100, 0)
    assert cfg._device == "cuda:0"
    if not torch.cuda.is_available():
        for c in (cfg, TI.Config()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                c.device()
    cfg.switch_ir_optim(False)
    cfg.enable_memory_optim()
    assert cfg._ir_optim is False and cfg._memory_optim is True


def test_encoder_exports_with_a_dynamic_batch(encoders, tmp_path):
    """The port's encoder keeps a symbolic batch through its reshapes
    (``tensor/manipulation._ints`` leaves symbolic sizes alone, where
    ``int()`` fixed the batch at the example's): ``dynamic_batch`` holds
    and batches 3 and 4 share the 4-bucket's signature, equal to the
    eager forward."""
    got = encoders[0]
    prefix = str(tmp_path / "dyn")
    meta = TI.save_inference_model(prefix, got,
                                   [((None, SMALL["N"]), "int64")])
    assert meta["dynamic_batch"] is True
    assert meta["inputs"][0]["shape"] == [-1, SMALL["N"]]
    assert [o["shape"] for o in meta["outputs"]] == [
        [-1, SMALL["N"], SMALL["H"]], [-1, SMALL["N"], SMALL["V"]]]
    m = StandaloneModel(prefix, device="cpu")
    rng = np.random.RandomState(11)
    for b in (3, 4):
        x = rng.randint(0, SMALL["V"], (b, SMALL["N"])).astype(np.int64)
        outs = m(x)
        with pt.no_grad():
            want = got(pt.to_tensor(x))
        for o, w in zip(outs, want):
            _close(o.numpy(), w.numpy())
    assert len(m._calls) == 1
