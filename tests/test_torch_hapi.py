"""The port's ``hapi.Model``, callbacks and ``metric`` against the JAX
package, on the CPU.

The reference's ``Model`` trains through one jitted functional step; the
port's through the eager tape and its multi-tensor ``Optimizer.step``.
Both start from the same weights (the reference's ``state_dict``, as
numpy, into ``set_state_dict``) and read the same batches (one numpy
seed for the shuffle), so losses, parameters, ``evaluate`` logs and
``predict`` outputs must agree: at 1e-5 (absolute, fp32, sums in another
order) for the ERNIE classifier below (2 layers, H=64, the flash route,
plain on the CPU; AdamW with ``ClipGradByGlobalNorm`` on a
``LinearWarmup`` stepped by the ``LRScheduler`` callback), also with
``accumulate_grad_batches=2`` and ``num_iters``.  Also the counterparts of
``tests/test_hapi_io.py``'s Model tests, ``.pdparams`` / ``.pdopt`` files
read across the two packages, the checkpoint files of ``EarlyStopping``
and ``ModelCheckpoint``, and the metrics.
"""
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.models import bert as JB
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.models import bert as TB

TOL = 1e-5
V, H, N = 512, 64, 64


@pytest.fixture(autouse=True)
def _cpu():
    """The CPU as the default place and one intra-op thread (tiny ops on
    many threads stall on a shared host); both restored after."""
    prev, threads = core._state.expected_place, torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    core._state.expected_place = prev
    torch.set_num_threads(threads)


def _state(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _carry(ref_net, net):
    """``net`` given ``ref_net``'s weights; returns ``net``."""
    net.set_state_dict(_state(ref_net))
    return net


# --------------------------------------------------------------------------
# the ERNIE classifier, in both packages
# --------------------------------------------------------------------------

_JCFG = dataclasses.replace(JB.bert_tiny(), vocab_size=V, hidden_size=H,
                            num_layers=2, num_heads=1, max_seq_len=N,
                            use_flash=True, remat=True, dtype="float32")
_TCFG = TB.BertConfig(**dataclasses.asdict(_JCFG))


def _classifier(mod):
    """ERNIE's pooled output into a ``Linear(H, 2)``."""
    bert = JB if mod is P else TB
    cfg = _JCFG if mod is P else _TCFG

    class Classifier(mod.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ernie = bert.ErnieModel(cfg)
            self.cls = mod.nn.Linear(H, 2)

        def forward(self, tokens):
            _, pooled = self.ernie(tokens)
            return self.cls(pooled)
    return Classifier()


def _tokens(mod, n, seed):
    """n samples: N token ids and the first id's parity as the label."""
    class Tokens(mod.io.Dataset):
        def __init__(self):
            rng = np.random.default_rng(seed)
            self.t = rng.integers(0, V, (n, N)).astype(np.int64)
            self.y = (self.t[:, :1] % 2).astype(np.int64)

        def __len__(self):
            return n

        def __getitem__(self, i):
            return self.t[i], self.y[i]
    return Tokens()


def _prepared(mod, net, clip=1.0, warmup=4):
    sched = mod.optimizer.lr.LinearWarmup(1e-3, warmup, 0.0, 1e-3)
    opt = mod.optimizer.AdamW(
        learning_rate=sched, weight_decay=0.01,
        grad_clip=mod.nn.ClipGradByGlobalNorm(clip),
        parameters=net.parameters())
    m = mod.Model(net, inputs=[mod.static.InputSpec([None, N], "int64")],
                  labels=[mod.static.InputSpec([None, 1], "int64")])
    m.prepare(opt, mod.nn.CrossEntropyLoss(), mod.metric.Accuracy())
    return m


def _fit_ernie(mod, net, **fit_kw):
    """Fit 2 epochs of 4 batches (32 samples, batch 8, shuffled from numpy
    seed 3), then evaluate and predict 16 more."""
    m = _prepared(mod, net)
    losses, lrs = [], []

    class Record(mod.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])
            lrs.append(m._optimizer.get_lr())

    np.random.seed(3)
    m.fit(_tokens(mod, 32, 0), batch_size=8, epochs=2, verbose=0,
          callbacks=[Record()], **fit_kw)
    ev = m.evaluate(_tokens(mod, 16, 1), batch_size=8, verbose=0)
    pred = m.predict(_tokens(mod, 16, 1), batch_size=8, stack_outputs=True)
    return dict(model=m, losses=losses, lrs=lrs, params=_state(net),
                eval=ev, pred=pred[0], steps=m._optimizer._step_count)


def _assert_runs_agree(got, want):
    assert len(got["losses"]) == len(want["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL,
                               atol=0)
    assert got["lrs"] == pytest.approx(want["lrs"], abs=1e-12)
    assert got["steps"] == want["steps"]
    assert got["params"].keys() == want["params"].keys()
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0, atol=TOL,
                                   err_msg=k)
    assert got["eval"].keys() == want["eval"].keys()
    assert got["eval"]["acc"] == want["eval"]["acc"]
    assert got["eval"]["loss"] == pytest.approx(want["eval"]["loss"],
                                                rel=TOL)
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def ernie_weights():
    """The classifier's initial weights, drawn from the reference's
    generator at a fixed seed; the generator's state is restored after,
    so the weights do not depend on which tests ran before."""
    state = P.get_rng_state()
    P.seed(1234)
    try:
        return _state(_classifier(P))
    finally:
        P.set_rng_state(state)


def _pair(weights):
    ref = _classifier(P)
    ref.set_state_dict({k: P.to_tensor(v) for k, v in weights.items()})
    net = _classifier(pt)
    net.set_state_dict(weights)
    return ref, net


@pytest.mark.parametrize("fit_kw", [{}, {"accumulate_grad_batches": 2},
                                    {"accumulate_grad_batches": 3},
                                    {"num_iters": 6}],
                         ids=["plain", "accumulate2", "accumulate3",
                              "num_iters"])
def test_ernie_classifier_fit_matches_reference(ernie_weights, fit_kw):
    """Per-batch losses and lrs, optimizer updates, final params,
    ``evaluate`` logs and ``predict`` outputs equal the reference's.
    Accumulating 3 over 4 batches an epoch applies a partial window (the
    mean of one) on each epoch's last batch."""
    ref, net = _pair(ernie_weights)
    want = _fit_ernie(P, ref, **fit_kw)
    got = _fit_ernie(pt, net, **fit_kw)
    _assert_runs_agree(got, want)
    k = fit_kw.get("accumulate_grad_batches", 1)
    updates = (fit_kw.get("num_iters") or 8 if k == 1
               else 2 * -(-4 // k))
    assert got["steps"] == updates
    assert got["losses"][-1] < got["losses"][0]


def test_pdparams_and_pdopt_cross_both_ways(ernie_weights, tmp_path):
    """A checkpoint saved by the reference's Model loads into the port's
    and predicts the same; resuming from it trains the same as the
    reference resumed; and the reverse."""
    for src, dst in ((P, pt), (pt, P)):
        src_net = _classifier(src)
        src_net.set_state_dict(
            {k: src.to_tensor(v) if src is P else v
             for k, v in ernie_weights.items()})
        m = _prepared(src, src_net)
        np.random.seed(3)
        m.fit(_tokens(src, 16, 0), batch_size=8, epochs=1, verbose=0)
        path = str(tmp_path / f"{src.__name__}" / "ckpt")
        m.save(path)
        assert os.path.exists(path + ".pdparams")
        assert os.path.exists(path + ".pdopt")
        want = m.predict(_tokens(src, 8, 2), batch_size=8)[0][0]
        resumed = {}
        for mod, model in ((src, m), (dst, None)):
            if model is None:
                model = _prepared(dst, _classifier(dst))
                model.load(path)
                got = model.predict(_tokens(dst, 8, 2), batch_size=8)[0][0]
                np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
            np.random.seed(4)
            model.fit(_tokens(mod, 16, 5), batch_size=8, epochs=1,
                      verbose=0)
            resumed[mod.__name__] = (model._optimizer._step_count,
                                     _state(model.network))
        (sa, pa), (sb, pb) = resumed.values()
        assert sa == sb == 4
        for k in pa:
            np.testing.assert_allclose(pb[k], pa[k], rtol=0, atol=TOL,
                                       err_msg=k)


# --------------------------------------------------------------------------
# counterparts of tests/test_hapi_io.py
# --------------------------------------------------------------------------

def _xor(mod, n=512, seed=0):
    """Tiny separable problem: y = (x0 > 0) ^ (x1 > 0)."""
    class XorDataset(mod.io.Dataset):
        def __init__(self):
            rng = np.random.RandomState(seed)
            self.x = rng.randn(n, 2).astype(np.float32)
            self.y = ((self.x[:, 0] > 0) ^ (self.x[:, 1] > 0)).astype(
                np.int64)

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return self.x[i], self.y[i]
    return XorDataset()


def _mlp(mod, act="Tanh"):
    return mod.nn.Sequential(mod.nn.Linear(2, 32), getattr(mod.nn, act)(),
                             mod.nn.Linear(32, 2))


def _both(make, *args):
    """The same network in both packages, the port's with the reference's
    weights."""
    ref = make(P, *args)
    return ref, _carry(ref, make(pt, *args))


def test_model_fit_evaluate_predict():
    """20 epochs of Adam on the XOR MLP: both packages above 0.9 accuracy,
    with the same evaluation and predictions (1e-4: 160 steps compound
    fp32 rounding)."""
    out = {}
    for mod, net in zip((P, pt), _both(_mlp)):
        m = mod.Model(net)
        m.prepare(mod.optimizer.Adam(2e-2, parameters=net.parameters()),
                  mod.nn.CrossEntropyLoss(), mod.metric.Accuracy())
        np.random.seed(0)
        m.fit(_xor(mod), epochs=20, batch_size=64, verbose=0, shuffle=True)
        res = m.evaluate(_xor(mod, seed=1), batch_size=64, verbose=0)
        assert res["acc"] > 0.9, res
        preds = m.predict(_xor(mod, seed=2), batch_size=64, verbose=0,
                          stack_outputs=True)
        assert np.asarray(preds[0]).shape == (512, 2)
        out[mod] = res, np.asarray(preds[0])
    (rr, rp), (tr, tp) = out[P], out[pt]
    assert abs(tr["acc"] - rr["acc"]) <= 2 / 512
    np.testing.assert_allclose(tp, rp, rtol=0, atol=1e-4)


def test_model_save_load_roundtrip(tmp_path):
    m = pt.Model(_mlp(pt))
    m.prepare(pt.optimizer.Adam(5e-3, parameters=m.network.parameters()),
              pt.nn.CrossEntropyLoss())
    m.fit(_xor(pt), epochs=1, batch_size=128, verbose=0)
    path = str(tmp_path / "ckpt")
    m.save(path)
    m2 = pt.Model(_mlp(pt))
    m2.prepare(pt.optimizer.Adam(5e-3, parameters=m2.network.parameters()),
               pt.nn.CrossEntropyLoss())
    m2.load(path)
    x = pt.to_tensor(np.zeros((3, 2), np.float32))
    np.testing.assert_array_equal(m.network(x).numpy(),
                                  m2.network(x).numpy())
    assert m2._optimizer._step_count == m._optimizer._step_count == 4


def test_model_summary():
    info = pt.Model(_mlp(pt)).summary(input_size=(1, 2))
    assert info == P.Model(_mlp(P)).summary(input_size=(1, 2))
    assert info["total_params"] == 2 * 32 + 32 + 32 * 2 + 2


def test_early_stopping_and_checkpoint_callbacks(tmp_path):
    """The files each package's callbacks write are the same set, and the
    port's load."""
    files = {}
    for mod, net in zip((P, pt), _both(_mlp)):
        d = tmp_path / mod.__name__
        m = mod.Model(net)
        m.prepare(mod.optimizer.Adam(5e-3, parameters=net.parameters()),
                  mod.nn.CrossEntropyLoss())
        cb = [mod.callbacks.EarlyStopping(monitor="loss", patience=1,
                                          min_delta=10.0),
              mod.callbacks.ModelCheckpoint(save_dir=str(d), save_freq=1)]
        np.random.seed(0)
        m.fit(_xor(mod), eval_data=_xor(mod, 64, 9), epochs=5,
              batch_size=128, verbose=0, callbacks=cb, save_dir=str(d))
        files[mod] = sorted(os.listdir(d))
        assert m.stop_training
    assert files[pt] == files[P]
    assert "0.pdparams" in files[pt] and "final.pdparams" in files[pt]
    assert "best_model.pdparams" in files[pt]
    m = pt.Model(_mlp(pt))
    m.prepare(pt.optimizer.Adam(5e-3, parameters=m.network.parameters()))
    m.load(str(tmp_path / "paddle_tpu" / "final"))


class TestFitContract:
    """Counterparts of test_hapi_io.py::TestFitContract."""

    def _model(self, mod=pt, net=None):
        net = net or mod.nn.Sequential(mod.nn.Linear(2, 16), mod.nn.ReLU(),
                                       mod.nn.Linear(16, 2))
        model = mod.Model(net)
        model.prepare(mod.optimizer.Adam(1e-2, parameters=net.parameters()),
                      mod.nn.CrossEntropyLoss(), mod.metric.Accuracy())
        return model

    def test_fit_iterable_dataset_loader(self):
        class Stream(pt.io.IterableDataset):
            def __iter__(self):
                rng = np.random.RandomState(0)
                for _ in range(8):
                    x = rng.randn(16, 2).astype(np.float32)
                    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.int64)
                    yield x, y.reshape(-1, 1)

        loader = pt.io.DataLoader(Stream(), batch_size=None)
        model = self._model()
        model.fit(loader, epochs=1, verbose=0)   # must not raise
        assert model._optimizer._step_count == 1

    def test_num_iters_bounds_total_steps(self):
        seen = []

        class Counter(pt.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append(step)

        self._model().fit(_xor(pt, 256), epochs=5, batch_size=32,
                          num_iters=3, verbose=0, callbacks=[Counter()])
        assert len(seen) == 3, seen

    def test_lr_scheduler_steps_per_batch(self):
        lrs = []
        for mod in (P, pt):
            net = mod.nn.Linear(2, 2)
            sched = mod.optimizer.lr.StepDecay(learning_rate=0.1,
                                               step_size=4, gamma=0.5)
            opt = mod.optimizer.SGD(learning_rate=sched,
                                    parameters=net.parameters())
            model = mod.Model(net)
            model.prepare(opt, mod.nn.CrossEntropyLoss())
            model.fit(_xor(mod, 256), epochs=1, batch_size=32, verbose=0)
            lrs.append(opt.get_lr())
        # 8 batches / step_size 4 -> two decays: 0.1 -> 0.05 -> 0.025
        assert abs(lrs[1] - 0.025) < 1e-9 and lrs[0] == lrs[1]

    def test_two_input_model_split_by_spec(self):
        class TwoIn(pt.nn.Layer):
            def __init__(self):
                super().__init__()
                self.lin = pt.nn.Linear(4, 2)

            def forward(self, a, b):
                return self.lin(pt.concat([a, b], axis=-1))

        class PairDs(pt.io.Dataset):
            def __len__(self):
                return 64

            def __getitem__(self, i):
                rng = np.random.RandomState(i)
                a = rng.randn(2).astype(np.float32)
                b = rng.randn(2).astype(np.float32)
                return a, b   # two inputs, NO label

        specs = [pt.static.InputSpec([None, 2], "float32", "a"),
                 pt.static.InputSpec([None, 2], "float32", "b")]
        model = pt.Model(TwoIn(), inputs=specs)
        model.prepare()
        out = model.predict(PairDs(), batch_size=16, verbose=0)
        assert np.asarray(out[0][0]).shape == (16, 2)
        assert len(out) == 4

    def test_early_stopping_monitors_eval_and_saves_best(self, tmp_path):
        model = self._model()
        es = pt.callbacks.EarlyStopping(monitor="acc", patience=0,
                                        verbose=0)
        model.fit(_xor(pt, 256), eval_data=_xor(pt, 64, seed=9),
                  epochs=6, batch_size=32, verbose=0,
                  save_dir=str(tmp_path), callbacks=[es])
        assert es.best is not None          # saw eval metrics
        assert os.path.exists(str(tmp_path / "best_model.pdparams"))

    def test_early_stopping_warns_without_eval_data(self):
        model = self._model()
        es = pt.callbacks.EarlyStopping(monitor="acc", verbose=0)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            model.fit(_xor(pt, 64), epochs=1, batch_size=32, verbose=0,
                      callbacks=[es])
        assert any("validation data" in str(x.message) for x in w)


def test_accumulate_grad_batches_matches_big_batch():
    """fit(accumulate_grad_batches=4) trains like one big batch: one
    update per 4 micro-batches with the MEAN micro-grad, as the
    reference's does."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    w = rng.randn(4, 2).astype(np.float32)
    y = (x @ w).astype(np.float32)

    def make_model(mod):
        net = mod.nn.Linear(4, 2)
        net.weight.set_value(mod.to_tensor(np.ones((4, 2), np.float32)))
        net.bias.set_value(mod.to_tensor(np.zeros(2, np.float32)))
        m = mod.Model(net)
        m.prepare(mod.optimizer.SGD(learning_rate=0.1,
                                    parameters=net.parameters()),
                  mod.nn.MSELoss())
        return m, net

    weights = {}
    for mod in (P, pt):
        ds = mod.io.TensorDataset([mod.to_tensor(x), mod.to_tensor(y)])
        m_acc, net_acc = make_model(mod)
        m_acc.fit(ds, epochs=1, batch_size=16, shuffle=False, verbose=0,
                  accumulate_grad_batches=4)
        m_big, net_big = make_model(mod)
        m_big.fit(ds, epochs=1, batch_size=64, shuffle=False, verbose=0)
        np.testing.assert_allclose(net_acc.weight.numpy(),
                                   net_big.weight.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert m_acc._optimizer._step_count == 1
        weights[mod] = np.asarray(net_acc.weight.numpy())
    np.testing.assert_allclose(weights[pt], weights[P], rtol=0, atol=TOL)


def test_train_eval_predict_batch_modes():
    """train_batch records and updates; eval_batch and predict_batch run
    in eval mode without recording; an update=False batch leaves the
    params alone and keeps its gradients for the next update."""
    net = pt.nn.Sequential(pt.nn.Linear(2, 8), pt.nn.Dropout(0.5),
                           pt.nn.Linear(8, 2))
    m = pt.Model(net)
    m.prepare(pt.optimizer.SGD(0.1, parameters=net.parameters()),
              pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    x = np.random.RandomState(0).randn(4, 2).astype(np.float32)
    y = np.array([[0], [1], [1], [0]], np.int64)
    before = _state(net)
    loss, acc = m.train_batch([x], [y], update=False)
    assert loss[0].shape == () and len(acc) == 1
    assert all(np.array_equal(before[k], v) for k, v in _state(net).items())
    assert all(p.grad is not None for p in net.parameters())
    m.train_batch([x], [y])
    assert not any(np.array_equal(before[k], v)
                   for k, v in _state(net).items())
    assert all(p.grad is None for p in net.parameters())
    a = m.predict_batch([x])[0]
    assert not net.training
    np.testing.assert_array_equal(a, m.predict_batch([x])[0])
    loss, _ = m.eval_batch([x], [y])
    assert np.isfinite(loss[0]) and torch.is_grad_enabled()


def test_observability_callbacks_raise():
    for cls in (pt.callbacks.TelemetryCallback, pt.callbacks.VisualDL,
                pt.callbacks.ProgressBarCallback):
        with pytest.raises(NotImplementedError, match="item 12"):
            cls("x") if cls is pt.callbacks.VisualDL else cls()


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def test_metrics_equal_reference():
    rng = np.random.RandomState(0)
    logits = rng.randn(40, 5).astype(np.float32)
    labels = rng.randint(0, 5, (40, 1)).astype(np.int64)
    probs = rng.rand(40).astype(np.float32)
    binary = rng.randint(0, 2, 40).astype(np.int64)
    for mk in (lambda m: m.metric.Accuracy(),
               lambda m: m.metric.Accuracy(topk=(1, 3))):
        out = []
        for mod in (P, pt):
            acc = mk(mod)
            for i in (0, 20):
                c = acc.compute(mod.to_tensor(logits[i:i + 20]),
                                mod.to_tensor(labels[i:i + 20]))
                step = acc.update(c)
            out.append((step, acc.accumulate(), acc.name()))
        assert out[0] == out[1]
    for name in ("Precision", "Recall", "Auc"):
        vals = []
        for mod in (P, pt):
            m = getattr(mod.metric, name)()
            m.update(mod.to_tensor(probs), mod.to_tensor(binary))
            vals.append(m.accumulate())
        assert vals[0] == pytest.approx(vals[1], abs=1e-12), name
    a = pt.metric.accuracy(pt.to_tensor(logits), pt.to_tensor(labels), k=2)
    b = P.metric.accuracy(P.to_tensor(logits), P.to_tensor(labels), k=2)
    assert float(a) == pytest.approx(float(b))
    # a bf16 prediction is read as float32
    acc = pt.metric.Accuracy()
    c = acc.compute(pt.to_tensor(logits).astype("bfloat16"),
                    pt.to_tensor(labels))
    assert c.numpy().shape == (40, 1)
