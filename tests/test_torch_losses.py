"""The port's losses (``nn.functional`` and their layers) against the JAX
package's, on the CPU, and an ERNIE multi-label fine-tune through them.

Each loss runs in every ``reduction`` mode it takes, with ``weight``,
``pos_weight``, ``margin`` ... where the reference takes them, on
inputs drawn from a numpy ``RandomState`` seeded by the case's name:
values within 1e-5 of max|ref| (1e-4 for ``ctc_loss``, as the
reference's own test), dtypes and shapes equal, and the gradient of
sum(out * w) against ``paddle_tpu.grad`` within 1e-5 of max|ref grad|
(1e-4 for ``ctc_loss``; the reference's cases batched as
``tests/op_reference.py`` runs them).  The layers carry the reference's
parameters (``HSigmoidLoss``).  The coverage guards hold every loss
function and layer of the reference's files against the port.

The multi-label test fine-tunes ERNIE (2 layers, H=64, the flash route,
plain on the CPU) with its pooled output into a ``Linear(H, 16)``, by a
hand-written eager loop: ``BCEWithLogitsLoss``, AdamW (weight decay
0.01, ``ClipGradByGlobalNorm(1.0)``), 3 steps from the reference's
weights in both packages; the losses within 1e-5 (relative), the
parameters within 1e-5 (absolute, as ``tests/test_torch_hapi.py`` holds
the classifier it fits), and the predictions (``sigmoid``,
``greater_than``, ``cast``), micro-F1 (``logical_and``, ``sum``) and
each row's top 3 labels (``topk``) equal.
"""
import dataclasses
import inspect

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.models import bert as JB
from paddle_tpu.nn.functional import loss as r_loss
from paddle_tpu.nn.layer import loss as r_loss_layers
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.models import bert as TB
from tools.op_sweep import (LOSS_CASES, LOSS_LAYER_CASES, TOL, R, arrays,
                            check, check_grads, flat, grads, run)

import op_reference


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


_loss_reference = op_reference.lazy(LOSS_CASES)


@pytest.mark.parametrize("case", LOSS_CASES,
                         ids=[c.name for c in LOSS_CASES])
def test_loss_matches_reference(case):
    arr = arrays(case)
    ref, ref_g = _loss_reference(case)
    _, got = run(pt, case, arr)
    check(ref, flat(got), case.tol, case.name)
    check_grads(ref_g, grads(pt, case, arr), case.tol, case.name)


def test_mbce_loss_refuses_as_the_reference():
    for fn in (r_loss.mbce_loss, pt.nn.functional.mbce_loss):
        with pytest.raises(NotImplementedError) as e:
            fn(None, None)
        assert str(e.value) == ""


def test_hsigmoid_custom_tree_refuses_as_the_reference():
    for mod in (P, pt):
        x = mod.to_tensor(np.ones((2, 3), np.float32))
        with pytest.raises(NotImplementedError, match="custom tree"):
            mod.nn.functional.hsigmoid_loss(x, x, 4, x, path_table=x)
        with pytest.raises(NotImplementedError, match="custom tree"):
            mod.nn.HSigmoidLoss(3, 4, is_custom=True)


_loss_layer_reference = op_reference.lazy(LOSS_LAYER_CASES)


@pytest.mark.parametrize("case", LOSS_LAYER_CASES,
                         ids=[c.name for c in LOSS_LAYER_CASES])
def test_loss_layer_matches_reference(case):
    arr = arrays(case)
    ref, ref_g = _loss_layer_reference(case)
    _, got = run(pt, case, arr)
    check(ref, flat(got), case.tol, case.name)
    check_grads(ref_g, grads(pt, case, arr), case.tol, case.name)


def test_hsigmoid_layer_carries_reference_weights():
    rng = R(21)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    y = rng.randint(0, 6, (5, 1)).astype(np.int64)
    ref = P.nn.HSigmoidLoss(4, 6)
    net = pt.nn.HSigmoidLoss(4, 6)
    assert [list(v.shape) for v in ref.state_dict().values()] == [
        v.shape for v in net.state_dict().values()]
    net.set_state_dict({k: np.asarray(v.numpy())
                        for k, v in ref.state_dict().items()})
    r = np.asarray(ref(P.to_tensor(x), P.to_tensor(y)).numpy())
    g = net(pt.to_tensor(x), pt.to_tensor(y)).numpy()
    np.testing.assert_allclose(g, r, rtol=0, atol=TOL * np.abs(r).max())


_IMPORTED = {"call", "Layer", "Tensor", "XavierUniform"}


def _public(mod, classes):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and n not in _IMPORTED
                  and inspect.isclass(v) == classes and callable(v)
                  and getattr(v, "__module__", "").startswith("paddle_tpu."))


def test_every_reference_loss_is_ported():
    funcs = _public(r_loss, False)
    missing = [n for n in funcs if not callable(
        getattr(pt.nn.functional, n, None))]
    assert not missing, missing
    assert len(funcs) >= 21
    held = {c.name.split(":")[0] for c in LOSS_CASES} | {
        # held by the port's earlier loss tests (test_torch_nn, _hapi) and
        # by the refusal test above
        "cross_entropy", "softmax_with_cross_entropy", "nll_loss",
        "mse_loss", "l1_loss", "mbce_loss"}
    assert not [n for n in funcs if n not in held]


def test_every_reference_loss_layer_is_ported():
    layers = _public(r_loss_layers, True)
    missing = [n for n in layers if not hasattr(pt.nn, n)]
    assert not missing, missing
    assert len(layers) >= 14


# --------------------------------------------------------------------------
# an ERNIE multi-label fine-tune through the new losses and ops
# --------------------------------------------------------------------------

V, H, N, LABELS = 512, 64, 32, 16
_JCFG = dataclasses.replace(JB.bert_tiny(), vocab_size=V, hidden_size=H,
                            num_layers=2, num_heads=2, max_seq_len=N,
                            use_flash=True, remat=True, dtype="float32")
_TCFG = TB.BertConfig(**dataclasses.asdict(_JCFG))


def _multilabel(mod):
    bert = JB if mod is P else TB
    cfg = _JCFG if mod is P else _TCFG

    class MultiLabel(mod.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ernie = bert.ErnieModel(cfg)
            self.cls = mod.nn.Linear(H, LABELS)

        def forward(self, tokens):
            _, pooled = self.ernie(tokens)
            return self.cls(pooled)
    return MultiLabel()


def trained(net):
    """The parameters the classifier reads: not ERNIE's pretraining heads,
    which the pooled output never reaches (the reference's eager tape
    gives them zero grads, which AdamW decays; torch's gives none, which
    it skips: ROADMAP Queue 3)."""
    return [p for n, p in net.named_parameters()
            if not n.startswith(("ernie.mlm_", "ernie.nsp_"))]


def _finetune(mod, weights, batches):
    net = _multilabel(mod)
    net.set_state_dict({k: mod.to_tensor(v) for k, v in weights.items()}
                       if mod is P else weights)
    opt = mod.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              grad_clip=mod.nn.ClipGradByGlobalNorm(1.0),
                              parameters=trained(net))
    crit = mod.nn.BCEWithLogitsLoss()
    F = mod.nn.functional
    losses = []
    for toks, lbl in batches:
        loss = crit(net(mod.to_tensor(toks)), mod.to_tensor(lbl))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    toks, lbl = batches[0]
    net.eval()
    with mod.no_grad():
        logits = net(mod.to_tensor(toks))
    y = mod.to_tensor(lbl)
    pred = mod.cast(mod.greater_than(F.sigmoid(logits),
                                     mod.full([1], 0.5)), "float32")
    tp = mod.sum(mod.cast(mod.logical_and(pred > 0, y > 0), "float32"))
    f1 = 2 * tp / (mod.sum(pred) + mod.sum(y))
    top = mod.topk(logits, 3)[1]
    return dict(losses=losses, params={k: np.asarray(v.numpy())
                                       for k, v in net.state_dict().items()},
                pred=np.asarray(pred.numpy()), f1=float(f1),
                top=np.asarray(top.numpy()), top_dtype=str(top.dtype))


def test_ernie_multilabel_finetune_matches_reference():
    state = P.get_rng_state()
    P.seed(1234)
    try:
        weights = {k: np.asarray(v.numpy())
                   for k, v in _multilabel(P).state_dict().items()}
    finally:
        P.set_rng_state(state)
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, V, (4, N)).astype(np.int64),
                (rng.random((4, LABELS)) < 0.3).astype(np.float32))
               for _ in range(3)]
    want = _finetune(P, weights, batches)
    got = _finetune(pt, weights, batches)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0, atol=TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got["pred"], want["pred"])
    assert got["f1"] == pytest.approx(want["f1"], rel=TOL)
    np.testing.assert_array_equal(got["top"], want["top"])
    assert got["top_dtype"].replace("torch.", "") == want["top_dtype"]
