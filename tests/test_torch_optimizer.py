"""The port's Optimizer classes, LR schedulers, regularizers and clips
against the JAX package's, on the CPU.

A small MLP (``Linear(4, 8)``, relu, ``Linear(8, 3)``, ``mse_loss``) is
built in each package with the same numpy weights (carried by
``set_state_dict``) and trained 5 steps on the same numpy batches with
the same optimizer; every parameter must then agree within 1e-6 of its
max|ref| (fp32: sums in another order).  Covered: each optimizer class;
float and ``L2Decay`` weight decay and a parameter's own ``L1Decay``;
``ParamAttr`` learning rates; parameter groups; ``apply_decay_param_fun``;
each clip (with ``need_clip`` False on one parameter); the multi-tensor
step against the per-leaf path; the fused counters; every scheduler's 50
steps, exactly; ``state_dict`` round trips, within the port and from the
reference's state.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu.nn.clip as PC
import paddle_tpu.optimizer.optimizers as PO
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.clip as TC
import paddle_tpu_torch.optimizer as TO
from paddle_tpu.optimizer import lr as PL
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.optimizer import lr as TL
from paddle_tpu_torch.optimizer import optimizer as TOPT

TOL = 1e-6
STEPS = 5


@pytest.fixture(autouse=True)
def cpu_place():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _param_attr(m, **kw):
    return (P.ParamAttr if m is P else pt.framework.ParamAttr)(**kw)


def _reg(m, kind, coeff):
    mod = P.regularizer if m is P else pt.regularizer
    return getattr(mod, kind)(coeff)


def _mlp(m, w1_attr=None, b2_attr=None):
    class MLP(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin1 = m.nn.Linear(4, 8, weight_attr=w1_attr)
            self.lin2 = m.nn.Linear(8, 3, bias_attr=b2_attr)

        def forward(self, x):
            return self.lin2(m.nn.functional.relu(self.lin1(x)))
    return MLP()


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"lin1.weight": 0.5 * rng.standard_normal((4, 8)),
            "lin1.bias": 0.1 * rng.standard_normal(8),
            "lin2.weight": 0.5 * rng.standard_normal((8, 3)),
            "lin2.bias": 0.1 * rng.standard_normal(3)}


def _batches(n=STEPS, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((6, 4)).astype(np.float32),
             rng.standard_normal((6, 3)).astype(np.float32))
            for _ in range(n)]


def _model(m, attrs=None):
    model = _mlp(m, **(attrs(m) if attrs else {}))
    model.set_state_dict({k: v.astype(np.float32)
                          for k, v in _weights().items()})
    return model


def _train(m, model, opt, batches, sched=None):
    losses = []
    for x, y in batches:
        loss = m.nn.functional.mse_loss(model(m.to_tensor(x)),
                                        m.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
        losses.append(float(loss.numpy()))
    return losses


def _state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _close_states(got, ref, tol=TOL):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=tol,
                                   atol=tol * max(1.0, np.abs(ref[k]).max()),
                                   err_msg=k)


def _params(m, model, groups):
    if not groups:
        return model.parameters()
    return [{"params": model.lin1.parameters(), "learning_rate": 0.5,
             "weight_decay": 0.05},
            {"params": model.lin2.parameters()}]


# name -> (class name, kwargs(m, model)), each class of the reference
CASES = {
    "sgd": ("SGD", lambda m, md: dict(learning_rate=0.1)),
    "sgd_l2": ("SGD", lambda m, md: dict(
        learning_rate=0.1, weight_decay=_reg(m, "L2Decay", 0.05))),
    "momentum": ("Momentum", lambda m, md: dict(learning_rate=0.05,
                                                 momentum=0.9)),
    "momentum_nesterov_wd": ("Momentum", lambda m, md: dict(
        learning_rate=0.05, momentum=0.9, use_nesterov=True,
        weight_decay=0.01)),
    "adam": ("Adam", lambda m, md: dict(learning_rate=0.01)),
    "adam_wd": ("Adam", lambda m, md: dict(learning_rate=0.01,
                                           weight_decay=0.02)),
    "adamw": ("AdamW", lambda m, md: dict(learning_rate=0.01,
                                          weight_decay=0.1)),
    "adamw_decay_fun": ("AdamW", lambda m, md: dict(
        learning_rate=0.01, weight_decay=0.1,
        apply_decay_param_fun=lambda n, ws={md.lin1.weight.name,
                                             md.lin2.weight.name}:
        n in ws)),
    "adagrad": ("Adagrad", lambda m, md: dict(
        learning_rate=0.05, initial_accumulator_value=0.1)),
    "adadelta": ("Adadelta", lambda m, md: dict(learning_rate=1.0)),
    "adamax": ("Adamax", lambda m, md: dict(learning_rate=0.01)),
    "rmsprop": ("RMSProp", lambda m, md: dict(learning_rate=0.01,
                                               momentum=0.5)),
    "rmsprop_centered": ("RMSProp", lambda m, md: dict(
        learning_rate=0.01, centered=True)),
    "lamb": ("Lamb", lambda m, md: dict(
        learning_rate=0.01, exclude_from_weight_decay_fn=lambda p,
        bs={id(md.lin1.bias), id(md.lin2.bias)}: id(p) in bs)),
    "decayed_adagrad": ("DecayedAdagrad", lambda m, md: dict(
        learning_rate=0.05)),
    "ftrl": ("Ftrl", lambda m, md: dict(learning_rate=0.1, l1=0.01,
                                        l2=0.01)),
    "dpsgd_no_noise": ("Dpsgd", lambda m, md: dict(learning_rate=0.1,
                                                   clip=1.0, batch_size=6,
                                                   sigma=0.0)),
    "lars": ("LarsMomentum", lambda m, md: dict(learning_rate=0.5,
                                                momentum=0.9)),
}


def _make_opt(m, cls_name, kwargs, model, groups=False):
    mod = PO if m is P else TO
    return getattr(mod, cls_name)(parameters=_params(m, model, groups),
                                  **kwargs)


def _run_case(cls_name, kw, attrs=None, groups=False, steps=STEPS):
    out = {}
    for m in (P, pt):
        model = _model(m, attrs)
        opt = _make_opt(m, cls_name, kw(m, model), model, groups)
        losses = _train(m, model, opt, _batches(steps))
        out[m] = (losses, _state(model))
    np.testing.assert_allclose(out[pt][0], out[P][0], rtol=TOL)
    _close_states(out[pt][1], out[P][1])
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_reference(case):
    cls_name, kw = CASES[case]
    out = _run_case(cls_name, kw)
    # the parameters moved
    assert any(np.abs(out[pt][1][k] - _weights()[k]).max() > 1e-4
               for k in out[pt][1])


def _attrs(m):
    """lin1.weight at half the lr with its own L1 decay; lin2.bias out
    of clipping."""
    return {"w1_attr": _param_attr(m, learning_rate=0.5,
                                   regularizer=_reg(m, "L1Decay", 0.02)),
            "b2_attr": _param_attr(m, need_clip=False)}


@pytest.mark.parametrize("cls_name", ["SGD", "Momentum", "Adam", "AdamW",
                                      "RMSProp"])
def test_param_attr_lr_regularizer_and_groups_match_reference(cls_name):
    def kw(m, md):
        return dict(learning_rate=0.02, weight_decay=0.01)
    _run_case(cls_name, kw, attrs=_attrs)
    _run_case(cls_name, kw, groups=True)


def _clip(m, which):
    mod = PC if m is P else TC
    return {"value": lambda: mod.ClipGradByValue(0.05),
            "norm": lambda: mod.ClipGradByNorm(0.1),
            "global_norm": lambda: mod.ClipGradByGlobalNorm(0.2)}[which]()


@pytest.mark.parametrize("which", ["value", "norm", "global_norm"])
@pytest.mark.parametrize("cls_name", ["SGD", "AdamW", "Adagrad"])
def test_clips_match_reference(which, cls_name):
    def kw(m, md):
        return dict(learning_rate=0.05, grad_clip=_clip(m, which))
    _run_case(cls_name, kw, attrs=_attrs)


def test_clip_functions_match_reference():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in
             ((3, 4), (5,))]
    for fn, args in (("clip_grad_norm_", (0.5,)),
                     ("clip_grad_norm_", (0.5, float("inf"))),
                     ("clip_grad_norm_", (0.5, 1.0)),
                     ("clip_grad_value_", (0.3,))):
        got = {}
        for m, mod in ((P, PC), (pt, TC)):
            ts = [m.to_tensor(np.zeros_like(g), stop_gradient=False)
                  for g in grads]
            for t, g in zip(ts, grads):
                t.grad = g
            total = getattr(mod, fn)(ts, *args)
            got[m] = ([np.asarray(t.grad.numpy()) for t in ts],
                      None if total is None else float(total.numpy()))
        for a, b in zip(got[pt][0], got[P][0]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        if got[P][1] is not None:
            np.testing.assert_allclose(got[pt][1], got[P][1], rtol=TOL)


@pytest.mark.parametrize("cls_name,kw", [
    ("SGD", dict(learning_rate=0.1, weight_decay=0.05)),
    ("Momentum", dict(learning_rate=0.05, use_nesterov=True,
                      weight_decay=0.01)),
    ("Adam", dict(learning_rate=0.01, weight_decay=0.02)),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.1))])
def test_fused_step_equals_per_leaf_rule(cls_name, kw):
    """The multi-tensor step of the four fused classes against their own
    per-leaf rule (``_fused_supported`` False on the instance), with
    ParamAttr lrs, an L1 regularizer and a global-norm clip."""
    states, stats = [], []
    for fused in (True, False):
        TOPT.reset_fused_stats()
        model = _model(pt, _attrs)
        opt = getattr(TO, cls_name)(
            parameters=model.parameters(),
            grad_clip=TC.ClipGradByGlobalNorm(0.2), **kw)
        opt._fused_supported = fused
        _train(pt, model, opt, _batches())
        states.append(_state(model))
        stats.append(dict(TOPT._fused_stats))
    _close_states(states[0], states[1])
    assert stats == [{"calls": STEPS, "compiles": 1, "eager_steps": 0},
                     {"calls": 0, "compiles": 0, "eager_steps": STEPS}]


def test_fused_plan_rebuilt_on_new_signature_and_failure_raises():
    TOPT.reset_fused_stats()
    model = _model(pt)
    opt = TO.AdamW(learning_rate=0.01, parameters=model.parameters())
    _train(pt, model, opt, _batches(2))
    model.lin1.weight.optimize_attr["learning_rate"] = 0.5
    _train(pt, model, opt, _batches(1))
    assert TOPT._fused_stats == {"calls": 3, "compiles": 2,
                                 "eager_steps": 0}

    class Broken(TO.SGD):
        def _foreach_update(self, *a):
            raise RuntimeError("fused rule failed")

    opt = Broken(learning_rate=0.1, parameters=model.parameters())
    before = _state(model)
    with pytest.raises(RuntimeError, match="fused rule failed"):
        _train(pt, model, opt, _batches(1))
    _close_states(_state(model), before, tol=0)
    assert TOPT._fused_stats["eager_steps"] == 0


def test_parameters_stay_the_same_leaves_and_moments_update_in_place():
    model = _model(pt)
    opt = TO.Adam(learning_rate=0.01, parameters=model.parameters())
    vals = [p.value for p in model.parameters()]
    _train(pt, model, opt, _batches(1))
    moments = [opt._accumulators["moment1"][id(p)]
               for p in model.parameters()]
    _train(pt, model, opt, _batches(1))
    assert all(p.value is v and v.is_leaf and v.requires_grad
               for p, v in zip(model.parameters(), vals))
    assert all(opt._accumulators["moment1"][id(p)] is mm
               for p, mm in zip(model.parameters(), moments))


def test_dpsgd_noise_per_parameter_and_step():
    """Noise on: each parameter moves by its own draw (no two alike) with
    the spread sigma * clip / batch_size, and two steps draw anew."""
    model = _model(pt)
    opt = TO.Dpsgd(learning_rate=1.0, clip=1e-6, batch_size=1.0, sigma=1.0,
                   parameters=model.parameters(), seed=5)
    deltas = []
    for batch in _batches(2):
        w0 = _state(model)
        _train(pt, model, opt, [batch])
        deltas.append({k: v - w0[k] for k, v in _state(model).items()})
    for d in deltas:
        flat = np.concatenate([x.ravel() for x in d.values()])
        assert 0.5 < flat.std() * 1e6 < 2.0   # lr * sigma * clip / batch
        assert len({float(x.ravel()[0]) for x in d.values()}) == 4
    assert not np.allclose(deltas[0]["lin1.weight"],
                           deltas[1]["lin1.weight"])


def test_optimizer_lr_api_matches_reference():
    for m, mod in ((P, PO), (pt, TO)):
        model = _model(m)
        sched = (PL if m is P else TL).StepDecay(learning_rate=0.5,
                                                 step_size=1, gamma=0.1)
        opt = mod.SGD(learning_rate=sched, parameters=model.parameters())
        assert abs(opt.get_lr() - 0.5) < 1e-8
        sched.step()
        assert abs(opt.get_lr() - 0.05) < 1e-8
        with pytest.raises(RuntimeError, match="LRScheduler"):
            opt.set_lr(0.1)
        opt2 = mod.SGD(learning_rate=0.1, parameters=model.parameters())
        opt2.set_lr(0.2)
        assert opt2.get_lr() == 0.2


def test_scheduled_training_matches_reference():
    out = {}
    for m, mod, lrm in ((P, PO, PL), (pt, TO, TL)):
        model = _model(m)
        sched = lrm.LinearWarmup(lrm.CosineAnnealingDecay(0.02, 4), 2,
                                 0.0, 0.02)
        opt = mod.AdamW(learning_rate=sched, weight_decay=0.01,
                        parameters=model.parameters(),
                        grad_clip=(PC if m is P else TC)
                        .ClipGradByGlobalNorm(0.5))
        out[m] = (_train(m, model, opt, _batches(), sched), _state(model))
    np.testing.assert_allclose(out[pt][0], out[P][0], rtol=TOL)
    _close_states(out[pt][1], out[P][1])


def _scheduler_cases(lrm):
    return {
        "NoamDecay": lambda: lrm.NoamDecay(64, 10, learning_rate=1.0),
        "PiecewiseDecay": lambda: lrm.PiecewiseDecay([5, 20, 30],
                                                     [1.0, 0.5, 0.1, 0.01]),
        "NaturalExpDecay": lambda: lrm.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: lrm.InverseTimeDecay(0.5, 0.1),
        "PolynomialDecay": lambda: lrm.PolynomialDecay(0.5, 20, 0.01, 2.0),
        "PolynomialDecay_cycle": lambda: lrm.PolynomialDecay(
            0.5, 12, 0.01, 1.5, cycle=True),
        "LinearWarmup": lambda: lrm.LinearWarmup(0.5, 10, 0.0, 0.5),
        "LinearWarmup_inner": lambda: lrm.LinearWarmup(
            lrm.ExponentialDecay(0.5, 0.9), 10, 0.01, 0.5),
        "ExponentialDecay": lambda: lrm.ExponentialDecay(0.5, 0.95),
        "MultiStepDecay": lambda: lrm.MultiStepDecay(0.5, [10, 25, 40], 0.3),
        "StepDecay": lambda: lrm.StepDecay(0.5, 7, 0.5),
        "LambdaDecay": lambda: lrm.LambdaDecay(0.5, lambda e: 0.97 ** e),
        "MultiplicativeDecay": lambda: lrm.MultiplicativeDecay(
            0.5, lambda e: 0.99),
        "ReduceOnPlateau": lambda: lrm.ReduceOnPlateau(
            1.0, factor=0.5, patience=2, cooldown=1),
        "ReduceOnPlateau_max_abs": lambda: lrm.ReduceOnPlateau(
            1.0, mode="max", threshold_mode="abs", patience=1),
        "CosineAnnealingDecay": lambda: lrm.CosineAnnealingDecay(0.5, 13,
                                                                 0.01),
        "OneCycleLR": lambda: lrm.OneCycleLR(0.5, 50),
        "CyclicLR": lambda: lrm.CyclicLR(0.01, 0.5, 6),
        "CyclicLR_triangular2": lambda: lrm.CyclicLR(
            0.01, 0.5, 5, 3, mode="triangular2"),
        "CyclicLR_exp_range": lambda: lrm.CyclicLR(
            0.01, 0.5, 4, mode="exp_range", exp_gamma=0.97),
    }


@pytest.mark.parametrize("name", sorted(_scheduler_cases(PL)))
def test_scheduler_curve_equals_reference(name):
    metrics = np.abs(np.sin(np.arange(50) / 3.0))
    curves = []
    for lrm in (PL, TL):
        s = _scheduler_cases(lrm)[name]()
        vals = []
        for i in range(50):
            vals.append(s())
            if name.startswith("ReduceOnPlateau"):
                s.step(metrics[i] if lrm is PL
                       else pt.to_tensor(np.float32(metrics[i])))
            else:
                s.step()
        curves.append(vals)
    assert curves[1] == curves[0]
    assert len(set(curves[1])) > 1


def test_scheduler_state_dict_round_trip_across_packages():
    ref = PL.LinearWarmup(PL.StepDecay(0.5, 3, 0.5), 4, 0.0, 0.5)
    for _ in range(9):
        ref.step()
    port = TL.LinearWarmup(TL.StepDecay(0.5, 3, 0.5), 4, 0.0, 0.5)
    port.set_state_dict(ref.state_dict())
    for _ in range(10):
        assert port() == ref()
        port.step()
        ref.step()


def _to_numpy_state(sd):
    return {k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
            for k, v in sd.items()}


@pytest.mark.parametrize("cls_name", ["Adam", "Momentum", "Adagrad"])
def test_state_dict_round_trip_in_the_port(cls_name):
    kw = dict(learning_rate=0.05)
    batches = _batches(5)
    model = _model(pt)
    opt = getattr(TO, cls_name)(parameters=model.parameters(), **kw)
    _train(pt, model, opt, batches[:2])
    sd = opt.state_dict()
    assert sd["@step"] == 2
    assert len(sd["@param_names"]) == 4
    model2 = _model(pt)
    model2.set_state_dict(_state(model))
    opt2 = getattr(TO, cls_name)(parameters=model2.parameters(), **kw)
    opt2.set_state_dict(_to_numpy_state(sd))
    _train(pt, model, opt, batches[2:])
    _train(pt, model2, opt2, batches[2:])
    _close_states(_state(model2), _state(model), tol=0)


@pytest.mark.parametrize("cls_name", ["AdamW", "Momentum", "RMSProp"])
def test_state_dict_from_the_reference_resumes_identically(cls_name):
    """The reference trains 2 steps; its weights and optimizer state (as
    numpy, with its LR scheduler) cross into a fresh port model and
    optimizer, and 3 more steps on each agree within 1e-6."""
    batches = _batches(5)
    ref_model = _model(P)
    ref_sched = PL.ExponentialDecay(0.02, 0.9)
    ref_opt = getattr(PO, cls_name)(learning_rate=ref_sched,
                                    parameters=ref_model.parameters())
    _train(P, ref_model, ref_opt, batches[:2], ref_sched)
    sd = _to_numpy_state(ref_opt.state_dict())
    model = _model(pt)
    model.set_state_dict(_state(ref_model))
    sched = TL.ExponentialDecay(1.0, 0.5)
    opt = getattr(TO, cls_name)(learning_rate=sched,
                                parameters=model.parameters())
    opt.set_state_dict(sd)
    assert opt._step_count == 2 and sched() == ref_sched()
    ref_l = _train(P, ref_model, ref_opt, batches[2:], ref_sched)
    got_l = _train(pt, model, opt, batches[2:], sched)
    np.testing.assert_allclose(got_l, ref_l, rtol=TOL)
    _close_states(_state(model), _state(ref_model))


def test_minimize_and_clear_grad():
    out = {}
    for m, mod in ((P, PO), (pt, TO)):
        model = _model(m)
        opt = mod.SGD(learning_rate=0.1, parameters=model.parameters())
        for x, y in _batches(3):
            loss = m.nn.functional.mse_loss(model(m.to_tensor(x)),
                                            m.to_tensor(y))
            if m is pt:
                loss.backward()         # the classic recipe: backward first
            opt.minimize(loss)
            assert all(p.grad is None for p in model.parameters())
        out[m] = _state(model)
    _close_states(out[pt], out[P])


def test_numpy_is_a_snapshot_across_in_place_updates():
    """A parameter's ``numpy()`` taken before a step keeps the old values
    (the reference's arrays are immutable); the port updates in place, so
    ``numpy()`` copies a CPU payload rather than viewing it."""
    out = {}
    for m, mod in ((P, PO), (pt, TO)):
        model = _model(m)
        before = model.lin1.weight.numpy()
        opt = mod.SGD(learning_rate=0.1, parameters=model.parameters())
        _train(m, model, opt, _batches(1))
        out[m] = (before, model.lin1.weight.numpy())
    np.testing.assert_array_equal(out[pt][0], _weights()["lin1.weight"]
                                  .astype(np.float32))
    assert np.abs(out[pt][1] - out[pt][0]).max() > 1e-4
    np.testing.assert_allclose(out[pt][1], out[P][1], rtol=TOL, atol=TOL)
