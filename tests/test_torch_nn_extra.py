"""The rest of the port's ``nn`` against the JAX package's, on the CPU:
the functionals of ``extension``, ``common``, ``norm``, ``sequence`` and
``vision`` (``tools/op_sweep.py``'s ``NN_CASES``: every ``interpolate``
mode with both ``align_corners`` and ``align_mode``, ``grid_sample``'s
three padding modes) and the layers of ``common``, ``container``,
``norm`` and ``nn.utils`` (``NN_LAYER_CASES``, their state drawn from
the case's seed), outputs and gradients at 1e-5 of max|ref| (the
reference's cases batched as ``tests/op_reference.py`` runs them).

Every new layer's ``state_dict`` keys equal the reference's.  The
dropouts draw from torch's generators, so their training forms are held
in their structure and rates, not their numbers.  The coverage guards
hold every public function and layer of those reference modules against
a case or a named exception (``LEFT_OUT``).
"""
import inspect

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.nn.functional import common as r_common
from paddle_tpu.nn.functional import extension as r_ext
from paddle_tpu.nn.functional import norm as r_norm
from paddle_tpu.nn.functional import sequence as r_seq
from paddle_tpu.nn.functional import vision as r_vision
from paddle_tpu.nn.layer import common as r_common_layers
from paddle_tpu.nn.layer import container as r_container
from paddle_tpu.nn.layer import norm as r_norm_layers
from paddle_tpu_torch.framework import core
from tools.op_sweep import (LEFT_OUT, NN_CASES, NN_LAYER_CASES, arrays, check,
                            check_grads, flat, grads, run)

import op_reference


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


_nn_reference = op_reference.lazy(NN_CASES)
_layer_reference = op_reference.lazy(NN_LAYER_CASES)


@pytest.mark.parametrize("case", NN_CASES, ids=[c.name for c in NN_CASES])
def test_nn_functional_matches_reference(case):
    arr = arrays(case)
    ref, ref_g = _nn_reference(case)
    _, got = run(pt, case, arr)
    check(ref, flat(got), case.tol, case.name)
    if case.grad:
        check_grads(ref_g, grads(pt, case, arr), case.tol, case.name)


@pytest.mark.parametrize("case", NN_LAYER_CASES,
                         ids=[c.name for c in NN_LAYER_CASES])
def test_nn_layer_matches_reference(case):
    arr = arrays(case)
    ref, ref_g = _layer_reference(case)
    _, got = run(pt, case, arr)
    check(ref, flat(got), case.tol, case.name)
    if case.grad:
        check_grads(ref_g, grads(pt, case, arr), case.tol, case.name)


# --------------------------------------------------------------------------
# state-dict keys
# --------------------------------------------------------------------------

def _layers(nn):
    return {
        "Bilinear": nn.Bilinear(3, 5, 2), "GroupNorm": nn.GroupNorm(2, 4),
        "InstanceNorm1D": nn.InstanceNorm1D(3),
        "InstanceNorm2D": nn.InstanceNorm2D(3, weight_attr=False),
        "InstanceNorm3D": nn.InstanceNorm3D(3),
        "LocalResponseNorm": nn.LocalResponseNorm(3),
        "SpectralNorm": nn.SpectralNorm([4, 6], 1),
        "ParameterList": nn.ParameterList(
            [nn.Layer().create_parameter([2]) for _ in range(3)]),
        "LayerDict": nn.LayerDict({"x": nn.Linear(2, 3),
                                   "y": nn.GroupNorm(1, 3)}),
        "weight_norm": nn.weight_norm(nn.Conv2D(3, 4, 3), dim=1),
        "spectral_norm": nn.utils.spectral_norm(nn.Linear(4, 3)),
        "Transformer": nn.Transformer(16, 2, 1, 2, 32),
        "LSTM": nn.LSTM(4, 5, 2, "bidirect"), "GRU": nn.GRU(4, 5),
        "SimpleRNN": nn.SimpleRNN(4, 5, 2, "backward"),
        "BiRNN": nn.BiRNN(nn.GRUCell(4, 5), nn.LSTMCell(4, 5)),
        "Upsample": nn.Upsample(scale_factor=2), "Pad2D": nn.Pad2D(1),
        "Fold": nn.Fold([4, 4], 2), "Unfold": nn.Unfold(2),
    }


def test_state_dict_keys_and_shapes_match_reference():
    ref, got = _layers(P.nn), _layers(pt.nn)
    for name in ref:
        r = {k: list(v.shape) for k, v in ref[name].state_dict().items()}
        g = {k: list(v.shape) for k, v in got[name].state_dict().items()}
        assert g == r, name


# --------------------------------------------------------------------------
# the dropouts' training forms
# --------------------------------------------------------------------------

def test_dropout2d_3d_drop_whole_channels_at_the_rate():
    F = pt.nn.functional
    pt.seed(4)
    x = np.ones((64, 32, 3, 3), np.float32)
    out = F.dropout2d(pt.to_tensor(x), 0.25).numpy()
    per_ch = out.reshape(64, 32, -1)
    assert ((per_ch == 0).all(-1) | (per_ch == 1 / 0.75).all(-1)).all()
    assert abs((per_ch[..., 0] == 0).mean() - 0.25) < 0.04
    nhwc = F.dropout2d(pt.to_tensor(x.transpose(0, 2, 3, 1)), 0.25,
                       data_format="NHWC").numpy()
    assert ((nhwc == 0).all((1, 2)) | (nhwc != 0).all((1, 2))).all()
    vol = F.dropout3d(pt.to_tensor(np.ones((16, 32, 2, 2, 2), np.float32)),
                      0.5).numpy().reshape(16, 32, -1)
    assert ((vol == 0).all(-1) | (vol == 2.0).all(-1)).all()
    ref = P.nn.functional.dropout2d(P.to_tensor(x[:2]), 0.25)
    assert list(ref.shape) == list(out[:2].shape)


def test_alpha_dropout_keeps_mean_and_variance():
    F = pt.nn.functional
    pt.seed(5)
    x = np.random.RandomState(0).standard_normal((400, 500)).astype(
        np.float32)
    out = F.alpha_dropout(pt.to_tensor(x), 0.2).numpy()
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = 0.8
    A = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    dropped = np.isclose(out, A * alpha_p + (-A * alpha_p * 0.2), atol=1e-6)
    assert abs(dropped.mean() - 0.2) < 0.01
    assert abs(out.mean() - x.mean()) < 0.01
    assert abs(out.std() - x.std()) < 0.02
    layer = pt.nn.AlphaDropout(0.2)
    layer.eval()
    np.testing.assert_array_equal(layer(pt.to_tensor(x)).numpy(), x)


def test_remove_weight_norm_restores_one_parameter():
    for mod in (P, pt):
        lin = mod.nn.Linear(4, 3)
        w = np.asarray(lin.weight.numpy()).copy()
        mod.nn.weight_norm(lin)
        assert {"weight_g", "weight_v"} <= set(lin.state_dict())
        mod.nn.remove_weight_norm(lin)
        assert set(lin.state_dict()) == {"weight", "bias"}
        np.testing.assert_allclose(np.asarray(lin.weight.numpy()), w,
                                   rtol=1e-5, atol=1e-6)
    assert not lin._forward_pre_hooks


def test_containers_behave_like_reference():
    for mod in (P, pt):
        d = mod.nn.LayerDict([("a", mod.nn.Identity())])
        d["b"] = mod.nn.Flatten()
        assert list(d.keys()) == ["a", "b"] and "b" in d and len(d) == 2
        d.pop("a")
        assert list(d) == ["b"]
        pl = mod.nn.ParameterList()
        pl.append(mod.nn.Layer().create_parameter([2]))
        assert len(pl) == 1 and len(list(pl.parameters())) == 1


# --------------------------------------------------------------------------
# coverage
# --------------------------------------------------------------------------

_IMPORTED = {"call", "Layer", "Tensor", "Parameter", "Constant",
             "XavierUniform", "Uniform", "Normal", "diag_embed_"}


def _public(mod, classes):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and n not in _IMPORTED
                  and inspect.isclass(v) == classes and callable(v)
                  and getattr(v, "__module__", "").startswith("paddle_tpu."))


def test_every_reference_function_has_a_case_or_a_reason():
    funcs = sorted({n for m in (r_ext, r_common, r_norm, r_seq, r_vision)
                    for n in _public(m, False)})
    missing = [n for n in funcs
               if not callable(getattr(pt.nn.functional, n, None))]
    assert not missing, missing
    held = {c.name.split(":")[0] for c in NN_CASES}
    unheld = [n for n in funcs if n not in held and n not in LEFT_OUT]
    assert not unheld, unheld
    for alias in ("adaptive_average_pool1d", "adaptive_average_pool2d",
                  "adaptive_average_pool3d"):
        assert getattr(pt.nn.functional, alias) is getattr(
            pt.nn.functional, alias.replace("average", "avg"))


def test_every_reference_layer_has_a_case_or_a_reason():
    layers = sorted({n for m in (r_common_layers, r_container, r_norm_layers)
                     for n in _public(m, True)
                     if issubclass(getattr(m, n), P.nn.Layer)})
    missing = [n for n in layers if not hasattr(pt.nn, n)]
    assert not missing, missing
    held = ({c.name.split(":")[0] for c in NN_LAYER_CASES}
            | {"Linear", "Embedding", "Dropout", "Sequential", "LayerList",
               "LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D",
               "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm"})
    assert not [n for n in layers if n not in held]
    for name in ("weight_norm", "remove_weight_norm", "spectral_norm",
                 "BeamSearchDecoder", "dynamic_decode", "diag_embed"):
        assert hasattr(pt.nn, name), name
    with pytest.raises(NotImplementedError, match="item 13"):
        pt.nn.SyncBatchNorm(4)
