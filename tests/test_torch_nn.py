"""The port's eager nn API against the JAX package's, on the CPU.

The same numpy-seeded inputs and weights go through ``paddle_tpu.nn`` and
``paddle_tpu_torch.nn``; weights cross from the reference's
``state_dict()`` by ``set_state_dict`` (the two packages draw different
numbers from one seed).  Both routes of the norms are held: under
``no_grad`` (the reference's fused-kernel route; on the CPU both sides
run the kernels' plain versions) and recording (grad mode on, a weight
that does not stop gradients: the plain formulas).  Tolerances: fp32
1e-5 of max|ref| (sums in another order); bf16 one rounding step (2**-7
relative), where both sides round at the same places.  On the CPU no
kernel launches.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.nn import functional as PF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import ParamAttr, core
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attn, norms
from paddle_tpu_torch.tensor import arange as t_arange

FP32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def cpu_place():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _np(t):
    """A Tensor of either package -> float32 numpy."""
    return np.asarray(t.astype("float32").numpy())


def _both(a, dtype=None, stop_gradient=True):
    """The same numpy array as a reference Tensor and a port Tensor."""
    return (P.to_tensor(a, dtype=dtype, stop_gradient=stop_gradient),
            pt.to_tensor(a, dtype=dtype, stop_gradient=stop_gradient))


def _close(got, ref, bf16=False):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape
    if bf16:
        np.testing.assert_allclose(g, r, rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=FP32_TOL * max(1.0, np.abs(r).max()))


def _counts():
    return (norms.launches, norms.rms_launches, flash_attn.fwd_launches)


# --------------------------------------------------------------------------
# norms, both routes
# --------------------------------------------------------------------------

DTYPES = [("float32", "float32"), ("bfloat16", "float32"),
          ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("route", ["no_grad", "recording", "no_weight"])
@pytest.mark.parametrize("xdt,wdt", DTYPES)
def test_rms_norm_routes_match_reference(route, xdt, wdt):
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((4, 8, 256)) * 3 + 0.5).astype(np.float32)
    w = rng.standard_normal(256).astype(np.float32)
    rx, tx = _both(x, xdt)
    rw, tw = _both(w, wdt, stop_gradient=route != "recording")
    if route == "no_weight":
        rw = tw = None
    before = _counts()
    with (pt.no_grad() if route == "no_grad" else torch.enable_grad()):
        got = TF.rms_norm(tx, tw, 1e-6)
    with (P.no_grad() if route == "no_grad" else P.enable_grad()):
        ref = PF.rms_norm(rx, rw, 1e-6)
    assert _counts() == before
    assert core.dtype_name(got.dtype) == str(ref.dtype)
    assert got.stop_gradient == ref.stop_gradient == (route != "recording")
    _close(got, ref, bf16="bfloat16" in (xdt, wdt))


@pytest.mark.parametrize("route", ["no_grad", "recording"])
def test_rms_norm_layer_matches_reference(route):
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    ref_l, port_l = P.nn.RMSNorm(128), tnn.RMSNorm(128)
    w = {"weight": rng.standard_normal(128).astype(np.float32)}
    ref_l.set_state_dict(w)
    port_l.set_state_dict(w)
    rx, tx = _both(x)
    if route == "no_grad":
        with pt.no_grad():
            got = port_l(tx)
        with P.no_grad():
            ref = ref_l(rx)
    else:
        got, ref = port_l(tx), ref_l(rx)
    assert got.stop_gradient == (route == "no_grad")
    _close(got, ref)


@pytest.mark.parametrize("route", ["no_grad", "recording", "no_bias"])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_layer_norm_routes_match_reference(route, xdt):
    rng = np.random.default_rng(33)
    x = (rng.standard_normal((3, 7, 128)) * 2 + 1).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    rx, tx = _both(x, xdt)
    rw, tw = _both(w, xdt, stop_gradient=route != "recording")
    rb, tb = _both(b, xdt)
    if route == "no_bias":
        rb = tb = None
    before = _counts()
    with (pt.no_grad() if route == "no_grad" else torch.enable_grad()):
        got = TF.layer_norm(tx, 128, tw, tb, 1e-5)
    with (P.no_grad() if route == "no_grad" else P.enable_grad()):
        ref = PF.layer_norm(rx, 128, rw, rb, 1e-5)
    assert _counts() == before
    assert core.dtype_name(got.dtype) == str(ref.dtype)
    if xdt == "bfloat16" and route != "no_grad":
        # the plain formula rounds x - mean, the rsqrt and the affine to
        # bf16 op by op; XLA keeps some of them in fp32 inside a fusion.
        # Both sides are as far from the exact LayerNorm of the bf16 inputs;
        # they meet within two bf16 steps of the largest output
        r = _np(ref)
        np.testing.assert_allclose(_np(got), r, rtol=0,
                                   atol=2.0 ** -6 * np.abs(r).max())
    else:
        _close(got, ref, bf16=xdt == "bfloat16")


# --------------------------------------------------------------------------
# other functionals and MultiHeadAttention
# --------------------------------------------------------------------------

def test_linear_embedding_activations_match_reference():
    rng = np.random.default_rng(34)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    (rx, tx), (rw, tw), (rb, tb) = _both(x), _both(w), _both(b)
    _close(TF.linear(tx, tw, tb), PF.linear(rx, rw, rb))
    _close(TF.linear(tx, tw), PF.linear(rx, rw))
    _close(TF.linear(tx[0, 0], tw, tb), PF.linear(rx[0, 0], rw, rb))
    bx, rbx = tx.astype("bfloat16"), rx.astype("bfloat16")
    got, ref = TF.linear(bx, tw, tb), PF.linear(rbx, rw, rb)
    assert core.dtype_name(got.dtype) == str(ref.dtype) == "float32"
    _close(got, ref)
    for approximate in (False, True):
        _close(TF.gelu(tx, approximate), PF.gelu(rx, approximate))
    _close(TF.relu(tx), PF.relu(rx))
    ids = rng.integers(0, 48, (3, 9))
    ids[0, :3] = [5, 47, 5]
    table = rng.standard_normal((48, 16)).astype(np.float32)
    (ri, ti), (rt, tt) = _both(ids), _both(table)
    assert ti.dtype == torch.int32 and str(ri.dtype) == "int32"
    for pid in (None, 5, -1):
        got = TF.embedding(ti, tt, padding_idx=pid)
        _close(got, PF.embedding(ri, rt, padding_idx=pid))
    assert not _np(TF.embedding(ti, tt, padding_idx=5))[0, 0].any()


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_multi_head_attention_matches_reference(mask):
    """No mask: the flash route (the plain ``_ref_attention`` on the CPU);
    a mask: the dense ``scaled_dot_product_attention``."""
    rng = np.random.default_rng(35)
    ref_l, port_l = P.nn.MultiHeadAttention(64, 2), tnn.MultiHeadAttention(
        64, 2)
    port_l.set_state_dict({k: v.numpy()
                           for k, v in ref_l.state_dict().items()})
    ref_l.eval(), port_l.eval()
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    rx, tx = _both(x)
    rm = tm = None
    if mask == "bool":
        m = np.tril(np.ones((10, 10), bool))
        rm, tm = _both(m)
    elif mask == "additive":
        m = np.where(np.tril(np.ones((10, 10))), 0.0, -1e9)
        rm, tm = _both(m.astype(np.float32))
    before = _counts()
    with pt.no_grad():
        got = port_l(tx, attn_mask=tm)
    with P.no_grad():
        ref = ref_l(rx, attn_mask=rm)
    assert _counts() == before
    _close(got, ref)


def test_scaled_dot_product_attention_causal_matches_reference():
    rng = np.random.default_rng(36)
    q, k, v = (rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
               for _ in range(3))
    (rq, tq), (rk, tk), (rv, tv) = _both(q), _both(k), _both(v)
    _close(TF.scaled_dot_product_attention(tq, tk, tv, is_causal=True),
           PF.scaled_dot_product_attention(rq, rk, rv, is_causal=True))


# --------------------------------------------------------------------------
# the slice's model
# --------------------------------------------------------------------------

SMALL = dict(V=1000, H=128, nh=2, F=512, L=2, N=64)


def make_encoder(pkg, arange, V, H, nh, F, L, N):
    """A user's script on either package's nn API: token and learned
    position embeddings, a pre-LN TransformerEncoder (gelu, dropout 0)
    with an RMSNorm final norm, a Linear head.  Forward: (final norm
    output, logits)."""
    nn = pkg.nn

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(V, H)
            self.pos = nn.Embedding(N, H)
            self.encoder = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(H, nh, F, dropout=0.0,
                                           activation="gelu",
                                           normalize_before=True),
                L, norm=nn.RMSNorm(H))
            self.head = nn.Linear(H, V)

        def forward(self, ids):
            h = self.word(ids) + self.pos(arange(ids.shape[1]))
            h = self.encoder(h)
            return h, self.head(h)

    return Encoder().eval()


@pytest.fixture(scope="module")
def models():
    """The reference's model, and the port's with its weights."""
    prev = core._state.expected_place
    pt.set_device("cpu")
    try:
        ref = make_encoder(P, P.arange, **SMALL)
        port = make_encoder(pt, t_arange, **SMALL)
        port.set_state_dict({k: v.numpy()
                             for k, v in ref.state_dict().items()})
    finally:
        core._state.expected_place = prev
    return ref, port


def test_state_dict_keys_and_shapes_match_reference(models):
    ref, port = models
    rs, ts = ref.state_dict(), port.state_dict()
    assert list(rs) == list(ts)
    assert all(rs[k].shape == ts[k].shape for k in rs)
    assert len(ts) == 4 + 16 * SMALL["L"] + 1


@pytest.mark.parametrize("route", ["no_grad", "recording"])
def test_encoder_matches_reference_with_carried_weights(models, route):
    ref, port = models
    ids = np.random.default_rng(37).integers(0, SMALL["V"], (2, SMALL["N"]))
    ri, ti = _both(ids)
    before = _counts()
    if route == "no_grad":
        with pt.no_grad():
            h, logits = port(ti)
        with P.no_grad():
            rh, rlogits = ref(ri)
    else:
        h, logits = port(ti)
        rh, rlogits = ref(ri)
    assert _counts() == before
    assert h.stop_gradient == (route == "no_grad")
    assert h.shape == [2, SMALL["N"], SMALL["H"]]
    assert logits.shape == [2, SMALL["N"], SMALL["V"]]
    _close(h, rh)
    _close(logits, rlogits)


def test_set_state_dict_refuses_missing_extra_and_wrong_shape():
    port = make_encoder(pt, t_arange, V=50, H=64, nh=2, F=128, L=1, N=16)
    good = {k: np.zeros(v.shape, np.float32)
            for k, v in port.state_dict().items()}
    before = _np(port.head.weight)
    missing = dict(good)
    missing.pop("head.bias")
    with pytest.raises(KeyError, match="head.bias"):
        port.set_state_dict(missing)
    with pytest.raises(KeyError, match="stray"):
        port.set_state_dict({**good, "stray": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="head.weight"):
        port.set_state_dict({**good, "head.weight": np.zeros((50, 64),
                                                             np.float32)})
    np.testing.assert_array_equal(_np(port.head.weight), before)
    port.set_state_dict(good)
    assert not _np(port.head.weight).any()
    assert port.head.weight.dtype == torch.float32
    assert not port.head.weight.stop_gradient


def test_clone_layer_reinitialises_and_drops_weight_attr():
    """``TransformerEncoder`` clones its layer as the reference does: the
    clones are freshly initialised and lose ``weight_attr``."""
    attr = ParamAttr(initializer=tnn.initializer.Constant(0.5))
    enc = tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(32, 2, 64, dropout=0.0,
                                    normalize_before=True,
                                    weight_attr=attr), 3)
    ref = P.nn.TransformerEncoder(
        P.nn.TransformerEncoderLayer(
            32, 2, 64, dropout=0.0, normalize_before=True,
            weight_attr=P.ParamAttr(
                initializer=P.nn.initializer.Constant(0.5))), 3)
    for i in range(3):
        got = bool((_np(enc.layers[i].linear1.weight) == 0.5).all())
        want = bool((_np(ref.layers[i].linear1.weight) == 0.5).all())
        assert got == want == (i == 0)
    assert enc.layers[2].normalize_before
    assert enc.layers[1].activation is TF.relu


# --------------------------------------------------------------------------
# framework surface
# --------------------------------------------------------------------------

def test_default_place_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    core._state.expected_place = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.tensor.zeros([2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.set_device("gpu:0")
    with pytest.raises(ValueError, match="'gpu'"):
        pt.set_device("tpu")
    assert pt.set_device("cpu") == core.CPUPlace()
    assert pt.get_device() == "cpu"
    assert pt.tensor.zeros([2]).place == core.CPUPlace()


def test_tensor_surface():
    t = pt.to_tensor(np.arange(6, dtype=np.int64).reshape(2, 3))
    assert t.shape == [2, 3] and t.dtype == torch.int32 and t.stop_gradient
    f = pt.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert f.dtype == torch.float32
    assert _np(f + 1).tolist() == [[2, 3], [4, 5]]
    assert _np(2 * f - f).tolist() == _np(f).tolist()
    assert _np(f @ f).tolist() == [[7, 10], [15, 22]]
    assert _np(pt.tensor.matmul(f, f, transpose_y=True)).tolist() == [
        [5, 11], [11, 25]]
    assert f[1].shape == [2] and float(f[1, 0].item()) == 3.0
    assert pt.tensor.reshape(t, [0, -1, 1]).shape == [2, 3, 1]
    assert pt.tensor.transpose(t, [1, 0]).shape == [3, 2]
    assert pt.tensor.concat([t, t], axis=1).shape == [2, 6]
    assert t_arange(4).dtype == torch.int32
    assert pt.tensor.ones([3], "bfloat16").dtype == torch.bfloat16
    b = f.astype("bfloat16")
    assert b.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="bfloat16"):
        b.numpy()
    g = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert g.value.requires_grad and not (g * 2).stop_gradient
    assert g.detach().stop_gradient
    with pt.no_grad():
        assert (g * 2).stop_gradient
    # backward and grad work (no longer refused) and give the reference's
    rg = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (g * g * 3).backward()
    (rg * rg * 3).backward()
    np.testing.assert_allclose(_np(g.grad), _np(rg.grad), rtol=1e-6)
    np.testing.assert_allclose(_np(g.grad), [6.0, 12.0])


def test_grad_mode_switches_are_torch_grad_mode():
    assert pt.autograd.is_grad_enabled() and torch.is_grad_enabled()
    with pt.no_grad():
        assert not torch.is_grad_enabled()
        with pt.autograd.enable_grad():
            assert torch.is_grad_enabled()
        assert not pt.autograd.is_grad_enabled()
    with torch.no_grad():
        assert not pt.autograd.is_grad_enabled()
    with pt.autograd.set_grad_enabled(False):
        assert not torch.is_grad_enabled()

    @pt.no_grad()
    def f():
        return torch.is_grad_enabled()
    assert f() is False and torch.is_grad_enabled()


def test_layer_to_hooks_modes_and_dropout():
    lin = tnn.Linear(8, 4)
    seq = tnn.Sequential(lin, tnn.Dropout(0.5))
    assert len(seq) == 2 and seq[0] is lin
    assert [n for n, _ in seq.named_parameters()] == ["0.weight", "0.bias"]
    x = pt.to_tensor(np.ones((16, 8), np.float32))
    h = lin.register_forward_post_hook(lambda l, i, o: o * 0)
    assert not _np(lin(x)).any()
    h.remove()
    pre = lin.register_forward_pre_hook(lambda l, i: (i[0] * 2,))
    twice = _np(lin(x))
    pre.remove()
    np.testing.assert_allclose(twice - _np(lin.bias), 2 * (
        _np(lin(x)) - _np(lin.bias)), rtol=1e-6)
    pt.seed(7)
    a = _np(seq(x))
    pt.seed(7)
    np.testing.assert_array_equal(a, _np(seq(x)))
    kept = _np(lin(x)) * 2
    assert np.all((a == 0) | np.isclose(a, kept))
    assert 0 < (a == 0).mean() < 1
    seq.eval()
    assert not seq[1].training
    np.testing.assert_array_equal(_np(seq(x)), _np(lin(x)))
    seq.to(dtype="bfloat16")
    assert lin.weight.dtype == torch.bfloat16
    assert lin.weight.value.requires_grad
    with pytest.raises(NotImplementedError, match="set_device"):
        seq.to(device="gpu")


# --------------------------------------------------------------------------
# losses, eager training, dropout's generator
# --------------------------------------------------------------------------

def _loss_inputs(seed=40):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    labels = np.array([0, 4, -100, 2, 1, 3], np.int32)
    labels4 = np.array([0, 4, 3, 2, 4, 1], np.int32)    # ignore_index 4
    soft = rng.random((6, 5)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    weight = (0.5 + rng.random(5)).astype(np.float32)
    logits3 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    labels3 = rng.integers(0, 4, (2, 3, 1)).astype(np.int32)
    x, y = (rng.standard_normal((4, 3)).astype(np.float32) for _ in "xy")
    return dict(logits=logits, labels=labels, labels4=labels4, soft=soft,
                weight=weight,
                logits3=logits3, labels3=labels3, x=x, y=y)


LOSS_CASES = {
    "ce": lambda F, d: F.cross_entropy(d["logits"], d["labels"]),
    "ce_weight_sum": lambda F, d: F.cross_entropy(
        d["logits"], d["labels"], weight=d["weight"], reduction="sum"),
    "ce_weight_mean": lambda F, d: F.cross_entropy(
        d["logits"], d["labels"], weight=d["weight"]),
    "ce_none_ignore": lambda F, d: F.cross_entropy(
        d["logits"], d["labels4"], reduction="none", ignore_index=4),
    "ce_soft": lambda F, d: F.cross_entropy(d["logits"], d["soft"],
                                            soft_label=True),
    "ce_soft_weight": lambda F, d: F.cross_entropy(
        d["logits"], d["soft"], soft_label=True, weight=d["weight"],
        reduction="sum"),
    "ce_axis_label_dim": lambda F, d: F.cross_entropy(
        d["logits3"], d["labels3"], axis=-1),
    "ce_no_softmax": lambda F, d: F.cross_entropy(
        d["soft"], d["labels"], use_softmax=False),
    "softmax_with_ce": lambda F, d: F.softmax_with_cross_entropy(
        d["logits"], d["labels"][:, None]),
    "nll": lambda F, d: F.nll_loss(d["logits"], d["labels"]),
    "nll_weight_none": lambda F, d: F.nll_loss(
        d["logits"], d["labels"][:, None], weight=d["weight"],
        reduction="none"),
    "mse": lambda F, d: F.mse_loss(d["x"], d["y"]),
    "mse_sum": lambda F, d: F.mse_loss(d["x"], d["y"], reduction="sum"),
    "l1": lambda F, d: F.l1_loss(d["x"], d["y"]),
    "l1_none": lambda F, d: F.l1_loss(d["x"], d["y"], reduction="none"),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_its_grad_match_reference(case):
    """Each ported loss, its value and the grad of its first input, at
    1e-6 (the first input trains, the others do not)."""
    data = _loss_inputs()
    out = {}
    for pkg in (P, pt):
        first = {"ce": "logits", "nll": "logits", "softmax_with_ce":
                 "logits", "mse": "x", "l1": "x"}
        key = next(v for k, v in first.items() if case.startswith(k))
        if case in ("ce_axis_label_dim",):
            key = "logits3"
        if case == "ce_no_softmax":
            key = "soft"
        ts = {k: pkg.to_tensor(v, stop_gradient=(k != key))
              for k, v in data.items()}
        loss = LOSS_CASES[case](pkg.nn.functional, ts)
        pkg.sum(loss).backward()
        out[pkg] = (np.asarray(loss.numpy()), np.asarray(
            ts[key].grad.numpy()))
    for a, b in zip(out[pt], out[P]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_loss_layers_match_reference():
    data = _loss_inputs(41)
    for name, kw, args in (
            ("CrossEntropyLoss", dict(ignore_index=4), ("logits", "labels4")),
            ("CrossEntropyLoss", dict(soft_label=True, reduction="sum"),
             ("logits", "soft")),
            ("NLLLoss", dict(reduction="sum"), ("logits", "labels")),
            ("MSELoss", dict(), ("x", "y")),
            ("L1Loss", dict(reduction="none"), ("x", "y"))):
        got = [np.asarray(getattr(pkg.nn, name)(**kw)(
            *[pkg.to_tensor(data[a]) for a in args]).numpy())
            for pkg in (P, pt)]
        np.testing.assert_allclose(got[1], got[0], rtol=1e-6, atol=1e-6)


def test_encoder_training_matches_reference():
    """The nn encoder at 2 layers, [2, 128], dropout 0 (JAX's RNG cannot
    be matched), trained 3 steps in each package with the same weights:
    ``CrossEntropyLoss`` on shifted ids, ``loss.backward()``, AdamW (eps
    1e-6) with ``ClipGradByGlobalNorm(1.0)``; the losses within 1e-5
    relative, every parameter within 1e-5 of its max|ref|."""
    cfg = dict(SMALL, N=128)
    ids = np.random.default_rng(42).integers(0, cfg["V"], (2, cfg["N"]))
    ref = make_encoder(P, P.arange, **cfg)
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    out = {}
    for pkg, arange in ((P, P.arange), (pt, t_arange)):
        model = ref if pkg is P else make_encoder(pt, arange, **cfg)
        model.train()
        model.set_state_dict(state)
        opt = pkg.optimizer.AdamW(
            learning_rate=1e-3, epsilon=1e-6, parameters=model.parameters(),
            grad_clip=pkg.nn.ClipGradByGlobalNorm(1.0))
        ce = pkg.nn.CrossEntropyLoss()
        t = pkg.to_tensor(ids)
        losses = []
        for _ in range(3):
            _, logits = model(t)
            loss = ce(logits[:, :-1], t[:, 1:])
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        out[pkg] = (losses, {k: np.asarray(v.numpy())
                             for k, v in model.state_dict().items()})
    np.testing.assert_allclose(out[pt][0], out[P][0], rtol=1e-5)
    assert out[pt][0][-1] < out[pt][0][0]
    for k, want in out[P][1].items():
        np.testing.assert_allclose(
            out[pt][1][k], want, rtol=0,
            atol=FP32_TOL * max(1.0, np.abs(want).max()), err_msg=k)


def test_encoder_amp_step_on_cpu():
    """One bf16 ``auto_cast`` + ``GradScaler`` step of the encoder with
    dropout 0.1 and attention dropout 0 (the flash route): the logits are
    bf16, every grad lands fp32, the step is not skipped and no kernel
    launches on the CPU."""
    model = make_encoder(pt, t_arange, **SMALL).train()
    for layer in model.encoder.layers:
        layer.dropout1.p = layer.dropout2.p = layer.dropout.p = 0.1
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    scaler = pt.amp.GradScaler()
    ids = pt.to_tensor(np.random.default_rng(43).integers(
        0, SMALL["V"], (2, SMALL["N"])))
    before = _counts()
    with pt.amp.auto_cast(dtype="bfloat16"):
        _, logits = model(ids)
        loss = pt.nn.CrossEntropyLoss()(logits[:, :-1], ids[:, 1:])
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    scaler.scale(loss).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())
    w0 = _np(model.head.weight)
    scaler.step(opt)
    scaler.update()
    assert not scaler._found_inf and _counts() == before
    assert np.abs(_np(model.head.weight) - w0).max() > 0


def test_dropout_generator_seed_device_and_rate(monkeypatch):
    """Same seed, same mask; the mask is drawn on the tensor's device from
    the default generator's generator for it (no host draw, no copy); the
    kept share is within 3 sigma of 1 - p."""
    from paddle_tpu_torch.nn.functional import common
    x = pt.to_tensor(np.ones((200, 500), np.float32))
    pt.seed(11)
    a = _np(TF.dropout(x, 0.3))
    pt.seed(11)
    b = _np(TF.dropout(x, 0.3))
    np.testing.assert_array_equal(a, b)
    c = _np(TF.dropout(x, 0.3))
    assert not np.array_equal(a, c)
    n, p = a.size, 0.3
    assert abs((a == 0).mean() - p) <= 3 * np.sqrt(p * (1 - p) / n)
    np.testing.assert_allclose(a[a != 0], 1 / 0.7, rtol=1e-6)

    seen = []
    real = torch.rand

    def rand(*args, generator=None, device=None, **kw):
        seen.append((generator, device))
        return real(*args, generator=generator, device=device, **kw)
    monkeypatch.setattr(common.torch, "rand", rand)
    TF.dropout(x, 0.5)
    gen = core.default_generator()
    assert seen == [(gen.on(x.value.device), x.value.device)]
    assert gen.on(torch.device("cpu")) is gen.torch
