"""The port's convolutions, pooling, batch norm, their layers and the
vision models against the JAX package, on the CPU.

Inputs and weights are drawn with numpy and go to both packages; layer
weights cross as the reference's ``state_dict()`` (numpy, batch norm's
``_mean`` / ``_variance`` buffers included) into ``set_state_dict``.
Functionals agree at rtol 1e-5, atol 1e-5 (fp32, sums in another order),
``return_mask`` indices exactly; batch norm's running statistics after a
training call too.  LeNet on the synthetic MNIST, ten dygraph steps with
Adam through ``io.DataLoader``: losses at rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.vision import models as JM
from paddle_tpu_torch import vision
from paddle_tpu_torch.framework import core

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    """The CPU as the default place and one intra-op thread; both restored
    after."""
    prev, threads = core._state.expected_place, torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    core._state.expected_place = prev
    torch.set_num_threads(threads)


@pytest.fixture
def seeded():
    """Both packages' generators (and numpy's) seeded, and restored
    after."""
    ref, np_state = P.get_rng_state(), np.random.get_state()
    port = core.default_generator().torch.get_state()
    P.seed(11)
    core.default_generator().torch.manual_seed(11)
    try:
        yield
    finally:
        P.set_rng_state(ref)
        np.random.set_state(np_state)
        core.default_generator().torch.set_state(port)


def _np(t):
    return np.asarray(t.numpy())


def _run(name, arrays, grads=False, **kw):
    """``name`` of both functional modules on the same numpy ``arrays``;
    returns (reference outputs, port outputs) as numpy lists, with the
    inputs' gradients of sum(out * g) appended when ``grads``."""
    outs = []
    rng = np.random.RandomState(5)
    g = None
    for mod, F in ((P, JF), (pt, TF)):
        ts = [mod.to_tensor(a, stop_gradient=not grads) for a in arrays]
        out = getattr(F, name)(*ts, **kw)
        res = [_np(o) for o in (out if isinstance(out, tuple) else (out,))]
        if grads:
            if g is None:
                g = rng.randn(*res[0].shape).astype(np.float32)
            (out * mod.to_tensor(g)).sum().backward()
            res += [_np(t.grad) for t in ts]
        outs.append(res)
    return outs


def _close(ref, got, exact=False, tol=TOL):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, **tol)


_R = np.random.RandomState(0)
X2 = _R.randn(2, 4, 9, 11).astype(np.float32)
W2 = (_R.randn(6, 4, 3, 3) * 0.3).astype(np.float32)
WG = (_R.randn(6, 2, 3, 3) * 0.3).astype(np.float32)
B6 = _R.randn(6).astype(np.float32)
X2L = np.ascontiguousarray(X2.transpose(0, 2, 3, 1))

CONV_CASES = {
    "pad1": ([X2, W2, B6], dict(padding=1)),
    "pad_per_dim": ([X2, W2, B6], dict(padding=[1, 2])),
    "pad_pairs": ([X2, W2], dict(padding=[[1, 0], [2, 1]])),
    "pad_2n_list": ([X2, W2, B6], dict(padding=[0, 2, 1, 0], stride=2)),
    "same_stride2": ([X2, W2, B6], dict(padding="SAME", stride=2)),
    "same_dilated": ([X2, W2], dict(padding="same", dilation=2)),
    "valid_stride2": ([X2, W2], dict(padding="VALID", stride=(2, 1))),
    "dilation2": ([X2, W2, B6], dict(padding=2, dilation=2)),
    "groups2": ([X2, WG, B6], dict(padding=1, groups=2)),
    "nhwc": ([X2L, W2, B6], dict(padding=1, stride=2,
                                 data_format="NHWC")),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_reference(case):
    arrays, kw = CONV_CASES[case]
    _close(*_run("conv2d", arrays, grads=case in ("pad1", "groups2",
                                                  "same_stride2"), **kw))


def test_conv1d_and_conv3d_match_reference():
    r = np.random.RandomState(1)
    x1 = r.randn(2, 3, 13).astype(np.float32)
    w1 = r.randn(4, 3, 5).astype(np.float32)
    _close(*_run("conv1d", [x1, w1], grads=True, padding=2, stride=2))
    _close(*_run("conv1d", [np.ascontiguousarray(x1.transpose(0, 2, 1)),
                            w1], padding="SAME", data_format="NLC"))
    x3 = r.randn(1, 2, 5, 6, 7).astype(np.float32)
    w3 = r.randn(3, 2, 3, 3, 3).astype(np.float32)
    b3 = r.randn(3).astype(np.float32)
    _close(*_run("conv3d", [x3, w3, b3], grads=True, padding=1,
                 stride=(1, 2, 2)))


TRANSPOSE_CASES = {
    "stride2_outpad": ("conv2d_transpose", 2, dict(stride=2, padding=1,
                                                   output_padding=1)),
    "pad_pairs": ("conv2d_transpose", 2, dict(stride=2,
                                              padding=[[1, 0], [0, 2]])),
    "output_size": ("conv2d_transpose", 2, dict(stride=2, padding=1,
                                                output_size=[14, 18])),
    "groups_dilation": ("conv2d_transpose", 2, dict(groups=2, dilation=2,
                                                    padding=1)),
    "nhwc": ("conv2d_transpose", 2, dict(stride=2, padding=1,
                                         data_format="NHWC")),
    "1d": ("conv1d_transpose", 1, dict(stride=3, padding=1)),
    "3d": ("conv3d_transpose", 3, dict(stride=2, padding=1)),
}


def test_conv_transpose_refuses_string_padding_as_reference():
    r = np.random.RandomState(2)
    x = r.randn(1, 4, 5, 5).astype(np.float32)
    w = r.randn(4, 6, 3, 3).astype(np.float32)
    for mod, F in ((P, JF), (pt, TF)):
        with pytest.raises(ValueError, match="String padding"):
            F.conv2d_transpose(mod.to_tensor(x), mod.to_tensor(w),
                               stride=2, padding="SAME")


@pytest.mark.parametrize("case", sorted(TRANSPOSE_CASES))
def test_conv_transpose_matches_reference(case):
    name, nd, kw = TRANSPOSE_CASES[case]
    r = np.random.RandomState(2)
    groups = kw.get("groups", 1)
    x = r.randn(*((2, 4) + (7, 9, 5)[:nd] if nd != 3
                  else (1, 4, 4, 5, 3))).astype(np.float32)
    w = r.randn(4, 6 // groups, *([3] * nd)).astype(np.float32)
    b = r.randn(6).astype(np.float32)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    _close(*_run(name, [x, w, b], grads=case == "stride2_outpad", **kw))


XP = np.random.RandomState(3).randn(2, 3, 9, 10).astype(np.float32)

POOL_CASES = {
    "max_k3s2p1": ("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    "max_ceil": ("max_pool2d", dict(kernel_size=3, stride=2,
                                    ceil_mode=True)),
    "max_same": ("max_pool2d", dict(kernel_size=3, stride=2,
                                    padding="SAME")),
    "max_nhwc": ("max_pool2d", dict(kernel_size=2, stride=2,
                                    data_format="NHWC")),
    "avg_exclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                         padding=1)),
    "avg_inclusive": ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1,
                                         exclusive=False)),
    "avg_ceil_exclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                              padding=1, ceil_mode=True)),
    "avg_ceil_inclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                              ceil_mode=True,
                                              exclusive=False)),
    "avg_divisor": ("avg_pool2d", dict(kernel_size=2, stride=2,
                                       divisor_override=3)),
    "avg_pad_pairs": ("avg_pool2d", dict(kernel_size=3, stride=1,
                                         padding=[[1, 0], [0, 2]])),
    "avg_nhwc": ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1,
                                    data_format="NHWC")),
    "adaptive_avg_divides": ("adaptive_avg_pool2d", dict(output_size=(3, 5))),
    "adaptive_avg_ragged": ("adaptive_avg_pool2d", dict(output_size=(4, 3))),
    "adaptive_avg_none": ("adaptive_avg_pool2d",
                          dict(output_size=[None, 7])),
    "adaptive_max_ragged": ("adaptive_max_pool2d", dict(output_size=(4, 3))),
    "adaptive_max_divides": ("adaptive_max_pool2d", dict(output_size=5)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_reference(case):
    name, kw = POOL_CASES[case]
    x = XP
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(XP.transpose(0, 2, 3, 1))
    _close(*_run(name, [x], grads=case in ("max_k3s2p1", "avg_exclusive",
                                           "adaptive_avg_ragged"), **kw))


@pytest.mark.parametrize("kw", [dict(kernel_size=3, stride=2, padding=1),
                                dict(kernel_size=3, stride=2, ceil_mode=True),
                                dict(kernel_size=2, stride=2,
                                     data_format="NHWC")],
                         ids=["padded", "ceil", "nhwc"])
def test_max_pool_mask_matches_reference(kw):
    x = XP
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(XP.transpose(0, 2, 3, 1))
    (rv, ri), (tv, ti) = _run("max_pool2d", [x], return_mask=True, **kw)
    _close([rv], [tv])
    _close([ri], [ti], exact=True)


def test_adaptive_max_mask_matches_reference():
    (rv, ri), (tv, ti) = _run("adaptive_max_pool2d", [XP], output_size=(4, 3),
                              return_mask=True)
    _close([rv], [tv])
    _close([ri], [ti], exact=True)


def test_pools_1d_and_3d_match_reference():
    r = np.random.RandomState(4)
    x1 = r.randn(2, 3, 11).astype(np.float32)
    x3 = r.randn(1, 2, 5, 6, 7).astype(np.float32)
    for name, x, kw in (
            ("max_pool1d", x1, dict(kernel_size=3, stride=2, padding=1)),
            ("avg_pool1d", x1, dict(kernel_size=3, stride=2, padding=1,
                                    ceil_mode=True)),
            ("adaptive_avg_pool1d", x1, dict(output_size=4)),
            ("adaptive_max_pool1d", x1, dict(output_size=4)),
            ("max_pool3d", x3, dict(kernel_size=2, stride=2, ceil_mode=True)),
            ("avg_pool3d", x3, dict(kernel_size=3, stride=2, padding=1,
                                    exclusive=False)),
            ("adaptive_avg_pool3d", x3, dict(output_size=(2, 4, 3)))):
        _close(*_run(name, [x], **kw))


@pytest.mark.parametrize("mode", ["train", "eval", "train_nhwc",
                                  "train_no_affine", "global_stats"])
def test_batch_norm_matches_reference(mode):
    """Output, input and affine gradients, and the running statistics
    after the call (Paddle's momentum, the unbiased variance)."""
    r = np.random.RandomState(6)
    x = (r.randn(4, 5, 3, 2) * 2 + 0.7).astype(np.float32)
    fmt = "NCHW"
    if mode == "train_nhwc":
        x, fmt = np.ascontiguousarray(x.transpose(0, 2, 3, 1)), "NHWC"
    w = (r.rand(5) + 0.5).astype(np.float32)
    b = r.randn(5).astype(np.float32)
    rm0 = r.randn(5).astype(np.float32)
    rv0 = (r.rand(5) + 0.5).astype(np.float32)
    g = r.randn(*x.shape).astype(np.float32)
    res = []
    for mod, F in ((P, JF), (pt, TF)):
        xt = mod.to_tensor(x, stop_gradient=False)
        wt = mod.to_tensor(w, stop_gradient=False)
        bt = mod.to_tensor(b, stop_gradient=False)
        rm, rv = mod.to_tensor(rm0), mod.to_tensor(rv0)
        affine = (wt, bt) if mode != "train_no_affine" else (None, None)
        out = F.batch_norm(xt, rm, rv, *affine,
                           training=mode != "eval", momentum=0.8,
                           epsilon=1e-4, data_format=fmt,
                           use_global_stats=True if mode == "global_stats"
                           else None)
        (out * mod.to_tensor(g)).sum().backward()
        grads = [_np(t.grad) for t in (xt,) + ((wt, bt) if affine[0]
                                              is not None else ())]
        res.append([_np(out), _np(rm), _np(rv)] + grads)
    _close(*res)


def _block(mod):
    nn = mod.nn
    return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4),
                         nn.MaxPool2D(2), nn.BatchNorm(4, act="relu"),
                         nn.Conv1D(4, 2, 3), nn.BatchNorm1D(2),
                         nn.AdaptiveAvgPool1D(1))


def test_layers_state_dict_keys_match_reference(seeded):
    """A block of conv, batch norm and pool layers and LeNet have the
    reference's parameter and buffer names, shapes and order (ResNet's,
    and its forward and train step, are ``tests/test_torch_static.py``'s);
    the conv layer classes build with the reference's weight shapes."""
    for make in (_block, lambda m: (JM.LeNet() if m is P
                                    else vision.models.LeNet())):
        rsd, tsd = make(P).state_dict(), make(pt).state_dict()
        assert list(rsd) == list(tsd)
        assert all(list(rsd[k].shape) == tsd[k].shape for k in rsd)
    for name in ("Conv1D", "Conv3D", "Conv2DTranspose", "Conv1DTranspose",
                 "Conv3DTranspose"):
        a = getattr(P.nn, name)(4, 6, 3, groups=2)
        b = getattr(pt.nn, name)(4, 6, 3, groups=2)
        assert [list(p.shape) for p in a.parameters()] == \
            [p.shape for p in b.parameters()]
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        pt.nn.SyncBatchNorm(4)


def test_lenet_dygraph_matches_reference(seeded):
    """The verify flow's dygraph path: LeNet on the synthetic MNIST through
    ``io.DataLoader``, ten steps of Adam (``loss.backward()``, ``step()``,
    ``clear_grad()``), the same batches; losses at rtol 1e-4, and the
    dataset is the reference's, sample for sample."""
    ds_ref = P.vision.datasets.MNIST(mode="test")
    ds = vision.datasets.MNIST(mode="test")
    assert len(ds) == len(ds_ref) == 512
    for i in (0, 17, 511):
        np.testing.assert_array_equal(ds[i][0], ds_ref[i][0])
        np.testing.assert_array_equal(ds[i][1], ds_ref[i][1])
    ref = JM.LeNet()
    net = vision.models.LeNet()
    net.set_state_dict({k: _np(v) for k, v in ref.state_dict().items()})
    losses = []
    for mod, m, d in ((P, ref, ds_ref), (pt, net, ds)):
        opt = mod.optimizer.Adam(learning_rate=1e-3,
                                 parameters=m.parameters())
        loader = mod.io.DataLoader(d, batch_size=32, shuffle=False)
        out = []
        for step, (img, label) in enumerate(loader):
            if step == 10:
                break
            loss = mod.nn.functional.cross_entropy(m(img), label).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss))
        losses.append(out)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    assert losses[1][-1] < losses[1][0]
