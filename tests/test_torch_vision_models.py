"""VGG11, MobileNetV1 and MobileNetV2 of the port against the JAX package,
on the CPU, and a small SSD (as ``examples/ssd_detection.py``) trained
through ``ssd_loss`` and run through ``detection_output``.

Weights cross as the reference's ``state_dict()`` (numpy; batch norm's
``_mean`` / ``_variance`` included) into ``set_state_dict``; inputs are
numpy draws.  The models run at scale 0.25 (VGG has no width scale):
the eval forward's logits at 1e-5 of max|logit|, then three SGD steps
in training mode (dropout set to 0 in both, its masks being each
package's own draws) with losses and the weights after them compared:
VGG11's in fp32 at 32 x 32, the MobileNets' in float64 at 64 x 64 (their
fp32 steps are ill-conditioned; the reference's float64 run is in a
fresh interpreter with JAX's x64 on).  The SSD's losses at rtol 1e-4
and its detections' labels exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.vision import models as TM


@pytest.fixture(autouse=True)
def _cpu():
    prev, threads = core._state.expected_place, torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(2)
    yield
    core._state.expected_place = prev
    torch.set_num_threads(threads)


def _np(t):
    return np.asarray(t.numpy())


def _no_dropout(model, mod):
    for layer in model.sublayers():
        if isinstance(layer, mod.nn.Dropout):
            layer.p = 0.0


def _rel(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


MODELS = {
    "vgg11": lambda M: M.vgg11(num_classes=10),
    "vgg11_bn": lambda M: M.vgg11(batch_norm=True, num_classes=10),
    "mobilenet_v1": lambda M: M.mobilenet_v1(scale=0.25, num_classes=10),
    "mobilenet_v2": lambda M: M.MobileNetV2(scale=0.25, num_classes=10),
}


def _train(mod, m, x, y, steps=3, lr=0.01):
    """``steps`` SGD steps in training mode, dropout at 0; the losses."""
    m.train()
    _no_dropout(m, mod)
    opt = mod.optimizer.SGD(learning_rate=lr, parameters=m.parameters())
    out = []
    for _ in range(steps):
        loss = mod.nn.functional.cross_entropy(
            m(mod.to_tensor(x)), mod.to_tensor(y)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out


def _carry(ref, got):
    rsd = ref.state_dict()
    assert list(rsd) == list(got.state_dict())
    assert all(list(v.shape) == got.state_dict()[k].shape
               for k, v in rsd.items())
    got.set_state_dict({k: _np(v) for k, v in rsd.items()})


@pytest.mark.parametrize("name", ["vgg11", "vgg11_bn"])
def test_vgg_matches_reference(name):
    """Names, shapes and order of parameters and buffers; the eval
    forward; VGG11's three fp32 SGD steps (lr 0.01)."""
    P.seed(3)
    ref, got = MODELS[name](JM), MODELS[name](TM)
    _carry(ref, got)
    rng = np.random.RandomState(4)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, (4, 1)).astype(np.int64)
    ref.eval()
    got.eval()
    _rel(_np(got(pt.to_tensor(x))), _np(ref(P.to_tensor(x))), 1e-5)
    if name != "vgg11":
        return
    losses = [_train(mod, m, x, y) for mod, m in ((P, ref), (pt, got))]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    tsd = got.state_dict()
    for k, v in ref.state_dict().items():
        _rel(_np(tsd[k]), _np(v), 1e-4)


@pytest.mark.parametrize("arch", ["vgg13", "vgg16", "vgg19"])
def test_vgg_configurations_match_reference(arch):
    """VGG13, 16 and 19 (configurations B, D, E): the port's builders
    make the reference's layers (the feature stacks' names and shapes,
    with and without batch norm), and VGG16's feature stack computes the
    reference's values (the classifiers are VGG11's, tested above)."""
    from paddle_tpu.vision.models import vgg as JV
    from paddle_tpu_torch.vision.models import vgg as TV
    cfg = {"vgg13": "B", "vgg16": "D", "vgg19": "E"}[arch]
    assert TV.cfgs == JV.cfgs
    for bn in (False, True):
        P.seed(3)
        ref, got = JV.make_layers(JV.cfgs[cfg], bn), \
            TV.make_layers(TV.cfgs[cfg], bn)
        _carry(ref, got)
        if arch == "vgg16" and not bn:
            x = np.random.RandomState(5).randn(1, 3, 32, 32).astype(
                np.float32)
            _rel(_np(got(pt.to_tensor(x))), _np(ref(P.to_tensor(x))), 1e-5)
    got = getattr(TM, arch)(num_classes=0)
    assert list(got.state_dict()) == [
        f"features.{k}" for k in TV.make_layers(TV.cfgs[cfg]).state_dict()]


def test_make_divisible_and_widths_match_reference():
    from paddle_tpu.vision.models.mobilenetv2 import _make_divisible as ref
    from paddle_tpu_torch.vision.models.mobilenetv2 import \
        _make_divisible as got
    for v in (3, 8, 12.5, 16 * 0.35, 1280 * 1.4, 320 * 0.75, 0.5):
        assert got(v) == ref(v)
    n = sum(int(np.prod(p.shape)) for p in TM.mobilenet_v2().parameters())
    assert n == 3504872          # Sandler et al. 2018: 3.4M at width 1.0


# --------------------------------------------------------------------------
# a small SSD: priors -> ssd_loss training -> detection_output
# --------------------------------------------------------------------------

def _batch(rng, n=4, size=32):
    imgs = np.zeros((n, 1, size, size), np.float32)
    boxes = np.zeros((n, 2, 4), np.float32)
    for i in range(n):
        s = rng.randint(8, 16)
        x0, y0 = rng.randint(0, size - s, 2)
        imgs[i, 0, y0:y0 + s, x0:x0 + s] = 1.0
        boxes[i, 0] = [x0 / size, y0 / size, (x0 + s) / size,
                       (y0 + s) / size]
    labels = np.ones((n, 2), np.int64)
    return imgs, boxes, labels


def _tiny_ssd(mod):
    nn = mod.nn

    class TinySSD(nn.Layer):
        def __init__(self):
            super().__init__()
            self.backbone = nn.Sequential(
                nn.Conv2D(1, 8, 3, stride=2, padding=1), nn.ReLU(),
                nn.Conv2D(8, 16, 3, stride=2, padding=1), nn.ReLU())
            self.loc = nn.Conv2D(16, 3 * 4, 3, padding=1)
            self.conf = nn.Conv2D(16, 3 * 2, 3, padding=1)

        def forward(self, x):
            f = self.backbone(x)
            loc = mod.reshape(mod.transpose(self.loc(f), [0, 2, 3, 1]),
                              [0, -1, 4])
            conf = mod.reshape(mod.transpose(self.conf(f), [0, 2, 3, 1]),
                               [0, -1, 2])
            return loc, conf
    return TinySSD()


def test_small_ssd_trains_and_detects_as_reference():
    """``examples/ssd_detection.py``'s pipeline in both packages from the
    same weights and batches: three Adam steps of ``ssd_loss`` (losses at
    rtol 1e-4), then ``fluid.layers.detection_output`` on the softmaxed
    scores (labels equal, scores and boxes at 1e-4)."""
    P.seed(5)
    ref = _tiny_ssd(P)
    got = _tiny_ssd(pt)
    got.set_state_dict({k: _np(v) for k, v in ref.state_dict().items()})
    rng = np.random.RandomState(6)
    batches = [_batch(rng) for _ in range(3)]
    test_imgs = _batch(rng, n=2)[0]
    res = []
    for mod, m in ((P, ref), (pt, got)):
        D = mod.vision.detection
        priors, pvar = D.prior_box(mod.zeros([1, 16, 8, 8]),
                                   mod.zeros([1, 1, 32, 32]),
                                   min_sizes=[10.0], max_sizes=[20.0],
                                   aspect_ratios=[2.0], flip=False,
                                   clip=True)
        priors = mod.reshape(priors, [-1, 4])
        pvar = mod.reshape(pvar, [-1, 4])
        opt = mod.optimizer.Adam(2e-3, parameters=m.parameters())
        losses = []
        for imgs, boxes, labels in batches:
            loc, conf = m(mod.to_tensor(imgs))
            loss = D.ssd_loss(loc, conf, mod.to_tensor(boxes),
                              mod.to_tensor(labels), priors,
                              overlap_threshold=0.4)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        loc, conf = m(mod.to_tensor(test_imgs))
        det = mod.fluid.layers.detection_output(
            loc, mod.nn.functional.softmax(conf, axis=-1), priors, pvar,
            score_threshold=0.01, keep_top_k=5)
        res.append((losses, _np(det)))
    (lr, dr), (lg, dg) = res
    np.testing.assert_allclose(lg, lr, rtol=1e-4)
    np.testing.assert_array_equal(dg[..., 0], dr[..., 0])
    np.testing.assert_allclose(dg[..., 1:], dr[..., 1:], rtol=1e-4,
                               atol=1e-4)
    assert (dg[:, 0, 0] >= 0).all()


# the reference's MobileNets in a fresh interpreter with JAX's x64 on, as
# float64 static programs: the eval forward (the test clone) and three
# training steps
_REF = """
import sys
import numpy as np, jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import paddle_tpu as P
from paddle_tpu import static
from paddle_tpu.vision import models
for name, make in (("mobilenet_v1", lambda: models.mobilenet_v1(
        scale=0.25, num_classes=10)), ("mobilenet_v2", lambda:
        models.MobileNetV2(scale=0.25, num_classes=10))):
    P.seed(3)
    rng = np.random.RandomState(4)
    x = rng.randn(8, 3, 64, 64)
    y = rng.randint(0, 10, (8, 1))
    P.enable_static()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        img = static.data("image", [None, 3, 64, 64], "float64")
        label = static.data("label", [None, 1], "int64")
        net = make()
        for v in net.state_dict().values():
            v.value = v.value.astype(jnp.float64)
        init = {k: np.asarray(v.numpy()) for k, v in
                net.state_dict().items()}
        for layer in net.sublayers():
            if isinstance(layer, P.nn.Dropout):
                layer.p = 0.0
        logits = net(img)
        loss = P.nn.functional.cross_entropy(logits, label).mean()
        test = main.clone(for_test=True)
        P.optimizer.SGD(learning_rate=2.0 ** -6).minimize(loss)
    exe = static.Executor()
    lg, = exe.run(test, feed={"image": x, "label": y}, fetch_list=[logits])
    losses = [exe.run(main, feed={"image": x, "label": y},
                      fetch_list=[loss])[0] for _ in range(3)]
    P.disable_static()
    after = {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
    np.savez(sys.argv[1] + name + ".npz", x=x, y=y, logits=lg,
             loss=np.stack(losses),
             **{"init/" + k: v for k, v in init.items()},
             **{"after/" + k: v for k, v in after.items()})
"""


@pytest.fixture(scope="module", autouse=True)
def ref_mobilenets(tmp_path_factory):
    """The reference's MobileNet runs, started in a subprocess when the
    module's first test starts (they overlap the VGG and SSD tests) and
    awaited by the MobileNet tests."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path_factory.mktemp("ref")) + os.sep
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    proc = subprocess.Popen([sys.executable, "-c", _REF, out], env=env,
                            cwd=root, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)

    def load(name):
        if proc.returncode is None:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err.decode()[-4000:]
        return np.load(out + name + ".npz")
    yield load
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("name", ["mobilenet_v1", "mobilenet_v2"])
def test_mobilenet_matches_reference(ref_mobilenets, name):
    """Names and shapes of parameters and buffers; the fp32 eval forward
    at 1e-5 of max|logit| from the reference's float64 one; three SGD
    steps (lr 2^-6) in training mode at 64 x 64, batch 8, in float64:
    losses at rtol 1e-6, weights and running statistics after them at
    1e-6 of each tensor's largest value (1e-12 at least).  In fp32 these
    steps are ill-conditioned (batch statistics over 32 values a channel
    in the last blocks, and batch norms whose weight gradient is exactly
    zero at initialisation): the two packages' fp32 losses part by
    percents within the three steps, where in float64 they agree to
    rounding."""
    P.seed(3)
    assert list(MODELS[name](JM).state_dict()) == list(
        MODELS[name](TM).state_dict())
    ref = ref_mobilenets(name)
    net = MODELS[name](TM)
    init = {k[5:]: ref[k] for k in ref.files if k.startswith("init/")}
    assert all(list(v.shape) == net.state_dict()[k].shape
               for k, v in init.items())
    net.set_state_dict({k: v.astype(np.float32) for k, v in init.items()})
    net.eval()
    _rel(_np(net(pt.to_tensor(ref["x"].astype(np.float32)))),
         ref["logits"], 1e-5)
    net.set_state_dict(init)
    for t in net.state_dict().values():
        t.value = t.value.detach().double()
        if isinstance(t, pt.tensor.Parameter):
            t._mark()
    losses = _train(pt, net, pt.Tensor(torch.from_numpy(ref["x"])),
                    ref["y"].astype(np.int64), lr=2.0 ** -6)
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-6)
    tsd = net.state_dict()
    for k in ref.files:
        if k.startswith("after/"):
            got, want = _np(tsd[k[6:]]), ref[k]
            assert got.dtype == np.float64
            np.testing.assert_allclose(got, want, rtol=0, atol=max(
                1e-6 * float(np.abs(want).max()), 1e-12))
