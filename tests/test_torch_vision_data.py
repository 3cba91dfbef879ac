"""The port's vision input side against the JAX package, on the CPU: the
nineteen transforms under ``random.seed`` (the same crops, flips,
jitter and rotations, bit for bit), the functionals, the datasets (a
CIFAR archive and a folder tree written under ``tmp_path``, the
synthetic surrogates), ``runtime.preprocess_images`` against its plain
numpy version, ``read_file`` / ``decode_jpeg`` (skipped where PIL is
missing) and ``mask_labels``.
"""
import io
import os
import pickle
import random
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch import runtime, vision
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.vision import transforms as TT


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _arr(v):
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


IMG = np.random.RandomState(0).randint(0, 256, (37, 45, 3)).astype(np.uint8)

TRANSFORMS = {
    "Compose": lambda T: T.Compose([T.RandomHorizontalFlip(0.5),
                                    T.RandomCrop(20), T.Normalize(
                                        127.5, 127.5, data_format="HWC")]),
    "Resize": lambda T: T.Resize(24),
    "Resize_hw_nearest": lambda T: T.Resize((20, 31), "nearest"),
    "Normalize": lambda T: T.Normalize([120.0, 110.0, 100.0],
                                       [60.0, 50.0, 40.0], "HWC"),
    "ToTensor": lambda T: T.ToTensor(),
    "Transpose": lambda T: T.Transpose(),
    "RandomCrop": lambda T: T.RandomCrop((30, 33), padding=2,
                                         pad_if_needed=True),
    "RandomCrop_pad_needed": lambda T: T.RandomCrop(48, pad_if_needed=True,
                                                    padding_mode="edge"),
    "CenterCrop": lambda T: T.CenterCrop(21),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(),
    "RandomVerticalFlip": lambda T: T.RandomVerticalFlip(),
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(24),
    "Pad": lambda T: T.Pad((1, 2, 3, 4), padding_mode="reflect"),
    "BrightnessTransform": lambda T: T.BrightnessTransform(0.4),
    "ContrastTransform": lambda T: T.ContrastTransform(0.4),
    "SaturationTransform": lambda T: T.SaturationTransform(0.4),
    "HueTransform": lambda T: T.HueTransform(0.3),
    "ColorJitter": lambda T: T.ColorJitter(0.4, 0.4, 0.4, 0.2),
    "Grayscale": lambda T: T.Grayscale(3),
    "RandomRotation": lambda T: T.RandomRotation(30, fill=7),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_reference_under_random_seed(name):
    """Each transform on the same image after the same ``random.seed``,
    for five seeds: outputs equal bit for bit (the random ones draw from
    Python's ``random`` in the reference's order)."""
    for seed in range(5):
        outs = []
        for T in (JT, TT):
            t = TRANSFORMS[name](T)
            random.seed(seed)
            outs.append(_arr(t(IMG.copy())))
        assert outs[0].dtype == outs[1].dtype
        np.testing.assert_array_equal(outs[1], outs[0])
    assert isinstance(TT.ToTensor()(IMG), pt.Tensor)
    assert issubclass(getattr(TT, name.split("_")[0]), TT.BaseTransform) \
        or name == "Compose"


def test_functionals_match_reference():
    JF, TF = JT.functional, TT.functional
    img_f = IMG.astype(np.float32) / 255.0
    cases = [("resize", (IMG, 30)), ("resize", (img_f, (17, 50))),
             ("resize", (IMG[..., 0], (9, 8), "nearest")),
             ("center_crop", (IMG, (11, 40))), ("hflip", (IMG,)),
             ("vflip", (IMG,)), ("pad", (IMG, 3, 9)),
             ("pad", (IMG, (1, 2), 0, "symmetric")),
             ("normalize", (img_f.transpose(2, 0, 1), [0.5] * 3, [0.2] * 3)),
             ("rotate", (IMG, 17.0)), ("adjust_brightness", (IMG, 1.3)),
             ("adjust_contrast", (img_f, 0.7)),
             ("adjust_saturation", (IMG, 1.5)), ("adjust_hue", (IMG, -0.2)),
             ("to_grayscale", (IMG, 1)), ("crop", (IMG, 3, 4, 10, 12))]
    for name, args in cases:
        np.testing.assert_array_equal(_arr(getattr(TF, name)(*args)),
                                      _arr(getattr(JF, name)(*args)))
    t = TF.to_tensor(IMG)
    assert isinstance(t, pt.Tensor) and t.shape == [3, 37, 45]
    np.testing.assert_array_equal(_arr(t), _arr(JF.to_tensor(IMG)))


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

def _cifar_archive(path, fine):
    rng = np.random.RandomState(1)
    key = b"fine_labels" if fine else b"labels"
    with tarfile.open(path, "w:gz") as tf:
        for name, n in (("data_batch_1", 6), ("data_batch_2", 5),
                        ("test_batch", 4)):
            blob = pickle.dumps({b"data": rng.randint(
                0, 256, (n, 3072)).astype(np.uint8),
                key: rng.randint(0, 100 if fine else 10, n).tolist()})
            info = tarfile.TarInfo(f"cifar/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


@pytest.mark.parametrize("fine", [False, True])
def test_cifar_archive_parses_as_reference(tmp_path, fine):
    path = str(tmp_path / "cifar.tar.gz")
    _cifar_archive(path, fine)
    cls = "Cifar100" if fine else "Cifar10"
    for mode, n in (("train", 11), ("test", 4)):
        ref = getattr(P.vision.datasets, cls)(data_file=path, mode=mode)
        got = getattr(vision.datasets, cls)(data_file=path, mode=mode)
        assert len(got) == len(ref) == n
        np.testing.assert_array_equal(got.images, ref.images)
        np.testing.assert_array_equal(got.labels, ref.labels)
        for i in (0, n - 1):
            for a, b in zip(got[i], ref[i]):
                np.testing.assert_array_equal(a, b)


def test_synthetic_datasets_match_reference():
    t = TT.Compose([TT.Resize(16), TT.Transpose()])
    j = JT.Compose([JT.Resize(16), JT.Transpose()])
    for name, kw in (("Cifar10", dict(mode="test")),
                     ("Flowers", dict(mode="test")),
                     ("VOC2012", dict(mode="test"))):
        ref = getattr(P.vision.datasets, name)(**kw)
        got = getattr(vision.datasets, name)(**kw)
        assert len(got) == len(ref)
        for i in (0, len(got) - 1):
            for a, b in zip(got[i], ref[i]):
                np.testing.assert_array_equal(a, b)
        ref.transform, got.transform = j, t
        for a, b in zip(got[3], ref[3]):
            np.testing.assert_array_equal(a, b)


def test_folder_datasets_match_reference(tmp_path):
    """``DatasetFolder`` (class subdirectories; ``.npy`` files, a PNG
    read with PIL where it is present) and ``ImageFolder``."""
    rng = np.random.RandomState(2)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / c)
        for i in range(3):
            np.save(tmp_path / c / f"{i}.npy",
                    rng.randint(0, 256, (8, 9, 3)).astype(np.uint8))
    (tmp_path / "dog" / "notes.txt").write_text("skipped")
    try:
        from PIL import Image
        Image.fromarray(rng.randint(0, 256, (6, 7, 3)).astype(
            np.uint8)).save(tmp_path / "cat" / "p.png")
    except ImportError:
        pass
    t = TT.Normalize(127.5, 127.5, "HWC")
    for cls in ("DatasetFolder", "ImageFolder"):
        ref = getattr(P.vision.datasets, cls)(str(tmp_path),
                                              transform=JT.Normalize(
                                                  127.5, 127.5, "HWC"))
        got = getattr(vision.datasets, cls)(str(tmp_path), transform=t)
        assert got.samples == ref.samples and len(got) >= 6
        for i in range(len(got)):
            for a, b in zip(got[i], ref[i]):
                np.testing.assert_array_equal(a, b)
    assert vision.datasets.DatasetFolder(str(tmp_path)).classes == \
        ["cat", "dog"]


# --------------------------------------------------------------------------
# the native preprocess, image io, mask labels, the package
# --------------------------------------------------------------------------

def _plain_preprocess(batch, mean, std, scale):
    """The reference's numpy fallback (``paddle_tpu/runtime``), the
    plain version of the native pass."""
    b = np.stack(batch).astype(np.float32) * scale
    b = (b - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return np.ascontiguousarray(b.transpose(0, 3, 1, 2))


@pytest.mark.skipif(not runtime.is_available(),
                    reason="the native runtime cannot be built here")
def test_preprocess_images_matches_plain_version():
    """u8 NHWC -> f32 NCHW, fused and threaded, against the numpy
    arithmetic at 1e-6 of max (the native pass multiplies by scale / std
    and subtracts mean / std); a list batch, and the ImageNet constants
    in pixel units as (aq) uses them; non-uint8 and ragged batches
    raise."""
    rng = np.random.RandomState(3)
    batch = rng.randint(0, 256, (5, 13, 11, 3)).astype(np.uint8)
    for mean, std, scale in (([0.485, 0.456, 0.406],
                              [0.229, 0.224, 0.225], 1 / 255.0),
                             ([123.675, 116.28, 103.53],
                              [58.395, 57.12, 57.375], 1.0)):
        want = _plain_preprocess(list(batch), mean, std, scale)
        for imgs, th in ((batch, 0), (list(batch), 2)):
            got = runtime.preprocess_images(imgs, mean, std, scale, th)
            assert got.dtype == np.float32 and got.shape == (5, 3, 13, 11)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    with pytest.raises(TypeError):
        runtime.preprocess_images(batch.astype(np.float32), [0] * 3, [1] * 3)
    with pytest.raises(ValueError):
        runtime.preprocess_images([batch[0], batch[0, :5]], [0] * 3,
                                  [1] * 3)


def test_read_file_and_decode_jpeg_match_reference(tmp_path):
    pytest.importorskip("PIL", reason="decode_jpeg decodes with PIL")
    from PIL import Image
    rng = np.random.RandomState(4)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(rng.randint(0, 256, (10, 12, 3)).astype(
        np.uint8)).save(path, quality=90)
    data = vision.ops.read_file(path)
    np.testing.assert_array_equal(_arr(data),
                                  _arr(P.vision.ops.read_file(path)))
    for mode in ("unchanged", "gray", "rgb"):
        got = vision.ops.decode_jpeg(data, mode=mode)
        assert isinstance(got, pt.Tensor)
        np.testing.assert_array_equal(
            _arr(got), _arr(P.vision.ops.decode_jpeg(
                P.vision.ops.read_file(path), mode=mode)))


def test_fluid_read_file_reads_a_path_as_reference(tmp_path):
    """``fluid.layers.read_file`` of anything but a reader is
    ``vision.ops.read_file``, as the reference dispatches."""
    path = tmp_path / "blob.bin"
    path.write_bytes(bytes(range(7)) * 3)
    got = pt.fluid.layers.read_file(str(path))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        _arr(got), _arr(P.fluid.layers.read_file(str(path))))


def test_mask_labels_match_reference():
    """``generate_mask_labels`` of the port's copy on the reference's
    inputs: the same targets."""
    from paddle_tpu.vision import mask_labels as JL
    from paddle_tpu_torch.vision import mask_labels as TL
    im_info = np.array([[64, 64, 1.0]], np.float32)
    gt_classes = [np.array([1, 2], np.int32)]
    is_crowd = [np.array([0, 0], np.int32)]
    segms = [[[[4, 4, 30, 6, 28, 30, 6, 26]],
              [[34, 34, 60, 36, 58, 60, 36, 50, 40, 40]]]]
    rois = [np.array([[2, 2, 32, 32], [30, 30, 62, 62], [0, 0, 10, 10]],
                     np.float32)]
    labels = [np.array([1, 2, 0], np.int32)]
    outs = [M.generate_mask_labels(im_info, gt_classes, is_crowd, segms,
                                   rois, labels, num_classes=3,
                                   resolution=14)
            for M in (JL, TL)]
    flat = [[np.asarray(v) for v in (o if isinstance(o, (tuple, list))
                                     else [o])] for o in outs]
    for a, b in zip(*flat):
        np.testing.assert_array_equal(b, a)


def test_vision_package_exports():
    names = [n for n in dir(P.vision) if not n.startswith("_")
             and n not in ("annotations",)]
    missing = [n for n in names if not hasattr(vision, n)]
    assert missing == [], missing
    assert vision.get_image_backend() == "numpy"
    vision.set_image_backend("pil")
    for n in ("VGG", "vgg16", "MobileNetV1", "mobilenet_v2", "LeNet",
              "resnet50"):
        assert hasattr(vision.models, n) and hasattr(vision, n)
    assert "not ported" not in vision.__doc__
    for n in ("deform_conv2d", "multi_box_head"):
        assert not isinstance(getattr(pt.static.nn, n), type(None))
    assert torch.is_tensor(vision.detection.prior_box(
        pt.zeros([1, 1, 2, 2]), pt.zeros([1, 3, 8, 8]), [4.0])[0].value)
