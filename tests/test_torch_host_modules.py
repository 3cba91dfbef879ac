"""The port's host-side modules against the JAX package, on the CPU:
``dataset`` (the reader creators, sample for sample), ``reader`` (the
decorators), ``batch``, ``hub`` (local sources; remote ones raise),
``utils`` (``unique_name``, ``run_check``, ``deprecated``,
``cpp_extension``, ``flops``, ``try_import``, ``require_version``),
``compat``, ``version``, ``sysconfig`` and the top-level exports.
"""
import ctypes
import gzip
import os
import random
import struct
import textwrap
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import core


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _same_samples(got, want, n):
    gi, wi = iter(got()), iter(want())
    for _ in range(n):
        g, w = next(gi), next(wi)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert type(a) is type(b)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- dataset: the reader creators ---------------------------------------------

def test_dataset_mnist_reader_schema_and_samples():
    img, label = next(iter(pt.dataset.mnist.train()()))
    assert img.shape == (784,) and img.dtype == np.float32
    assert -1.0 <= img.min() and img.max() <= 1.0
    assert isinstance(label, int) and 0 <= label <= 9
    _same_samples(pt.dataset.mnist.test(), P.dataset.mnist.test(), 16)


def test_dataset_mnist_reads_idx_files(tmp_path):
    rng = np.random.RandomState(5)
    images = rng.randint(0, 255, (8, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 8).astype(np.uint8)
    ip, lp = str(tmp_path / "i.gz"), str(tmp_path / "l.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">iiii", 2051, 8, 28, 28) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">ii", 2049, 8) + labels.tobytes())
    got = list(pt.dataset.mnist.train(ip, lp)())
    assert [lab for _, lab in got] == labels.tolist()
    _same_samples(pt.dataset.mnist.train(ip, lp),
                  P.dataset.mnist.train(ip, lp), 8)


def test_dataset_uci_housing_reader():
    x, y = next(iter(pt.dataset.uci_housing.train()()))
    assert x.shape == (13,) and y.shape == (1,)
    _same_samples(pt.dataset.uci_housing.test(),
                  P.dataset.uci_housing.test(), 32)


def test_dataset_cifar_reader():
    img, label = next(iter(pt.dataset.cifar.train10()()))
    assert img.shape == (3072,) and 0.0 <= img.min() <= img.max() <= 1.0
    assert 0 <= label <= 9
    _same_samples(pt.dataset.cifar.test100(), P.dataset.cifar.test100(), 8)


def test_dataset_imdb_reader_and_word_dict():
    wd = pt.dataset.imdb.word_dict()
    assert wd == P.dataset.imdb.word_dict()
    ids, label = next(iter(pt.dataset.imdb.train(wd)()))
    assert isinstance(ids, list) and label in (0, 1)
    _same_samples(pt.dataset.imdb.train(wd), P.dataset.imdb.train(wd), 32)


def test_batch_composes_with_dataset():
    batches = list(pt.batch(
        pt.reader.firstn(pt.dataset.uci_housing.train(), 10), 4)())
    assert [len(b) for b in batches] == [4, 4, 2]
    assert np.stack([x for x, _ in batches[0]]).shape == (4, 13)
    assert [len(b) for b in pt.batch(
        pt.reader.firstn(pt.dataset.uci_housing.train(), 10), 4,
        drop_last=True)()] == [4, 4]


# -- reader: the decorators (mirrors tests/test_sequence_reader.py) ----------

def test_reader_decorators_pipeline():
    r = pt.reader
    base = lambda: iter(range(10))                       # noqa: E731
    mapped = r.map_readers(lambda x: x * 2, base)
    assert list(mapped()) == [i * 2 for i in range(10)]
    assert sorted(r.shuffle(base, 4)()) == list(range(10))
    assert list(r.firstn(base, 3)()) == [0, 1, 2]
    assert list(r.chain(base, base)()) == list(range(10)) * 2
    batches = list(r.batch(base, 4)())
    assert batches[0] == [0, 1, 2, 3] and batches[-1] == [8, 9]
    assert list(r.batch(base, 4, drop_last=True)())[-1] == [4, 5, 6, 7]
    assert list(r.compose(base, mapped)())[3] == (3, 6)
    assert list(r.buffered(base, 2)()) == list(range(10))
    cached = r.cache(base)
    assert list(cached()) == list(range(10))
    assert list(cached()) == list(range(10))
    sq = r.xmap_readers(lambda x: x * x, base, 4, 8, order=True)
    assert list(sq()) == [i * i for i in range(10)]
    assert sorted(r.xmap_readers(lambda x: x + 1, base, 4, 8)()) == \
        list(range(1, 11))
    assert sorted(r.multiprocess_reader([base, base])()) == \
        sorted(list(range(10)) * 2)


def test_reader_compose_misaligned_raises():
    a = lambda: iter(range(3))                           # noqa: E731
    b = lambda: iter(range(5))                           # noqa: E731
    with pytest.raises(RuntimeError):
        list(pt.reader.compose(a, b)())
    assert list(pt.reader.compose(a, b, check_alignment=False)())[4] == \
        (None, 4)


def test_reader_shuffle_equals_reference_under_one_seed():
    base = lambda: iter(range(50))                       # noqa: E731
    random.seed(3)
    got = list(pt.reader.shuffle(base, 16)())
    random.seed(3)
    want = list(P.reader.shuffle(base, 16)())
    assert got == want and sorted(got) == list(range(50))


@pytest.mark.parametrize("deco", ["buffered", "xmap", "multiprocess"])
def test_reader_forwards_producer_errors(deco):
    def bad():
        yield 1
        raise ValueError("producer failed")
    r = pt.reader
    wrapped = {"buffered": lambda: r.buffered(bad, 2),
               "xmap": lambda: r.xmap_readers(lambda x: x / 0,
                                              lambda: iter(range(3)), 2, 4),
               "multiprocess": lambda: r.multiprocess_reader([bad])}[deco]()
    with pytest.raises((ValueError, ZeroDivisionError)):
        list(wrapped())


# -- hub ---------------------------------------------------------------------

def test_hub_local_repo(tmp_path):
    (tmp_path / "hubconf.py").write_text(textwrap.dedent("""
        import paddle_tpu_torch as paddle

        def tiny_mlp(hidden=4):
            \"\"\"A tiny MLP entrypoint.\"\"\"
            return paddle.nn.Sequential(
                paddle.nn.Linear(2, hidden), paddle.nn.ReLU(),
                paddle.nn.Linear(hidden, 1))

        def _private():
            pass
    """))
    names = pt.hub.list(str(tmp_path))
    assert "tiny_mlp" in names and "_private" not in names
    assert "tiny MLP" in pt.hub.help(str(tmp_path), "tiny_mlp")
    net = pt.hub.load(str(tmp_path), "tiny_mlp", hidden=8)
    out = net(pt.to_tensor(np.ones((3, 2), np.float32)))
    assert tuple(out.shape) == (3, 1)
    with pytest.raises(ValueError):
        pt.hub.load(str(tmp_path), "missing")


def test_hub_remote_sources_raise(tmp_path):
    with pytest.raises(RuntimeError):
        pt.hub.list("some/repo", source="github")
    with pytest.raises(FileNotFoundError):
        pt.hub.list(str(tmp_path))


# -- utils -------------------------------------------------------------------

def test_unique_name_generate_and_guard():
    from paddle_tpu_torch.utils import unique_name
    a = unique_name.generate("fc")
    b = unique_name.generate("fc")
    assert a != b and a.startswith("fc_")
    with unique_name.guard():
        assert unique_name.generate("fc") == "fc_0"
    assert unique_name.generate("fc") not in (a, b, "fc_0")
    with unique_name.guard("scope_"):
        assert unique_name.generate("w").startswith("scope_w_")


def test_run_check_on_the_cpu_where_asked(capsys):
    pt.utils.run_check(device="cpu")
    assert "successfully" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_run_check_defaults_to_the_card():
    """With no card, the default (the card) raises: no move to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.utils.run_check()


def test_deprecated_warns():
    @pt.utils.deprecated(update_to="paddle.new_api", since="2.0")
    def old_api(x):
        return x + 1

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert old_api(1) == 2
    assert any("deprecated" in str(x.message) for x in w)


def test_cpp_extension_load(tmp_path):
    from paddle_tpu_torch.utils import cpp_extension
    src = tmp_path / "myext.cc"
    src.write_text(
        'extern "C" int add_ints(int a, int b) { return a + b; }\n'
        'extern "C" double scale(double x) { return x * 2.5; }\n')
    lib = cpp_extension.load("myext", [str(src)],
                             build_directory=str(tmp_path))
    lib.add_ints.restype = ctypes.c_int
    lib.add_ints.argtypes = [ctypes.c_int, ctypes.c_int]
    assert lib.add_ints(2, 40) == 42
    lib.scale.restype = ctypes.c_double
    lib.scale.argtypes = [ctypes.c_double]
    assert lib.scale(2.0) == 5.0
    mtime = os.path.getmtime(tmp_path / "myext.so")
    assert cpp_extension.load("myext", [str(src)],
                              build_directory=str(tmp_path)) is not None
    assert os.path.getmtime(tmp_path / "myext.so") == mtime   # cached
    libs = cpp_extension.setup(name="viasetup", ext_modules=[
        cpp_extension.CppExtension([str(src)], build_directory=str(
            tmp_path))])
    assert libs[0].add_ints(1, 2) == 3


def test_cpp_extension_build_error(tmp_path):
    from paddle_tpu_torch.utils import cpp_extension
    src = tmp_path / "bad.cc"
    src.write_text("this is not C++")
    with pytest.raises(RuntimeError):
        cpp_extension.load("bad", [str(src)], build_directory=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        cpp_extension.load("gone", [str(tmp_path / "gone.cc")],
                           build_directory=str(tmp_path))


def test_flops_matches_reference():
    """``flops`` reads the port's Linear and conv attributes, which have
    the reference's names."""
    def net(lib):
        return lib.nn.Sequential(lib.nn.Conv2D(3, 8, 3, groups=1),
                                 lib.nn.Conv2D(8, 8, 3, groups=4),
                                 lib.nn.Flatten(), lib.nn.Linear(32, 10))
    got = pt.flops(net(pt), [1, 3, 8, 8])
    assert got == P.flops(net(P), [1, 3, 8, 8]) > 0
    assert pt.utils.flops is pt.flops


def test_try_import_and_require_version():
    assert pt.utils.try_import("json").dumps([1]) == "[1]"
    with pytest.raises(ImportError, match="needed here"):
        pt.utils.try_import("no_such_module_xyz", "needed here")
    assert pt.utils.require_version("1.8", "2.1")
    assert pt.utils.require_version("2.0.0")
    with pytest.raises(Exception, match="required"):
        pt.utils.require_version("2.1")
    with pytest.raises(Exception, match="allowed"):
        pt.utils.require_version("1.0", "1.9")


def test_only_the_network_names_stay_unported():
    assert sorted(pt.utils.NOT_PORTED) == ["download",
                                           "get_weights_path_from_url"]
    with pytest.raises(NotImplementedError, match="network"):
        pt.utils.get_weights_path_from_url("http://example.invalid/w")


# -- compat, version, sysconfig, the top level -------------------------------

def test_compat_matches_reference():
    for fn, args in (("to_text", (b"abc",)), ("to_text", ([b"a", "b"],)),
                     ("to_bytes", ("abc",)), ("to_bytes", ({"a"},)),
                     ("floor_division", (7, 2)), ("round", (2.5,)),
                     ("round", (-2.5,)), ("round", (1.234, 2)),
                     ("get_exception_message", (ValueError("m"),))):
        assert getattr(pt.compat, fn)(*args) == getattr(P.compat, fn)(*args)
    lst = [b"x"]
    assert pt.compat.to_text(lst, inplace=True) is lst and lst == ["x"]
    assert pt.compat.long_type is int


def test_version_and_sysconfig():
    assert pt.__version__ == P.__version__ == pt.version.full_version
    assert pt.version.mkl() == P.version.mkl()
    assert os.path.isfile(os.path.join(pt.sysconfig.get_include(),
                                       "hopper.cuh"))
    assert pt.sysconfig.get_lib().startswith(
        os.path.dirname(pt.__file__))


def test_top_level_exports_match_reference():
    """``paddle_tpu/__init__.py:62-123``'s host-side names: the modules,
    ``flops`` and ``batch`` (the module-level def, as there)."""
    for n in ("text", "reader", "quantization", "dataset", "hub", "compat",
              "sysconfig", "version", "flops", "batch"):
        assert hasattr(P, n) and hasattr(pt, n), n
    assert pt.batch is not pt.reader.batch
    assert pt.batch.__module__ == "paddle_tpu_torch"
    for n in ("FullTokenizer", "WordpieceTokenizer", "load_vocab",
              "viterbi_decode", "ViterbiDecoder", "UCIHousing", "Imdb",
              "Imikolov", "Movielens", "Conll05st", "WMT14", "WMT16"):
        assert hasattr(pt.text, n), n
    for n in P.quantization.__all__ + ["AbsmaxObserver"]:
        assert hasattr(pt.quantization, n), n
    for n in P.reader.__all__:
        assert hasattr(pt.reader, n), n
