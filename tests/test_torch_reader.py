"""The port's reader path against the JAX package, on the CPU: fluid's
``py_reader`` family over the static Executor (the reference's
``tests/test_py_reader.py`` ``TestPyReader``) and the MultiSlot data
plumbing with ``train_from_dataset`` / ``infer_from_dataset``
(``tests/test_ps_compat.py``).

Both packages build the same program, take the same weights (the
reference's, as numpy, in creation order) and read the same batches;
fetches and parameters agree at 1e-5.  The reference reads through its
queue (``use_double_buffer=False``), so that these tests never build its
native ring; the port reads through both the queue and its ring.
"""
import os
import time

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu.distributed as JD
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as TD
from paddle_tpu import fluid as JFL
from paddle_tpu import static as JS
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch import fluid as TFL
from paddle_tpu_torch import static as TS
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.framework import core

PKGS = {"ref": (P, JS, JFL), "port": (pt, TS, TFL)}


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    P.seed(5)
    pt.seed(5)
    try:
        yield
    finally:
        P.disable_static()
        pt.disable_static()
        core._state.expected_place = prev


def _same_weights(jm, tm):
    for a, b in zip(jm.all_parameters(), tm.all_parameters()):
        assert list(a.shape) == list(b.shape)
        b.set_value(np.asarray(a.numpy()))


def _batches(n=5, bs=4, seed=0):
    """A batched sample reader: lists of (x [2, 4] flat, label [1])."""
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield [(rng.rand(8).astype("float32"),
                    np.array([rng.randint(3)], "int64")) for _ in range(bs)]
    return reader


def _mlp_program(key, double_buffer):
    """py_reader(x [-1, 2, 4], label [-1, 1]) -> fc(3) -> softmax cross
    entropy -> mean; SGD(0.1)."""
    mod, S, FL = PKGS[key]
    mod.enable_static()
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        rd = FL.layers.py_reader(capacity=4, shapes=[(-1, 2, 4), (-1, 1)],
                                 dtypes=["float32", "int64"],
                                 use_double_buffer=double_buffer)
        x, lbl = FL.layers.read_file(rd)
        logits = S.nn.fc(mod.reshape(x, [-1, 8]), 3)
        loss = mod.nn.functional.cross_entropy(logits, lbl).mean()
        mod.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return mod, main, startup, rd, loss


def _classic_loop(mod, FL, exe, main, rd, loss, passes=2):
    out = []
    for _ in range(passes):
        rd.start()
        losses = []
        try:
            while True:
                lv, = exe.run(main, fetch_list=[loss])
                losses.append(float(lv))
        except FL.core.EOFException:
            rd.reset()
        out.append(losses)
    return out


@pytest.mark.parametrize("double_buffer", [False, True],
                         ids=["queue", "ring"])
def test_classic_loop_matches_reference(double_buffer):
    """start() / run until EOFException / reset(), two passes of five
    batches: the losses (SGD trains between them) equal the reference's."""
    got = {}
    progs = {k: _mlp_program(k, double_buffer and k == "port")
             for k in PKGS}
    _same_weights(progs["ref"][1], progs["port"][1])
    for key, (mod, main, startup, rd, loss) in progs.items():
        rd.decorate_paddle_reader(_batches())
        exe = PKGS[key][1].Executor()
        exe.run(startup)
        got[key] = _classic_loop(mod, PKGS[key][2], exe, main, rd, loss)
        if key == "port":
            assert (rd._pass is None) and not rd._started
    assert [len(p) for p in got["port"]] == [5, 5]
    np.testing.assert_allclose(got["port"], got["ref"], rtol=1e-5)


def test_ring_stages_the_batches():
    """With the double buffer on, a pass's batches go through the native
    ring (``runtime.DataRing``)."""
    from paddle_tpu_torch import runtime
    assert runtime.is_available()
    mod, main, startup, rd, loss = _mlp_program("port", True)
    rd.decorate_paddle_reader(_batches(n=3))
    exe = TS.Executor()
    rd.start()
    ring = rd._pass.ring
    assert ring is not None
    n = 0
    with pytest.raises(TFL.core.EOFException):
        while True:
            exe.run(main, fetch_list=[loss])
            n += 1
    rd.reset()
    assert n == 3
    assert ring._h == 0             # destroyed at the end of the pass


def _sum_program(key, shapes, dtypes, double_buffer=False):
    mod, S, FL = PKGS[key]
    mod.enable_static()
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        rd = FL.layers.py_reader(capacity=4, shapes=shapes, dtypes=dtypes,
                                 use_double_buffer=double_buffer)
        vs = FL.layers.read_file(rd)
        vs = vs if isinstance(vs, list) else [vs]
        out = sum(mod.sum(mod.cast(v, "float32")) for v in vs)
    return main, rd, out


def _drain(key, main, rd, out):
    S, FL = PKGS[key][1], PKGS[key][2]
    exe = S.Executor()
    rd.start()
    vals = []
    try:
        while True:
            v, = exe.run(main, fetch_list=[out])
            vals.append(float(v))
    except FL.core.EOFException:
        rd.reset()
    return vals


@pytest.mark.parametrize("case", ["sample_reshape", "tensor_provider"])
def test_sources_match_reference(case):
    """A flat sample field reshaped to its slot's shape; a batch
    provider through ``double_buffer``."""
    got = {}
    for key in PKGS:
        if case == "sample_reshape":
            main, rd, out = _sum_program(key, [(-1, 2, 3)], ["float32"])
            rd.decorate_paddle_reader(
                lambda: iter([[(np.arange(6, dtype="float32"),)]]))
        else:
            main, rd, out = _sum_program(key, [(-1, 3), (-1, 1)],
                                         ["float32", "int64"])
            rd = PKGS[key][2].layers.double_buffer(rd) if key == "port" \
                else rd
            assert rd.use_double_buffer or key == "ref"
            rd.decorate_tensor_provider(lambda: (
                (np.full((2, 3), i, "float32"), np.full((2, 1), i, "int64"))
                for i in range(3)))
        got[key] = _drain(key, main, rd, out)
    assert got["port"] == got["ref"]
    assert got["port"] == ([15.0] if case == "sample_reshape"
                           else [0.0, 8.0, 16.0])


def test_reader_by_data_keeps_declared_unknown_dims():
    """``create_py_reader_by_data`` over data variables: their names are
    the slots, and a -1 sample dim keeps each sample's real size."""
    got = {}
    for key, (mod, S, FL) in PKGS.items():
        mod.enable_static()
        main, startup = S.Program(), S.Program()
        with S.program_guard(main, startup):
            seq = S.data("seq_byd", [None, -1, 8], "float32")
            lbl = S.data("lbl_byd", [None, 1], "int64")
            rd = FL.layers.create_py_reader_by_data(
                capacity=2, feed_list=[seq, lbl], use_double_buffer=False)
            assert [t.name for t in FL.layers.read_file(rd)] == \
                ["seq_byd", "lbl_byd"]
            out = mod.sum(seq) + mod.sum(mod.cast(lbl, "float32"))
        rd.decorate_paddle_reader(lambda: iter(
            [[(np.ones((5, 8), "float32"), np.array([7], "int64"))]]))
        got[key] = _drain(key, main, rd, out)
    assert got["port"] == got["ref"] == [47.0]


def test_ownership_is_scoped_per_program():
    """Two programs each declare ``shared_img`` with a reader of its own:
    each run reads its own program's reader."""
    vals = {}
    for key, (mod, S, FL) in PKGS.items():
        mod.enable_static()
        readers, progs, outs = [], [], []
        for fill in (1.0, 2.0):
            main, startup = S.Program(), S.Program()
            with S.program_guard(main, startup):
                v = S.data("shared_img", [None, 2], "float32")
                rd = FL.layers.create_py_reader_by_data(
                    capacity=2, feed_list=[v], use_double_buffer=False)
                rd.decorate_batch_generator(lambda fill=fill: iter(
                    [(np.full((1, 2), fill, "float32"),)]))
                outs.append(mod.sum(v))
            progs.append(main)
            readers.append(rd)
        exe = S.Executor()
        for rd in readers:
            rd.start()
        vals[key] = [float(exe.run(p, fetch_list=[o])[0])
                     for p, o in zip(progs, outs)]
        for rd in readers:
            rd.reset()
    assert vals["port"] == vals["ref"] == [2.0, 4.0]


def _late_crash():
    yield (np.ones((1, 2), "float32"),)
    time.sleep(0.3)                 # the consumer blocks on the queue
    raise ValueError("late source crash")


def _early_crash():
    raise RuntimeError("boom in source")
    yield                           # pragma: no cover


@pytest.mark.parametrize("case", ["not_started", "partial_feed",
                                  "late_error", "early_error"])
@pytest.mark.parametrize("double_buffer", [False, True],
                         ids=["queue", "ring"])
def test_reader_errors_match_reference(case, double_buffer):
    """Each fault raises in the port as in the reference: a reader not
    started, some of a started reader's slots fed by hand, a source's
    error after a batch (it beats the end of the pass) and before any."""
    for key, (mod, S, FL) in PKGS.items():
        main, rd, out = _sum_program(
            key, [(-1, 2), (-1, 1)], ["float32", "float32"],
            double_buffer=double_buffer and key == "port")
        src = {"late_error": _late_crash, "early_error": _early_crash}.get(
            case, lambda: iter([(np.ones((1, 2), "float32"),
                                 np.ones((1, 1), "float32"))]))
        if case in ("late_error", "early_error"):
            # one slot, as the reference's tests give it
            main, rd, out = _sum_program(
                key, [(-1, 2)], ["float32"],
                double_buffer=double_buffer and key == "port")
        rd.decorate_batch_generator(src)
        exe = S.Executor()
        if case == "not_started":
            with pytest.raises(RuntimeError, match="not started"):
                exe.run(main, fetch_list=[out])
            continue
        rd.start()
        if case == "partial_feed":
            with pytest.raises(RuntimeError, match="feed all"):
                exe.run(main, feed={rd._slots[0].name:
                                    np.zeros((1, 2), "float32")},
                        fetch_list=[out])
        elif case == "late_error":
            assert float(exe.run(main, fetch_list=[out])[0]) == 2.0
            with pytest.raises(ValueError, match="late source crash"):
                exe.run(main, fetch_list=[out])
        else:
            time.sleep(0.2)
            with pytest.raises(RuntimeError, match="boom in source"):
                exe.run(main, fetch_list=[out])
        rd.reset()


# --------------------------------------------------------------------------
# the MultiSlot data plumbing (ps_compat) and train_from_dataset
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["ref", "port"])
def test_entry_attrs(key):
    D = JD if key == "ref" else TD
    assert D.ProbabilityEntry(0.5)._to_attr() == "probability_entry:0.5"
    assert D.CountFilterEntry(10)._to_attr() == "count_filter_entry:10"
    for bad in (lambda: D.ProbabilityEntry(1.5),
                lambda: D.CountFilterEntry(-1)):
        with pytest.raises(ValueError):
            bad()


def test_multislot_generators_match_reference(capsys):
    """The MultiSlot protocol line by line, the proto's slot kinds, the
    string generator and ``run_from_memory``'s output."""
    outs = {}
    for key, fleet in (("ref", jfleet), ("port", tfleet)):
        g = fleet.MultiSlotDataGenerator()
        lines = [g._gen_str([("words", [1926, 8, 17]), ("label", [1])])]
        proto = [list(g._proto_info)]
        lines.append(g._gen_str([("words", [1.5, 2.0, 3.0]), ("label", [0])]))
        proto.append(list(g._proto_info))
        with pytest.raises(ValueError):
            g._gen_str([("words", [1])])
        s = fleet.MultiSlotStringDataGenerator()._gen_str(
            [("w", ["a", "b"]), ("l", ["1"])])

        class G(fleet.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def it():
                    for i in range(3):
                        yield [("ids", [i, i + 1]), ("label", [i % 2])]
                return it
        capsys.readouterr()
        G().run_from_memory()
        outs[key] = (lines, proto, s, capsys.readouterr().out)
    assert outs["port"] == outs["ref"]
    assert outs["port"][0][0] == "3 1926 8 17 1 1\n"
    assert outs["port"][3].splitlines() == ["2 0 1 1 0", "2 1 2 1 1",
                                            "2 2 3 1 0"]


def _slot_vars(key):
    mod, S, _ = PKGS[key]
    mod.enable_static()
    main = S.Program()
    with S.program_guard(main, S.Program()):
        ids = S.data("ds_ids", [None, -1], "int64")
        lbl = S.data("ds_label", [None, 1], "int64")
    return ids, lbl


def _protocol_file(path, rows):
    with open(path, "w") as f:
        for ids, label in rows:
            f.write(f"{len(ids)} {' '.join(map(str, ids))} 1 {label}\n")
    return path


@pytest.mark.parametrize("case", ["in_memory", "queue_pipe", "trailing"])
def test_datasets_match_reference(tmp_path, case):
    """``InMemoryDataset`` (load, seeded shuffle, padded batches,
    release), ``QueueDataset`` through a pipe command, and a line with
    trailing tokens rejected: the port's batches equal the reference's."""
    got = {}
    for key in PKGS:
        D = JD if key == "ref" else TD
        ids, lbl = _slot_vars(key)
        if case == "queue_pipe":
            raw = str(tmp_path / "raw.txt")
            with open(raw, "w") as f:
                f.write("7 8\n9 10\n")
            ds = D.QueueDataset()
            ds.init(batch_size=1, use_var=[ids, lbl],
                    pipe_command="awk '{print 2, $1, $2, 1, 0}'")
            ds.set_filelist([raw])
        else:
            ds = D.InMemoryDataset()
            ds.init(batch_size=2, use_var=[ids, lbl])
            rows = ([([5], 0)] if case == "trailing" else
                    [([1, 2], 0), ([3], 1), ([4, 5, 6], 0)])
            p = _protocol_file(str(tmp_path / f"{key}.txt"), rows)
            if case == "trailing":
                with open(p, "a") as f:
                    f.write("1 5 1 0 99 99\n")
                ds.set_filelist([p])
                with pytest.raises(ValueError, match="trailing"):
                    ds.load_into_memory()
                continue
            ds.set_filelist([p])
            ds.load_into_memory()
            assert ds.get_memory_data_size() == 3
            ds._seed = 0
            ds.local_shuffle()
        got[key] = list(ds.iter_batches())
        if case == "in_memory":
            ds.release_memory()
            assert ds.get_memory_data_size() == 0
    for a, b in zip(got.get("port", []), got.get("ref", [])):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    if case == "queue_pipe":
        np.testing.assert_array_equal(got["port"][0]["ds_ids"], [[7, 8]])


def _regression_program(key, tmp_path, lr):
    mod, S, _ = PKGS[key]
    D = JD if key == "ref" else TD
    mod.enable_static()
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        x = S.data("tfd_x", [None, 2], "float32")
        y = S.data("tfd_y", [None, 1], "float32")
        loss = mod.mean(mod.square(S.nn.fc(x, 1) - y))
        mod.optimizer.SGD(learning_rate=lr).minimize(loss)
    ds = D.InMemoryDataset()
    ds.init(batch_size=2, use_var=[x, y])
    p = str(tmp_path / "train.txt")
    rng = np.random.RandomState(2)
    with open(p, "w") as f:
        for a, b, c in rng.randn(8, 3).round(3):
            f.write(f"2 {a} {b} 1 {c}\n")
    ds.set_filelist([p])
    ds.load_into_memory()
    return main, loss, ds


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_train_and_infer_from_dataset_match_reference(tmp_path, mode,
                                                      capsys):
    """``train_from_dataset`` over four batches: the parameters after it
    and the printed fetches equal the reference's; ``infer_from_dataset``
    leaves them bitwise as they were and keeps the program's
    ``train_spec``."""
    progs = {k: _regression_program(k, tmp_path, 0.1) for k in PKGS}
    _same_weights(progs["ref"][0], progs["port"][0])
    after, printed = {}, {}
    for key, (main, loss, ds) in progs.items():
        exe = PKGS[key][1].Executor()
        w0 = [np.asarray(p.numpy()).copy() for p in main.all_parameters()]
        capsys.readouterr()
        run = (exe.train_from_dataset if mode == "train"
               else exe.infer_from_dataset)
        run(main, ds, fetch_list=[loss], fetch_info=["loss"],
            print_period=2)
        printed[key] = capsys.readouterr().out
        after[key] = [np.asarray(p.numpy()) for p in main.all_parameters()]
        if mode == "infer":
            for a, b in zip(w0, after[key]):
                np.testing.assert_array_equal(a, b)
            assert main.train_spec is not None
        else:
            assert not np.allclose(w0[0], after[key][0])
    for a, b in zip(after["port"], after["ref"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert printed["port"].count("step ") == 2
    for a, b in zip(printed["port"].split(), printed["ref"].split()):
        if "[" in a:
            np.testing.assert_allclose(float(a.split("[")[1].strip("]")),
                                       float(b.split("[")[1].strip("]")),
                                       rtol=1e-5)
        else:
            assert a == b


def test_dataset_factory_and_facade():
    """``fluid.DatasetFactory`` makes the port's datasets; a fluid name
    the port has not brought over raises, naming its item."""
    f = TFL.DatasetFactory()
    assert isinstance(f.create_dataset("InMemoryDataset"),
                      TD.InMemoryDataset)
    assert isinstance(f.create_dataset(), TD.QueueDataset)
    with pytest.raises(ValueError):
        f.create_dataset("Nope")
    with pytest.raises(NotImplementedError, match="item 4"):
        TFL.layers.fc
    assert TFL.core.EOFException is TFL.reader_compat.EOFException
    assert TFL.io.PyReader is TFL.reader_compat.PyReader
    assert os.path.basename(TFL.reader_compat.__file__) == \
        "reader_compat.py"
