"""The port's ``io`` and ``runtime`` against the JAX package, on the CPU.

``paddle_tpu_torch.io`` against ``paddle_tpu.io``: the datasets and
samplers (the same indices under one numpy seed or generator), the
``DataLoader`` in its four modes (one thread, worker threads, worker
threads through the native ring, workers over an ``IterableDataset``)
yielding the reference loader's batches exactly, the resumable position,
``save`` / ``load`` files read by both packages, and the counterparts of
``tests/test_hapi_io.py``'s loader and sampler tests.  Also: the ring's
slab is never read after its release (a consumer that holds every
batch), ``use_native_ring=True`` without a compiler raises, and every
wait ends within seconds.  The port's ring is built by ``g++`` into
``paddle_tpu_torch/_build/``; the reference's ring is never built here.
"""
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch import runtime
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.io import dataloader as TDL

MODES = {
    "single": dict(num_workers=0),
    "threaded": dict(num_workers=3, use_native_ring=False),
    "native": dict(num_workers=3, use_native_ring=True),
    "native_prefetch": dict(num_workers=2, use_native_ring=True,
                            prefetch_to_device=2),
}


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


def _ds(mod, n=50, seed=0):
    """A map-style dataset of (float32 [3], int64 label, dict) samples."""
    class D(mod.io.Dataset):
        def __init__(self):
            rng = np.random.RandomState(seed)
            self.x = rng.randn(n, 3).astype(np.float32)
            self.y = rng.randint(0, 7, n).astype(np.int64)

        def __len__(self):
            return n

        def __getitem__(self, i):
            return self.x[i], self.y[i], {"i": np.int64(i)}
    return D()


def _np(tree):
    """A batch tree with every Tensor leaf read to numpy."""
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.numpy()) if hasattr(tree, "numpy") else tree


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert type(g) is type(w)
        if isinstance(g, dict):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype
        else:
            for a, b in zip(g, w):
                if isinstance(a, dict):
                    a, b = a["i"], b["i"]
                np.testing.assert_array_equal(a, b)
                assert np.asarray(a).dtype == np.asarray(b).dtype


# --------------------------------------------------------------------------
# the loader against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_loader_batches_equal_reference(mode):
    """Shuffled epochs under one numpy seed: the same batches in the same
    order, values and dtypes exactly equal (int64 narrowed to int32 as the
    reference narrows it), two epochs in a row."""
    kw = MODES[mode]
    ref_kw = {k: v for k, v in kw.items()
              if k not in ("use_native_ring", "prefetch_to_device")}
    if ref_kw.get("num_workers"):
        # threads: the reference's own ring is never built here
        ref_kw["use_native_ring"] = False
    np.random.seed(11)
    ref = P.io.DataLoader(_ds(P), batch_size=8, shuffle=True, **ref_kw)
    want = [list(ref), list(ref)]
    np.random.seed(11)
    port = pt.io.DataLoader(_ds(pt), batch_size=8, shuffle=True, **kw)
    got = [list(port), list(port)]
    for g, w in zip(got, want):
        _assert_same(g, w)
    for batch in got[0]:
        assert batch[0].place == core.CPUPlace()
        assert batch[1].dtype == torch.int32


@pytest.mark.parametrize("mode", ["single", "threaded", "native"])
def test_resume_mid_epoch_equals_reference(mode):
    """A state_dict taken after 3 batches, restored into a new loader,
    yields the reference's remaining batches (and the same position)."""
    kw = MODES[mode]

    def rest(mod, loader_kw):
        np.random.seed(5)
        a = mod.io.DataLoader(_ds(mod), batch_size=6, shuffle=True,
                              **loader_kw)
        it = iter(a)
        for _ in range(3):
            next(it)
        state = a.state_dict()
        np.random.seed(99)          # the restored state rewinds the RNG
        b = mod.io.DataLoader(_ds(mod), batch_size=6, shuffle=True,
                              **loader_kw)
        b.set_state_dict(state)
        assert b.state_dict()["batch_index"] == 3
        return state, list(b)

    ref_state, want = rest(P, {})
    state, got = rest(pt, kw)
    assert (state["epoch"], state["batch_index"]) == (
        ref_state["epoch"], ref_state["batch_index"])
    _assert_same(got, want)


def test_iterable_workers_shard_like_reference():
    """Workers over an IterableDataset that shards by get_worker_info: the
    same multiset of batches as the reference's (the interleaving of two
    workers is not deterministic), and the single-thread mode in order."""
    def make(mod):
        class Stream(mod.io.IterableDataset):
            def __iter__(self):
                info = mod.io.get_worker_info()
                wid, nw = (0, 1) if info is None else (info.id,
                                                       info.num_workers)
                for i in range(wid, 23, nw):
                    yield np.float32(i), np.int64(i % 3)
        return Stream()

    for kw in ({}, {"num_workers": 2}):
        want = [tuple(_np(b)) for b in
                P.io.DataLoader(make(P), batch_size=4, **kw)]
        got = [tuple(_np(b)) for b in
               pt.io.DataLoader(make(pt), batch_size=4, **kw)]
        key = lambda b: tuple(b[0].tolist())               # noqa: E731
        if kw:
            want, got = sorted(want, key=key), sorted(got, key=key)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_loader_hands_batches_to_the_default_place_only():
    """Workers collate on the host; the consumer gets the default place.
    A collate_fn that makes Tensors in a worker makes them on the CPU even
    when the consumer's place is the card (the workers' own place)."""
    places = []

    def collate(samples):
        places.append(core.get_place())
        return pt.to_tensor(np.stack([s[0] for s in samples]))

    loader = pt.io.DataLoader(_ds(pt, 12), batch_size=4, num_workers=2,
                              use_native_ring=False, collate_fn=collate)
    out = list(loader)
    assert places and all(p == core.CPUPlace() for p in places)
    assert all(b.place == core.CPUPlace() for b in out)
    with pytest.raises(TypeError):          # pinned to numeric leaves
        list(pt.io.DataLoader([np.array(["a"])] * 4, batch_size=2,
                              num_workers=1, use_native_ring=True,
                              collate_fn=lambda s: np.stack(s)))


def test_prefetch_counts_every_batch():
    TDL.reset_prefetch_stats()
    n = len(list(pt.io.DataLoader(_ds(pt, 20), batch_size=4,
                                  prefetch_to_device=True)))
    s = pt.io.prefetch_stats()
    assert n == 5 and s["batches"] == s["puts"] == 5
    assert s["hits"] + s["misses"] == 5 and s["hit_ratio"] == 1.0


# --------------------------------------------------------------------------
# the native ring
# --------------------------------------------------------------------------

def test_ring_slab_never_read_after_release():
    """Capacity 2 (one worker, prefetch factor 2): slabs are recycled
    every other pop.  A consumer that holds every batch must see each
    batch as it was produced, after the whole epoch."""
    class Distinct(pt.io.Dataset):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return np.full((257,), i, np.float32), np.int64(i)

    loader = pt.io.DataLoader(Distinct(), batch_size=4, num_workers=1,
                              prefetch_factor=2, use_native_ring=True)
    held = list(loader)
    assert len(held) == 16
    for b, (x, y) in enumerate(held):
        idx = np.arange(4 * b, 4 * b + 4)
        np.testing.assert_array_equal(x.numpy(),
                                      np.repeat(idx, 257).reshape(4, 257))
        np.testing.assert_array_equal(y.numpy(), idx)


def test_ring_and_pool_round_trip():
    ring = runtime.DataRing(capacity=2)
    a = np.arange(10, dtype=np.int32)
    b = np.ones((2, 3), np.float64)
    assert ring.push([a, b], 7) == 0
    views, tag = ring.pop()
    assert tag == 7
    np.testing.assert_array_equal(views[0], a)
    np.testing.assert_array_equal(views[1], b)
    with pytest.raises(TimeoutError):
        ring.pop(timeout_ms=10)
    ring.close()
    assert ring.pop() is None
    ring.destroy()
    pool = runtime.HostMemoryPool()
    p = pool.alloc(1000)
    assert pool.stats()["in_use"] >= 1000
    pool.free(p)
    assert pool.stats()["in_use"] == 0
    pool.close()
    assert runtime.is_prebuilt()


def test_native_ring_without_compiler_raises(monkeypatch, tmp_path):
    """use_native_ring=True with no compiler raises; it never runs
    threaded instead.  use_native_ring=None takes threads then, and never
    compiles."""
    from paddle_tpu_torch.runtime import build
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_lib_err", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "compilers", lambda: [str(tmp_path / "cxx")])
    assert not runtime.is_prebuilt()
    auto = pt.io.DataLoader(_ds(pt, 8), batch_size=4, num_workers=1)
    assert len(list(auto)) == 2
    assert not (tmp_path / "_build").exists()
    loader = pt.io.DataLoader(_ds(pt, 8), batch_size=4, num_workers=1,
                              use_native_ring=True)
    with pytest.raises(RuntimeError, match="native runtime|compiler"):
        list(loader)
    assert not runtime.is_available()


def test_build_names_library_by_digest_and_renames_atomically(tmp_path,
                                                              monkeypatch):
    """Each build writes a per-process temporary and renames it; the name
    carries a digest of the source and flags."""
    from paddle_tpu_torch.runtime import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    path = build.lib_path()
    assert path.parent == tmp_path
    assert path.name.startswith("libptpu_runtime-") and path.suffix == ".so"
    monkeypatch.setattr(build, "FLAGS", build.FLAGS + ("-DPTPU_X=1",))
    assert build.lib_path() != path
    # builds racing in threads each rename a complete library into place
    errs = []

    def one():
        try:
            build.build()
        except Exception as e:                             # noqa: BLE001
            errs.append(e)
    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and build.lib_path().exists()
    assert not list(tmp_path.glob("*.tmp"))


# --------------------------------------------------------------------------
# samplers and datasets
# --------------------------------------------------------------------------

def test_distributed_sampler_equals_reference():
    """3 replicas, shuffled over two epochs (set_epoch), and the defaults
    without torch.distributed (one replica, rank 0)."""
    for shuffle, drop_last in ((True, False), (False, True)):
        for rank in range(3):
            want = P.io.DistributedBatchSampler(
                _ds(P, 31), 4, num_replicas=3, rank=rank, shuffle=shuffle,
                drop_last=drop_last)
            got = pt.io.DistributedBatchSampler(
                _ds(pt, 31), 4, num_replicas=3, rank=rank, shuffle=shuffle,
                drop_last=drop_last)
            for epoch in range(2):
                want.set_epoch(epoch)
                got.set_epoch(epoch)
                assert list(got) == list(want)
            assert len(got) == len(want)
    s = pt.io.DistributedBatchSampler(_ds(pt, 10), 4)
    assert (s.nranks, s.local_rank) == (1, 0)


def test_random_split_and_weighted_sampler_equal_reference():
    for gen in (7, np.random.RandomState(3)):
        g2 = (gen if isinstance(gen, int)
              else np.random.RandomState(3))
        want = P.io.random_split(_ds(P, 30), [20, 10], generator=g2)
        got = pt.io.random_split(_ds(pt, 30), [20, 10], generator=gen)
        assert [s.indices for s in got] == [s.indices for s in want]
    w = [0.1, 0.5, 0.0, 2.0, 1.0]
    np.random.seed(4)
    want = list(P.io.WeightedRandomSampler(w, 12, replacement=True))
    np.random.seed(4)
    got = list(pt.io.WeightedRandomSampler(w, 12, replacement=True))
    assert got == want
    np.random.seed(8)
    want = list(P.io.RandomSampler(_ds(P, 9), replacement=True,
                                   num_samples=20))
    np.random.seed(8)
    got = list(pt.io.RandomSampler(_ds(pt, 9), replacement=True,
                                   num_samples=20))
    assert got == want


def test_tensor_dataset_and_samplers():
    """Counterpart of test_hapi_io.py::test_tensor_dataset_and_samplers."""
    x = pt.to_tensor(np.arange(20, dtype=np.float32).reshape(10, 2))
    y = pt.to_tensor(np.arange(10, dtype=np.int64))
    ds = pt.io.TensorDataset([x, y])
    assert len(ds) == 10
    xi, yi = ds[3]
    np.testing.assert_allclose(np.asarray(xi.numpy()), [6.0, 7.0])
    assert list(pt.io.SequenceSampler(ds)) == list(range(10))
    np.random.seed(2)
    rs = list(pt.io.RandomSampler(ds))
    np.random.seed(2)
    assert rs == list(P.io.RandomSampler(ds))
    assert sorted(rs) == list(range(10))
    ws = list(pt.io.WeightedRandomSampler(
        np.asarray([0.0, 0.0, 1.0, 0.0]), num_samples=8, replacement=True))
    assert ws == [2] * 8
    bs = pt.io.BatchSampler(ds, batch_size=4, drop_last=False)
    assert [len(b) for b in bs] == [4, 4, 2] and len(bs) == 3
    # the default collate stacks Tensor samples where they are
    b = next(iter(pt.io.DataLoader(ds, batch_size=4)))
    np.testing.assert_array_equal(b[0].numpy(), x.numpy()[:4])


def test_distributed_batch_sampler_partitions():
    """Counterpart of test_hapi_io.py::test_distributed_batch_sampler_
    partitions."""
    shards = []
    for rank in range(4):
        s = pt.io.DistributedBatchSampler(_ds(pt, 100), batch_size=5,
                                          num_replicas=4, rank=rank)
        idxs = [i for batch in s for i in batch]
        assert idxs == [i for batch in P.io.DistributedBatchSampler(
            _ds(P, 100), batch_size=5, num_replicas=4, rank=rank)
            for i in batch]
        shards.append(set(idxs))
        assert len(idxs) == 25
    assert set.union(*shards) == set(range(100))


def test_distributed_sampler_tiles_tiny_dataset():
    """Counterpart of TestLoaderContractArgs::test_distributed_sampler_
    tiles_tiny_dataset."""
    counts = []
    for rank in range(8):
        s = pt.io.DistributedBatchSampler(list(range(3)), batch_size=1,
                                          num_replicas=8, rank=rank)
        counts.append(sum(len(b) for b in s))
    assert len(set(counts)) == 1 and counts[0] == 1, counts


def test_subset_random_split_concat_chain():
    """Counterpart of test_hapi_io.py::test_subset_random_split_concat_
    chain, against the reference's values."""
    base, ref = _ds(pt, 30), _ds(P, 30)
    sub = pt.io.Subset(base, [1, 3, 5])
    assert len(sub) == 3
    np.testing.assert_allclose(sub[1][0], base[3][0])
    np.random.seed(1)
    a, b = pt.io.random_split(base, [20, 10])
    np.random.seed(1)
    ra, rb = P.io.random_split(ref, [20, 10])
    assert (a.indices, b.indices) == (ra.indices, rb.indices)
    cat = pt.io.ConcatDataset([pt.io.Subset(base, [0, 1]),
                               pt.io.Subset(base, [2])])
    assert len(cat) == 3
    np.testing.assert_allclose(cat[2][0], base[2][0])
    np.testing.assert_allclose(cat[-1][0], base[2][0])

    class It(pt.io.IterableDataset):
        def __init__(self, vals):
            self.vals = vals

        def __iter__(self):
            return iter(self.vals)

    assert list(pt.io.ChainDataset([It([1, 2]), It([3])])) == [1, 2, 3]
    comp = pt.io.ComposeDataset([base, base])
    assert len(comp[0]) == 6


def test_iterable_dataset_loader_batches():
    """Counterpart of test_hapi_io.py::test_iterable_dataset_loader_
    batches."""
    def stream(mod):
        class Stream(mod.io.IterableDataset):
            def __iter__(self):
                for i in range(7):
                    yield np.float32(i)
        return Stream()
    out = [b.numpy() for b in pt.io.DataLoader(stream(pt), batch_size=3)]
    want = [np.asarray(b.numpy()) for b in
            P.io.DataLoader(stream(P), batch_size=3)]
    assert [len(o) for o in out] == [3, 3, 1]
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o, w)


def test_dataloader_threaded_order_preserved():
    """Counterpart of test_hapi_io.py::test_dataloader_threaded_order_
    preserved, with the ring too."""
    single = [x.numpy() for x, _, _ in
              pt.io.DataLoader(_ds(pt, 64), batch_size=8, num_workers=0)]
    for ring in (False, True):
        threaded = [x.numpy() for x, _, _ in
                    pt.io.DataLoader(_ds(pt, 64), batch_size=8,
                                     num_workers=4, use_native_ring=ring)]
        assert len(threaded) == len(single)
        for s, t in zip(single, threaded):
            np.testing.assert_array_equal(s, t)


@pytest.mark.parametrize("ring", [False, True])
def test_worker_init_fn_called_per_worker(ring):
    """Counterpart of TestLoaderContractArgs::test_worker_init_fn_called_
    per_worker (threads and ring); an init that raises surfaces."""
    seen, lock = [], threading.Lock()

    def init_fn(wid):
        with lock:
            seen.append(wid)

    ds = pt.io.TensorDataset([pt.to_tensor(
        np.arange(32, dtype=np.float32).reshape(32, 1))])
    list(pt.io.DataLoader(ds, batch_size=4, num_workers=2,
                          use_native_ring=ring, worker_init_fn=init_fn))
    assert sorted(seen) == [0, 1], seen

    def bad(wid):
        raise ValueError("init failed")
    with pytest.raises(ValueError, match="init failed"):
        list(pt.io.DataLoader(ds, batch_size=4, num_workers=2,
                              use_native_ring=ring, worker_init_fn=bad))


@pytest.mark.parametrize("native", [False, True])
def test_timeout_raises_on_stuck_dataset(native):
    """Counterpart of TestLoaderContractArgs::test_timeout_raises_on_
    stuck_dataset: raised at about 1 s, not after the sleep, and the
    shutdown does not wait for the stuck worker."""
    class Stuck(pt.io.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            time.sleep(8)
            return np.zeros(2, np.float32)

    loader = pt.io.DataLoader(Stuck(), batch_size=2, num_workers=1,
                              timeout=1, use_native_ring=native)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="timeout"):
        list(loader)
    assert time.time() - t0 < 6


def test_abandoned_epochs_stop_their_workers():
    """A consumer that stops early (break) leaves no worker blocked on a
    full queue: every mode's threads end within seconds."""
    class Stream(pt.io.IterableDataset):
        def __iter__(self):
            for i in range(10000):
                yield np.float32(i)

    before = threading.active_count()
    for loader in (pt.io.DataLoader(Stream(), batch_size=2, num_workers=2),
                   pt.io.DataLoader(_ds(pt, 200), batch_size=2,
                                    num_workers=2, use_native_ring=True),
                   pt.io.DataLoader(_ds(pt, 200), batch_size=2,
                                    num_workers=2, use_native_ring=False)):
        it = iter(loader)
        next(it)
        it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


# --------------------------------------------------------------------------
# save / load
# --------------------------------------------------------------------------

def test_save_load_files_cross_both_ways(tmp_path):
    """A state dict and a nested object saved by either package load in
    the other with the same values; the pickle holds the reference's
    ``__param__`` / ``__tensor__`` records."""
    ref_lin, lin = P.nn.Linear(3, 2), pt.nn.Linear(3, 2)
    lin.set_state_dict({k: np.asarray(v.numpy())
                        for k, v in ref_lin.state_dict().items()})
    obj = {"t": pt.to_tensor(np.arange(4, dtype=np.float32)), "n": 3,
           "l": [1.5, "s"]}
    pt.save(lin.state_dict(), str(tmp_path / "port.pdparams"))
    pt.save(obj, str(tmp_path / "port.pkl"))
    P.save(ref_lin.state_dict(), str(tmp_path / "ref.pdparams"))
    with open(tmp_path / "port.pdparams", "rb") as f:
        raw = pickle.load(f)
    assert set(raw["weight"]) == {"__param__", "name", "trainable"}
    for path in ("port.pdparams", "ref.pdparams"):
        mine = pt.load(str(tmp_path / path))
        theirs = P.load(str(tmp_path / path))
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert isinstance(mine[k], pt.Tensor)
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(theirs[k].numpy()))
            np.testing.assert_array_equal(
                mine[k].numpy(), np.asarray(ref_lin.state_dict()[k].numpy()))
    back = P.load(str(tmp_path / "port.pkl"))
    np.testing.assert_array_equal(np.asarray(back["t"].numpy()),
                                  np.arange(4, dtype=np.float32))
    assert back["n"] == 3 and back["l"] == [1.5, "s"]
