"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``).

Four modes, as the reference's: one process (``num_workers=0``), worker
threads collating ahead of the consumer, worker threads staging batches
through the native ring (``runtime.DataRing``: one C++ slab a batch, a
bounded queue that backpressures the producers), and worker threads each
iterating an ``IterableDataset``.  Batches come out in the sampler's order
and hold the values the reference's loader gives; the resumable position
(``state_dict`` / ``set_state_dict``) is the reference's.

Where batches go.  Workers collate on the host only: their thread's
default place is the CPU, so a ``collate_fn`` that makes Tensors makes
them there.  Each batch is handed out on the default place
(``framework.get_place()``, the card unless the caller set the CPU):
without ``prefetch_to_device`` the consumer's thread copies it when it is
handed out; with it, :func:`prefetch_to_device` copies ``depth`` batches
ahead from pinned host memory on a side CUDA stream, and the consumer's
stream waits on that copy's event.  The ring's slab is released at the
next pop, so a popped batch is copied out of it (into pinned memory when
it is bound for the card) before the next pop.

Every wait polls (``_POLL_S``), so none outlives its workers; a
``timeout`` bounds each batch.  A worker still stuck in the dataset at
shutdown is left behind (a daemon thread; its ring is parked by
``DataRing.destroy``), never joined for longer than a few seconds.
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading
import time

import numpy as np
import torch

from ..framework import core
from ..tensor.tensor import Tensor
from .dataset import BatchSampler, IterableDataset

_worker_tls = threading.local()
_POLL_S = 0.1            # period of every wait on workers
_JOIN_S = 2.0            # longest wait for a worker at shutdown


class WorkerInfo:
    """ref: fluid/dataloader/worker.py::WorkerInfo: the worker a sample is
    being produced in, so IterableDatasets can shard."""

    def __init__(self, id, num_workers, dataset, seed=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, "
                f"num_workers={self.num_workers})")


def get_worker_info():
    """Inside a DataLoader worker: that worker's WorkerInfo; in the main
    thread: None (ref: paddle.io.get_worker_info)."""
    return getattr(_worker_tls, "info", None)


def _enter_worker(wid, loader, dtype):
    """Thread-local set-up of worker ``wid``: its WorkerInfo, the CPU as
    its default place (collation stays on the host) and the consumer's
    default dtype."""
    _worker_tls.info = WorkerInfo(wid, loader.num_workers, loader.dataset)
    core._state.expected_place = core.CPUPlace()
    core._state.default_dtype = dtype


# device-prefetch counters (a plain dict; the reference's registry view
# waits for the port's observability)
_prefetch_stats = {"batches": 0, "hits": 0, "misses": 0, "puts": 0}


def prefetch_stats():
    s = dict(_prefetch_stats)
    n = s["batches"]
    s["hit_ratio"] = round(s["hits"] / n, 4) if n else 0.0
    return s


def reset_prefetch_stats():
    for k in _prefetch_stats:
        _prefetch_stats[k] = 0


# --------------------------------------------------------------------------
# batch trees: lists, tuples and dicts of leaves (a Tensor is a leaf)
# --------------------------------------------------------------------------

def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flatten(tree):
    """(leaves, spec): the leaves in order and what rebuilds the tree."""
    leaves = []

    def walk(t):
        if isinstance(t, (list, tuple)):
            return (type(t), [walk(v) for v in t])
        if isinstance(t, dict):
            return (dict, [(k, walk(v)) for k, v in t.items()])
        leaves.append(t)
        return None
    return leaves, walk(tree)


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, kids = s
        if kind is dict:
            return {k: build(v) for k, v in kids}
        return kind(build(v) for v in kids)
    return build(spec)


def _tensor_leaves(tree):
    leaves, _ = _flatten(tree)
    return [x for x in leaves if isinstance(x, Tensor)]


# --------------------------------------------------------------------------
# collation and placement
# --------------------------------------------------------------------------

def _host_tensor(arr):
    """A Tensor on the CPU, 64-bit types narrowed as ``to_tensor`` does."""
    return Tensor(arr, place=core.CPUPlace())


def _host_collate(batch):
    """The default collate, on the host: numpy samples stack into CPU
    Tensors; Tensor samples stack where they are."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor(torch.stack([s.value for s in batch]))
    if isinstance(sample, np.ndarray):
        return _host_tensor(np.stack(batch))
    if isinstance(sample, (int, float)):
        return _host_tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return type(sample)(_host_collate([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: _host_collate([b[k] for b in batch]) for k in sample}
    return _host_tensor(np.asarray(batch))


def _to_place(tree):
    """``tree`` with every Tensor leaf on the default place, copied by
    this thread; other leaves as they are."""
    dev = core.get_place().device

    def move(x):
        if isinstance(x, Tensor) and x.value.device != dev:
            return Tensor(x.value.to(dev), stop_gradient=x.stop_gradient)
        return x
    return _map(move, tree)


def default_collate_fn(batch):
    """Stack samples into Tensors on the default place (ref:
    ``io/dataloader.py::default_collate_fn``)."""
    return _to_place(_host_collate(batch))


def _numeric(x):
    return (isinstance(x, np.ndarray) and not x.dtype.hasobject
            and x.dtype.kind not in "USV")


def prefetch_to_device(iterable, depth=1):
    """Hand out each batch of ``iterable`` on the default place, its
    host-to-device copy started ``depth`` batches ahead of consumption
    (ref: the pinned double buffer of fluid/reader/buffered_reader.cc).

    On the card, each Tensor (and numeric numpy) leaf is copied from
    pinned host memory (pinned here if it is not) with
    ``non_blocking=True`` on a side stream, and an event is recorded
    after the batch's copies.  When the batch is handed out, the current
    stream waits on that event and each copied tensor is marked used by
    it (``record_stream``), so its memory outlives the consumer's work;
    the pinned sources are held until then (the caching host allocator
    keeps a block from reuse until its copy is done).  A batch whose
    event had completed when it was handed out counts as a hit, one the
    consumer's stream must wait on as a miss (``prefetch_stats()``).  On
    the CPU the batch moves when it is staged, and is always a hit.
    Other leaves (strings, Python objects) pass through untouched."""
    dev = core.get_place().device
    depth = max(int(depth), 1)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def leaf(x, keep):
        if isinstance(x, Tensor):
            v, sg = x.value, x.stop_gradient
        elif _numeric(x):
            v = core.narrow(torch.from_numpy(np.require(x, None, "C")))
            sg = True
        else:
            return x
        if v.device == dev:
            return x if isinstance(x, Tensor) else Tensor(v)
        if side is None:
            return Tensor(v.to(dev), stop_gradient=sg)
        if v.device.type == "cpu" and not v.is_pinned():
            v = v.pin_memory()
        keep.append(v)
        return Tensor(v.to(dev, non_blocking=True), stop_gradient=sg)

    def put(batch):
        _prefetch_stats["puts"] += 1
        keep = []
        if side is None:
            return _map(lambda x: leaf(x, keep), batch), None, keep
        with torch.cuda.stream(side):
            out = _map(lambda x: leaf(x, keep), batch)
            ev = torch.cuda.Event()
            ev.record(side)
        return out, ev, keep

    def hand_out(entry):
        batch, ev, _keep = entry
        _prefetch_stats["batches"] += 1
        ready = ev is None or ev.query()
        _prefetch_stats["hits" if ready else "misses"] += 1
        if ev is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            for t in _tensor_leaves(batch):
                if t.value.device == dev:
                    t.value.record_stream(cur)
        return batch

    def gen():
        it = iter(iterable)
        buf = collections.deque()
        for batch in itertools.islice(it, depth):
            buf.append(put(batch))
        while buf:
            entry = buf.popleft()
            for batch in itertools.islice(it, 1):
                buf.append(put(batch))
            yield hand_out(entry)

    return gen()


# --------------------------------------------------------------------------
# the loader
# --------------------------------------------------------------------------

class _Waiter:
    """Bounded waits on a queue or ring fed by ``threads``: each polls,
    raises the reference's timeout error once ``timeout`` seconds pass
    without a batch (0: no limit), and raises if every worker exited
    while the consumer still waits."""

    def __init__(self, timeout, threads):
        self.timeout = timeout
        self.threads = threads
        self.restart()

    def restart(self):
        self.deadline = (time.monotonic() + self.timeout
                         if self.timeout else None)

    def check(self):
        if self.deadline is not None and time.monotonic() >= self.deadline:
            raise RuntimeError(f"DataLoader worker produced no batch within "
                               f"timeout={self.timeout}s")

    def alive(self):
        return any(t.is_alive() for t in self.threads)

    def get(self, q):
        while True:
            # read before the wait: workers that had all exited by then
            # had put everything they would
            alive = self.alive()
            try:
                item = q.get(timeout=_POLL_S)
            except queue.Empty:
                self.check()
                if not alive:
                    raise RuntimeError("DataLoader workers exited before "
                                       "the epoch's batches were produced")
                continue
            self.restart()
            return item


def _put(q, item, stop):
    """Put onto a bounded queue unless ``stop`` is set; False if stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, use_shared_memory=True,
                 prefetch_factor=2, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_native_ring=None,
                 prefetch_to_device=False):
        self.dataset = dataset
        # False: off.  True / int N: copy N batches to the card ahead of
        # consumption on a side stream
        self.prefetch_to_device = prefetch_to_device
        self.collate_fn = collate_fn or default_collate_fn
        self._default_collate = collate_fn in (None, default_collate_fn)
        self.num_workers = num_workers
        # None: the ring when the library is already built; True: the ring
        # (raises without a compiler); False: threads
        self.use_native_ring = use_native_ring
        self.prefetch_factor = max(prefetch_factor, 2)
        # timeout bounds each batch (0: no limit); worker_init_fn runs once
        # in every worker with its id; persistent_workers is accepted for
        # API parity (workers are threads made each epoch)
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
        # resumable position: epochs completed, batches handed out this
        # epoch, a pending skip for the next __iter__, and numpy's global
        # RNG state as of this epoch's start
        self._epoch = 0
        self._batch_index = 0
        self._resume_skip = 0
        self._epoch_rng_state = None

    # ------------------------------------------------- resumable state
    def state_dict(self):
        """Completed epochs, batches handed to the consumer this epoch,
        and numpy's global RNG state as of this epoch's start (what a
        shuffling sampler drew the epoch's order from), so a resumed epoch
        draws the same order and skips to the same batch."""
        rng = (self._epoch_rng_state if self._epoch_rng_state is not None
               else np.random.get_state())
        return {"epoch": self._epoch, "batch_index": self._batch_index,
                "np_rng_state": rng}

    def set_state_dict(self, state):
        """Rewind to a captured position: the next ``__iter__`` skips the
        first ``batch_index`` batches (map-style datasets at the sampler,
        without fetching; iterable datasets by consuming) and numpy's RNG
        is restored so a shuffling epoch replays its order."""
        self._epoch = int(state.get("epoch", 0))
        self._resume_skip = int(state.get("batch_index", 0))
        # a state_dict taken before the next __iter__ reports the restored
        # position and RNG, not a stale one
        self._batch_index = self._resume_skip
        self._epoch_rng_state = state.get("np_rng_state")
        if state.get("np_rng_state") is not None:
            np.random.set_state(state["np_rng_state"])

    def _track(self, it, skip):
        """Count batches handed out (after any prefetch) and roll the
        epoch when the iterator drains."""
        self._batch_index = skip
        for batch in it:
            self._batch_index += 1
            yield batch
        self._epoch += 1
        self._batch_index = 0
        # between epochs a state_dict captures the current stream (the
        # next epoch draws afresh), not this epoch's start
        self._epoch_rng_state = None

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def __call__(self):
        # the reader-factory spelling: `for batch in loader():`
        return iter(self)

    def _collate(self, samples):
        return (_host_collate(samples) if self._default_collate
                else self.collate_fn(samples))

    def _fetch(self, indices):
        return self._collate([self.dataset[i] for i in indices])

    def _start(self, worker):
        dtype = core.get_default_dtype()

        def run(wid):
            _enter_worker(wid, self, dtype)
            worker(wid)
        threads = [threading.Thread(target=run, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        return threads

    def _init_worker(self, wid):
        if self.worker_init_fn is not None:
            self.worker_init_fn(wid)

    # ------------------------------------------------------------ modes
    def _iter_single(self, skip=0):
        if self._iterable_mode:
            buf = []
            emitted = 0
            for sample in self.dataset:
                buf.append(sample)
                if len(buf) == self.batch_size:
                    emitted += 1
                    if emitted > skip:     # resume: drop replayed batches
                        yield self._collate(buf)
                    buf = []
            if buf and not self.drop_last and emitted + 1 > skip:
                yield self._collate(buf)
            return
        for indices in itertools.islice(iter(self.batch_sampler),
                                        skip, None):
            yield self._fetch(indices)

    def _iter_threaded(self, skip=0):
        """Worker threads collate batches ahead of consumption, at most
        ``prefetch_factor * num_workers`` outstanding (so one slow batch
        cannot make the reorder buffer take the epoch)."""
        work_q: queue.Queue = queue.Queue()
        done = object()
        out_q: queue.Queue = queue.Queue()
        batches = list(self.batch_sampler)[skip:]
        window = self.prefetch_factor * self.num_workers

        def worker(wid):
            try:
                self._init_worker(wid)
            except Exception as e:                         # noqa: BLE001
                out_q.put((-1, e))
                return
            while True:
                item = work_q.get()
                if item is done:
                    out_q.put(done)
                    return
                i, idxs = item
                try:
                    out_q.put((i, self._fetch(idxs)))
                except Exception as e:   # surfaced in the consumer
                    out_q.put((i, e))

        threads = self._start(worker)
        submitted = 0
        want = 0
        sent_done = False

        def refill():
            nonlocal submitted, sent_done
            # submitted - want counts in-flight AND reorder-buffered
            # batches, so the window never reopens behind a straggler
            while (submitted < len(batches)
                   and submitted - want < window):
                work_q.put((submitted, batches[submitted]))
                submitted += 1
            if submitted == len(batches) and not sent_done:
                sent_done = True
                for _ in range(self.num_workers):
                    work_q.put(done)

        pending = {}
        received = 0
        wait = _Waiter(self.timeout, threads)
        try:
            refill()
            while received < len(batches):
                item = wait.get(out_q)
                if item is done:
                    continue
                i, data = item
                if isinstance(data, Exception):
                    raise data
                pending[i] = data
                received += 1
                while want in pending:
                    yield pending.pop(want)
                    want += 1
                refill()
            while want in pending:
                yield pending.pop(want)
                want += 1
        finally:
            if not sent_done:
                for _ in range(self.num_workers):
                    work_q.put(done)
            for t in threads:
                t.join(timeout=_POLL_S)

    def _iter_native_ring(self, skip=0):
        """Native staging (ref: the C++ BlockingQueue reader): workers
        collate on the host and gather each batch into one C++ pool slab
        (memcpy with the GIL released); the bounded ring backpressures
        them; the consumer copies each popped batch out of its slab before
        the next pop, into pinned memory when the batch is bound for the
        card."""
        from .. import runtime

        batches = list(self.batch_sampler)[skip:]
        ring = runtime.DataRing(
            capacity=self.prefetch_factor * self.num_workers)
        pin = core.get_place().device.type == "cuda"
        specs = {}
        spec_lock = threading.Lock()
        errors = []
        done = object()
        work_q: queue.Queue = queue.Queue()

        def host_leaves(idxs):
            leaves, spec = _flatten(self._fetch(idxs))
            out = []
            for x in leaves:
                if isinstance(x, Tensor):
                    x = x.value.detach().cpu().numpy()
                x = np.asarray(x)
                if not _numeric(x):
                    raise TypeError(
                        "native-ring DataLoader requires numeric array "
                        f"batches, got dtype={x.dtype}; pass "
                        "use_native_ring=False for object batches")
                out.append(x)
            return out, spec

        def worker(wid):
            try:
                self._init_worker(wid)
            except Exception as e:                         # noqa: BLE001
                errors.append(e)
                ring.close()
                return
            while True:
                item = work_q.get()
                if item is done:
                    return
                i, idxs = item
                try:
                    leaves, spec = host_leaves(idxs)
                    with spec_lock:
                        specs[i] = spec
                    rc = ring.push(leaves, i)
                    if rc == runtime.DataRing.CLOSED:
                        return       # the consumer shut down under us
                    if rc != 0:
                        raise MemoryError(
                            f"native ring push failed (code {rc})")
                except Exception as e:                     # noqa: BLE001
                    errors.append(e)
                    ring.close()
                    return

        def copy_out(view):
            src = torch.from_numpy(view)
            if pin:
                dst = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
                dst.copy_(src)
            else:
                dst = src.clone()
            return Tensor(dst)

        threads = self._start(worker)
        # outstanding work is capped so the reorder buffer stays bounded:
        # the ring caps how far producers run ahead, but a straggler's
        # producer needs the consumer to keep draining it
        window = self.prefetch_factor * self.num_workers
        pending = {}
        want = 0
        submitted = 0
        sent_done = False

        def refill():
            nonlocal submitted, sent_done
            while (submitted < len(batches)
                   and submitted - want < window):
                work_q.put((submitted, batches[submitted]))
                submitted += 1
            if submitted == len(batches) and not sent_done:
                sent_done = True
                for _ in range(self.num_workers):
                    work_q.put(done)

        wait = _Waiter(self.timeout, threads)
        try:
            refill()
            while want < len(batches):
                if want in pending:
                    yield pending.pop(want)
                    want += 1
                    refill()
                    continue
                alive = wait.alive()
                try:
                    got = ring.pop(timeout_ms=int(_POLL_S * 1000))
                except TimeoutError:
                    wait.check()
                    if not alive:
                        if errors:
                            raise errors[0]
                        raise RuntimeError("DataLoader workers exited before "
                                           "the epoch's batches were staged")
                    continue
                if got is None:        # closed: an error
                    if errors:
                        raise errors[0]
                    break
                wait.restart()
                views, tag = got
                with spec_lock:
                    spec = specs.pop(tag)
                # copied before the next pop recycles the slab
                pending[tag] = _unflatten(spec, [copy_out(v) for v in views])
            while want in pending:
                yield pending.pop(want)
                want += 1
            if errors:
                raise errors[0]
        finally:
            ring.close()
            if not sent_done:          # unblock workers parked on get()
                for _ in range(self.num_workers):
                    work_q.put(done)
            for t in threads:
                t.join(timeout=_JOIN_S)
            # safe under a live producer: a stuck worker's later push
            # fails as closed, and the native object is parked
            ring.destroy()

    def _iter_iterable_workers(self, skip=0):
        """Multi-worker IterableDataset: each worker iterates the dataset
        under its own WorkerInfo (datasets shard themselves through
        get_worker_info) and batches locally."""
        out_q: queue.Queue = queue.Queue(
            maxsize=self.prefetch_factor * self.num_workers)
        done = object()
        stop = threading.Event()

        def worker(wid):
            try:
                self._init_worker(wid)
                buf = []
                for sample in self.dataset:
                    buf.append(sample)
                    if len(buf) == self.batch_size:
                        if not _put(out_q, self._collate(buf), stop):
                            return
                        buf = []
                if buf and not self.drop_last:
                    _put(out_q, self._collate(buf), stop)
            except Exception as e:                         # noqa: BLE001
                _put(out_q, e, stop)
            finally:
                _put(out_q, done, stop)

        threads = self._start(worker)
        wait = _Waiter(self.timeout, threads)
        finished = 0
        dropped = 0
        try:
            while finished < self.num_workers:
                item = wait.get(out_q)
                if item is done:
                    finished += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                if dropped < skip:
                    dropped += 1
                    continue
                yield item
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=_POLL_S)

    def __iter__(self):
        skip = self._resume_skip
        self._resume_skip = 0
        # the position resets now: a state_dict between iter() and the
        # first next() reports this epoch's
        self._batch_index = skip
        # the RNG the sampler is about to draw from: a mid-epoch
        # state_dict hands back this state so the resumed epoch replays
        self._epoch_rng_state = np.random.get_state()
        if self.num_workers and self._iterable_mode:
            # worker interleaving is not deterministic; a resume skip
            # drops the first `skip` batches produced
            it = self._iter_iterable_workers(skip)
        elif self.num_workers:
            use_ring = self.use_native_ring
            if use_ring is None:
                # never stall an epoch on a C++ compile: the ring only
                # when its library is already built
                from .. import runtime
                use_ring = runtime.is_prebuilt()
            it = (self._iter_native_ring(skip) if use_ring
                  else self._iter_threaded(skip))
        else:
            it = self._iter_single(skip)
        if self.prefetch_to_device:
            depth = (1 if self.prefetch_to_device is True
                     else int(self.prefetch_to_device))
            it = prefetch_to_device(it, depth=depth)
        else:
            it = map(_to_place, it)
        return self._track(it, skip)
