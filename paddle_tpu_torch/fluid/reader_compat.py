"""fluid's py_reader over the port's input path (counterpart of
``paddle_tpu/fluid/reader_compat.py``; ref: python/paddle/fluid/layers/
io.py:561 ``py_reader``, :732 ``create_py_reader_by_data``, :843
``double_buffer``, :876 ``read_file``).

The record-replay Program has no reader ops: ``py_reader()`` makes
ordinary feed placeholders (``static.data``) and registers itself as
their owner; a prefetch thread stages batches into the native ring
(``runtime.DataRing``, the double buffer: bounded, GIL-released memcpy,
backpressure) or a plain queue; ``Executor.run`` fills every feed
placeholder of a started reader from it (:func:`fill_feed_from_readers`,
a hook of ``static.graph._executor_feed_hooks``) and raises
:class:`EOFException` when the pass is spent, so the classic

    reader.start()
    try:
        while True: exe.run(fetch_list=[loss])
    except fluid.core.EOFException:
        reader.reset()

loop runs as it is.  For an executor on the card a batch is copied once
out of the ring into pinned host memory and sent to the card with a
non-blocking copy on the current stream: the step syncs nothing.  On the
CPU it is copied out into numpy arrays, as the reference does.  A
source's error surfaces on the consumer before the end of the pass.
"""
from __future__ import annotations

import itertools
import queue
import threading
import weakref

import numpy as np
import torch

from ..framework import core as _core


class EOFException(Exception):
    """Raised by ``Executor.run`` when a started py_reader's pass is spent
    (ref: ``fluid.core.EOFException``)."""


_name_counter = itertools.count()
# (id(program), feed name) -> weakref(PyReader): train and eval programs
# may each declare a feed of the same name with a reader of its own
_slot_owner = {}

_EOF = object()


def _np_dtype(dt):
    return torch.empty(0, dtype=_core.convert_dtype(dt)).numpy().dtype


class _PassState:
    """One start()..EOF/reset() pass's ring or queue, stop flag and
    error: a filler thread that outlives its pass touches only its own."""

    __slots__ = ("ring", "queue", "stop", "error")

    def __init__(self, ring, q):
        self.ring = ring
        self.queue = q
        self.stop = threading.Event()
        self.error = None


def _per_sample_shape(shape):
    """A slot's declared shape less the batch dim; -1s stay, and reshape
    resolves them per field."""
    return [int(s) for s in list(shape)[1:]]


class PyReader:
    """The reader variable ``py_reader()`` returns: ``decorate_*`` attaches
    a source, ``start()`` / ``reset()`` bracket each pass, ``read_file()``
    gives its data variables."""

    def __init__(self, capacity=64, shapes=None, dtypes=None,
                 lod_levels=None, name=None, use_double_buffer=True,
                 feed_vars=None, feed_list=None, iterable=True,
                 return_list=False):
        from ..static import graph
        if feed_list is not None:       # fluid.io.PyReader's spelling
            feed_vars = feed_list
        self.capacity = int(capacity)
        self.use_double_buffer = bool(use_double_buffer)
        self.name = name or f"py_reader_{next(_name_counter)}"
        if feed_vars is not None:
            self._slots = list(feed_vars)
            self._dtypes = [_np_dtype(t.dtype) for t in self._slots]
            # the placeholder holds 1 where a dim is unknown: read the
            # shape as declared
            self._sample_shapes = [
                _per_sample_shape(graph._declared_shapes.get(
                    t._var_id, graph._feed_declared_shapes.get(
                        t.name, t.shape))) for t in self._slots]
        else:
            if shapes is None or dtypes is None:
                raise ValueError("py_reader needs shapes and dtypes")
            self._slots, self._dtypes, self._sample_shapes = [], [], []
            for i, (shp, dt) in enumerate(zip(shapes, dtypes)):
                self._slots.append(graph.data(f"{self.name}_slot_{i}",
                                              list(shp), dt))
                self._dtypes.append(_np_dtype(dt))
                self._sample_shapes.append(_per_sample_shape(shp))
        self._program_id = id(graph.default_main_program())
        for t in self._slots:
            _slot_owner[(self._program_id, t.name)] = weakref.ref(self)
        self._source = None          # ("sample" | "batch", callable)
        self._thread = None
        self._pass = None
        self._started = False

    def decorate_paddle_reader(self, reader, places=None):
        """``reader()`` yields lists of per-sample field tuples (a batched
        reader)."""
        self._source = ("sample", reader)
        return self

    decorate_sample_list_generator = decorate_paddle_reader

    def decorate_tensor_provider(self, reader, places=None):
        """``reader()`` yields tuples of batched arrays."""
        self._source = ("batch", reader)
        return self

    decorate_batch_generator = decorate_tensor_provider

    def _assemble(self, item, mode):
        out = []
        if mode == "sample":
            for i, (dt, sshape) in enumerate(
                    zip(self._dtypes, self._sample_shapes)):
                fields = [np.asarray(s[i]) for s in item]
                if sshape and sshape.count(-1) <= 1:
                    fields = [f.reshape(sshape) for f in fields]
                out.append(np.stack(fields).astype(dt, copy=False))
        else:
            for f, dt in zip(item, self._dtypes):
                a = f.numpy() if hasattr(f, "numpy") else np.asarray(f)
                out.append(np.ascontiguousarray(a).astype(dt, copy=False))
        return out

    def start(self):
        if self._source is None:
            raise RuntimeError(
                f"py_reader {self.name!r}: no data source; call "
                "decorate_paddle_reader/decorate_tensor_provider first")
        if self._started:
            raise RuntimeError(
                f"py_reader {self.name!r} already started; reset() first")
        ring = None
        if self.use_double_buffer:
            from .. import runtime
            if runtime.is_available():
                ring = runtime.DataRing(capacity=self.capacity)
        q = None if ring is not None else queue.Queue(maxsize=self.capacity)
        st = _PassState(ring, q)
        mode, src = self._source
        self._thread = threading.Thread(
            target=self._fill, args=(mode, src, st), daemon=True,
            name=f"{self.name}_prefetch")
        self._pass = st
        self._started = True
        self._thread.start()

    def _fill(self, mode, src, st):
        try:
            for tag, item in enumerate(src()):
                if st.stop.is_set():
                    return
                batch = self._assemble(item, mode)
                if st.ring is not None:
                    # blocks while full; CLOSED after reset
                    if st.ring.push(batch, tag) != 0:
                        return
                else:
                    while not st.stop.is_set():
                        try:
                            st.queue.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
        except Exception as e:  # surfaced on the consumer
            st.error = e
        finally:
            if st.ring is not None:
                st.ring.close()
            else:
                while not st.stop.is_set():
                    try:
                        st.queue.put(_EOF, timeout=0.1)
                        break
                    except queue.Full:
                        continue

    def _next_batch(self, device=None):
        """The next staged batch: on a CUDA ``device`` as tensors there
        (pinned host copies, sent with non-blocking copies), else as
        numpy arrays; :class:`EOFException` when the pass is done (or
        was never started)."""
        st = self._pass
        if not self._started or st is None:
            raise EOFException(
                f"py_reader {self.name!r} not started (or already "
                "exhausted); call start()")
        if st.error is not None:
            self._raise_error_or_eof(st)
        if st.ring is not None:
            got = st.ring.pop()           # None: closed and drained
            if got is None:
                # the filler closes the ring on an error too: look again
                self._raise_error_or_eof(st)
            views, _tag = got
            # the views alias ring memory that the next pop recycles
            return _staged(views, device, copy=True)
        item = st.queue.get()
        if item is _EOF:
            self._raise_error_or_eof(st)
        return _staged(item, device, copy=False)

    def _raise_error_or_eof(self, st):
        self._finish()
        if st.error is not None:
            err, st.error = st.error, None
            raise err
        raise EOFException(f"py_reader {self.name!r} pass finished")

    def _finish(self):
        self._started = False
        st, self._pass = self._pass, None
        th, self._thread = self._thread, None
        if st is None:
            return
        if st.ring is not None:
            st.ring.close()               # wakes a blocked push
        else:
            st.stop.set()
        if th is not None:
            th.join(timeout=5)
            if not th.is_alive() and st.ring is not None:
                st.ring.destroy()

    def reset(self):
        """End the pass: stop the prefetch thread and drop staged batches;
        ``start()`` begins a new pass (the source is called again)."""
        st = self._pass
        if st is not None:
            st.stop.set()
            if st.ring is not None:
                st.ring.close()
                # drain, so that a push blocked on a full ring returns
                try:
                    while st.ring.pop(timeout_ms=100) is not None:
                        pass
                except TimeoutError:
                    pass
            else:
                try:
                    while True:
                        st.queue.get_nowait()
                except queue.Empty:
                    pass
        self._finish()

    shutdown = reset


def _staged(arrays, device, copy):
    """``arrays`` for a feed on ``device``: on the card each through a
    pinned host buffer and a non-blocking copy (the caching host
    allocator keeps a buffer until its copy is done); on the CPU numpy
    arrays, copied out when ``copy``."""
    if device is None or device.type != "cuda":
        return [np.array(a) for a in arrays] if copy else list(arrays)
    out = []
    for a in arrays:
        host = torch.empty(a.shape, pin_memory=True, dtype=torch.from_numpy(
            np.empty(0, a.dtype)).dtype)
        host.numpy()[...] = a
        out.append(host.to(device, non_blocking=True))
    return out


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """ref fluid/layers/io.py:561: an asynchronous Python-fed reader."""
    return PyReader(capacity, shapes=shapes, dtypes=dtypes,
                    lod_levels=lod_levels, name=name,
                    use_double_buffer=use_double_buffer)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """ref fluid/layers/io.py:732: a py_reader over existing data
    variables (their names, declared shapes and dtypes are its slots)."""
    return PyReader(capacity, name=name,
                    use_double_buffer=use_double_buffer,
                    feed_vars=feed_list)


def double_buffer(reader, place=None, name=None):
    """ref fluid/layers/io.py:843: stage the reader's batches through the
    native ring (on for a reader made with ``use_double_buffer=False``)."""
    if not isinstance(reader, PyReader):
        raise TypeError("double_buffer expects a py_reader Reader variable")
    reader.use_double_buffer = True
    return reader


def read_file(reader):
    """ref fluid/layers/io.py:876: a reader variable's data variables; any
    other argument is a path, read by ``vision.ops.read_file``, as the
    reference dispatches."""
    if isinstance(reader, PyReader):
        slots = list(reader._slots)
        return slots if len(slots) > 1 else slots[0]
    from ..vision.ops import read_file as _vision_read_file
    return _vision_read_file(reader)


def _install_feed_hook():
    from ..static import graph
    if fill_feed_from_readers not in graph._executor_feed_hooks:
        graph._executor_feed_hooks.append(fill_feed_from_readers)


def fill_feed_from_readers(program, feed, device=None):
    """The Executor's feed hook: every placeholder of this program owned
    by a py_reader and absent from ``feed`` takes the reader's next batch
    (one batch a reader a run), on ``device``.  A placeholder whose
    reader is not started raises: replaying its build-time zeros would
    train on nothing."""
    pending = {}
    for fname in program.feed_ids:
        if fname in feed:
            continue
        ref = _slot_owner.get((id(program), fname))
        rd = ref() if ref is not None else None
        if rd is None:
            continue
        if not rd._started:
            raise RuntimeError(
                f"py_reader {rd.name!r} owns feed var {fname!r} but is "
                "not started: call reader.start() before Executor.run "
                "(or feed all of its slots explicitly)")
        pending.setdefault(id(rd), rd)
    if not pending:
        return feed
    feed = dict(feed)
    for rd in pending.values():
        fed = [t.name for t in rd._slots if t.name in feed]
        if fed:
            # some slots fed and the rest from the queue would pair fields
            # of different batches
            raise RuntimeError(
                f"py_reader {rd.name!r} is started but {fed} were passed "
                "in feed=: feed all of its slots explicitly or none")
        for t, a in zip(rd._slots, rd._next_batch(device)):
            feed[t.name] = a
    return feed


_install_feed_hook()
