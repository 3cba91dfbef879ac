# Copied from paddle_tpu/reader/__init__.py (the reader-creator decorators, stdlib only), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.reader — reader-creator decorators.

Re-design of the reference's legacy data pipeline
(ref: python/paddle/reader/decorator.py — map_readers, buffered, shuffle,
batch, compose, chain, firstn, cache, xmap_readers).  A *reader creator*
is a zero-arg callable returning an iterable; decorators wrap creators.
Pure-python host-side plumbing — device transfer happens at the DataLoader
/ feed boundary, so nothing here touches jax.
"""
from __future__ import annotations

import itertools
import queue as queue_mod
import random as random_mod
import threading

__all__ = ["map_readers", "buffered", "shuffle", "batch", "compose",
           "chain", "firstn", "cache", "xmap_readers", "multiprocess_reader"]


def map_readers(func, *readers):
    """Element-wise map over one or more readers zipped together."""
    def reader():
        its = [r() for r in readers]
        for items in zip(*its):
            yield func(*items)
    return reader


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer of ``buf_size`` items."""
    def new_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                random_mod.shuffle(buf)
                while buf:
                    yield buf.pop()
        random_mod.shuffle(buf)
        while buf:
            yield buf.pop()
    return new_reader


def chain(*readers):
    """Concatenate readers end to end."""
    def reader():
        for r in readers:
            yield from r()
    return reader


def compose(*readers, check_alignment=True):
    """Zip readers into tuples (flattening tuple items, like the ref)."""
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        its = [r() for r in readers]
        for items in itertools.zip_longest(*its):
            if check_alignment and any(i is None for i in items):
                raise RuntimeError("composed readers have different "
                                   "lengths")
            yield sum((make_tuple(i) for i in items), ())
    return reader


def buffered(reader, size):
    """Decouple producer/consumer with a background thread + queue.
    Producer exceptions are forwarded and re-raised at the consumer."""
    end = object()

    def new_reader():
        q = queue_mod.Queue(maxsize=size)

        def fill():
            try:
                for item in reader():
                    q.put((None, item))
            except BaseException as e:                     # noqa: BLE001
                q.put((e, None))
                return
            q.put((None, end))

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            exc, item = q.get()
            if exc is not None:
                raise exc
            if item is end:
                break
            yield item
    return new_reader


def firstn(reader, n):
    def new_reader():
        return itertools.islice(reader(), n)
    return new_reader


def cache(reader):
    """Materialize once; replay from memory afterwards.  Only a pass that
    runs to completion commits the cache (a partially consumed iteration
    must not leave duplicates behind)."""
    data = []
    filled = [False]

    def new_reader():
        if filled[0]:
            yield from data
            return
        this_pass = []
        for item in reader():
            this_pass.append(item)
            yield item
        data[:] = this_pass
        filled[0] = True
    return new_reader


def batch(reader, batch_size, drop_last=False):
    def new_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return new_reader


def xmap_readers(mapper, reader, process_num, buffer_size,
                 order=False):
    """Parallel map with a thread pool (the reference's process pool is a
    poor fit under jit-driven training; threads overlap host-side decode
    with device compute, which is the actual win on TPU)."""
    end = object()

    def new_reader():
        in_q = queue_mod.Queue(buffer_size)
        out_q = queue_mod.Queue(buffer_size)

        def feed():
            for i, item in enumerate(reader()):
                in_q.put((i, item))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                got = in_q.get()
                if got is end:
                    out_q.put(end)
                    return
                i, item = got
                try:
                    out_q.put((i, mapper(item)))
                except BaseException as e:                 # noqa: BLE001
                    # forward the failure, then count this worker as done
                    out_q.put(("error", e))
                    out_q.put(end)
                    return

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        finished = 0
        if order:
            pending = {}
            want = 0
            while finished < process_num:
                got = out_q.get()
                if got is end:
                    finished += 1
                    continue
                i, item = got
                if i == "error":
                    raise item
                pending[i] = item
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                got = out_q.get()
                if got is end:
                    finished += 1
                    continue
                if got[0] == "error":
                    raise got[1]
                yield got[1]
    return new_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Run the readers concurrently on threads, interleaving items as they
    arrive (the reference uses worker processes over pipes; on this runtime
    threads overlap host-side IO with device compute and avoid the fork
    hazards — ``use_pipe`` is accepted for parity).  Reader exceptions are
    forwarded and re-raised at the consumer."""
    end = object()

    def new_reader():
        q = queue_mod.Queue(maxsize=queue_size)

        def run(r):
            try:
                for item in r():
                    q.put((None, item))
            except BaseException as e:                     # noqa: BLE001
                q.put((e, None))
                return
            q.put((None, end))

        for r in readers:
            threading.Thread(target=run, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            exc, item = q.get()
            if exc is not None:
                raise exc
            if item is end:
                finished += 1
                continue
            yield item
    return new_reader
