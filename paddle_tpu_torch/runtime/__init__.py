"""Native host runtime (C++): the staging memory pool and the data ring.

Counterpart of ``paddle_tpu/runtime/__init__.py``: its pool, ring,
image preprocess and WordPiece tokenizer (``ptpu_wp_create`` /
``ptpu_wp_encode`` / ``ptpu_wp_destroy``, which ``text.FullTokenizer``
calls).  ``csrc/ptpu_runtime.cc`` is a copy of the reference's source,
built by ``build.py`` at first use and bound through ctypes.
What stays native is the host side of the input pipeline: batch staging
slabs drawn from a size-class auto-growth pool, a bounded blocking ring
that overlaps worker collation and memcpy (the GIL released by ctypes)
with device steps, and the fused u8 NHWC -> normalised f32 NCHW batch
preprocess (:func:`preprocess_images`).

There is no fallback: without a C++ compiler, :func:`is_available` is
False and a :class:`DataRing`, a :class:`HostMemoryPool`,
:func:`preprocess_images` or a native ``text.FullTokenizer`` raises (the
reference falls back to numpy for the preprocess and to Python for the
tokenizer).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import build as _b

_lib = None
_lib_err = None
_lock = threading.Lock()


def _load():
    """The loaded library, built first if needed.  Raises
    ``RuntimeError`` when it cannot be built."""
    global _lib, _lib_err
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_err is not None:
            raise RuntimeError(f"native runtime unavailable: {_lib_err}")
        try:
            path = _b.build()
        except RuntimeError as e:
            _lib_err = str(e)
            raise
        lib = ctypes.CDLL(str(path))
        lib.ptpu_pool_create.restype = ctypes.c_int64
        lib.ptpu_pool_alloc.restype = ctypes.c_void_p
        lib.ptpu_pool_alloc.argtypes = [ctypes.c_int64, ctypes.c_uint64]
        lib.ptpu_pool_free.argtypes = [ctypes.c_int64, ctypes.c_void_p]
        lib.ptpu_pool_destroy.argtypes = [ctypes.c_int64]
        lib.ptpu_pool_stats.argtypes = [ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_uint64)]
        lib.ptpu_ring_create.restype = ctypes.c_int64
        lib.ptpu_ring_create.argtypes = [ctypes.c_int]
        lib.ptpu_ring_destroy.argtypes = [ctypes.c_int64]
        lib.ptpu_ring_push_gather.restype = ctypes.c_int
        lib.ptpu_ring_push_gather.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int]
        lib.ptpu_ring_pop.restype = ctypes.c_int
        lib.ptpu_ring_pop.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int]
        lib.ptpu_ring_release.argtypes = [ctypes.c_int64, ctypes.c_void_p]
        lib.ptpu_ring_close.argtypes = [ctypes.c_int64]
        lib.ptpu_ring_size.restype = ctypes.c_int
        lib.ptpu_ring_size.argtypes = [ctypes.c_int64]
        lib.ptpu_ring_stats.argtypes = [ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_uint64)]
        lib.ptpu_preprocess_u8_nhwc_to_f32_nchw.restype = ctypes.c_int
        lib.ptpu_preprocess_u8_nhwc_to_f32_nchw.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int]
        lib.ptpu_wp_create.restype = ctypes.c_int64
        lib.ptpu_wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_char_p]
        lib.ptpu_wp_destroy.argtypes = [ctypes.c_int64]
        lib.ptpu_wp_encode.restype = ctypes.c_int64
        lib.ptpu_wp_encode.argtypes = [
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        _lib = lib
        return _lib


def is_available():
    """True if the native library loads (it is built on the first call);
    False if it cannot be built."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def is_prebuilt():
    """True if the library is already built and loads; never compiles."""
    return _b.is_built() and is_available()


def preprocess_images(images, mean, std, scale=1.0 / 255.0, n_threads=0):
    """The fused u8 NHWC -> normalised f32 NCHW batch preprocess, in
    native code over ``n_threads`` threads (default: the cores less one,
    at most 8): out[i, c, y, x] = images[i, y, x, c] * (scale / std[c]) -
    mean[c] / std[c].

    images: uint8 [N, H, W, C] or a list of [H, W, C] arrays of one
    shape; mean / std: per channel, in post-scale units (as
    ``transforms.Normalize``).  Returns float32 [N, C, H, W].  Raises
    ``RuntimeError`` when the library cannot be built."""
    import os

    if isinstance(images, np.ndarray):
        assert images.ndim == 4, images.shape
        images = [images[i] for i in range(images.shape[0])]
    if not images:
        raise ValueError("preprocess_images: empty batch")
    for a in images:
        if np.asarray(a).dtype != np.uint8:
            raise TypeError("preprocess_images expects uint8 images, got "
                            f"{np.asarray(a).dtype} (normalize raw pixels, "
                            "not already-scaled floats)")
    imgs = [np.ascontiguousarray(a, np.uint8) for a in images]
    n = len(imgs)
    h, w, c = imgs[0].shape
    for a in imgs:
        if a.shape != (h, w, c):
            raise ValueError("preprocess_images: all images must share one "
                             f"shape; got {a.shape} vs {(h, w, c)}")
    mean = np.ascontiguousarray(np.asarray(mean, np.float32).reshape(c))
    inv_std = np.ascontiguousarray(
        1.0 / np.asarray(std, np.float32).reshape(c), np.float32)
    lib = _load()
    out = np.empty((n, c, h, w), np.float32)
    srcs = (ctypes.c_void_p * n)(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in imgs])
    if n_threads <= 0:
        n_threads = min(8, max(1, (os.cpu_count() or 2) - 1))
    rc = lib.ptpu_preprocess_u8_nhwc_to_f32_nchw(
        srcs, n, h, w, c,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        inv_std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(scale), out.ctypes.data_as(ctypes.c_void_p),
        n_threads)
    if rc != 0:
        raise RuntimeError(f"ptpu_preprocess failed rc={rc}")
    return out


class HostMemoryPool:
    """Size-class auto-growth host allocator with statistics (the
    reference's analogue of AutoGrowthBestFitAllocator for host staging
    memory)."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.ptpu_pool_create()

    def alloc(self, nbytes: int) -> int:
        p = self._lib.ptpu_pool_alloc(self._h, nbytes)
        if not p:
            raise MemoryError(f"pool alloc of {nbytes} bytes failed")
        return p

    def free(self, ptr: int):
        self._lib.ptpu_pool_free(self._h, ptr)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 6)()
        self._lib.ptpu_pool_stats(self._h, out)
        keys = ("reserved", "in_use", "peak_in_use", "alloc_count",
                "grow_count", "free_count")
        return dict(zip(keys, [int(v) for v in out]))

    def close(self):
        if self._h:
            self._lib.ptpu_pool_destroy(self._h)
            self._h = 0

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class DataRing:
    """Bounded blocking ring of staged batches.

    ``push(arrays, tag)`` gathers a batch's numpy arrays into one native
    slab (one GIL-released memcpy pass) and blocks while the ring is full;
    ``pop()`` returns ``(views, tag)``, zero-copy numpy views into the
    slab.  The slab is released at the NEXT pop: copy out of the views
    before popping again.
    """

    CLOSED, TIMEOUT, OOM = -1, -2, -3

    def __init__(self, capacity: int = 8):
        self._lib = _load()
        self._h = self._lib.ptpu_ring_create(capacity)
        self._meta = {}           # tag -> per-array (shape, dtype, nbytes)
        self._meta_lock = threading.Lock()
        # the deferred release is serialized by _pop_lock: the C++ ring is
        # MPMC, but "views valid until the next pop" holds only if pops
        # through this wrapper go one at a time
        self._pending_release = None
        self._pop_lock = threading.Lock()

    def push(self, arrays, tag: int, timeout_ms: int = -1) -> int:
        arrs = [np.ascontiguousarray(a) for a in arrays]
        n = len(arrs)
        srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
        lens = (ctypes.c_uint64 * n)(*[a.nbytes for a in arrs])
        with self._meta_lock:
            self._meta[tag] = [(a.shape, a.dtype, a.nbytes) for a in arrs]
        rc = self._lib.ptpu_ring_push_gather(self._h, srcs, lens, n,
                                             tag, timeout_ms)
        if rc != 0:
            with self._meta_lock:
                self._meta.pop(tag, None)
        return rc

    def pop(self, timeout_ms: int = -1):
        """``(list_of_array_views, tag)``, or ``None`` once closed and
        drained; raises ``TimeoutError`` after ``timeout_ms`` (-1: wait
        until an item or close).  The views alias native memory that the
        next ``pop`` recycles."""
        with self._pop_lock:
            if self._pending_release is not None:
                self._lib.ptpu_ring_release(self._h, self._pending_release)
                self._pending_release = None
            ptr = ctypes.c_void_p()
            ln = ctypes.c_uint64()
            tag = ctypes.c_uint64()
            rc = self._lib.ptpu_ring_pop(self._h, ctypes.byref(ptr),
                                         ctypes.byref(ln),
                                         ctypes.byref(tag), timeout_ms)
            if rc == self.CLOSED:
                return None
            if rc == self.TIMEOUT:
                raise TimeoutError("DataRing.pop timed out")
            with self._meta_lock:
                meta = self._meta.pop(int(tag.value))
            buf = (ctypes.c_char * ln.value).from_address(ptr.value)
            flat = np.frombuffer(buf, dtype=np.uint8)
            views, off = [], 0
            for shape, dtype, nbytes in meta:
                views.append(
                    flat[off:off + nbytes].view(dtype).reshape(shape))
                off += nbytes
            self._pending_release = ptr.value
            return views, int(tag.value)

    def close(self):
        self._lib.ptpu_ring_close(self._h)

    def size(self) -> int:
        return self._lib.ptpu_ring_size(self._h)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 8)()
        self._lib.ptpu_ring_stats(self._h, out)
        keys = ("pushed", "popped", "reserved", "in_use", "peak_in_use",
                "alloc_count", "grow_count", "free_count")
        return dict(zip(keys, [int(v) for v in out]))

    def destroy(self):
        """Close and free.  Safe under a live producer: the handle is
        erased (its later calls fail as closed) and the native object is
        parked with its queued slabs released."""
        if self._h:
            if self._pending_release is not None:
                self._lib.ptpu_ring_release(self._h, self._pending_release)
                self._pending_release = None
            self._lib.ptpu_ring_destroy(self._h)
            self._h = 0

    def __del__(self):  # pragma: no cover
        try:
            self.destroy()
        except Exception:
            pass

