"""Training checkpoint and resume (counterpart of
``paddle_tpu/utils/checkpoint.py``; ref: python/paddle/distributed/fleet/
utils/fs.py, incubate/checkpoint/auto_checkpoint.py).

One directory a step holds the model, optimizer and LR-scheduler state,
the default generator's state and the step counter (and a DataLoader's
state when given), written to ``step_N.tmp`` and renamed into place, so a
write cut short is never taken for a checkpoint; keep-last-k retention and
the latest step follow an explicit save-order sequence number, not
mtimes.  The files are the port's ``paddle.save`` format.

* **Async saves** (``async_save=True``): ``save()`` copies the state's
  device tensors into pinned host memory on a side stream, which the
  current stream then waits for, so a later ``optimizer.step()`` cannot
  change what is written, and returns without a host sync; one writer
  thread waits for the copies, serializes, digests and publishes, in
  save order.  ``wait()`` drains the writes and raises their failures.
* **Digests**: each file's SHA-256 goes into ``digests.json`` and is
  checked at restore.
* **Quarantine**: a step dir that fails its digests (or fails to load)
  is renamed ``step_N.corrupt`` and restore falls back to the previous
  checkpoint in save order, with a warning.

The counters (:func:`checkpoint_stats`) live in this module, as the
port's profiler keeps its own; the reference's ``observability``
registry comes with ROADMAP Queue 1 item 12.  ``_truncate_fault`` is the
tests' injected torn write (the reference's ``ckpt_truncate`` fault):
``None``, or ``fn(step, file name) -> None | {"publish": 0 or 1}``.
"""
from __future__ import annotations

import copy
import hashlib
import json
import os
import queue
import re
import shutil
import threading
import time
import warnings

import torch

from ..framework import core
from ..io.serialization import save as _save
from ..tensor.tensor import Parameter, Tensor, host_payload

_STEP_DIR = re.compile(r"^step_(\d+)$")
_SEQ_FILE = "save_seq"    # monotonic publish-order counter (one int)
_DIGEST_FILE = "digests.json"

_ckpt_stats = {
    "async_saves": 0,            # background (non-blocking) publishes
    "sync_saves": 0,
    "digest_failures": 0,        # files whose content hash mismatched
    "checkpoints_quarantined": 0,  # dirs renamed to step_N.corrupt
    "restore_fallbacks": 0,      # restores that fell back a checkpoint
}

# the tests' injected torn write (module docstring)
_truncate_fault = None


def checkpoint_stats():
    return dict(_ckpt_stats)


def reset_checkpoint_stats():
    for k in _ckpt_stats:
        _ckpt_stats[k] = 0


def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class _Snapshot:
    """A point-in-time copy of the state's tensors.  On the card each goes
    to pinned host memory on a side stream: the stream waits for the
    work queued so far, the current stream then waits for the copies (a
    later in-place update lands after them), and the writer waits for
    ``events`` before it reads.  CPU tensors are cloned."""

    def __init__(self, streams):
        self._streams = streams         # device -> side stream
        self._pending = {}              # device -> [(host, src)]
        self.events = []

    def grab(self, v):
        if not isinstance(v, torch.Tensor):
            try:
                return copy.deepcopy(v)
            except Exception:                              # noqa: BLE001
                return v
        v = v.detach()
        if v.device.type != "cuda":
            return v.clone()
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        self._pending.setdefault(v.device, []).append((host, v))
        return host

    def launch(self):
        for dev, pairs in self._pending.items():
            side = self._streams.get(dev)
            if side is None:
                side = self._streams[dev] = torch.cuda.Stream(dev)
            cur = torch.cuda.current_stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for host, src in pairs:
                    host.copy_(src, non_blocking=True)
                    src.record_stream(side)
            ev = torch.cuda.Event()
            ev.record(side)
            cur.wait_stream(side)
            self.events.append(ev)
        self._pending = {}


def _snapshot_storable(obj, grab):
    """``io.serialization``'s storable form with the tensors ``grab``bed
    (a pinned host copy, a clone, or the live tensor)."""
    if isinstance(obj, Parameter):
        return {"__param__": grab(obj.value), "name": obj.name,
                "trainable": obj.trainable}
    if isinstance(obj, Tensor):
        return {"__tensor__": grab(obj.value), "name": obj.name}
    if isinstance(obj, dict):
        return {k: _snapshot_storable(v, grab) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot_storable(v, grab) for v in obj)
    return grab(obj)


def _materialize(obj):
    """The snapshot's tensors as host numpy (a bfloat16 payload as its raw
    bits with its dtype tag, as ``paddle.save`` writes it)."""
    if isinstance(obj, dict):
        for key in ("__param__", "__tensor__"):
            if isinstance(obj.get(key), torch.Tensor):
                arr, tag = host_payload(obj[key])
                out = dict(obj, **{key: arr})
                if tag is not None:
                    out["dtype"] = tag
                return out
        return {k: _materialize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_materialize(v) for v in obj)
    return obj


class _InjectedCheckpointCrash(RuntimeError):
    """The ckpt_truncate fault's simulated writer crash (testing only)."""


class _MissingComponent(RuntimeError):
    """restore() asked for a component the checkpoint never contained —
    a usage error that must NOT trigger quarantine (a file that was
    saved but is missing fails digest verification instead)."""


class CheckpointManager:
    """Save/restore full training state.

    >>> mgr = CheckpointManager("ckpts", keep=3, async_save=True)
    >>> mgr.save(step, model=net, optimizer=opt, scheduler=sched)
    >>> mgr.wait()                       # drain pending background saves
    >>> step = mgr.restore(model=net, optimizer=opt, scheduler=sched)
    """

    def __init__(self, root, keep=3, async_save=False):
        self.root = root
        self.keep = keep
        self.async_save = bool(async_save)
        self.last_extra = None
        os.makedirs(root, exist_ok=True)
        self._work: queue.Queue = queue.Queue()
        self._worker = None
        self._pending = 0
        self._lock = threading.Lock()
        self._errors = []
        self._seq = None               # monotonic; assigned at enqueue
        self._streams = {}             # device -> the snapshots' stream

    # ------------------------------------------------------------ helpers
    def _step_dirs(self):
        out = []
        for name in os.listdir(self.root):
            m = _STEP_DIR.match(name)
            if m and os.path.isdir(os.path.join(self.root, name)):
                out.append((int(m.group(1)), os.path.join(self.root, name)))
        return sorted(out)

    def _read_seq(self, path):
        try:
            with open(os.path.join(path, _SEQ_FILE)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _next_seq(self):
        """Monotonic publish-order counter: the max of the cached counter
        (covers queued async saves not yet on disk) and the on-disk max
        (covers other manager instances writing the same root), plus
        one."""
        seqs = [s for s in (self._read_seq(p)
                            for _, p in self._step_dirs())
                if s is not None]
        disk = max(seqs) if seqs else 0
        self._seq = max(self._seq or 0, disk) + 1
        return self._seq

    def _dirs_by_save_order(self):
        """Step dirs ordered by when they were SAVED — an explicit
        monotonic sequence number written at publish time — not by step
        number: after an operator rewinds to an earlier step and trains
        on, the new lower-numbered checkpoints are the live run — numeric
        ordering would reap them and auto-resume from the stale
        high-numbered leftovers of the abandoned run.  (Not mtime either:
        cp without -p, git checkout and object-store syncs all rewrite
        mtimes, after which that ordering is arbitrary.)  Dirs from
        before the sequence file existed sort OLDEST, by step number."""
        def key(sp):
            seq = self._read_seq(sp[1])
            return (0, sp[0]) if seq is None else (1, seq)
        return sorted(self._step_dirs(), key=key)

    def latest_step(self):
        self.wait(raise_errors=False)
        dirs = self._dirs_by_save_order()
        return dirs[-1][0] if dirs else None

    # ------------------------------------------------------------ save
    def _snapshot(self, model, optimizer, scheduler, detach):
        """Point-in-time capture of the state dicts in storable form.
        ``detach`` (async saves) copies the tensors (:class:`_Snapshot`);
        a blocking save writes before anything can change them and keeps
        the live tensors.  Returns (payload, the copies' events)."""
        snap = _Snapshot(self._streams)
        grab = snap.grab if detach else (lambda x: x)
        payload = {}
        if model is not None:
            payload["model.pdparams"] = _snapshot_storable(
                model.state_dict(), grab)
        if optimizer is not None:
            payload["opt.pdopt"] = _snapshot_storable(
                optimizer.state_dict(), grab)
        if scheduler is not None:
            payload["lr.pdstate"] = _snapshot_storable(
                scheduler.state_dict(), grab)
        snap.launch()
        return payload, snap.events

    def save(self, step, model=None, optimizer=None, scheduler=None,
             extra=None, dataloader=None, blocking=None):
        """Checkpoint the passed objects at ``step``.  With
        ``async_save`` (or ``blocking=False``) the state is snapshotted
        NOW and written/published by the background worker; the returned
        path exists only after the publish (``wait()`` to be sure)."""
        if blocking is None:
            blocking = not self.async_save
        final = os.path.join(self.root, f"step_{step}")
        seq = self._next_seq()
        state = {"step": int(step), "seq": seq,
                 "rng_state": core.default_generator().get_state()}
        if extra is not None:
            # async saves must capture extra's VALUE now — the caller
            # keeps mutating its live metrics dict while the background
            # writer serializes, and a point-in-time checkpoint must not
            # absorb a later step's bookkeeping
            state["extra"] = copy.deepcopy(extra) if not blocking else extra
        if dataloader is not None:
            state["dataloader"] = dataloader.state_dict()
        payload, events = self._snapshot(model, optimizer, scheduler,
                                         detach=not blocking)
        if blocking:
            self.wait()          # publish order: drain queued async saves
            _ckpt_stats["sync_saves"] += 1
            self._write(final, seq, state, payload)
            return final
        with self._lock:
            self._pending += 1
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._drain, name="ckpt-writer", daemon=True)
                self._worker.start()
        self._work.put((final, seq, state, payload, events))
        return final

    def _drain(self):
        while True:
            try:
                item = self._work.get(timeout=0.5)
            except queue.Empty:
                # retire only with no work pending: _pending and _worker
                # share the lock, so a save() that just incremented
                # pending either sees this thread alive or starts a new
                # one — a queued item can never be orphaned
                with self._lock:
                    if self._pending == 0:
                        self._worker = None
                        return
                continue
            final, seq, state, payload, events = item
            try:
                for ev in events:
                    ev.synchronize()
                self._write(final, seq, state, payload)
                _ckpt_stats["async_saves"] += 1
            except Exception as e:                         # noqa: BLE001
                with self._lock:
                    self._errors.append(e)
            finally:
                with self._lock:
                    self._pending -= 1

    def _write(self, final, seq, state, payload):
        """Serialize + digest + atomically publish one checkpoint.  Runs
        on the caller (blocking) or the background worker (async)."""
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _SEQ_FILE), "w") as f:
            f.write(str(seq))
        # digests are taken as each file lands, BEFORE any injected
        # truncation: the recorded hash is of the intended content, so a
        # torn write (real or injected) mismatches at verify time
        digests = {_SEQ_FILE: _sha256_file(os.path.join(tmp, _SEQ_FILE))}
        crash = None
        for name, obj in payload.items():
            path = os.path.join(tmp, name)
            _save(_materialize(obj), path)
            digests[name] = _sha256_file(path)
            fault = _truncate_fault(state["step"], name) \
                if _truncate_fault is not None else None
            if fault is not None:
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(max(size // 2, 1))
                if not int(fault.get("publish", 0)):
                    crash = _InjectedCheckpointCrash(
                        f"injected writer crash truncating {name} at "
                        f"step {state['step']}")
        meta_path = os.path.join(tmp, "meta.pdstate")
        _save(state, meta_path)
        digests["meta.pdstate"] = _sha256_file(meta_path)
        if crash is not None:
            raise crash          # tmp dir left behind, nothing published
        with open(os.path.join(tmp, _DIGEST_FILE), "w") as f:
            json.dump(digests, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._retain()

    def wait(self, raise_errors=True):
        """Block until every queued async save has published.  Background
        save failures since the last drain are all reported, never
        silently dropped: raised (a single one as itself, several as one
        summarizing error) — or, with ``raise_errors=False`` (the
        restore/latest_step drain, which must not let an unrelated failed
        SAVE block an explicit rollback), surfaced as warnings."""
        while True:
            with self._lock:
                if self._pending == 0:
                    break
            time.sleep(0.01)
        if not raise_errors:
            # read-only drain (latest_step/restore): warn once per error
            # but KEEP them queued — a later explicit wait() must still
            # raise, or the caller is told every save succeeded
            with self._lock:
                errs = self._errors[:]
            for e in errs:
                if not getattr(e, "_ckpt_warned", False):
                    e._ckpt_warned = True
                    warnings.warn(
                        f"background checkpoint save failed: "
                        f"{type(e).__name__}: {e}", RuntimeWarning,
                        stacklevel=2)
            return
        with self._lock:
            errs, self._errors = self._errors[:], []
        if not errs:
            return
        if len(errs) == 1:
            raise errs[0]
        raise RuntimeError(
            f"{len(errs)} background checkpoint saves failed: "
            + "; ".join(f"{type(e).__name__}: {e}" for e in errs)
        ) from errs[0]

    # reference-style alias (Orbax: wait_until_finished)
    wait_until_finished = wait

    def _retain(self):
        dirs = self._dirs_by_save_order()
        for _, path in dirs[:-self.keep] if self.keep else []:
            shutil.rmtree(path, ignore_errors=True)

    # ------------------------------------------------------------ restore
    def _read_digests(self, path):
        """The digests recorded at save time; {} for legacy dirs (nothing
        recorded to verify against)."""
        dpath = os.path.join(path, _DIGEST_FILE)
        if not os.path.exists(dpath):
            return {}
        with open(dpath) as f:
            return json.load(f)

    def _check_digest_file(self, fpath, want):
        if not os.path.exists(fpath):
            _ckpt_stats["digest_failures"] += 1
            raise IOError(f"checkpoint file missing: {fpath}")
        got = _sha256_file(fpath)
        if got != want:
            _ckpt_stats["digest_failures"] += 1
            raise IOError(
                f"checkpoint digest mismatch for {fpath}: "
                f"recorded {want[:12]}…, on disk {got[:12]}… — "
                "truncated or corrupted write")

    def _load_verified(self, fpath, want):
        """Read once: hash the bytes against the recorded digest (when
        one exists) and deserialize from the same buffer — restore I/O
        is paid once per file, not once for verify plus once for load."""
        import pickle
        from ..io.serialization import _from_storable
        with open(fpath, "rb") as f:
            data = f.read()
        if want is not None:
            got = hashlib.sha256(data).hexdigest()
            if got != want:
                _ckpt_stats["digest_failures"] += 1
                raise IOError(
                    f"checkpoint digest mismatch for {fpath}: "
                    f"recorded {want[:12]}…, on disk {got[:12]}… — "
                    "truncated or corrupted write")
        return _from_storable(pickle.loads(data))

    def verify(self, path):
        """Digest-check every file recorded at save time.  Raises on the
        first mismatch/missing file.  Legacy dirs (no digests.json) pass:
        there is nothing recorded to verify against."""
        for name, want in self._read_digests(path).items():
            self._check_digest_file(os.path.join(path, name), want)

    def _quarantine(self, path):
        dst = path + ".corrupt"
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{path}.corrupt{n}"
        try:
            os.rename(path, dst)
        except OSError:
            if os.path.exists(path):
                raise
            # several ranks restore the same shared root: a peer already
            # moved this dir aside — same outcome, continue the fallback
            return path + ".corrupt"
        _ckpt_stats["checkpoints_quarantined"] += 1
        return dst

    def restore(self, model=None, optimizer=None, scheduler=None, step=None,
                dataloader=None):
        """Load the given (or latest) step into the passed objects; returns
        the restored step counter, or None when no checkpoint exists.

        Crash-consistent: digests are verified and every file is loaded
        into memory BEFORE anything is applied to the passed objects — a
        corrupt dir can never leave the model half-restored.  A corrupt
        step dir is quarantined (renamed ``step_N.corrupt``) with a
        warning and restore falls back to the previous checkpoint in
        publish order."""
        self.wait(raise_errors=False)
        requested = orig_requested = step
        # when an explicitly requested step turns out corrupt, "previous"
        # means EARLIER IN PUBLISH ORDER than the requested dir — never a
        # newer checkpoint the operator was rolling back from.  The
        # candidate list is captured positionally at the first failure,
        # so it stays correct even when the corrupt dir's own save_seq
        # file is the unreadable one.
        fallback = None     # steps older than the requested, oldest-first
        while True:
            if step is None:
                if fallback is not None:
                    if not fallback:
                        # the EXPLICITLY requested step was corrupt and
                        # nothing older exists: returning None here would
                        # be indistinguishable from "no checkpoints",
                        # sending the caller into its cold-start branch
                        # over the run it was trying to rescue
                        raise RuntimeError(
                            f"requested checkpoint step_{orig_requested} "
                            "failed verification (quarantined) and no "
                            "earlier checkpoint exists to fall back to")
                    step = fallback.pop()
                else:
                    dirs = self._dirs_by_save_order()
                    if not dirs:
                        return None
                    step = dirs[-1][0]
            path = os.path.join(self.root, f"step_{step}")
            if not os.path.isdir(path):
                if requested is not None:
                    # a typo'd/reaped explicit step is a clean error,
                    # not a quarantine candidate
                    raise FileNotFoundError(
                        f"no checkpoint directory {path}; available "
                        f"steps: {[s for s, _ in self._step_dirs()]}")
                # auto/fallback candidate vanished under us (peer rank
                # quarantined or retention reaped it): try the next one
                step = None
                continue
            try:
                digests = self._read_digests(path)
                components = [("meta.pdstate", True),
                              ("model.pdparams", model),
                              ("opt.pdopt", optimizer),
                              ("lr.pdstate", scheduler)]
                loading = {n for n, obj in components if obj is not None}
                # files recorded at save time but NOT loaded below (the
                # seq file, components the caller skips) still get their
                # integrity check; loaded files are hashed from the same
                # read that deserializes them — one read per file total
                for name, want in digests.items():
                    if name not in loading:
                        self._check_digest_file(
                            os.path.join(path, name), want)
                loaded = {}
                for name, obj in components:
                    if obj is None:
                        continue
                    fpath = os.path.join(path, name)
                    if not os.path.exists(fpath):
                        if name in digests:     # saved, then lost: corrupt
                            _ckpt_stats["digest_failures"] += 1
                            raise IOError(
                                f"checkpoint file missing: {fpath}")
                        # a component this checkpoint NEVER contained
                        # (saved model-only, restored with optimizer=)
                        # is a usage error, not corruption: quarantining
                        # would cascade through every valid checkpoint
                        raise _MissingComponent(
                            f"checkpoint step_{step} was saved without "
                            f"{name}; restore only the components it "
                            "contains")
                    loaded[name] = self._load_verified(
                        fpath, digests.get(name))
                meta = loaded.pop("meta.pdstate")
            except _MissingComponent as e:
                raise FileNotFoundError(str(e)) from None
            except Exception as e:                         # noqa: BLE001
                if requested is not None and step == requested:
                    # capture the older-than-requested candidates while
                    # the failing dir is still listed (pre-quarantine)
                    order = self._dirs_by_save_order()
                    if self._read_seq(path) is not None:
                        idx = next((i for i, (s, _) in enumerate(order)
                                    if s == step), len(order))
                        fallback = [s for s, _ in order[:idx]]
                    else:
                        # the corrupt dir's own save_seq is unreadable:
                        # publish order is unknowable, so "previous"
                        # falls back to step NUMBERS below the request
                        # (the operator's rollback intent), kept in
                        # publish order among themselves
                        fallback = [s for s, _ in order if s < step]
                    requested = None
                quarantined = self._quarantine(path)
                _ckpt_stats["restore_fallbacks"] += 1
                warnings.warn(
                    f"checkpoint step_{step} failed verification "
                    f"({type(e).__name__}: {e}); quarantined to "
                    f"{quarantined} and falling back to the previous "
                    "valid checkpoint", RuntimeWarning, stacklevel=2)
                step = None
                continue
            # verified and fully in memory: now (and only now) apply
            if model is not None:
                model.set_state_dict(loaded["model.pdparams"])
            if optimizer is not None:
                optimizer.set_state_dict(loaded["opt.pdopt"])
            if scheduler is not None:
                scheduler.set_state_dict(loaded["lr.pdstate"])
            if dataloader is not None and meta.get("dataloader"):
                dataloader.set_state_dict(meta["dataloader"])
            # restore the deterministic RNG stream position exactly
            core.default_generator().set_state(meta["rng_state"])
            self.last_extra = meta.get("extra")
            return meta["step"]
