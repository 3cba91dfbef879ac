"""Continuous-batching GPT serving, in PyTorch: the counterpart of
``paddle_tpu/inference/serving.py`` limited to its single-device engines.

* :class:`Request` and :class:`ServingQueueFull` as in the reference.
* :class:`ServingEngine`: the slot-contiguous engine.  Its KV pool is one
  [L, slots, max_len, nh, hd] strip a slot (``gpt.init_slot_cache``);
  admission runs in waves of one seq bucket padded to the batch ladder
  (one ``forward_cached`` a wave, each row scattered into its slot in
  row order), and every iteration decodes every slot
  (``gpt.decode_step_slots``).
* :class:`PagedServingEngine`: wave admission into pages
  (``inference/kv_pager.py``), one padded ``forward_cached`` per
  admission wave followed by one page scatter, one
  ``decode_step_paged`` per iteration for every slot, shared-prefix pages
  with copy-on-write, and preemption of the newest request when the pool
  runs out of pages.  With ``prefill_chunk`` prompts longer than a chunk
  are admitted in chunks (``forward_paged_chunk``), one chunk an engine
  iteration, so in-flight decodes advance between chunks.
* ``inference/speculative.py`` builds :class:`SpeculativeServingEngine`
  on the paged engine: its decode step is a verify of a drafted window.
* Quantized serving, as in the reference: ``quant="int8"`` stores the
  block matmul weights as int8 with per-output-channel scales (their
  matmuls launch the dequant-matmul kernel), and ``kv_dtype="int8"``
  (paged engine) keeps the page pool in int8 with per-position, per-head
  scales (decode attention launches the int8 paged-attention kernel).
  The two knobs are independent.

The JAX engines compile one executable per prefill rung (batch, seq),
one for the chunk and one for the decode step, counted by
``prefill_compiles`` and ``decode_compiles``.  Here each is one step
object (:class:`_GraphStep`), built once and counted the same way: static
device inputs fed from one pinned staging array, and on the card one CUDA
graph of the eager step, captured at its first call and replayed at every
later one.  ``warmup()`` builds every rung the ladder can reach, the chunk
step and the decode step, so traffic captures nothing; it returns the
prefill steps it built, as the reference returns the prefill executables
it compiled.  An engine's prefill graphs share one memory pool.  A failed
capture raises; there is no eager mode on the card.  Copy-on-write page
copies stay eager, on the same stream, ordered before the replays.  The
host-side numpy mirrors (``_lens``, ``_tables_np``, ``_active``) stay the
scheduling authority, exactly as in the reference.
Decoding is greedy: the parity contract is token-exactness with
``models.gpt.generate``.  The telemetry registry, tracing and fault
injection of the reference are not part of this slice; :meth:`stats`
returns the engine's own counts.
"""
from __future__ import annotations

import collections
import math
import time
import uuid
import weakref

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models import gpt
from ..ops.cuda import counters, dequant_matmul, paged_attn
from . import export
from .kv_pager import KVPager, PagesExhausted

DEFAULT_BATCH_BUCKETS = (1, 2, 4)

_COUNTERS = ("prefill_calls", "decode_steps", "requests_admitted",
             "requests_completed", "tokens_generated", "queue_rejects",
             "step_aborts", "requests_aborted",
             "prefix_page_hits", "prefix_page_misses", "cow_copies",
             "preemptions", "prefill_chunks",
             # quantized serving: quantized matmuls run (4 per layer per
             # forward), KV bytes the int8 pool saves against the same
             # pool in the compute dtype (counted once), and this
             # engine's launches of the dequant-matmul and int8
             # paged-attention kernels (the reference counts once per
             # compiled executable; eager PyTorch has none, so the port
             # counts launches, 0 on the CPU)
             "quant_matmuls", "kv_quant_bytes_saved",
             "dequant_kernel_calls",
             # builds of the engine's step objects (one CUDA graph
             # capture each on the card), as the reference counts its
             # executables: a prefill step per (batch, seq) rung and one
             # for the chunk; the decode step, 1 per engine
             "prefill_compiles", "decode_compiles",
             # speculative decoding (zero on the other engines): draft
             # candidates proposed, accepted and rejected by the verify,
             # verify steps, and builds of the draft model's steps
             "drafted_tokens", "accepted_tokens", "rejected_tokens",
             "spec_steps", "spec_draft_compiles")

# traffic counters a warmup wave must not inflate
_WARMUP_QUIET = frozenset(_COUNTERS) - {"queue_rejects", "step_aborts",
                                        "requests_aborted",
                                        "kv_quant_bytes_saved",
                                        "prefill_compiles",
                                        "decode_compiles",
                                        "spec_draft_compiles"}

# every live engine, for profiler.serving_stats
_engines = weakref.WeakSet()


def serving_stats():
    """The serving counters of every live engine in the process, summed,
    and the artifacts' ``standalone_compiles`` (the reference's
    ``serving`` registry family)."""
    out = dict.fromkeys(_COUNTERS, 0)
    for eng in list(_engines):
        for k, v in eng._counts.items():
            out[k] += v
    out.update(export.serving_stats())
    return out


def _pow2_ladder(lo, hi):
    """lo, 2lo, 4lo, ... capped at (and always including) hi."""
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class _GraphStep:
    """One engine step over static device buffers, built once per engine.

    * Static device inputs: one int32 buffer holds the step's fields
      (``fields``: (name, shape) pairs) as views (``_args``).  One staging
      array of the same layout (pinned on the card) holds the host's
      values: the engine writes them into its numpy views (the attributes
      the fields name) and one non-blocking copy moves them a call.
      Rewriting the staging array is safe once the step that read it has
      synced; a step launched again before a sync stages from a fresh
      pinned copy (``fresh``), which the caching host allocator keeps
      until its copy has run.
    * :meth:`_run` (each subclass's) returns the step's device outputs.
    * On the card the first call runs :meth:`_run` over the static buffers
      on a side stream (the warm-up PyTorch's CUDA-graph notes ask for,
      which also builds the kernels, sets their attributes and grows their
      workspaces) and returns its result; the step is then captured into
      one CUDA graph (``captures``), and every later call replays it.
      Capture executes nothing, so its increments of the kernel modules'
      launch counters are taken back, and each replay adds them again:
      the launch counts read as if the step ran eagerly.  The graph keeps
      the workspace and ticket tensors it baked, and the step keeps its
      outputs (``_out``).  A failure to capture raises.  On the CPU the
      same buffers feed the eager step, with no capture.
    * ``shared_pool``: the graph takes its memory from the engine's one
      prefill pool (:meth:`ServingEngine._prefill_pool`), which all its
      prefill steps share; they run one at a time on one stream, and each
      keeps its outputs, so no replay reuses another step's outputs.
    * The tensors the step reads and writes (the pools) are baked into
      the graph, so the engine zeroes them in place on an abort instead
      of reallocating them."""

    def __init__(self, eng, fields, shared_pool=False):
        self._eng = eng
        self.device = dev = eng.device
        self._cuda = dev.type == "cuda"
        sizes = [math.prod(shape) for _, shape in fields]
        self._stage = torch.zeros(sum(sizes), dtype=torch.int32,
                                  pin_memory=self._cuda)
        self._in = torch.zeros(sum(sizes), dtype=torch.int32, device=dev)
        h = self._stage.numpy()
        args, off = [], 0
        for (name, shape), n in zip(fields, sizes):
            setattr(self, name, h[off:off + n].reshape(shape))
            args.append(self._in[off:off + n].view(shape))
            off += n
        self._args = tuple(args)
        self.captures = 0
        self._graph = None
        self._out = None
        self._delta = None
        self._held = ()
        self._pool = None
        if self._cuda:
            self._side = torch.cuda.Stream(dev)
            self._done = torch.cuda.Event()
            if shared_pool:
                self._pool = eng._prefill_pool()

    def _run(self):
        raise NotImplementedError

    def _first(self):
        """The first call on the card: the eager step on the side stream,
        then the capture (which executes nothing).  Returns the eager
        step's outputs."""
        out, self._graph, self._out, self._delta, self._held = \
            counters.capture(self._run, self.device, self._side, self._pool)
        self.captures += 1
        return out

    def _launch(self, fresh=False, before=None):
        """The staged values copied in, then ``before(*args)`` (device work
        on the inputs, such as drafts written into them), then the step
        (a replay once captured).  Returns its device outputs; nothing
        waits for them."""
        src = self._stage
        if fresh and self._cuda:
            src = torch.empty(src.shape, dtype=src.dtype,
                              pin_memory=True).copy_(src)
        self._in.copy_(src, non_blocking=True)
        if before is not None:
            before(*self._args)
        if self._graph is not None:
            self._graph.replay()
            counters.add_launch_counts(self._delta)
            return self._out
        if self._cuda:
            return self._first()
        return self._run()

    def _sync(self):
        """Wait for the work queued so far (the readback's sync point)."""
        if self._cuda:
            self._done.record(torch.cuda.current_stream(self.device))
            self._done.synchronize()


class _SampleStep(_GraphStep):
    """A step whose outputs are greedy tokens [rows] and their logits
    [rows, V] fp32: the decode steps (a row a slot) and the prefill steps
    (a row a wave row; one for a chunk).  A call stages, launches, and
    reads the tokens back through a pinned host buffer after one event
    sync, the step's one sync point."""

    def __init__(self, eng, fields, rows, shared_pool=False):
        super().__init__(eng, fields, shared_pool)
        self._next = torch.zeros(rows, dtype=torch.int64,
                                 pin_memory=self._cuda)
        self.logits = None          # [rows, V] fp32 on the device, last call

    @torch.inference_mode()
    def __call__(self):
        """One step over the staged values: (tokens [rows] int64, logits
        [rows, V] fp32 numpy or None without ``capture_logits``)."""
        nxt, self.logits = self._launch()
        self._next.copy_(nxt, non_blocking=True)
        self._sync()
        logits = (self.logits.cpu().numpy() if self._eng.capture_logits
                  else None)
        return self._next.numpy().copy(), logits


class _DecodeStep(_SampleStep):
    """A paged engine's decode step, built once (``decode_compiles``): its
    inputs are the page table [S, maxP], the write pages, the write
    offsets, the lens and the last tokens (:attr:`tables`,
    :attr:`wpages`, :attr:`woffs`, :attr:`lens`, :attr:`toks`); its
    outputs the next tokens (argmax) and the logits."""

    def __init__(self, eng):
        S, maxP = eng.slots, eng._pages_per_slot
        super().__init__(eng, (("tables", (S, maxP)), ("wpages", (S,)),
                               ("woffs", (S,)), ("lens", (S,)),
                               ("toks", (S,))), S)

    def _run(self):
        """The eager step over the static inputs: (next tokens, logits)."""
        eng = self._eng
        table, wp, wo, lens, toks = self._args
        if eng._kv_quant:
            logits, *_ = gpt.decode_step_paged_quant(
                eng.params, toks, eng.cfg, eng._cache_k, eng._cache_ks,
                eng._cache_v, eng._cache_vs, table, wp, wo, lens)
        else:
            logits, *_ = gpt.decode_step_paged(
                eng.params, toks, eng.cfg, eng._cache_k, eng._cache_v,
                table, wp, wo, lens)
        return torch.argmax(logits, -1), logits


class _SlotDecodeStep(_SampleStep):
    """The slot engine's decode step, built once (``decode_compiles``):
    ``gpt.decode_step_slots`` over the slot pool, its inputs the lens, the
    last tokens and the active flags (:attr:`lens`, :attr:`toks`,
    :attr:`active`) [S]."""

    def __init__(self, eng):
        S = eng.slots
        super().__init__(eng, (("lens", (S,)), ("toks", (S,)),
                               ("active", (S,))), S)

    def _run(self):
        eng = self._eng
        lens, toks, active = self._args
        cache = {"k": eng._cache_k, "v": eng._cache_v, "len": lens}
        logits, _ = gpt.decode_step_slots(eng.params, toks, eng.cfg, cache,
                                          active != 0)
        return torch.argmax(logits, -1), logits


class _WaveStep(_SampleStep):
    """One prefill wave rung (batch ``b``, seq ``s``), built the first
    time the rung is used (``prefill_compiles``) and kept by the engine:
    the engine's ``_prefill`` over the static inputs its
    ``_wave_fields(b, s)`` name (the tokens [b, s], the lens [b] and the
    page table rows [b, s / ps] or the slot ids [b]).  Its outputs are
    each row's first sampled token and the logits at its last prompt
    position."""

    def __init__(self, eng, b, s):
        super().__init__(eng, eng._wave_fields(b, s), b, shared_pool=True)

    def _run(self):
        return self._eng._prefill(*self._args)


class _ChunkStep(_SampleStep):
    """A paged engine's prefill chunk, one step for every chunk of every
    prompt (``prefill_compiles``): the engine's ``_chunk`` over the
    static chunk tokens [1, C], the slot's table row and held-page flags
    [maxP], the chunk's offset [1] and its real token count [1]
    (:attr:`toks`, :attr:`row`, :attr:`held`, :attr:`offset`,
    :attr:`take`).  Outputs the sampled token [1] and the logits of the
    chunk's last real position [1, V]."""

    def __init__(self, eng):
        C, maxP = eng._prefill_chunk, eng._pages_per_slot
        super().__init__(eng, (("toks", (1, C)), ("row", (maxP,)),
                               ("held", (maxP,)), ("offset", (1,)),
                               ("take", (1,))), 1, shared_pool=True)

    def _run(self):
        return self._eng._chunk(*self._args)


class ServingQueueFull(RuntimeError):
    """submit() back-pressure: the bounded admission queue is at
    ``max_queue``; callers retry or shed."""


class Request:
    """One generation request's lifecycle record.  ``id`` is stable
    (client-suppliable, a uuid4 hex otherwise)."""

    def __init__(self, prompt, max_new_tokens, eos_token=None,
                 request_id=None):
        self.id = request_id if request_id is not None else uuid.uuid4().hex
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.eos_token = eos_token
        self.tokens = []            # generated ids (python ints)
        self.logits = None          # per-token [V] rows when captured
        self.slot = None
        self.preemptions = 0        # page-exhaustion evictions survived
        # the speculative engine's committed tokens its draft model has
        # not ingested yet (None until the engine activates the row; a
        # retry starts from the prompt, so it is scrubbed)
        self.pending_draft = None
        self.done = False
        self.failed = False         # aborted mid-step; re-queueable
        self.error = None
        self.finish_reason = None   # "length" | "eos"
        self.submit_t = time.perf_counter()
        self.finish_t = None

    @property
    def output(self):
        """prompt + generated ids as one int32 array."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def latency(self):
        return (self.finish_t - self.submit_t) if self.done else None

    def reset_for_retry(self):
        """Scrub generation state so the same Request can be re-queued from
        its prompt; greedy decoding makes the retry token-exact.
        ``preemptions`` survives on purpose."""
        self.tokens = []
        self.logits = None
        self.slot = None
        self.pending_draft = None
        self.done = False
        self.failed = False
        self.error = None
        self.finish_reason = None
        self.finish_t = None
        return self


class ServingEngine:
    """Continuous-batching greedy decoder over a slot-contiguous KV pool,
    and the scheduling half of :class:`PagedServingEngine`.

    ``model``: a ``(params, cfg)`` pair of the port's GPT params and
    config.  ``device`` (default ``"cuda"``) is where params and KV pool
    live; with no GPU the default raises.  Knobs as in the reference:
    ``slots`` (the decode batch), ``max_len`` (a slot's KV capacity:
    prompt + new tokens fit in it), ``seq_buckets`` / ``batch_buckets``
    (the prefill padding ladder: at most ``len(seq_buckets) *
    len(batch_buckets)`` wave steps), ``max_queue`` (default
    ``8 * slots``; past it :meth:`submit` raises
    :class:`ServingQueueFull`), ``capture_logits``, ``cache_dtype`` and
    ``quant``.

    ``quant`` (``"int8"``, ``"int8_dynamic"`` or ``"fp8"``): the params
    are quantized once here (``models.gpt.quantize_params``: the block
    matmul weights in 1 byte with fp32 per-output-channel scales) and
    then prepared; the engine keeps no float copy of those weights.  A
    tree already quantized for the mode (loaded from the reference's npz)
    is kept as it is.  Only ``"int8"`` launches the dequant-matmul kernel;
    ``"int8_dynamic"`` multiplies int8 by int8 with ``torch._int_mm`` and
    ``"fp8"`` dequantizes in plain PyTorch, as the reference, which has no
    kernel for either, does with XLA.

    The slot decode attends through ``gpt._slot_block``'s plain math over
    ``max_len`` positions a slot, as the reference's does (it has no
    kernel there).  ``tp``/``pp`` are not in this slice and raise
    ``NotImplementedError``."""

    def __init__(self, model, *, device=DEFAULT_DEVICE, slots=4,
                 max_len=None, seq_buckets=None,
                 batch_buckets=DEFAULT_BATCH_BUCKETS, max_queue=None,
                 capture_logits=False, cache_dtype=None, quant=None,
                 tp=None, pp=None):
        if quant is not None and quant not in gpt.QUANT_MODES:
            raise ValueError(f"unknown quant mode {quant!r}; expected one "
                             f"of {gpt.QUANT_MODES}")
        for name, v in (("tp", tp), ("pp", pp)):
            if v is not None and int(v) != 1:
                raise NotImplementedError(
                    f"{name}={v}: sharded serving is not ported in this "
                    "slice")
        params, cfg = model
        self.device = resolve_device(device)
        self.cfg = cfg
        self.quant = quant
        self._kv_dtype = None
        params = _to_device(params, self.device)
        if quant is not None:
            params = gpt.quantize_params(params, quant)
        self.params = gpt.prepare_params(params, cfg)
        del params

        self.slots = int(slots)
        self.max_len = int(max_len or cfg.max_seq_len)
        if self.max_len > cfg.max_seq_len:
            raise ValueError(f"max_len {self.max_len} exceeds "
                             f"cfg.max_seq_len {cfg.max_seq_len}")
        if seq_buckets is None:
            seq_buckets = _pow2_ladder(min(16, self.max_len), self.max_len)
        self.seq_buckets = tuple(sorted(int(s) for s in seq_buckets))
        if self.seq_buckets[-1] > self.max_len:
            raise ValueError(f"seq bucket {self.seq_buckets[-1]} exceeds "
                             f"max_len {self.max_len}")
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
        self.max_queue = int(max_queue if max_queue is not None
                             else 8 * self.slots)
        self.capture_logits = bool(capture_logits)
        # speculative decoding's identity (the speculative engine sets it)
        self.spec_mode = None
        self.spec_k = None
        self._cache_dtype = cache_dtype
        self._step = None           # the decode step, built at first use
        self._waves = {}            # (b, s) -> its _WaveStep
        self._graph_pool = None     # the prefill graphs' shared pool
        self._build_cache()
        # host-side bookkeeping mirrors: authoritative for scheduling
        self._lens = np.zeros((self.slots,), np.int32)
        self._active = np.zeros((self.slots,), bool)
        self._last_tok = np.zeros((self.slots,), np.int32)
        self._slot_req = [None] * self.slots
        self._queue = collections.deque()
        self._counts = {k: 0 for k in _COUNTERS}
        _engines.add(self)
        self._aborted = []
        self._admitting = []
        self._finished_backlog = []
        self._tok_window = collections.deque(maxlen=64)   # (t, n) samples
        self._occ_peak = 0
        self._warming = False
        # host-clock seconds of each prefill wave and decode step (each
        # ends in the sampled-token readback, which waits for the device)
        self.prefill_s = []
        self.decode_step_s = []

    def _build_cache(self):
        cache = gpt.init_slot_cache(self.cfg, self.slots, self.max_len,
                                    dtype=self._cache_dtype,
                                    device=self.device)
        self._cache_k, self._cache_v = cache["k"], cache["v"]

    def _reset_cache(self):
        """After an abort: the pool zeroed in place (the same storage,
        which the captured steps read and write).  The steps stay
        built."""
        for pool in self._cache_operands():
            pool.zero_()

    def _cache_operands(self):
        """The KV pool arrays (the paged engine adds its int8 scales)."""
        return (self._cache_k, self._cache_v)

    def _prefill_pool(self):
        """The graph memory pool every prefill step of this engine
        captures into (made at the first capture)."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _wave_step(self, b, s):
        """The prefill step of rung (b, s), built at its first use."""
        st = self._waves.get((b, s))
        if st is None:
            st = self._waves[(b, s)] = _WaveStep(self, b, s)
            self._inc("prefill_compiles")
        return st

    # ------------------------------------------------------------- intake
    _UNSET = object()

    def submit(self, prompt, max_new_tokens=_UNSET, eos_token=_UNSET,
               request_id=_UNSET):
        """Queue one request; returns its :class:`Request`.  ``prompt`` is
        a token array (``max_new_tokens`` defaults to 16) or a prepared
        Request, whose limits travel on it.  Raises
        :class:`ServingQueueFull` past ``max_queue`` queued."""
        U = self._UNSET
        if isinstance(prompt, Request):
            if (max_new_tokens is not U or eos_token is not U
                    or request_id is not U):
                raise ValueError(
                    "submit(Request, ...) ignores per-call limits; set "
                    "max_new_tokens/eos_token/request_id on the Request")
            req = prompt
            req.submit_t = time.perf_counter()
        else:
            req = Request(prompt,
                          16 if max_new_tokens is U else max_new_tokens,
                          None if eos_token is U else eos_token,
                          None if request_id is U else request_id)
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} cache positions "
                f"(prompt {len(req.prompt)} + {req.max_new_tokens} new) "
                f"> max_len {self.max_len}")
        self._check_prompt(req)
        if self._queued_total() >= self.max_queue:
            self._inc("queue_rejects")
            raise ServingQueueFull(
                f"queue depth {self._queued_total()} at max_queue "
                f"{self.max_queue}")
        self._queue.append(req)
        return req

    def _check_prompt(self, req):
        if len(req.prompt) > self.seq_buckets[-1]:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds the largest "
                f"prefill bucket {self.seq_buckets[-1]}")

    def _seq_bucket(self, n):
        for b in self.seq_buckets:
            if n <= b:
                return b
        raise ValueError(f"no seq bucket fits prompt length {n}")

    def _batch_bucket(self, n):
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    # ----------------------------------------------------------- scheduling
    def _free_slots(self):
        return [i for i in range(self.slots) if not self._active[i]]

    def _admit(self):
        """Move queued requests into free slots, one prefill wave per
        consecutive same-seq-bucket run, padded to the batch ladder.
        Requests that finish during admission (``max_new_tokens=1``, or
        eos as the first token) land on the finished backlog."""
        while self._queue and not self._active.all():
            free = self._free_slots()
            group, sbucket = [], None
            while (self._queue and len(group) < len(free)
                   and len(group) < self.batch_buckets[-1]):
                nxt_b = self._seq_bucket(len(self._queue[0].prompt))
                if sbucket is None:
                    sbucket = nxt_b
                elif nxt_b != sbucket:
                    break           # next wave picks it up
                group.append(self._queue.popleft())
            if not group:
                break
            b = self._batch_bucket(len(group))
            st = self._wave_step(b, sbucket)
            # the pad rows come first and scatter over the scratch slot
            # free[0], which a real row then rewrites: the step writes its
            # rows in row order
            pads = b - len(group)
            st.tokens[:] = 0
            st.lens[:] = 1
            st.slot_ids[:] = free[0]
            for r, req in enumerate(group):
                req.slot = free[r]
                st.tokens[pads + r, :len(req.prompt)] = req.prompt
                st.lens[pads + r] = len(req.prompt)
                st.slot_ids[pads + r] = free[r]
            self._admitting = group
            first_np, logits_np = self._run_wave(st)
            for r, req in enumerate(group):
                s = req.slot
                self._lens[s] = len(req.prompt)
                self._active[s] = True
                self._slot_req[s] = req
                self._append_token(req, int(first_np[pads + r]),
                                   logits_np[pads + r]
                                   if logits_np is not None else None)
                self._last_tok[s] = int(first_np[pads + r])
                self._inc("requests_admitted")
            self._admitting = []
        if not self._warming:
            self._occ_peak = max(self._occ_peak, int(self._active.sum()))

    def _run_wave(self, st):
        """One staged wave through its step: (first tokens, logits or
        None) as numpy, its host time and counts recorded."""
        launched = self._kernel_launches()
        t0 = time.perf_counter()
        out = st()
        if not self._warming:
            self.prefill_s.append(time.perf_counter() - t0)
        self._inc("dequant_kernel_calls", self._kernel_launches() - launched)
        self._inc("prefill_calls")
        self._count_quant_matmuls()
        return out

    def _wave_fields(self, b, s):
        return (("tokens", (b, s)), ("lens", (b,)), ("slot_ids", (b,)))

    @torch.inference_mode()
    def _prefill(self, tokens, lens, slot_ids):
        """Causal forward over the padded prompts, then each row's K/V
        written into positions [0, s) of its slot, one row after another
        (a scatter with repeated slots has no defined winner on CUDA).
        Returns (first sampled tokens [b], logits at each row's last
        prompt position [b, V])."""
        cfg = self.cfg
        b, s = tokens.shape
        fresh = gpt.init_cache(cfg, b, s, dtype=self._cache_k.dtype,
                               device=self.device)
        logits, filled = gpt.forward_cached(self.params, tokens, cfg, fresh)
        ids = slot_ids.long()
        for pool, new in ((self._cache_k, filled["k"]),
                          (self._cache_v, filled["v"])):
            view = pool[:, :, :s]
            for r in range(b):
                view.index_copy_(1, ids[r:r + 1], new[:, r:r + 1])
        idx = (lens.long() - 1).clamp(0, s - 1)
        last = logits[torch.arange(b, device=logits.device), idx]   # [b, V]
        return torch.argmax(last, -1), last

    def _append_token(self, req, tok, logits_row):
        req.tokens.append(tok)
        if self.capture_logits:
            if req.logits is None:
                req.logits = []
            req.logits.append(np.asarray(logits_row, np.float32))
        self._inc("tokens_generated")
        if not self._warming:
            self._tok_window.append((time.perf_counter(), 1))
        if req.eos_token is not None and tok == req.eos_token:
            self._finish(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length")

    def _append_tokens(self, req, toks, logits_rows=None):
        """Append a committed window's tokens in order, stopping at the
        first that finishes the request.  Returns how many were
        appended."""
        n = 0
        for i, tok in enumerate(toks):
            self._append_token(req, int(tok),
                               logits_rows[i] if logits_rows is not None
                               else None)
            n += 1
            if req.done:
                break
        return n

    def _finish(self, req, reason):
        req.done = True
        req.finish_reason = reason
        req.finish_t = time.perf_counter()
        self._finished_backlog.append(req)
        if req.slot is not None:
            s = req.slot
            self._active[s] = False
            self._slot_req[s] = None
            gpt.reset_slots(self._lens, s)
        self._inc("requests_completed")

    # ------------------------------------------------------------- driving
    def step(self):
        """One engine iteration: admit from the queue into free slots, then
        one decode step for every slot.  Returns the requests that finished
        this iteration.  If the step raises, every in-flight request is
        aborted (slots freed, KV pool zeroed in place, requests marked
        failed and parked in :meth:`take_aborted`) and the exception
        propagates; the decode step stays built."""
        try:
            self._step_inner()
        except Exception as e:
            self._abort_inflight(e)
            raise
        return self.take_finished()

    def take_finished(self):
        out, self._finished_backlog = self._finished_backlog, []
        return out

    def _abort_inflight(self, err):
        aborted = [r for r in self._slot_req if r is not None]
        aborted += [r for r in self._admitting
                    if r not in aborted and not r.done]
        self._admitting = []
        detail = f"{type(err).__name__}: {err}"
        for req in aborted:
            req.failed = True
            req.error = detail
            req.slot = None
        self._active[:] = False
        self._lens[:] = 0
        self._slot_req = [None] * self.slots
        self._reset_cache()
        if aborted:
            self._inc("step_aborts")
            self._inc("requests_aborted", len(aborted))
            self._aborted.extend(aborted)
        return aborted

    def take_aborted(self):
        """Drain the requests aborted by failed steps (each can be
        ``reset_for_retry()`` and re-submitted)."""
        out, self._aborted = self._aborted, []
        return out

    def _step_inner(self):
        self._admit()
        if not self._active.any():
            return
        t0 = time.perf_counter()
        nxt_np, logits_np = self._decode()
        if not self._warming:
            self.decode_step_s.append(time.perf_counter() - t0)
        self._take_decoded(nxt_np, logits_np)

    @torch.inference_mode()
    def _decode(self):
        """One decode step through the engine's :class:`_SlotDecodeStep`
        (built at the first call): the host mirrors staged, then one
        copy, the step (a graph replay on the card) and the readback.
        Returns (next tokens [S], logits [S, V] or None) as numpy."""
        if self._step is None:
            self._step = _SlotDecodeStep(self)
            self._inc("decode_compiles")
        st = self._step
        st.lens[:] = self._lens
        st.toks[:] = self._last_tok
        st.active[:] = self._active
        launched = self._kernel_launches()
        out = st()
        self._inc("dequant_kernel_calls", self._kernel_launches() - launched)
        return out

    def _take_decoded(self, nxt_np, logits_np):
        """Every active slot takes its decoded token."""
        self._inc("decode_steps")
        self._count_quant_matmuls()
        for s in range(self.slots):
            if not self._active[s]:
                continue
            req = self._slot_req[s]
            self._lens[s] += 1
            self._append_token(req, int(nxt_np[s]),
                               logits_np[s] if logits_np is not None
                               else None)
            self._last_tok[s] = int(nxt_np[s])

    def _tps_value(self):
        if len(self._tok_window) < 2:
            return 0.0
        t0 = self._tok_window[0][0]
        t1 = self._tok_window[-1][0]
        if t1 <= t0:
            return 0.0
        return sum(c for _, c in self._tok_window) / (t1 - t0)

    def _queued_total(self):
        return len(self._queue)

    def _busy(self):
        return bool(self._queue) or bool(self._active.any())

    def run(self, max_steps=None):
        """Drive :meth:`step` until the queue and every slot drain.
        Returns all requests finished during the run."""
        out = []
        steps = 0
        while self._busy():
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out

    def warmup(self, max_new_tokens=2):
        """Run one wave of dummy requests for every (batch, seq) rung of
        the prefill ladder, plus decode steps, before taking traffic: every
        reachable rung's wave step and the decode step are built (captured
        on the card), so traffic builds nothing, and the first real
        requests do not pay first-call costs (kernel builds and loads,
        cuBLAS and allocator set-up).  The synthetic waves are kept out of
        the traffic counters.  Returns the number of prefill steps built
        (``prefill_compiles``' rise), as the reference returns the prefill
        executables it compiled."""
        before = self._counts["prefill_compiles"]
        self._warming = True
        real_max_queue = self.max_queue
        self.max_queue = max(real_max_queue, self.slots,
                             self.batch_buckets[-1])
        try:
            lo = 1                  # smallest prompt length in this rung
            for s in self.seq_buckets:
                mnt = min(max_new_tokens, self.max_len - lo)
                if mnt < 1:
                    continue        # rung unreachable by any admission
                n = self._warmup_wave_len(lo, s, mnt)
                lo = s + 1
                if n is None:
                    continue        # rung unreachable by a wave
                prev = 0
                for b in self.batch_buckets:
                    wave = prev + 1     # smallest group that pads to b
                    prev = b
                    if wave > self.slots:
                        continue
                    for _ in range(wave):
                        self.submit(np.ones((n,), np.int32), mnt)
                    self.run()
        finally:
            self._warming = False
            self.max_queue = real_max_queue
        return self._counts["prefill_compiles"] - before

    def _warmup_wave_len(self, lo, s, mnt):
        """Warmup prompt length that lands in rung ``s`` (whose shortest
        admissible prompt is ``lo``), or None if no wave reaches it."""
        return min(s, self.max_len - mnt)

    def generate(self, prompts, max_new_tokens=16, eos_token=None):
        """Batch convenience: submit every prompt, run to drain, return the
        generated-token lists in submission order."""
        reqs = []
        for p in prompts:
            while len(self._queue) >= self.max_queue and self._busy():
                self.step()
            reqs.append(self.submit(p, max_new_tokens, eos_token))
        self.run()
        return [r.tokens for r in reqs]

    # --------------------------------------------------------------- views
    def _inc(self, key, v=1):
        if self._warming and key in _WARMUP_QUIET:
            return
        self._counts[key] += v

    def stats(self):
        """This engine's counts plus live gauges, one dict."""
        out = dict(self._counts)
        out["queue_depth"] = self._queued_total()
        out["slot_occupancy"] = int(self._active.sum())
        out["slot_occupancy_peak"] = self._occ_peak
        out["tokens_per_s"] = self._tps_value()
        out["quant"] = self.quant
        out["kv_dtype"] = self._kv_dtype
        out["spec_mode"] = self.spec_mode
        out["tp"] = 1
        out["pp"] = 1
        out.update(self._kv_accounting())
        return out

    def _kv_accounting(self):
        """A slot-contiguous pool reserves its whole footprint, filled or
        not (what the paged engine's accounting shrinks)."""
        return {"kv_bytes_reserved": sum(int(a.nbytes)
                                         for a in self._cache_operands()),
                "kv_tokens_held": int(self._lens.sum())}

    def _count_quant_matmuls(self):
        """One forward runs 4 quantized matmuls per layer (qkv, proj, fc1,
        fc2) when the weights are quantized."""
        if self.quant:
            self._inc("quant_matmuls", 4 * self.cfg.num_layers)

    @staticmethod
    def _kernel_launches():
        """Launches so far of the two quantized-path kernels."""
        return dequant_matmul.launches + paged_attn.quant_launches


class PagedServingEngine(ServingEngine):
    """Continuous batching over a block-table paged KV cache:
    ``num_pages`` pages of ``page_size`` tokens (page 0 is scratch) and a
    page table per slot (``inference/kv_pager.py``), so a request pins KV
    memory in proportion to its length.  With ``prefix_cache`` (default)
    prompt pages are content-hashed and shared between requests with the
    same prefix; a diverging append copies the page first (copy-on-write).
    When the pool runs out, the newest request is preempted back to the
    queue head and retried from its prompt.

    ``max_len`` must be a multiple of ``page_size``; seq buckets are
    rounded up to page multiples.  ``kv_dtype="int8"`` keeps the pool in
    int8 with fp32 scales per position and head (K/V quantized once, on
    write; excludes ``cache_dtype``).

    ``prefill_chunk`` (rounded up to a page multiple; at most the largest
    seq bucket; it must divide ``max_len``): prompts longer than it are
    admitted in chunks, one chunk an engine iteration
    (``gpt.forward_paged_chunk`` on the slot's full page table, through
    the engine's one :class:`_ChunkStep`), so in-flight decodes advance
    between chunks.  Their fresh pages enter the prefix cache as each
    chunk lands.

    Not in this slice, each raising ``NotImplementedError``:
    ``host_tier_mb``, ``kv_handoff`` (and ``submit_prefilled``), MoE
    models and ``tp``/``pp``."""

    def __init__(self, model, *, page_size=16, num_pages=None,
                 prefix_cache=True, prefill_chunk=None, kv_dtype=None,
                 kv_handoff=False, host_tier_mb=None, **kw):
        for name, v in (("host_tier_mb", host_tier_mb or None),
                        ("kv_handoff", kv_handoff or None)):
            if v is not None:
                raise NotImplementedError(
                    f"{name}={v!r} is not ported in this slice")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None (compute dtype) or 'int8', got "
                f"{kv_dtype!r}; float overrides go through cache_dtype")
        if kv_dtype == "int8" and kw.get("cache_dtype") is not None:
            raise ValueError(
                "kv_dtype='int8' and cache_dtype are mutually exclusive: "
                "the int8 pool's storage is fixed (int8 pages + fp32 "
                "scales); drop cache_dtype")
        self._kv_quant = kv_dtype == "int8"
        self._kv_saved = None
        cfg = model[1]
        if cfg.moe_experts:
            raise NotImplementedError(
                "MoE serving (moe_experts > 0) is not ported in this slice")
        self._page_size = int(page_size)
        if self._page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self._num_pages_cfg = None if num_pages is None else int(num_pages)
        self._prefix_cache_on = bool(prefix_cache)
        self._admit_seq = 0
        self._prefill_chunk = None          # set once buckets are known
        self._chunk_jobs = collections.deque()
        self._chunk_slots = set()
        self._chunk_step = None             # built at the first chunk
        # host-clock seconds of each prefill chunk (ending in its
        # sampled-token readback)
        self.chunk_s = []
        super().__init__(model, **kw)
        self._kv_dtype = kv_dtype
        if self._kv_saved:
            self._inc("kv_quant_bytes_saved", self._kv_saved)
        ps = self._page_size
        # the page view is maxP*ps == max_len wide, the same mask width as
        # a contiguous strip; buckets round up to whole pages
        self.seq_buckets = tuple(sorted(
            {min(-(-b // ps) * ps, self.max_len) for b in self.seq_buckets}))
        if prefill_chunk is not None:
            c = -(-int(prefill_chunk) // ps) * ps
            if c > self.seq_buckets[-1]:
                raise ValueError(
                    f"prefill_chunk {c} exceeds the largest prefill bucket "
                    f"{self.seq_buckets[-1]}: prompts between them would "
                    "be unserveable")
            if self.max_len % c:
                raise ValueError(
                    f"prefill_chunk {c} must divide max_len {self.max_len}"
                    " (a chunk past the page view would be cut)")
            self._prefill_chunk = c

    def submit_prefilled(self, req, first_token, kv_arrays):
        raise NotImplementedError(
            "submit_prefilled (prefill/decode KV handoff) is not ported in "
            "this slice")

    # ------------------------------------------------------------ plumbing
    def _build_cache(self):
        ps = self._page_size
        if self.max_len % ps:
            raise ValueError(
                f"max_len {self.max_len} must be a multiple of "
                f"page_size {ps}")
        self._pages_per_slot = self.max_len // ps
        self._num_pages = int(self._num_pages_cfg
                              if self._num_pages_cfg is not None
                              else self.slots * self._pages_per_slot + 1)
        self._pager = self._new_pager()
        if self._kv_quant:
            cache = gpt.init_paged_cache_quant(self.cfg, self._num_pages,
                                               ps, device=self.device)
            self._cache_ks = cache["k_scale"]
            self._cache_vs = cache["v_scale"]
            # bytes saved against the same pool in the compute dtype
            fp = 2 * cache["k"].numel() * (torch.finfo(
                gpt.torch_dtype(self.cfg.dtype)).bits // 8)
            self._kv_saved = max(0, fp - sum(
                int(a.nbytes) for a in cache.values()))
        else:
            cache = gpt.init_paged_cache(self.cfg, self._num_pages, ps,
                                         dtype=self._cache_dtype,
                                         device=self.device)
        self._cache_k, self._cache_v = cache["k"], cache["v"]
        self._tables_np = np.zeros((self.slots, self._pages_per_slot),
                                   np.int32)

    def _new_pager(self):
        # prefix hashes are salted with the numeric contract, so an int8
        # pool's pages never alias an fp pool's
        return KVPager(
            self._num_pages, self._page_size, self.slots,
            prefix_cache=self._prefix_cache_on,
            hash_key=f"quant={self.quant or 'none'}"
                     f"/kv={'int8' if self._kv_quant else 'fp'}")

    def _reset_cache(self):
        """After an abort: the pool zeroed in place (the same storage, which
        the captured decode step reads and writes; page 0 stays the
        scratch page), a fresh pager and empty page tables.  The steps
        stay built."""
        super()._reset_cache()
        self._pager = self._new_pager()
        self._tables_np[:] = 0
        self._chunk_jobs.clear()
        self._chunk_slots.clear()

    def _check_prompt(self, req):
        need_pages = self._pager.pages_for(len(req.prompt)
                                           + req.max_new_tokens)
        if need_pages > self._num_pages - 1:
            raise ValueError(
                f"request needs {need_pages} KV pages but the pool only "
                f"has {self._num_pages - 1}; raise num_pages or shrink "
                "the request")
        if self._chunk_eligible(req):
            return                  # the chunked path ignores the ladder
        super()._check_prompt(req)

    def _chunk_eligible(self, req):
        return (self._prefill_chunk is not None
                and len(req.prompt) > self._prefill_chunk)

    def _free_slots(self):
        return [i for i in range(self.slots)
                if not self._active[i] and i not in self._chunk_slots]

    def _busy(self):
        return super()._busy() or bool(self._chunk_jobs)

    def _next_admit_seq(self):
        self._admit_seq += 1
        return self._admit_seq

    # ----------------------------------------------------------- admission
    def _admit(self):
        """Wave admission into pages: consecutive queued requests of one
        seq bucket form a wave; each first acquires its page table (prefix
        hits share physical pages).  Page exhaustion ends the wave; queued
        requests wait for decodes to free pages.  Long prompts go to the
        chunked path, in queue order."""
        self._intake_chunked()
        while self._queue and self._free_slots():
            if self._chunk_eligible(self._queue[0]):
                break               # the long head waits for intake
            free = self._free_slots()
            group, tables, sbucket, hits_total = [], [], None, 0
            exhausted = False
            while (self._queue and len(group) < len(free)
                   and len(group) < self.batch_buckets[-1]):
                nxt = self._queue[0]
                if self._chunk_eligible(nxt):
                    break
                nxt_b = self._seq_bucket(len(nxt.prompt))
                if sbucket is None:
                    sbucket = nxt_b
                elif nxt_b != sbucket:
                    break           # next wave picks it up
                slot = free[len(group)]
                try:
                    table, hits = self._pager.admit(slot, nxt.prompt)
                except PagesExhausted:
                    exhausted = True
                    break
                self._queue.popleft()
                nxt.slot = slot
                group.append(nxt)
                tables.append(table)
                hits_total += hits
            if not group:
                break
            self._prefill_group(group, tables, sbucket, hits_total)
            if exhausted:
                break
        if not self._warming:
            self._occ_peak = max(self._occ_peak, int(self._active.sum()))

    def _prefill_group(self, group, tables, sbucket, hits):
        ps = self._page_size
        st = self._wave_step(self._batch_bucket(len(group)), sbucket)
        st.tokens[:] = 0
        st.lens[:] = 1                          # pad rows: len 1
        st.ptab[:] = 0                          # pads: scratch
        for r, req in enumerate(group):
            st.tokens[r, :len(req.prompt)] = req.prompt
            st.lens[r] = len(req.prompt)
            st.ptab[r, :len(tables[r])] = tables[r]
        self._inc("prefix_page_hits", hits)
        self._inc("prefix_page_misses", sum(len(t) for t in tables) - hits)
        self._admitting = group
        first_np, logits_np = self._run_wave(st)
        for r, req in enumerate(group):
            s = req.slot
            self._tables_np[s] = 0
            self._tables_np[s, :len(tables[r])] = tables[r]
            self._lens[s] = len(req.prompt)
            self._active[s] = True
            self._slot_req[s] = req
            req._admit_seq = self._next_admit_seq()
            self._append_token(req, int(first_np[r]),
                               logits_np[r] if logits_np is not None
                               else None)
            self._last_tok[s] = int(first_np[r])
            self._inc("requests_admitted")
        self._admitting = []

    def _wave_fields(self, b, s):
        return (("tokens", (b, s)), ("lens", (b,)),
                ("ptab", (b, s // self._page_size)))

    @torch.inference_mode()
    def _prefill(self, tokens, lens, ptab):
        """Causal forward over the padded prompts, then one scatter of the
        filled K/V page blocks into the pool through the page tables (pad
        rows target the scratch page; shared pages receive the content
        they already hold).  Returns (first sampled tokens [b], logits at
        each row's last prompt position [b, V])."""
        cfg = self.cfg
        b, s = tokens.shape
        ps = self._page_size
        # the int8 pool's prompt K/V come out of the forward in the
        # compute dtype and are quantized on the way into the pool
        fresh = gpt.init_cache(
            cfg, b, s, dtype=None if self._kv_quant else self._cache_k.dtype,
            device=self.device)
        logits, filled = gpt.forward_cached(self.params, tokens, cfg, fresh)
        L, nh, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
        flat = ptab.reshape(-1).long()
        fk = filled["k"].reshape(L, b * (s // ps), ps, nh, hd)
        fv = filled["v"].reshape(L, b * (s // ps), ps, nh, hd)
        if self._kv_quant:
            # layer by layer: the fp32 temporaries of one layer, not all L
            for i in range(L):
                codes, scales = gpt.quantize_kv(torch.stack((fk[i], fv[i])))
                self._cache_k[i, flat] = codes[0]
                self._cache_ks[i, flat] = scales[0]
                self._cache_v[i, flat] = codes[1]
                self._cache_vs[i, flat] = scales[1]
        else:
            self._cache_k[:, flat] = fk
            self._cache_v[:, flat] = fv
        idx = (lens.long() - 1).clamp(0, s - 1)
        last = logits[torch.arange(b, device=logits.device), idx]   # [b, V]
        return torch.argmax(last, -1), last

    # ------------------------------------------------------ chunked prefill
    def _intake_chunked(self):
        """Give each long prompt at the queue head a slot and its whole
        page table; the chunks run one an engine iteration in
        :meth:`_advance_chunks`.  Fresh pages are not prefix-registered
        until their content lands, so a concurrent identical prompt never
        shares an unwritten page."""
        if self._prefill_chunk is None:
            return
        while self._queue and self._chunk_eligible(self._queue[0]):
            free = self._free_slots()
            if not free:
                return
            req = self._queue[0]
            slot = free[0]
            try:
                table, hits = self._pager.admit(slot, req.prompt,
                                                defer_register=True)
            except PagesExhausted:
                return              # decodes will free pages
            self._queue.popleft()
            req.slot = slot
            req._chunk_pos = 0
            # the prefix hits: registered already, their bytes stay
            req._chunk_held = [self._page_registered(p) for p in table]
            req._admit_seq = self._next_admit_seq()
            self._chunk_slots.add(slot)
            self._chunk_jobs.append(req)
            self._slot_req[slot] = req
            self._tables_np[slot] = 0
            self._tables_np[slot, :len(table)] = table
            self._inc("prefix_page_hits", hits)
            self._inc("prefix_page_misses", len(table) - hits)

    def _advance_chunks(self):
        """Run one prefill chunk of the oldest chunked admission: in-flight
        decodes get an iteration between every two chunks.  The final
        chunk's sampled token admits the request into the decode pool."""
        if not self._chunk_jobs:
            return
        req = self._chunk_jobs[0]
        C = self._prefill_chunk
        n = len(req.prompt)
        pos = req._chunk_pos
        take = min(C, n - pos)
        s = req.slot
        if self._chunk_step is None:
            self._chunk_step = _ChunkStep(self)
            self._inc("prefill_compiles")
        st = self._chunk_step
        st.toks[:] = 0
        st.toks[0, :take] = req.prompt[pos:pos + take]
        st.row[:] = self._tables_np[s]
        st.held[:] = 0
        st.held[:len(req._chunk_held)] = req._chunk_held
        st.offset[0] = pos
        st.take[0] = take
        launched = self._kernel_launches()
        t0 = time.perf_counter()
        tok_np, logits_np = st()
        tok = int(tok_np[0])
        row = logits_np[0] if logits_np is not None else None
        if not self._warming:
            self.chunk_s.append(time.perf_counter() - t0)
        self._inc("dequant_kernel_calls", self._kernel_launches() - launched)
        self._inc("prefill_chunks")
        self._count_quant_matmuls()
        req._chunk_pos = pos + take
        self._pager.register_prompt(s, req._chunk_pos)
        if req._chunk_pos < n:
            return                  # decode runs before the next chunk
        self._chunk_jobs.popleft()
        self._chunk_slots.discard(s)
        self._lens[s] = n
        self._active[s] = True
        self._append_token(req, tok, row)
        self._last_tok[s] = tok
        self._inc("requests_admitted")

    @torch.inference_mode()
    def _chunk(self, toks, row, held, offset, take):
        """One chunk through ``gpt.forward_paged_chunk`` (its int8 twin on
        the int8 pool) on the slot's table row from position ``offset``
        [1], leaving the ``held`` [maxP] prefix-hit pages as they are
        (their positions go to scratch page 0).  Returns (sampled token
        [1], logits of the chunk's ``take``-th position [1, V])."""
        if self._kv_quant:
            logits, *_ = gpt.forward_paged_chunk_quant(
                self.params, toks, self.cfg, self._cache_k, self._cache_ks,
                self._cache_v, self._cache_vs, row, offset, held)
        else:
            logits, *_ = gpt.forward_paged_chunk(
                self.params, toks, self.cfg, self._cache_k, self._cache_v,
                row, offset, held)
        last = logits[0].index_select(0, take.long() - 1)
        return torch.argmax(last, -1), last

    def _page_registered(self, pid):
        """Whether page ``pid`` is in the prefix cache: its content is
        frozen, sharers read it and nobody rewrites it."""
        return self._pager.prefix_cache and pid in self._pager._page_key

    # ----------------------------------------------------- page lifecycle
    def _finish(self, req, reason):
        s = req.slot
        super()._finish(req, reason)
        if s is not None:
            self._pager.release(s)
            self._tables_np[s] = 0

    def _copy_page(self, src, dst):
        """Device-side copy-on-write: duplicate page ``src`` into the
        freshly owned ``dst`` before the diverging write lands."""
        for pool in self._cache_operands():    # int8: the scale rows too
            pool[:, dst] = pool[:, src]
        self._inc("cow_copies")

    def _newest_victim(self):
        cands = [r for r in self._slot_req if r is not None and not r.done]
        if not cands:
            return None
        return max(cands, key=lambda r: getattr(r, "_admit_seq", -1))

    def _preempt(self, req, why):
        """Page-exhaustion eviction: free the victim's slot and pages,
        scrub it back to its prompt and put it at the queue head."""
        s = req.slot
        if s is not None:
            self._pager.release(s)
            self._tables_np[s] = 0
            self._active[s] = False
            self._lens[s] = 0
            self._slot_req[s] = None
            if s in self._chunk_slots:
                self._chunk_slots.discard(s)
                if req in self._chunk_jobs:
                    self._chunk_jobs.remove(req)
        req.reset_for_retry()
        req.preemptions += 1
        req.error = f"preempted: {why}"
        self._queue.appendleft(req)
        self._inc("preemptions")

    def _ensure_decode_pages(self):
        """Give every active slot a writable position for this step's
        token: a fresh tail page on a page boundary, a COW copy when the
        tail is shared.  On exhaustion, preempt the newest request and
        retry (``ensure_append`` is idempotent)."""
        ps = self._page_size
        wpages = np.zeros((self.slots,), np.int32)   # inactive -> scratch
        woffs = np.zeros((self.slots,), np.int32)
        while True:
            try:
                for s in range(self.slots):
                    if not self._active[s]:
                        wpages[s] = 0
                        woffs[s] = 0
                        continue
                    pos = int(self._lens[s])
                    pid, off, cow_src = self._pager.ensure_append(s, pos)
                    if cow_src is not None:
                        self._copy_page(cow_src, pid)
                    self._tables_np[s, pos // ps] = pid
                    wpages[s] = pid
                    woffs[s] = off
                return wpages, woffs
            except PagesExhausted as e:
                victim = self._newest_victim()
                if victim is None:
                    raise
                self._preempt(victim, str(e))

    # ------------------------------------------------------------- driving
    def _step_inner(self):
        self._admit()
        self._advance_chunks()
        if not self._active.any():
            return
        wpages, woffs = self._ensure_decode_pages()
        if not self._active.any():
            return
        t0 = time.perf_counter()
        nxt_np, logits_np = self._decode(wpages, woffs)
        if not self._warming:
            self.decode_step_s.append(time.perf_counter() - t0)
        self._take_decoded(nxt_np, logits_np)

    @torch.inference_mode()
    def _decode(self, wpages, woffs):
        """One decode step through the engine's :class:`_DecodeStep`
        (built at the first call): the host mirrors and this step's write
        coordinates staged, then one copy, the step (a graph replay on the
        card) and the readback, the decode loop's one sync point.  Returns
        (next tokens [S], logits [S, V] or None) as numpy."""
        if self._step is None:
            self._step = _DecodeStep(self)
            self._inc("decode_compiles")
        st = self._step
        st.tables[:] = self._tables_np
        st.wpages[:] = wpages
        st.woffs[:] = woffs
        st.lens[:] = self._lens
        st.toks[:] = self._last_tok
        launched = self._kernel_launches()
        out = st()
        self._inc("dequant_kernel_calls", self._kernel_launches() - launched)
        return out

    # -------------------------------------------------------------- warmup
    def _warmup_wave_len(self, lo, s, mnt):
        """Rungs only chunk-eligible prompts reach stay off the wave path;
        the others get a warmup prompt of at most ``prefill_chunk``."""
        n = super()._warmup_wave_len(lo, s, mnt)
        if self._prefill_chunk is None:
            return n
        if lo > self._prefill_chunk:
            return None             # every prompt this long chunks
        return min(n, self._prefill_chunk)

    def warmup(self, max_new_tokens=2):
        """Base ladder and decode warmup, then (with ``prefill_chunk``, and
        no chunk step yet) one synthetic prompt of two chunks, a full one
        and a tail, which builds the chunk step; the synthetic prompt
        pages are flushed from the prefix cache afterwards so they neither
        shadow real hits nor hold pages.  Returns the prefill steps built,
        the chunk's included."""
        before = self._counts["prefill_compiles"]
        super().warmup(max_new_tokens)
        c = self._prefill_chunk
        if (self._chunk_step is None and c is not None
                and c + 2 <= self.max_len):
            self._warming = True
            real_max_queue = self.max_queue
            self.max_queue = max(real_max_queue, self.slots,
                                 self.batch_buckets[-1])
            try:
                self.submit(np.ones((c + 1,), np.int32), 1)
                self.run()
            finally:
                self._warming = False
                self.max_queue = real_max_queue
        self._pager.flush_reclaimable()
        return self._counts["prefill_compiles"] - before

    # --------------------------------------------------------------- views
    def _cache_operands(self):
        """The pool arrays: (k, v), plus (k_scale, v_scale) for int8."""
        if self._kv_quant:
            return (self._cache_k, self._cache_v, self._cache_ks,
                    self._cache_vs)
        return (self._cache_k, self._cache_v)

    def _kv_accounting(self):
        """Reserved = pages actually referenced; ``page_utilization`` is
        tokens held per in-use page position (above 1.0 when prefix
        sharing packs several requests onto one page)."""
        ps = self._page_size
        # an int8 page costs its codes plus its scale rows
        total = sum(int(a.nbytes) for a in self._cache_operands())
        page_bytes = total // self._num_pages
        in_use = self._pager.pages_in_use()
        held = int(self._lens.sum()) + sum(
            int(r._chunk_pos) for r in self._chunk_jobs)
        return {"kv_bytes_reserved": int(in_use * page_bytes),
                "kv_bytes_total": total,
                "kv_tokens_held": held,
                "page_utilization": round(held / max(1, in_use * ps), 4)}

    def stats(self):
        out = super().stats()
        pg = self._pager.stats()
        for k in ("prefix_page_hits", "prefix_page_misses", "cow_copies"):
            pg.pop(k, None)    # the engine's warmup-quiet counts win
        out.update(pg)
        return out
