"""Speculative decoding on the paged engine, in PyTorch: the counterpart of
``paddle_tpu/inference/speculative.py``.

Each decode iteration of :class:`SpeculativeServingEngine` drafts
``spec_k`` candidate tokens a row, then one verify step scores the whole
window of ``k + 1`` positions (the last committed token and the k
candidates) in one target forward (``models.gpt.decode_step_paged_verify``
or its int8 twin), computes the longest accepted prefix and commits it:

* **one verify graph a engine.**  The verify step is the engine's one
  step object (``decode_compiles == 1``): its inputs (the window tokens,
  page table, write coordinates, lens, commit budgets, eos ids and the
  all-reject flag) are one static int32 buffer fed from a pinned staging
  array; on the card it is one CUDA graph, captured at its first call and
  replayed.  The accept length and the commit are computed inside it, and
  the step ends in one readback of the committed tokens and their count.
* **rejected tokens never reach the pool.**  The verify forward reads the
  pool only; the commit writes window lane ``j`` of a row at its page
  coordinates for ``j < n_commit`` and sends every other lane to the
  scratch page, so the pool's real pages only receive the bytes a
  sequential decode would have written (on the int8 pool, the same
  once-per-position scales).
* **token-exact greedy output.**  Accepted drafts equal the verify's own
  argmax and the bonus token is that argmax, so the committed stream is
  the non-speculative engine's.

Two drafting modes:

* ``"ngram"``: prompt lookup on the host over the row's own tokens (prompt
  and committed tokens, :func:`ngram_draft`); no device work.
* ``"draft"``: a draft GPT with its own slot cache (``2 * spec_k``
  positions deeper than the target's ``max_len``) proposes the
  candidates.  Two more step objects, counted by ``spec_draft_compiles``
  (two graphs on the card): the prompt ingestion a chunk of
  ``spec_draft_chunk`` tokens (``gpt.draft_prefill_slot``) and one step
  a iteration that catches the draft cache up on the last committed
  tokens and drafts k (``gpt.draft_catchup_and_draft``); its candidates
  stay on the device and are copied into the verify's inputs.  The
  reference draws the draft's weights with ``jax.random``; here they come
  from this package's ``gpt.init_params`` with a CPU ``torch.Generator``
  seeded ``spec_draft_seed``, so a target built the same way is its own
  draft.

Knobs (constructor arguments, with ``PADDLE_SPEC_*`` environment
fallbacks, as in the reference): ``spec_mode`` (``PADDLE_SPEC_MODE``,
default ``"ngram"``), ``spec_k`` (``PADDLE_SPEC_K``, 4),
``spec_ngram_max`` (``PADDLE_SPEC_NGRAM``, 3), ``spec_draft_cfg`` and
``spec_draft_seed`` (``PADDLE_SPEC_DRAFT_SEED``, 0).  Counters:
``drafted_tokens``, ``accepted_tokens``, ``rejected_tokens``,
``spec_steps``, ``spec_draft_compiles``; :meth:`accepted_tokens_per_step`.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..models import gpt
from .kv_pager import PagesExhausted
from .serving import PagedServingEngine, _GraphStep

__all__ = ["SpeculativeServingEngine", "ngram_draft", "accept_commit",
           "SPEC_MODES"]

SPEC_MODES = ("draft", "ngram")


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# Copied from paddle_tpu/inference/speculative.py (numpy only), unchanged.
def ngram_draft(history, k, max_ngram=3):
    """Prompt-lookup drafting: find the most recent earlier occurrence of
    the trailing ``n``-gram of ``history`` (``max_ngram`` down to 1) and
    draft the ``k`` tokens that followed it, padded with its last token
    when the match sits near the end.  No match at any n: the last token
    repeated."""
    h = np.asarray(history, np.int64).reshape(-1)
    k = int(k)
    if h.size == 0:
        return np.zeros((k,), np.int32)
    for n in range(min(int(max_ngram), h.size - 1), 0, -1):
        pat = h[-n:]
        # candidate windows live in h[:-1]: every length-n window whose
        # continuation exists and which is not the trailing n-gram itself
        win = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.nonzero((win == pat[None, :]).all(axis=1))[0]
        if hits.size:
            s = int(hits[-1])
            cont = h[s + n:s + n + k]
            out = np.empty((k,), np.int64)
            out[:cont.size] = cont
            out[cont.size:] = cont[-1]
            return out.astype(np.int32)
    return np.full((k,), int(h[-1]), np.int32)


def accept_commit(drafts, greedy, caps, eos_ids, force_reject):
    """The longest-accepted-prefix commit, on tensors (inside the verify
    graph on the card).  ``drafts`` [S, k] (window positions 1..k);
    ``greedy`` [S, k + 1] (the verify's argmax at every position);
    ``caps`` [S] (the commit budget, 0 for an inactive row); ``eos_ids``
    [S] (-1: none); ``force_reject`` (a 0-d tensor or int: accept length
    forced to 0).  Returns ``(out_toks [S, k + 1] int32, n_commit [S]
    int32)``: the committed stream is ``out_toks[s, :n_commit[s]]``, cut
    at the budget and after the first eos."""
    S, W = greedy.shape
    k = W - 1
    dev = greedy.device
    if k:
        eq = (drafts == greedy[:, :k]).to(torch.int32)
        accept = torch.cumprod(eq, 1).sum(1)
    else:
        accept = torch.zeros((S,), dtype=torch.int64, device=dev)
    accept = torch.where(torch.as_tensor(force_reject, device=dev) > 0,
                         torch.zeros_like(accept), accept)
    pos = torch.arange(W, device=dev)[None, :]
    n0 = torch.minimum(accept + 1, caps.long())
    hit = (greedy == eos_ids[:, None]) & (pos < n0[:, None])
    first = torch.where(hit, pos, W).amin(1)
    n_commit = torch.where(first < W, first + 1, n0).to(torch.int32)
    return greedy.to(torch.int32), n_commit


class _VerifyStep(_GraphStep):
    """The speculative engine's decode step (``decode_compiles``): the
    verify forward, argmax, :func:`accept_commit` and the masked commit
    into the pool, over static inputs (:attr:`toks` [S, W], :attr:`tables`,
    :attr:`wpages` / :attr:`woffs` [S, W], :attr:`lens`, :attr:`caps`,
    :attr:`eos`, :attr:`force`).  Outputs the committed tokens and their
    count [S, W + 1] (read back once, through a pinned buffer) and the
    logits [S, W, V]."""

    def __init__(self, eng):
        S, maxP, W = eng.slots, eng._pages_per_slot, eng._spec_k_val + 1
        super().__init__(eng, (("toks", (S, W)), ("tables", (S, maxP)),
                               ("wpages", (S, W)), ("woffs", (S, W)),
                               ("lens", (S,)), ("caps", (S,)),
                               ("eos", (S,)), ("force", (1,))))
        self._host = torch.zeros((S, W + 1), dtype=torch.int32,
                                 pin_memory=self._cuda)
        self.logits = None

    def _run(self):
        eng = self._eng
        toks, table, wpages, woffs, lens, caps, eos, force = self._args
        if eng._kv_quant:
            logits, *win = gpt.decode_step_paged_verify_quant(
                eng.params, toks, eng.cfg, eng._cache_k, eng._cache_ks,
                eng._cache_v, eng._cache_vs, table, lens)
            pools = (eng._cache_k, eng._cache_ks, eng._cache_v,
                     eng._cache_vs)
        else:
            logits, *win = gpt.decode_step_paged_verify(
                eng.params, toks, eng.cfg, eng._cache_k, eng._cache_v,
                table, lens)
            pools = (eng._cache_k, eng._cache_v)
        greedy = torch.argmax(logits, -1).to(torch.int32)       # [S, W]
        out, n_commit = accept_commit(toks[:, 1:], greedy, caps, eos,
                                      force[0])
        # lane j holds the K/V of the token consumed at lens + j, valid for
        # j < n_commit; every other lane goes to the scratch page
        keep = (torch.arange(toks.shape[1], device=toks.device)[None, :]
                < n_commit[:, None])
        wp = torch.where(keep, wpages, 0).long()
        wo = torch.where(keep, woffs, 0).long()
        for pool, w in zip(pools, win):
            pool[:, wp, wo] = w
        return torch.cat((out, n_commit[:, None]), 1), logits

    @torch.inference_mode()
    def __call__(self, before=None):
        """One verify over the staged values (``before`` as in
        :meth:`_launch`): (committed tokens and count [S, W + 1] numpy,
        logits [S, W, V] numpy or None without ``capture_logits``)."""
        packed, self.logits = self._launch(before=before)
        self._host.copy_(packed, non_blocking=True)
        self._sync()
        logits = (self.logits.cpu().numpy() if self._eng.capture_logits
                  else None)
        return self._host.numpy().copy(), logits


class _DraftStep(_GraphStep):
    """Draft mode's step a iteration (``gpt.draft_catchup_and_draft``)
    over static :attr:`ctx` [S, W], :attr:`n_ctx` and :attr:`lens`;
    returns the drafts [S, k] on the device, unsynced."""

    def __init__(self, eng):
        S, W = eng.slots, eng._spec_k_val + 1
        super().__init__(eng, (("ctx", (S, W)), ("n_ctx", (S,)),
                               ("lens", (S,))))

    def _run(self):
        eng = self._eng
        ctx, n_ctx, lens = self._args
        _, _, drafts = gpt.draft_catchup_and_draft(
            eng._draft_params, eng._draft_cfg, eng._draft_k, eng._draft_v,
            ctx, n_ctx, lens, eng._spec_k_val)
        return drafts

    @torch.inference_mode()
    def __call__(self):
        return self._launch()


class _DraftPrefill(_GraphStep):
    """Draft mode's prompt ingestion, one chunk a call
    (``gpt.draft_prefill_slot``) over static :attr:`toks` [1, C],
    :attr:`slot` and :attr:`offset`.  Called several times between two
    syncs, so each call stages from a fresh pinned copy."""

    def __init__(self, eng):
        super().__init__(eng, (("toks", (1, eng._draft_chunk)),
                               ("slot", (1,)), ("offset", (1,))))

    def _run(self):
        eng = self._eng
        toks, slot, offset = self._args
        gpt.draft_prefill_slot(eng._draft_params, toks, eng._draft_cfg,
                               eng._draft_k, eng._draft_v, slot, offset)
        return None

    @torch.inference_mode()
    def __call__(self):
        self._launch(fresh=True)


class SpeculativeServingEngine(PagedServingEngine):
    """:class:`~.serving.PagedServingEngine` whose decode step drafts
    ``spec_k`` candidates a row and verifies the ``k + 1`` window in one
    step (the module docstring has the contract).  Greedy output is
    token-exact with the non-speculative engine; only the number of
    target forwards a token changes.  Composes with ``prefill_chunk``,
    ``quant`` and ``kv_dtype="int8"``."""

    def __init__(self, model, *, spec_mode=None, spec_k=None,
                 spec_draft_cfg=None, spec_draft_seed=None,
                 spec_ngram_max=None, spec_draft_chunk=16, **kw):
        mode = spec_mode or os.environ.get("PADDLE_SPEC_MODE", "ngram")
        if mode not in SPEC_MODES:
            raise ValueError(
                f"spec_mode must be one of {SPEC_MODES}, got {mode!r} "
                "(no speculation: use PagedServingEngine)")
        k = int(spec_k if spec_k is not None
                else _env_int("PADDLE_SPEC_K", 4))
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        # set before the base constructor, whose _build_cache builds the
        # draft model from them
        self._spec_mode_val = mode
        self._spec_k_val = k
        self._ngram_max = int(spec_ngram_max if spec_ngram_max is not None
                              else _env_int("PADDLE_SPEC_NGRAM", 3))
        self._draft_seed = int(
            spec_draft_seed if spec_draft_seed is not None
            else _env_int("PADDLE_SPEC_DRAFT_SEED", 0))
        self._spec_draft_cfg_arg = spec_draft_cfg
        self._draft_chunk = int(spec_draft_chunk)
        self._draft_cfg = None
        self._draft_params = None
        self._draft_k = self._draft_v = None
        self._draft_step = None
        self._draft_prefill = None
        self._commit_sum = 0            # committed tokens over live traffic
        self._rowstep_sum = 0           # active rows x verify steps
        # test hook, the reference's ``spec_reject`` fault: a callable of
        # the coming decode step's number; True forces an all-reject verify
        self._spec_reject = None
        # seconds of each iteration's drafting and of the rest of its
        # step (staging, the verify, readback): the two sum to the step's
        # host time.  ngram drafting is host work, timed on the host
        # clock; the draft model's steps are queued unsynced, so on the
        # card their span on the stream is taken from CUDA events.
        self.verify_s = []
        self.draft_s = []
        super().__init__(model, **kw)
        self.spec_mode = mode
        self.spec_k = k

    # ------------------------------------------------------- draft model
    def _draft_depth(self):
        """Positions of the draft slot cache: ``2k`` past ``max_len`` (the
        catch-up step writes up to ``lens + 2k - 1``), and never short of
        the last ingestion chunk's end."""
        C = self._draft_chunk
        return max(self.max_len + 2 * self._spec_k_val,
                   -(-self.max_len // C) * C)

    def _build_draft_cfg(self):
        """The draft GPT config: the user's kwargs (or a ``GPTConfig``)
        with ``max_seq_len`` raised to the draft cache's depth, or a
        half-size default.  Its vocab must be the target's."""
        need = self._draft_depth()
        base = self._spec_draft_cfg_arg
        if base is None:
            c = self.cfg
            heads = max(1, c.num_heads // 2)
            hidden = max(heads, (c.hidden_size // 2 // heads) * heads)
            kwargs = dict(vocab_size=c.vocab_size, hidden_size=hidden,
                          num_layers=max(1, c.num_layers // 2),
                          num_heads=heads, dtype=c.dtype, ffn_size=0)
        elif isinstance(base, gpt.GPTConfig):
            kwargs = dataclasses.asdict(base)
        else:
            kwargs = dict(base)
        kwargs["max_seq_len"] = max(int(kwargs.get("max_seq_len") or 0),
                                    need)
        # the draft decodes through the slot cache's own attention
        kwargs["use_flash"] = False
        kwargs["remat"] = False
        cfg = gpt.GPTConfig(**kwargs)
        if cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size {cfg.vocab_size} != target "
                f"{self.cfg.vocab_size}: draft candidates feed the target "
                "verify")
        return cfg

    def _build_cache(self):
        super()._build_cache()
        self._draft_lens = np.zeros((self.slots,), np.int32)
        if self._spec_mode_val != "draft":
            return
        self._draft_cfg = self._build_draft_cfg()
        params = gpt.init_params(
            self._draft_cfg, torch.Generator().manual_seed(self._draft_seed),
            device=self.device)
        self._draft_params = gpt.prepare_params(params, self._draft_cfg)
        cache = gpt.init_slot_cache(self._draft_cfg, self.slots,
                                    self._draft_depth(), device=self.device)
        self._draft_k, self._draft_v = cache["k"], cache["v"]

    def _reset_cache(self):
        """The base reset, and the draft cache zeroed in place (its steps'
        graphs keep their storage)."""
        super()._reset_cache()
        self._draft_lens[:] = 0
        if self._draft_k is not None:
            self._draft_k.zero_()
            self._draft_v.zero_()

    def _draft_ingest(self, req):
        """Prefill the draft cache with the row's prompt, one fixed chunk
        a call, and arm its pending backlog with the tokens the target has
        committed (at activation, the prefill's first sampled token)."""
        if self._draft_prefill is None:
            self._draft_prefill = _DraftPrefill(self)
            self._inc("spec_draft_compiles")
        st = self._draft_prefill
        C = self._draft_chunk
        p = np.asarray(req.prompt, np.int32)
        for pos in range(0, len(p), C):
            take = min(C, len(p) - pos)
            st.toks[:] = 0
            st.toks[0, :take] = p[pos:pos + take]
            st.slot[0] = req.slot
            st.offset[0] = pos
            st()
        self._draft_lens[req.slot] = len(p)
        req.pending_draft = list(req.tokens)

    def _spec_draft_sync(self):
        """Ingest the rows the draft model has not seen since their
        admission (wave, chunked or a retry: ``pending_draft is None``)."""
        if self._spec_mode_val != "draft":
            return
        for s in range(self.slots):
            if self._active[s] and self._slot_req[s].pending_draft is None:
                self._draft_ingest(self._slot_req[s])

    # ---------------------------------------------------------- drafting
    def _make_drafts(self, st):
        """Fill the verify window [S, k + 1] (position 0 the last committed
        token, 1..k the candidates): ngram mode writes the candidates into
        the verify's staging array; draft mode runs the draft step and
        returns the device copy that puts its candidates into the verify's
        inputs (no readback)."""
        k = self._spec_k_val
        st.toks[:] = 0
        st.toks[:, 0] = np.where(self._active, self._last_tok, 0)
        if self._spec_mode_val == "ngram":
            for s in range(self.slots):
                if not self._active[s]:
                    continue
                req = self._slot_req[s]
                hist = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)])
                st.toks[s, 1:] = ngram_draft(hist, k, self._ngram_max)
            return None
        if self._draft_step is None:
            self._draft_step = _DraftStep(self)
            self._inc("spec_draft_compiles")
        ds = self._draft_step
        ds.ctx[:] = 0
        ds.n_ctx[:] = 0
        for s in range(self.slots):
            if not self._active[s]:
                continue
            pend = self._slot_req[s].pending_draft or []
            ds.ctx[s, :len(pend)] = pend
            ds.n_ctx[s] = len(pend)
        ds.lens[:] = self._draft_lens
        drafts = ds()
        for s in range(self.slots):
            if self._active[s]:
                self._draft_lens[s] += int(ds.n_ctx[s])
                self._slot_req[s].pending_draft = []
        return lambda toks, *_: toks[:, 1:].copy_(drafts)

    # ------------------------------------------------------------ paging
    def _ensure_spec_pages(self, caps):
        """Writable page coordinates for each row's commit window,
        positions ``lens[s] .. lens[s] + caps[s] - 1`` (lanes past the cap
        never commit: they go to scratch in the step).  Preempts the
        newest request on exhaustion, as the single-token version."""
        ps = self._page_size
        W = self._spec_k_val + 1
        wpages = np.zeros((self.slots, W), np.int32)
        woffs = np.zeros((self.slots, W), np.int32)
        while True:
            try:
                for s in range(self.slots):
                    wpages[s] = 0
                    woffs[s] = 0
                    if not self._active[s]:
                        continue
                    pos = int(self._lens[s])
                    n = int(caps[s])
                    pids, offs, cows = self._pager.ensure_append_window(
                        s, pos, n)
                    for src, dst in cows:
                        self._copy_page(src, dst)
                    for d, pid in enumerate(pids):
                        self._tables_np[s, (pos + d) // ps] = pid
                    wpages[s, :n] = pids
                    woffs[s, :n] = offs
                return wpages, woffs
            except PagesExhausted as e:
                victim = self._newest_victim()
                if victim is None:
                    raise
                self._preempt(victim, str(e))

    # ------------------------------------------------------------ driving
    def _step_inner(self):
        self._admit()
        self._advance_chunks()
        if not self._active.any():
            return
        k = self._spec_k_val
        W = k + 1
        force = int(bool(self._spec_reject is not None and not self._warming
                         and self._spec_reject(
                             self._counts["decode_steps"] + 1)))
        caps = np.zeros((self.slots,), np.int32)
        eos_ids = np.full((self.slots,), -1, np.int32)
        for s in range(self.slots):
            if not self._active[s]:
                continue
            req = self._slot_req[s]
            caps[s] = min(W, req.max_new_tokens - len(req.tokens))
            if req.eos_token is not None:
                eos_ids[s] = int(req.eos_token)
        wpages, woffs = self._ensure_spec_pages(caps)
        if not self._active.any():
            return
        # a preemption inside the page walk freed a slot after its cap was
        # set: silence it so the commit treats it as inactive
        caps = np.where(self._active, caps, 0).astype(np.int32)
        if self._step is None:
            self._step = _VerifyStep(self)
            self._inc("decode_compiles")
        st = self._step
        launched = self._kernel_launches()
        marks = None
        if self._spec_mode_val == "draft" and self.device.type == "cuda":
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        if marks:
            marks[0].record()
        self._spec_draft_sync()
        before = self._make_drafts(st)
        if marks:
            marks[1].record()
        t1 = time.perf_counter()
        st.tables[:] = self._tables_np
        st.wpages[:] = wpages
        st.woffs[:] = woffs
        st.lens[:] = self._lens
        st.caps[:] = caps
        st.eos[:] = eos_ids
        st.force[0] = force
        out_np, logits_np = st(before)
        t2 = time.perf_counter()
        self._inc("dequant_kernel_calls", self._kernel_launches() - launched)
        if not self._warming:
            # the readback synced the stream, so both marks have passed
            draft = (marks[0].elapsed_time(marks[1]) / 1e3 if marks
                     else t1 - t0)
            self.draft_s.append(draft)
            self.verify_s.append(t2 - t0 - draft)
            self.decode_step_s.append(t2 - t0)
        self._inc("decode_steps")
        self._count_quant_matmuls()
        committed, rows = 0, 0
        for s in range(self.slots):
            if not self._active[s]:
                continue
            req = self._slot_req[s]
            nc = int(out_np[s, W])
            rows += 1
            toks_row = [int(t) for t in out_np[s, :nc]]
            self._lens[s] += nc
            self._append_tokens(req, toks_row,
                                logits_np[s] if logits_np is not None
                                else None)
            self._last_tok[s] = toks_row[-1]
            committed += nc
            self._inc("drafted_tokens", k)
            self._inc("accepted_tokens", nc - 1)
            self._inc("rejected_tokens", k - (nc - 1))
            if self._spec_mode_val == "draft" and not req.done:
                req.pending_draft = toks_row
        self._inc("spec_steps")
        if not self._warming:
            self._commit_sum += committed
            self._rowstep_sum += rows

    # --------------------------------------------------------------- views
    def accepted_tokens_per_step(self):
        """Committed tokens per (row, verify) over live traffic: the
        speedup factor over one-token decode (1.0: speculation never
        helped)."""
        if not self._rowstep_sum:
            return 0.0
        return round(self._commit_sum / self._rowstep_sum, 4)

    def stats(self):
        out = super().stats()
        out["spec_k"] = self.spec_k
        out["accepted_tokens_per_step"] = self.accepted_tokens_per_step()
        return out
