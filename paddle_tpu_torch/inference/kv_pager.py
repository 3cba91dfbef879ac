# Copied from paddle_tpu/inference/kv_pager.py (numpy-only host bookkeeping), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""Block-table KV page allocator.

The PR-5 engine reserved one contiguous ``[max_len]`` KV strip per slot
whether or not it was used — admission capacity was ``slots`` no matter
how short the requests, and every idle position was dead HBM.  This
module is the vLLM-shaped fix (Kwon et al., SOSP 2023): the KV pool is a
fixed set of ``num_pages`` pages of ``page_size`` tokens, and each slot
holds a *page table* (a list of physical page ids) that grows on demand,
so a 12-token request pins two 8-token pages, not a 96-token strip.

On top of plain paging it does SGLang/RadixAttention-style
**shared-prefix reuse**: prompt pages are keyed by a running content
hash (chain of full-page token blocks; the partial tail page keys on the
chain digest *plus* its token tuple), identical prefixes map to the same
physical pages with a reference count, and a released request's prompt
pages are *retained* on an LRU reclaim list instead of freed — a later
request with the same system prompt re-acquires them without allocating
any new pages.  (Sharing saves *memory*, not FLOPs: the sharer's prefill
still recomputes and rewrites the identical content.)  Divergence is
handled by **copy-on-write**: appending a token into a page someone else
also holds — or into a prefix-registered page, which stays frozen at its
prompt-only content so future sharers are never exposed to live decode
state — first moves the writer onto a private copy (the engine performs
the device-side copy; the pager only does the bookkeeping and says which
page to copy).

The pager is pure host-side bookkeeping — no jax imports — so it is
unit-testable without a backend and never shows up in a trace.  Page 0
is reserved as the *scratch* page: inactive decode lanes and padded
prefill rows scatter their garbage there, where nothing ever reads it.

Invariants:

* ``ref[p] >= 1`` for every page in some table; exactly the pages with
  ``ref == 0`` are on the free list or the reclaim LRU.
* A page is written only by (a) the prefill of prompts whose content
  hashes to it — identical bytes for every prompt-covered position by
  construction, with nothing live past them (registered pages are
  frozen, see :meth:`KVPager.ensure_append`) — or (b) the single slot
  that owns it exclusively (``ref == 1``, unregistered) at append time;
  COW restores private ownership before any divergent write.
* Exhaustion raises :class:`PagesExhausted` *after rolling back* any
  partial acquisition, so a failed admit never leaks pages.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np

__all__ = ["KVPager", "PagesExhausted", "SCRATCH_PAGE",
           "prompt_chain_keys", "prompt_head_digest", "short_digest"]

SCRATCH_PAGE = 0

# compact digest width for the fleet prefix index: 12 hex
# chars of a 128-bit blake2b — short enough that a replica's whole
# sketch rides every step-stats reply, long enough that accidental
# collisions cost only a mis-routed (still correct) dispatch
SHORT_DIGEST_LEN = 12


def prompt_chain_keys(prompt, page_size, hash_key=""):
    """One content key per page of ``prompt`` (module-level so the
    ROUTER — which never imports jax or builds an engine — computes the
    IDENTICAL keys a replica's pager does): full pages key on the
    running chain digest (prefix-identity, not page-identity: the same
    tokens after a different prefix are a different page); the partial
    tail keys on the digest *plus* its token tuple.  ``hash_key`` is
    the numeric-contract salt (quant mode / kv_dtype)."""
    toks = np.asarray(prompt, np.int64).reshape(-1)
    ps = int(page_size)
    h = hashlib.blake2b(digest_size=16)
    if hash_key:
        h.update(str(hash_key).encode())
    keys = []
    for j in range(0, len(toks), ps):
        chunk = toks[j:j + ps]
        if len(chunk) == ps:
            h.update(chunk.tobytes())
            keys.append(("full", h.hexdigest()))
        else:
            keys.append(("part", h.hexdigest(),
                         tuple(int(t) for t in chunk)))
    return keys


def short_digest(key):
    """A content key's compact wire form for the fleet prefix index, or
    None for partial-tail keys (only FULL pages are sticky-routable —
    a tail's bytes change with every prompt length)."""
    if key[0] != "full":
        return None
    return key[1][:SHORT_DIGEST_LEN]


def prompt_head_digest(prompt, page_size, hash_key=""):
    """The compact digest of ``prompt``'s FIRST full page (the sticky-
    routing key: requests sharing their head page share their whole
    cached prefix chain's root), or None for prompts shorter than one
    page."""
    toks = np.asarray(prompt, np.int64).reshape(-1)
    ps = int(page_size)
    if len(toks) < ps:
        return None
    h = hashlib.blake2b(digest_size=16)
    if hash_key:
        h.update(str(hash_key).encode())
    h.update(toks[:ps].tobytes())
    return h.hexdigest()[:SHORT_DIGEST_LEN]


class PagesExhausted(RuntimeError):
    """The pool has no free or reclaimable page left.  The engine's
    policy on catching this is *preempt the newest request* (its pages
    go back to the pool, the request re-queues from its prompt) — named,
    counted, never a silent stall."""


class KVPager:
    """Free-list page allocator with ref-counted prefix sharing.

    ``num_pages`` counts the whole pool *including* the reserved scratch
    page 0, so ``num_pages - 1`` pages are allocatable.  ``tables[s]``
    is slot ``s``'s ordered list of physical page ids; page ``j`` holds
    token positions ``[j*page_size, (j+1)*page_size)`` of that slot's
    sequence."""

    def __init__(self, num_pages, page_size, slots, prefix_cache=True,
                 hash_key=None):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.prefix_cache = bool(prefix_cache)
        # the numeric contract under the page bytes (quant mode,
        # kv_dtype): salted into every content hash so pages
        # from engines with different numeric contracts can never be
        # mistaken for one another (a fleet comparing prefix keys across
        # mixed fp32/int8 replicas must never alias them)
        self.hash_key = "" if hash_key is None else str(hash_key)
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is scratch), got "
                f"{num_pages}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.free = collections.deque(range(1, self.num_pages))
        self.ref = [0] * self.num_pages
        self.tables = [[] for _ in range(self.slots)]
        self._cache = {}                    # content key -> page id
        self._cache_gen = 0                 # bumps on any _cache mutation
        self._digest_sketch = (None, None)  # (gen, digests) memo
        self._page_key = {}                 # page id -> content key
        self._reclaim = collections.OrderedDict()   # ref==0, retained
        # host-tier spill hook: the engine installs a
        # callable(pid, key) fired when a RETAINED prefix page is
        # evicted out of the reclaim LRU — at call time the page's
        # device bytes are still valid (the caller overwrites them only
        # after _alloc returns), so the engine can capture them into
        # its host tier.  None -> evictions simply discard.
        self.evict_hook = None
        self._pending_keys = [None] * self.slots    # deferred registration
        self._registered = [0] * self.slots         # pages registered so far
        # counters (the engine mirrors these into the serving.* family)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.cow_copies = 0
        self.evictions = 0
        # admission-footprint EMA, the router's pages-per-request signal
        self._ppr_ema = float(max(1, self.pages_for(
            self.page_size * max(1, (self.num_pages - 1) // max(1, self.slots)))))

    # ------------------------------------------------------------- sizing
    def pages_for(self, n_tokens):
        """Pages needed to hold ``n_tokens`` positions."""
        return -(-int(n_tokens) // self.page_size)

    def capacity_tokens(self):
        return (self.num_pages - 1) * self.page_size

    def pages_free(self):
        """Allocatable right now: the free list plus the reclaimable
        (retained, ref==0) prefix pages."""
        return len(self.free) + len(self._reclaim)

    def pages_in_use(self):
        return self.num_pages - 1 - self.pages_free()

    def pages_per_request_est(self):
        return max(1, int(round(self._ppr_ema)))

    # ------------------------------------------------------------ hashing
    def _prompt_keys(self, prompt):
        """One content key per page of ``prompt`` — the module-level
        :func:`prompt_chain_keys` math under this pager's salt (the
        router mirrors it byte-for-byte for sticky routing)."""
        return prompt_chain_keys(prompt, self.page_size, self.hash_key)

    def cached_page(self, key):
        """The physical page currently holding ``key``'s content, or
        None — the engine's fault-back probe (device hit vs host
        tier)."""
        return self._cache.get(key) if self.prefix_cache else None

    def chain_digests(self, limit=128):
        """The compact digests of the FULL prompt pages this pager can
        serve as prefix hits right now (registered, device-resident —
        shared or retained), newest-registered last, capped at
        ``limit``.  This is the per-replica sketch each step-stats
        reply ships to the router's fleet prefix index."""
        gen, memo = self._digest_sketch
        if gen != self._cache_gen:
            memo = [d for d in map(short_digest, self._cache)
                    if d is not None]
            self._digest_sketch = (self._cache_gen, memo)
        return memo[-int(limit):]

    # --------------------------------------------------------- allocation
    def _alloc(self):
        if self.free:
            return self.free.popleft()
        if self._reclaim:
            # evict the least-recently-retained prefix page
            pid, _ = self._reclaim.popitem(last=False)
            key = self._page_key.pop(pid, None)
            if key is not None:
                self._cache.pop(key, None)
                self._cache_gen += 1
                if self.evict_hook is not None:
                    # the page's device bytes are still intact HERE —
                    # the caller only overwrites them after we return —
                    # so the host-tier spill capture must be synchronous
                    # with the eviction
                    self.evict_hook(pid, key)
            self.evictions += 1
            return pid
        raise PagesExhausted(
            f"KV page pool exhausted: {self.num_pages - 1} pages all "
            f"referenced ({sum(1 for r in self.ref[1:] if r)} in tables)")

    def _decref(self, pid):
        self.ref[pid] -= 1
        assert self.ref[pid] >= 0, (pid, self.ref[pid])
        if self.ref[pid] == 0:
            if pid in self._page_key and self.prefix_cache:
                self._reclaim[pid] = True      # retained for prefix reuse
                self._reclaim.move_to_end(pid)
            else:
                self.free.append(pid)

    def _acquire_cached(self, pid):
        if self.ref[pid] == 0:
            self._reclaim.pop(pid, None)
        self.ref[pid] += 1

    # ------------------------------------------------------------- admit
    def admit(self, slot, prompt, defer_register=False):
        """Acquire the page table for ``prompt`` in ``slot``: prefix
        pages whose content hash is already cached are *shared*
        (ref-count bumped, zero new pages); the rest are freshly
        allocated.  Returns ``(table, hits)``.

        With ``defer_register`` (chunked prefill) the fresh pages are
        NOT entered into the prefix cache yet — their K/V content does
        not exist until the chunks run — call :meth:`register_prompt`
        after each chunk lands.  On exhaustion the partial acquisition
        is rolled back and :class:`PagesExhausted` propagates."""
        if self.tables[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        keys = self._prompt_keys(prompt)
        taken, hits = [], 0
        try:
            for key in keys:
                pid = self._cache.get(key) if self.prefix_cache else None
                if pid is not None:
                    self._acquire_cached(pid)
                    hits += 1
                else:
                    pid = self._alloc()
                    self.ref[pid] = 1
                    if self.prefix_cache and not defer_register:
                        self._register(pid, key)
                taken.append(pid)
        except PagesExhausted:
            for pid in taken:
                self._decref(pid)
            raise
        self.tables[slot] = taken
        self.prefix_hits += hits
        self.prefix_misses += len(taken) - hits
        if defer_register:
            self._pending_keys[slot] = keys
            self._registered[slot] = 0       # re-registering a shared
            # page is a no-op (_register keeps the oldest mapping), so
            # starting from 0 is safe even when some pages were hits
        self._ppr_ema = 0.75 * self._ppr_ema + 0.25 * len(taken)
        return taken, hits

    def admit_pinned(self, slot, prompt):
        """Two-pass admit for the engine's host-tier fault-back:
        acquire every device-cached page FIRST — pinning it (ref
        >= 1) so the second pass's fresh allocations can never evict it
        out of the reclaim LRU mid-admission — then allocate+register
        pages for the missing keys.  Returns ``(table, hit_flags)``
        where ``hit_flags[j]`` is True for device-shared pages and
        False for freshly allocated ones (whose bytes the engine
        injects from its host tier).  Rolls back on exhaustion exactly
        like :meth:`admit`."""
        if self.tables[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        keys = self._prompt_keys(prompt)
        table = [None] * len(keys)
        hit_flags = [False] * len(keys)
        taken = []
        try:
            for j, key in enumerate(keys):
                pid = self._cache.get(key) if self.prefix_cache else None
                if pid is not None:
                    self._acquire_cached(pid)
                    table[j] = pid
                    hit_flags[j] = True
                    taken.append(pid)
            for j, key in enumerate(keys):
                if table[j] is not None:
                    continue
                pid = self._alloc()
                self.ref[pid] = 1
                if self.prefix_cache:
                    self._register(pid, keys[j])
                table[j] = pid
                taken.append(pid)
        except PagesExhausted:
            for pid in taken:
                self._decref(pid)
            raise
        self.tables[slot] = table
        hits = sum(hit_flags)
        self.prefix_hits += hits
        self.prefix_misses += len(table) - hits
        self._ppr_ema = 0.75 * self._ppr_ema + 0.25 * len(table)
        return table, hit_flags

    def _register(self, pid, key):
        old = self._cache.get(key)
        if old is not None and old != pid:
            # a concurrent identical prompt registered first; keep the
            # oldest mapping (its content is just as valid)
            return
        self._cache[key] = pid
        self._cache_gen += 1
        self._page_key[pid] = key

    def register_prompt(self, slot, upto_tokens):
        """Enter this slot's prompt pages into the prefix cache once
        their content actually exists on device — pages fully covered by
        ``upto_tokens``, plus the partial tail when the whole prompt is
        in.  No-op for non-deferred admissions."""
        keys = self._pending_keys[slot]
        if keys is None or not self.prefix_cache:
            return
        ps = self.page_size
        table = self.tables[slot]
        for j in range(self._registered[slot], len(keys)):
            full = (j + 1) * ps <= upto_tokens
            tail_done = (keys[j][0] == "part"
                         and upto_tokens >= (len(keys) - 1) * ps)
            if not (full or tail_done):
                break
            self._register(table[j], keys[j])
            self._registered[slot] = j + 1
        if self._registered[slot] >= len(keys):
            self._pending_keys[slot] = None

    # ------------------------------------------------------------- append
    def ensure_append(self, slot, pos):
        """Make position ``pos`` of ``slot`` writable; returns
        ``(page_id, offset, cow_src)``.  Allocates a fresh tail page on
        a page boundary; if the tail page is shared (``ref > 1``) OR
        prefix-registered, the slot is moved onto a private copy first
        and ``cow_src`` names the page whose contents the engine must
        copy device-side before the write.

        The registered-page case is load-bearing: a cache-registered
        tail page is FROZEN at its prompt-only content.  If the owner
        appended decode tokens into it in place, a later identical
        prompt would share a page whose positions past the prompt hold
        live generated K/V — and that request's prefill rewrites whole
        pages, clobbering the owner's sequence.  COW-on-first-append
        keeps the cached page pristine (it retires to the reclaim list
        at ref 0), so sharers only ever rewrite prompt-identical bytes
        plus positions nobody has real data at.  Idempotent for the
        same ``(slot, pos)``."""
        ps = self.page_size
        j, off = divmod(int(pos), ps)
        table = self.tables[slot]
        if j == len(table):
            pid = self._alloc()
            self.ref[pid] = 1
            table.append(pid)
            return pid, off, None
        if j > len(table):
            raise RuntimeError(
                f"append at position {pos} skips pages (slot {slot} "
                f"holds {len(table)} pages of {ps})")
        pid = table[j]
        if self.ref[pid] > 1 or (self.prefix_cache
                                 and pid in self._page_key):
            dst = self._alloc()
            self.ref[dst] = 1
            self._decref(pid)
            table[j] = dst
            self.cow_copies += 1
            return dst, off, pid
        return pid, off, None

    def ensure_append_window(self, slot, pos, n):
        """Speculative multi-token append: make positions
        ``pos .. pos + n - 1`` of ``slot`` writable in one walk —
        allocating every tail page the window crosses and COWing a
        shared/frozen tail exactly like :meth:`ensure_append` (whose
        idempotence this inherits: re-walking after a preemption retry
        is safe, and pages pre-allocated for a window the verify then
        only partially committed are simply reused by the next window).
        Returns ``(pids [n], offs [n], cows)`` where ``cows`` is a list
        of ``(src, dst)`` pairs the engine must copy device-side before
        any write.  On exhaustion the already-ensured prefix stays owned
        by the slot (released wholesale if the slot is preempted) and
        :class:`PagesExhausted` propagates."""
        pids, offs, cows = [], [], []
        for d in range(int(n)):
            pid, off, cow = self.ensure_append(slot, int(pos) + d)
            if cow is not None:
                cows.append((cow, pid))
            pids.append(pid)
            offs.append(off)
        return pids, offs, cows

    # ------------------------------------------------------------ release
    def release(self, slot):
        """Drop the slot's table.  Pages fall to ref 0 and either retire
        to the reclaim LRU (prompt pages, prefix cache on) or the free
        list (generated-token pages)."""
        for pid in self.tables[slot]:
            self._decref(pid)
        self.tables[slot] = []
        self._pending_keys[slot] = None
        self._registered[slot] = 0

    def flush_reclaimable(self):
        """Evict every retained prefix page (e.g. after warmup, so the
        synthetic prompts don't shadow real traffic's cache)."""
        n = 0
        while self._reclaim:
            pid, _ = self._reclaim.popitem(last=False)
            key = self._page_key.pop(pid, None)
            if key is not None:
                self._cache.pop(key, None)
                self._cache_gen += 1
            self.free.append(pid)
            n += 1
        return n

    # -------------------------------------------------------------- views
    def table_array(self, slot, width):
        """The slot's table as a fixed-width int32 row (scratch-padded)
        for the device page-table tensor."""
        row = np.zeros((width,), np.int32)
        t = self.tables[slot]
        row[:len(t)] = t
        return row

    def stats(self):
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use(),
            "pages_free": self.pages_free(),
            "pages_reclaimable": len(self._reclaim),
            "free_page_fraction": round(
                self.pages_free() / max(1, self.num_pages - 1), 4),
            "prefix_page_hits": self.prefix_hits,
            "prefix_page_misses": self.prefix_misses,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "pages_per_request_est": self.pages_per_request_est(),
            "chain_digest_count": len(self._cache),
        }
