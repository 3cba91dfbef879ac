"""The speculative engine's per-verify write probe, shared by the CPU
tests (``test_torch_speculative.py``) and the card tests
(``test_torch_cuda.py``).

A verify may change the pool only at the positions it committed
(``lens[s] .. lens[s] + n_commit[s] - 1`` of each active row) and on
scratch page 0.  The end-state byte tests cannot see a rejected lane
written past the commit, since a later verify overwrites it, so the probe
checks each verify as it runs."""
import contextlib

import numpy as np

from paddle_tpu_torch.inference import speculative


@contextlib.contextmanager
def commit_write_probe(eng, record):
    """While open, each verify of ``eng`` appends (positions changed
    outside its commit, tokens committed) to ``record``.  Wraps the
    verify step's ``__call__``; steps of other engines pass through."""
    cls = speculative._VerifyStep
    real = cls.__call__
    ps = eng._page_size

    def probe(step, before=None):
        if step._eng is not eng:
            return real(step, before)
        pre = [t.clone() for t in eng._cache_operands()]
        lens, tables = eng._lens.copy(), eng._tables_np.copy()
        active = eng._active.copy()
        out = real(step, before)
        n_commit = out[0][:, eng._spec_k_val + 1]
        allowed = np.zeros(pre[0].shape[1:3], bool)        # [P, ps]
        allowed[0] = True
        for s in np.nonzero(active)[0]:
            for pos in range(int(lens[s]), int(lens[s]) + int(n_commit[s])):
                allowed[tables[s, pos // ps], pos % ps] = True
        bad = 0
        for t, p in zip(eng._cache_operands(), pre):
            ch = (t != p).reshape(*t.shape[:3], -1).any(3).any(0)
            bad += int((ch.cpu().numpy() & ~allowed).sum())
        record.append((bad, int(n_commit.sum())))
        return out

    cls.__call__ = probe
    try:
        yield record
    finally:
        cls.__call__ = real
