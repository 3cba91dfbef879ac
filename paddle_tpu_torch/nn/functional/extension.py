"""Extension functionals (counterpart of
``paddle_tpu/nn/functional/extension.py``: ``sequence_mask``,
``gather_tree``, ``temporal_shift``; ``diag_embed`` is the tensor API's).
"""
from __future__ import annotations

import torch

from ...framework import core
from ...ops.dispatch import call
from ...tensor.creation import diag_embed  # noqa: F401  (re-exported)
from ...tensor.tensor import Tensor


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen] mask, 1 where the position is below the length;
    ``maxlen`` None takes the largest length (read on the host)."""
    dt = core.convert_dtype(dtype)
    if maxlen is None:
        lengths = x.value if isinstance(x, Tensor) else torch.as_tensor(x)
        m = int(lengths.max())
        return Tensor((torch.arange(m, device=lengths.device)
                       < lengths[..., None]).to(dt))
    return call(lambda lens: (torch.arange(maxlen, device=lens.device)
                              < lens[..., None]).to(dt),
                x, _name="sequence_mask")


def gather_tree(ids, parents):
    """Beam-search ancestry backtrace.  ids, parents: [T, B, beam].  From
    the last step backwards each slot follows its parent pointers, so
    out[t, b, j] is the token at step t on slot j's final path."""
    def _gt(idv, parv):
        T, batch, beam = idv.shape
        beam_idx = torch.arange(beam, dtype=idv.dtype,
                                device=idv.device).expand(batch, beam)
        toks = [None] * T
        for t in range(T - 1, -1, -1):
            sel = beam_idx.long()
            toks[t] = torch.gather(idv[t], 1, sel)
            beam_idx = torch.gather(parv[t], 1, sel)
        return torch.stack(toks, 0)
    return call(_gt, ids, parents, _name="gather_tree")


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    def _ts(a):
        if data_format != "NCHW":
            a = a.permute(0, 3, 1, 2)
        n, c, h, w = a.shape
        a = a.reshape(n // seg_num, seg_num, c, h, w)
        fold = int(c * shift_ratio)
        left = torch.cat([a[:, 1:, :fold],
                          torch.zeros_like(a[:, :1, :fold])], 1)
        mid = torch.cat([torch.zeros_like(a[:, :1, fold:2 * fold]),
                         a[:, :-1, fold:2 * fold]], 1)
        out = torch.cat([left, mid, a[:, :, 2 * fold:]], 2).reshape(
            n, c, h, w)
        return out.permute(0, 2, 3, 1) if data_format != "NCHW" else out
    return call(_ts, x, _name="temporal_shift")
