"""Functional AdamW for the port's train step: the counterpart of
``paddle_tpu/optimizer/functional.py``."""
from __future__ import annotations

import torch


def adamw_update(p, g, m, v, lr, t, b1, b2, eps, wd, decay):
    """One AdamW step in fp32 master precision.

    p: param leaf (any dtype; updated in fp32, cast back), g: grad,
    m/v: moments (the math always runs in fp32; each is stored back in its
    own dtype, so bf16 moments halve optimizer-state memory), lr and t: the
    learning rate and the 1-based step count, as numbers or tensors (no
    host sync either way), decay: apply weight decay to this leaf.
    Returns new tensors (new_p, new_m, new_v); the caller decides whether
    to write them in place."""
    gf = g.float()
    pf = p.float()
    if isinstance(t, torch.Tensor):
        t = t.float()
    m_new = b1 * m.float() + (1 - b1) * gf
    v_new = b2 * v.float() + (1 - b2) * gf * gf
    mhat = m_new / (1 - b1 ** t)
    vhat = v_new / (1 - b2 ** t)
    upd = mhat / (torch.sqrt(vhat) + eps)
    if decay:
        upd = upd + wd * pf
    return ((pf - lr * upd).to(p.dtype), m_new.to(m.dtype),
            v_new.to(v.dtype))
