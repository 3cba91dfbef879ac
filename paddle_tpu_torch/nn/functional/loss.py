"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``;
``cross_entropy``, ``softmax_with_cross_entropy``, ``nll_loss``,
``mse_loss`` and ``l1_loss``), with the reference's ``weight``,
``ignore_index``, ``reduction`` and ``soft_label`` semantics: a mean over
hard labels divides by the summed weight of the labels that count, and
an ignored label contributes zero.  Labels may be int32 or int64, with or
without a trailing class axis of size 1."""
from __future__ import annotations

import torch

from ...ops.dispatch import call


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _picked(logp, lbl, ax, ignore_index, w, reduction):
    """-logp at the label along ``ax``, weighted, ignored labels zeroed,
    reduced (a weighted mean over the labels that count)."""
    lbl = lbl.to(torch.int32)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0).to(torch.int64)
    loss = -torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
    if w:
        cw = w[0][safe]
        loss = loss * cw
        wsum = torch.sum(torch.where(valid, cw, 0.0))
    else:
        wsum = torch.sum(valid.to(loss.dtype))
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp(wsum, min=1e-12)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Log-softmax and the negative log-likelihood of ``label`` along
    ``axis`` (hard labels, or a distribution with ``soft_label``)."""
    def _ce(logits, lbl, *w):
        ax = axis % logits.dim()
        if use_softmax:
            logp = torch.log_softmax(logits, dim=ax)
        else:
            logp = torch.log(torch.clamp(logits, min=1e-30))
        if soft_label:
            loss = -torch.sum(lbl * logp, dim=ax)
            if w:
                loss = loss * torch.sum(w[0] * lbl, dim=ax)
            return _reduce(loss, reduction)
        if lbl.dim() == logp.dim():
            lbl = lbl.squeeze(ax)
        return _picked(logp, lbl, ax, ignore_index, w, reduction)
    args = [weight] if weight is not None else []
    return call(_ce, input, label, *args, _name="cross_entropy")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-sample loss with the class axis kept as size 1 ([N, 1] for
    [N, C] logits), no reduction; with ``return_softmax`` also the
    softmax."""
    from .activation import softmax
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = call(lambda a: a.unsqueeze(axis), loss, _name="unsqueeze")
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``input`` ([N, C, ...]
    or [C]); an [N, 1] label is taken as [N]."""
    def _f(logp, lbl, *w):
        ax = 1 if logp.dim() > 1 else 0
        if lbl.dim() == logp.dim() and lbl.shape[-1] == 1:
            lbl = lbl.reshape(lbl.shape[:-1])
        return _picked(logp, lbl, ax, ignore_index, w, reduction)
    args = [weight] if weight is not None else []
    return call(_f, input, label, *args, _name="nll_loss")


def mse_loss(input, label, reduction="mean", name=None):
    return call(lambda a, b: _reduce(torch.square(a - b), reduction),
                input, label, _name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return call(lambda a, b: _reduce(torch.abs(a - b), reduction),
                input, label, _name="l1_loss")
