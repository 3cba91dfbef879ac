"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``),
with the reference's ``weight``, ``ignore_index``, ``reduction`` and
``soft_label`` semantics: a mean over hard labels divides by the summed
weight of the labels that count, and an ignored label contributes zero.
Labels may be int32 or int64, with or without a trailing class axis of
size 1.

``ctc_loss`` runs the reference's alpha recursion in log space over
time, one step of torch ops a frame; like the reference it takes
``norm_by_times`` and leaves the loss as it is.  ``hsigmoid_loss`` walks
the reference's complete binary tree (a custom tree raises, as there),
and ``mbce_loss`` raises ``NotImplementedError`` as the reference's
does."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

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


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def _sl1(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        return _reduce(loss, reduction)
    return call(_sl1, input, label, _name="smooth_l1_loss")


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """-(y log p + (1 - y) log(1 - p)), p clipped to [1e-12, 1 - 1e-12]."""
    def _bce(p, y, *w):
        p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
        loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)
    args = [weight] if weight is not None else []
    return call(_bce, input, label, *args, _name="binary_cross_entropy")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The sigmoid cross-entropy of logits, through softplus (stable at
    large |z|); ``pos_weight`` scales the positive term."""
    def _bcel(z, y, *extra):
        w = extra[0] if weight is not None else None
        pw = extra[-1] if pos_weight is not None else None
        sp = TF.softplus(-z)
        log_sig_pos = -sp
        log_sig_neg = -z - sp
        pos = y * log_sig_pos if pw is None else pw * y * log_sig_pos
        loss = -(pos + (1 - y) * log_sig_neg)
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)
    args = [a for a in (weight, pos_weight) if a is not None]
    return call(_bcel, logit, label, *args,
                _name="binary_cross_entropy_with_logits")


def kl_div(input, label, reduction="mean", name=None):
    """y (log y - x) for log-probabilities x; ``batchmean`` divides the
    sum by the batch."""
    def _kl(logp, y):
        loss = y * (torch.log(torch.clamp(y, min=1e-30)) - logp)
        if reduction == "batchmean":
            return torch.sum(loss) / logp.shape[0]
        return _reduce(loss, reduction)
    return call(_kl, input, label, _name="kl_div")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return call(lambda a, b, y: _reduce(torch.clamp(
        -y * (a - b) + margin, min=0.0), reduction),
        input, other, label, _name="margin_ranking_loss")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return call(lambda a, y: _reduce(torch.where(
        y == 1, a, torch.clamp(margin - a, min=0.0)), reduction),
        input, label, _name="hinge_embedding_loss")


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def _cel(a, b, y):
        cos = torch.sum(a * b, -1) / torch.clamp(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
        return _reduce(loss, reduction)
    return call(_cel, input1, input2, label, _name="cosine_embedding_loss")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def _tm(a, pos, neg):
        def dist(u, v):
            return torch.pow(torch.sum(torch.pow(torch.abs(u - v) + epsilon,
                                                 p), -1), 1.0 / p)
        d_pos = dist(a, pos)
        d_neg = dist(a, neg)
        if swap:
            d_neg = torch.minimum(d_neg, dist(pos, neg))
        return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0),
                       reduction)
    return call(_tm, input, positive, negative, _name="triplet_margin_loss")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of logits [T, B, C] (log-softmaxed here) against padded
    labels [B, L]: the alpha recursion in log space, frames past a
    sequence's length leaving its alphas as they are.  ``mean`` divides
    each loss by its label length, then averages."""
    def _ctc(lp, lbl, in_len, lbl_len):
        lp = torch.log_softmax(lp, dim=-1)
        T, B, _ = lp.shape
        L = lbl.shape[1]
        S = 2 * L + 1
        dev = lp.device
        ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
        ext[:, 1::2] = lbl.long()
        neg_inf = torch.full((), -1e30, dtype=lp.dtype, device=dev)
        alpha = neg_inf.expand(B, S).clone()
        alpha[:, 0] = lp[0, :, blank]
        alpha[:, 1] = torch.gather(lp[0], 1, ext[:, 1:2])[:, 0]
        same2 = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=dev),
                           ext[:, 2:] == ext[:, :-2]], 1)
        in_len = in_len.long()
        for t in range(1, T):
            a1 = torch.cat([neg_inf.expand(B, 1), alpha[:, :-1]], 1)
            a2 = torch.cat([neg_inf.expand(B, 2), alpha[:, :-2]], 1)
            a2 = torch.where(same2, neg_inf, a2)
            merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
            new = merged + torch.gather(lp[t], 1, ext)
            alpha = torch.where((t < in_len)[:, None], new, alpha)
        end = 2 * lbl_len.long()
        last1 = torch.gather(alpha, 1, end[:, None])[:, 0]
        last2 = torch.gather(alpha, 1, torch.clamp(end - 1, min=0)[:, None])[:, 0]
        loss = -torch.logaddexp(last1, last2)
        if reduction == "mean":
            return torch.mean(loss / torch.clamp(lbl_len.to(loss.dtype),
                                                 min=1))
        return _reduce(loss, reduction)
    return call(_ctc, log_probs, labels, input_lengths, label_lengths,
                _name="ctc_loss")


def square_error_cost(input, label):
    return call(lambda a, b: torch.square(a - b), input, label,
                _name="square_error_cost")


def log_loss(input, label, epsilon=1e-4, name=None):
    return call(lambda p, y: (-y * torch.log(p + epsilon)
                              - (1 - y) * torch.log(1 - p + epsilon)),
                input, label, _name="log_loss")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def _fl(z, y, *n):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + torch.log1p(
            torch.exp(-torch.abs(z)))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        if n:
            loss = loss / n[0]
        return _reduce(loss, reduction)
    args = [normalizer] if normalizer is not None else []
    return call(_fl, logit, label, *args, _name="sigmoid_focal_loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    def _np(a, p, y):
        B = a.shape[0]
        sim = a @ p.transpose(0, 1)
        y = y.reshape(-1)
        same = (y[:, None] == y[None, :]).to(a.dtype)
        same = same / torch.sum(same, dim=1, keepdim=True)
        logp = torch.log_softmax(sim, dim=1)
        xent = -torch.sum(same * logp, dim=1).mean()
        reg = l2_reg * (torch.sum(a * a) + torch.sum(p * p)) / (2 * B)
        return xent + reg
    return call(_np, anchor, positive, labels, _name="npair_loss")


def dice_loss(input, label, epsilon=1e-5, name=None):
    def _dice(p, y):
        y1 = TF.one_hot(y.squeeze(-1).long(), p.shape[-1]).to(p.dtype)
        dims = tuple(range(1, p.dim()))
        inter = torch.sum(p * y1, dim=dims)
        union = torch.sum(p, dim=dims) + torch.sum(y1, dim=dims)
        return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))
    return call(_dice, input, label, _name="dice_loss")


def mbce_loss(*a, **k):
    raise NotImplementedError


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over a complete binary tree: each sample's
    path from its leaf to the root is ceil(log2(C)) nodes long, and each
    node on it adds a sigmoid cross-entropy term.  Per-sample [N, 1]."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError("custom tree not yet supported")

    def _hs(x, lbl, w, *b):
        lbl = lbl.reshape(-1).long()
        code_len = int(math.ceil(math.log2(num_classes)))
        node = lbl + num_classes - 1
        losses = torch.zeros(lbl.shape[0], dtype=x.dtype, device=x.device)
        for _ in range(code_len):
            parent = torch.div(node - 1, 2, rounding_mode="floor")
            is_right = (node % 2 == 0).to(x.dtype)
            valid = (node > 0).to(x.dtype)
            at = torch.clamp(parent, min=0)
            logits = torch.sum(x * w[at], dim=-1)
            if b:
                logits = logits + b[0][at]
            ce = (torch.clamp(logits, min=0) - logits * is_right
                  + torch.log1p(torch.exp(-torch.abs(logits))))
            losses = losses + ce * valid
            node = parent
        return losses[:, None]
    args = [bias] if bias is not None else []
    return call(_hs, input, label, weight, *args, _name="hsigmoid_loss")
