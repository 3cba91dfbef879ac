"""Metrics (counterpart of ``paddle_tpu/metric/__init__.py``; ref:
python/paddle/metric/metrics.py): numpy over ``Tensor.numpy()``.  Reading
a Tensor on the card is a device-to-host copy that waits for the card,
as the reference's ``.numpy()`` does; a bf16 Tensor is read as float32.
``Accuracy.compute`` returns its per-sample hits as a CPU Tensor, which
``update`` reads without another copy."""
from __future__ import annotations

import numpy as np

import torch

from ..framework.core import CPUPlace
from ..tensor.tensor import Tensor


def _np(x):
    """``x`` (Tensor or array-like) as a numpy array."""
    if isinstance(x, Tensor):
        v = x.value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        self._name = self.__class__.__name__.lower()

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        if label_np.ndim == pred_np.ndim:
            label_np = np.squeeze(label_np, -1)
        correct = topk_idx == label_np[..., None]
        # on the host: update() reads it back at once
        return Tensor(correct.astype(np.float32), place=CPUPlace())

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim > 0 else 1
        accs = []
        for i, k in enumerate(self.topk):
            n_correct = c[..., :k].sum()
            self.total[i] += n_correct
            self.count[i] += num
            accs.append(float(n_correct) / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [float(t / max(c, 1)) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        l = _np(labels).reshape(-1)
        pred_pos = p > 0.5
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fp += int(np.sum(pred_pos & (l != 1)))

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        l = _np(labels).reshape(-1)
        pred_pos = p > 0.5
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fn += int(np.sum(~pred_pos & (l == 1)))

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, -1]
        idx = np.clip((p * self.num_thresholds).astype(int), 0,
                      self.num_thresholds)
        for i, lab in zip(idx, l):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds descending, anchored at (0,0) like
        # the reference's loop starting from tot_pos=tot_neg=0 — without
        # the anchor the first trapezoid's area is dropped (degenerate
        # one-bucket distributions returned 0.0 instead of 0.5)
        tp = np.concatenate([[0.0], np.cumsum(self._stat_pos[::-1])])
        fp = np.concatenate([[0.0], np.cumsum(self._stat_neg[::-1])])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))


def accuracy(input, label, k=1, correct=None, total=None):
    p = _np(input)
    l = _np(label)
    topk_idx = np.argsort(-p, axis=-1)[..., :k]
    if l.ndim == p.ndim:
        l = np.squeeze(l, -1)
    correct_ = (topk_idx == l[..., None]).any(-1)
    return Tensor(np.asarray(correct_.mean(), np.float32))
