"""Regularizers (counterpart of ``paddle_tpu/regularizer.py``): the
coupled weight-decay term an optimizer adds to a grad."""
from __future__ import annotations

import torch


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = coeff

    def grad_term(self, p):
        return self._coeff * torch.sign(p)


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = coeff

    def grad_term(self, p):
        return self._coeff * p


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
