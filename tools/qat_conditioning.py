#!/usr/bin/env python3
"""Why ``chip_smoke.py`` (at) and (au) are built as they are (CPU only).

* Conditioning of QAT: (au)'s model (2 layers at ERNIE-3.0-Base width,
  [4, 128], fp32, three AdamW steps at 5e-5) run twice on the CPU, once
  with the word embeddings multiplied by 1 + 1e-7 N(0, 1): fake
  quantisation is discontinuous, so a change of the size of the card's
  and the CPU's fp32 differences moves the losses by far more than
  1e-5.  Printed: each step's relative loss difference, then the same
  with the second run taking the first run's rounding at ties
  (``chip_smoke.RoundingTape``).
* The label and the schedule of (at): (n)'s encoder, 12 layers, cut to
  H = 256 for the CPU, 11 AdamW steps on one [32, 128] batch from
  random weights, for a balanced label (first id mod 2) and (at)'s
  imbalanced one (first id a multiple of 8), at a constant 5e-5 and on
  a 170-step warm-up to it.  Printed: the batch's loss without dropout
  before and after, and each step's loss.

    PYTHONPATH=. python tools/qat_conditioning.py
"""
import numpy as np
import torch

import chip_smoke as C
import paddle_tpu_torch as pt
from paddle_tpu_torch import quantization as Q


def qat_runs(perturb, tape=None):
    e = C.QAT_FT
    stream = np.random.default_rng(5).integers(0, e["V"], 40000)
    batches = C.packed_batches(stream, *C.QAT_PARITY, 3)
    weights, out = None, []
    for eps in (perturb, 0.0):
        if tape is not None:
            tape.mode = "record" if eps else "replay"
        pt.seed(1)
        m, weights = C.qat_model(pt, 2, weights, 0.0)
        if eps:
            g = torch.Generator().manual_seed(3)
            w = m.word.weight
            w.set_value(w.value * (1 + eps * torch.randn(w.shape,
                                                         generator=g)))
        Q.QAT().quantize(m)
        step = C.qat_loop(pt, m, batches[0], False, warmup=1, epsilon=1e-6,
                          start_lr=e["lr"])
        if tape is None:
            out.append([step() for _ in range(3)])
        else:
            with C.taped_rounding(Q, tape):
                out.append([step() for _ in range(3)])
    return [abs(a - b) / b for a, b in zip(*out)]


def schedules():
    e = dict(C.QAT_FT)
    C.QAT_FT.update(V=8000, H=256, nh=4, F=1024)
    try:
        stream = np.random.default_rng(5).integers(0, 8000, 40000)
        rows = stream[:len(stream) // 128 * 128].reshape(-1, 128)[:32]
        weights = None
        for label, y in (("first id mod 2", rows[:, :1] % 2),
                         ("first id a multiple of 8",
                          (rows[:, :1] % 8 == 0).astype(np.int64))):
            for warmup in (1, 170):
                pt.seed(7)
                m, weights = C.qat_model(pt, 12, weights, 0.1)
                step = C.qat_loop(pt, m, (rows, y), False, warmup=warmup,
                                  start_lr=C.QAT_FT["lr"] if warmup == 1
                                  else 0.0)
                before = C.train_loss(pt, m, (rows, y))
                losses = [step() for _ in range(11)]
                after = C.train_loss(pt, m, (rows, y))
                print(f"{label}, warm-up {warmup}: loss without dropout "
                      f"{before:.4f} -> {after:.4f}; steps "
                      f"{[round(x, 3) for x in losses]}", flush=True)
    finally:
        C.QAT_FT.clear()
        C.QAT_FT.update(e)


def main():
    pt.set_device("cpu")
    torch.set_num_threads(4)
    print("QAT, 1e-7 change of the embeddings: relative loss differences "
          f"{['%.2e' % x for x in qat_runs(1e-7)]}", flush=True)
    tape = C.RoundingTape(C.TIE_MARGIN)
    d = qat_runs(1e-7, tape)
    print(f"    taking the first run's rounding at {tape.ties} ties (far "
          f"{tape.far}): {['%.2e' % x for x in d]}", flush=True)
    schedules()


if __name__ == "__main__":
    main()
