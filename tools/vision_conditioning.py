#!/usr/bin/env python3
"""How far the port's fp32 training steps of the vision checks land from
a float64 evaluation of the same steps (CPU only; the figures
``chip_smoke.py`` (ap) and (aq) cite for asserting their card-against-CPU
gradients in float64), and how long the Executor takes to fetch every
parameter's gradient of (ap)'s program.

* (ap): ``chip_smoke.py``'s MobileNet-SSD300 program without its
  optimizer (``append_backward``), 2 images at 300 x 300, one run in
  fp32 and one with the parameters, buffers and image cast to float64
  after the build.
* (aq): MobileNetV2 x1.0, one training step (batch statistics, dropout
  0) on 2 images at 224 x 224, fp32 and float64 from the same weights.

Prints, for each, the loss's relative difference and the largest
gradient difference over the largest float64 |gradient|.

    PYTHONPATH=. python tools/vision_conditioning.py
"""
import time

import numpy as np
import torch

import paddle_tpu_torch as pt
from chip_smoke import (SEED, SSD_PARITY, float64_tensor, run_static,
                        ssd_batch, ssd_program, step_errors, to_float64)
from paddle_tpu_torch.vision import models


def ssd():
    feed = ssd_batch(pt, SSD_PARITY, SEED + 72)
    pt.seed(SEED + 73)
    p = ssd_program(pt, parity=True)
    params = p["main"].all_parameters()
    run_static(pt, p["startup"], None, [])
    runs = {}
    for dt in ("f32", "f64"):
        if dt == "f64":
            to_float64(pt, params + list(p["main"].captured.values()))
        f = {k: pt.to_tensor(v) for k, v in feed.items()}
        if dt == "f64":
            f["image"] = float64_tensor(pt, feed["image"])
        t0 = time.perf_counter()
        out = run_static(pt, p["main"], f, [p["loss"]] + p["grads"])
        secs = time.perf_counter() - t0
        runs[dt] = (float(out[0]), [np.asarray(g, np.float64)
                                    for g in out[1:]])
        print(f"(ap) {dt}: loss {runs[dt][0]}, {len(out) - 1} gradients "
              f"fetched in {secs:.2f} s")
    loss_err, grad_err = step_errors(runs["f32"], runs["f64"])
    print(f"(ap) fp32 against float64: loss {loss_err:.3e} relative, "
          f"gradients {grad_err:.3e} of the largest")


def mobilenet_v2():
    rng = np.random.RandomState(SEED + 84)
    x = rng.randn(2, 3, 224, 224).astype(np.float32)
    y = np.array([3, 917], np.int64)
    pt.seed(SEED + 85)
    state = {k: np.asarray(v.numpy()).copy()
             for k, v in models.MobileNetV2().state_dict().items()}
    runs = {}
    for dt in ("f32", "f64"):
        net = models.MobileNetV2()
        net.set_state_dict(state)
        if dt == "f64":
            to_float64(pt, list(net.state_dict().values()))
        net.train()
        for layer in net.sublayers():
            if isinstance(layer, pt.nn.Dropout):
                layer.p = 0.0
        xt = float64_tensor(pt, x) if dt == "f64" else pt.to_tensor(x)
        loss = pt.nn.functional.cross_entropy(net(xt),
                                              pt.to_tensor(y)).mean()
        loss.backward()
        runs[dt] = (float(loss), [np.asarray(p.grad.numpy(), np.float64)
                                  for p in net.parameters()])
    loss_err, grad_err = step_errors(runs["f32"], runs["f64"])
    print(f"(aq) MobileNetV2 step, fp32 against float64: loss "
          f"{loss_err:.3e} relative, gradients {grad_err:.3e} of the "
          "largest")


def main():
    pt.set_device("cpu")
    torch.manual_seed(SEED)
    ssd()
    mobilenet_v2()


if __name__ == "__main__":
    main()
