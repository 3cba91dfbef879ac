#!/usr/bin/env python3
"""How far fp32 static ResNet steps at 32 x 32, batch 4, land from a
float64 evaluation of the same steps, for the JAX package and the port
(CPU only; the figures ``tests/test_torch_static.py`` cites for running
its ResNet comparisons in float64).

Both packages build ``bench.py``'s program (cross entropy, Momentum
0.002 / 0.9 / 1e-4) at 32 x 32 with 10 classes from the JAX package's
seeded weights; the port also runs it in float64 (parameters, buffers
and feeds cast after the build).  Prints the losses and, for the
parameters and batch-norm buffers after the steps, the worst
|a - b| / (1e-5 + 1e-4 |b|) of the reference's fp32 and the port's fp32
against the port's float64, and of the port's fp32 against the
reference's fp32.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/resnet_fp32_conditioning.py 18 3
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/resnet_fp32_conditioning.py 50 1
"""
import argparse

import numpy as np
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu import static as JS
from paddle_tpu.vision import models as JM
from paddle_tpu_torch import static as TS
from paddle_tpu_torch.vision import models as TM


def program(mod, S, F, ctor, size):
    mod.enable_static()
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        img = S.data("image", [None, 3, size, size], "float32")
        label = S.data("label", [None, 1], "int64")
        net = ctor(num_classes=10)
        loss = F.cross_entropy(net(img), label).mean()
        mod.optimizer.Momentum(learning_rate=0.002, momentum=0.9,
                               weight_decay=1e-4).minimize(loss)
    mod.disable_static()
    return main, net, loss


def worst(a, b):
    return max(float((np.abs(a[k] - b[k]) / (1e-5 + 1e-4 * np.abs(b[k])))
                     .max()) for k in b)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("depth", type=int, choices=(18, 50))
    ap.add_argument("steps", type=int)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    pt.set_device("cpu")
    P.seed(3)
    name = f"resnet{args.depth}"
    jm, jnet, jloss = program(P, JS, JF, getattr(JM, name), args.size)
    init = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    rng = np.random.RandomState(0)
    x = rng.randn(args.batch, 3, args.size, args.size).astype(np.float32)
    y = rng.randint(0, 10, (args.batch, 1)).astype(np.int64)
    exe = JS.Executor()
    P.enable_static()
    jl = [float(exe.run(jm, feed={"image": x, "label": y},
                        fetch_list=[jloss])[0]) for _ in range(args.steps)]
    P.disable_static()
    jw = {k: np.asarray(v.numpy()).astype(np.float64)
          for k, v in jnet.state_dict().items()}
    out = {}
    for dt in (torch.float32, torch.float64):
        tm, tnet, tloss = program(pt, TS, TF, getattr(TM, name), args.size)
        tnet.set_state_dict(init)
        for t in tnet.state_dict().values():
            t.value = t.value.detach().to(dt)
            if isinstance(t, pt.tensor.Parameter):
                t._mark()
        exe = TS.Executor()
        feed = {"image": pt.Tensor(torch.from_numpy(x).to(dt)), "label": y}
        pt.enable_static()
        tl = [float(exe.run(tm, feed=feed, fetch_list=[tloss])[0])
              for _ in range(args.steps)]
        pt.disable_static()
        out[dt] = tl, {k: v.value.detach().double().numpy()
                       for k, v in tnet.state_dict().items()}
    (l32, w32), (l64, w64) = out[torch.float32], out[torch.float64]
    print(f"{name}, {args.steps} step(s), {args.size} x {args.size}, batch "
          f"{args.batch}: losses reference fp32 {jl}, port fp32 {l32}, "
          f"port float64 {l64}")
    print(f"worst |a - b| / (1e-5 + 1e-4 |b|): reference fp32 against "
          f"port float64 {worst(jw, w64):.1f}; port fp32 against port "
          f"float64 {worst(w32, w64):.1f}; port fp32 against reference "
          f"fp32 {worst(w32, jw):.1f}")


if __name__ == "__main__":
    main()
