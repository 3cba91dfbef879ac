#!/usr/bin/env python3
"""Host microseconds an eager op of ``chip_smoke.py`` (ah): the encoder
of (n) at ERNIE-3.0-Base widths in bf16, [8, 512] token ids, under
``no_grad``, for one or more checkouts of this repository in turn, on one
GPU.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/op_host_us.py ROOT [ROOT ...] [--forwards 3]

Each ROOT (``.`` for this tree, or another commit unpacked with ``git
archive`` into a directory ``.gitignore`` lists) runs in a subprocess of
its own, in the order given, so give them as ``A B B A`` to alternate.  A
subprocess imports ROOT's ``paddle_tpu_torch``, builds its LayerNorm and
flash kernels into ROOT's ``_build``, draws the encoder from a numpy seed
and runs one warm-up forward, then ``--forwards`` forwards under the
port's ``profiler.Profiler`` (host time op by op, as (ah) reads it), then
the three kernel wrappers alone at the encoder's shapes, 200 calls each
with no sync between (host µs a call: the wrapper, its checks and, where
the kernel is a ``torch.library`` op, the dispatcher).  Prints the card's
name and power limit, then one JSON line a subprocess.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

V, H, L, NH, F, N, B = 40064, 768, 12, 12, 3072, 512, 8
CALLS = 200


def child(root, forwards):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops.cuda import build, flash_attn, norms
    if not pt.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {pt.__file__}, not {root}")
    build.build(["layer_norm", "flash_attn"])
    pt.set_device("gpu")

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(V, H)
            self.pos = nn.Embedding(N, H)
            self.encoder = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(H, NH, F, dropout=0.0,
                                           activation="gelu",
                                           normalize_before=True),
                L, norm=nn.RMSNorm(H))
            self.head = nn.Linear(H, V)

        def forward(self, ids):
            h = self.word(ids) + self.pos(pt.arange(ids.shape[1]))
            return self.head(self.encoder(h))

    model = Encoder().eval()
    rng = np.random.default_rng(0)
    model.set_state_dict({k: (0.02 * rng.standard_normal(
        v.shape, dtype=np.float32)) for k, v in model.state_dict().items()})
    model.to(dtype="bfloat16")
    ids = pt.to_tensor(rng.integers(0, V, (B, N)))
    with pt.no_grad():
        model(ids)
        torch.cuda.synchronize()
        prof = pt.profiler.Profiler()
        with prof:
            for _ in range(forwards):
                model(ids)
                torch.cuda.synchronize()
                prof.step()
    rows = [r for r in prof.summary()[1:] if r[0] != "profiler_step"]
    n_ops = sum(c for _, c, _ in rows)
    host = sum(t for _, _, t in rows)
    per_op = {name: round(1e6 * t / c, 2) for name, c, t in rows
              if name in ("layer_norm", "rms_norm", "flash_attention")}
    x = torch.randn(B, N, H, device="cuda", dtype=torch.bfloat16)
    g = torch.ones(H, device="cuda", dtype=torch.bfloat16)
    q = torch.randn(B, N, NH, H // NH, device="cuda", dtype=torch.bfloat16)
    wrappers = {}
    with torch.no_grad():
        for name, fn in (
                ("layer_norm", lambda: norms.layer_norm(x, g, g, 1e-5)),
                ("rms_norm", lambda: norms.rms_norm(x, g, 1e-6)),
                ("flash_attention",
                 lambda: flash_attn.flash_attention(q, q, q, False))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            wrappers[name] = round(1e6 * host_s / CALLS, 2)
    print("RESULT " + json.dumps({
        "root": root, "ops_a_forward": n_ops // forwards,
        "us_an_op": round(1e6 * host / n_ops, 2),
        "host_us_forward": round(1e6 * host / forwards, 1),
        "profiler_us_a_call": per_op, "wrapper_us_a_call": wrappers}),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--forwards", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.roots[0], args.forwards)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for root in args.roots:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", "--forwards", str(args.forwards),
                            root], capture_output=True, text=True)
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if r.returncode or not line:
            raise SystemExit(f"{root}: rc {r.returncode}\n{r.stderr[-3000:]}")
        print(line[0][len("RESULT "):], flush=True)


if __name__ == "__main__":
    main()
