#!/usr/bin/env python3
"""Host ms of the paged engine's prefill chunks at ``gpt_345m``'s full
width, fp and int8, for one or more checkouts of this repository in turn,
on one GPU.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/chunk_host_ms.py ROOT [ROOT ...] [--rounds 3]

Each ROOT (``.`` for this tree, or another commit unpacked with ``git
archive`` into a directory ``.gitignore`` lists) runs in a subprocess of
its own, in the order given, so give them as ``A B B A`` to alternate.  A
subprocess imports ROOT's ``paddle_tpu_torch``, builds its kernels into
ROOT's ``_build``, draws ``gpt_345m`` with ``init_params`` (seed 0) and
builds ``PagedServingEngine(slots=8, max_len=512, page_size=16,
prefill_chunk=16)``, then the same with ``quant="int8",
kv_dtype="int8"``.  Each engine takes ``--rounds`` numpy-seeded
300-token prompts (the same in every subprocess), one at a time, so every
chunk runs alone; the engine's ``chunk_s`` holds each chunk's host-clock
seconds, ending in its sampled-token readback.  Prints the card's name and
power limit, then one JSON line a subprocess: the median, lowest and
highest chunk ms, fp and int8.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

PROMPT = 300
CHUNK = 16


def child(root, rounds):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.inference.serving import PagedServingEngine
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import build
    if not paddle_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {paddle_tpu_torch.__file__}, not {root}")
    build.build(["layer_norm", "dequant_matmul", "paged_attn"])
    cfg = dataclasses.replace(gpt.gpt_345m(), use_pallas_norm=True)
    params = gpt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
               for _ in range(rounds)]
    out = {"root": root}
    for kv in ("fp", "int8"):
        kw = dict(quant="int8", kv_dtype="int8") if kv == "int8" else {}
        eng = PagedServingEngine((params, cfg), device="cuda", slots=8,
                                 max_len=512, page_size=16,
                                 prefill_chunk=CHUNK, **kw)
        eng.warmup()
        n0 = len(eng.chunk_s)
        for p in prompts:
            eng.submit(p, 1)
            eng.run()
        ms = [1e3 * t for t in eng.chunk_s[n0:]]
        if len(ms) != rounds * -(-PROMPT // CHUNK):
            raise SystemExit(f"{kv}: {len(ms)} chunks timed")
        out[kv] = {"chunks": len(ms), "median_ms": float(np.median(ms)),
                   "min_ms": min(ms), "max_ms": max(ms)}
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.roots[0], args.rounds)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        root, "--rounds", str(args.rounds)], check=True)


if __name__ == "__main__":
    main()
