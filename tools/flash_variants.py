#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention kernels (forward, dq, dk/dv
and the fused backward, ``paddle_tpu_torch/ops/cuda/csrc/flash_attn.cu``)
against each other on one GPU, in one process.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/flash_variants.py [--against OTHER/flash_attn.cu]

The variants are the committed source, whose grid is (row tiles, nh, B);
the committed source with the block's (row tile, batch, head) found other
ways: from a one-dimensional grid by 32-bit or by 64-bit division, or from
the two-dimensional grid (row tiles, B * nh) that held B * nh to 65,535;
the committed source with no register cap on the forward and dk/dv
kernels; and, with ``--against``, another version of the source with the
same C interface (an older commit's, say).  Each is built
with the port's own nvcc flags into ``paddle_tpu_torch/_build/
flash_variants/`` and called through its C entry points on the same
operands (eight copies cycled, so a call does not find its inputs in L2),
at the 345M training shape [8, 1024, 16, 64] and the flagship's [6, 2048,
16, 128], causal.  Every variant's forward, dq, dk and dv must equal the
committed source's (the fused backward's dq sums with atomics, so only
its dk and dv are compared).  Times are CUDA-event means over 20 calls,
taken in rounds that visit the variants in turn, each round starting one
variant later; the median round is printed with the lowest and highest,
and ptxas' registers, stack and spill loads for the kernel beside them.
The card's name and power limit come first.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
from paddle_tpu_torch.ops.cuda import build  # noqa: E402

SRC = build.CSRC / build.SOURCES["flash_attn"]
OUT = build.BUILD_DIR / "flash_variants"
SHAPES = [(8, 1024, 16, 64), (6, 2048, 16, 128)]
COPIES, CALLS, ROUNDS = 8, 20, 7

# the committed tile_of and grid, and the call sites of tile_of
TILE_OF = """__device__ __forceinline__ void tile_of(int& tile, int& b, int& h) {
  tile = blockIdx.x;
  h = blockIdx.y;
  b = blockIdx.z;
}"""
GRID = "  return dim3((unsigned)tiles, (unsigned)H, (unsigned)B);"
DKV_SITES = [("  tile_of(tile, b, h);\n  const int k0 = tile * " + t,
              f"  tile_of((Nk + {t} - 1) / {t}, H, tile, b, h);\n"
              f"  const int k0 = tile * {t}") for t in ("TK", "MR")]


def one_d(index):
    """The grid (row tiles * nh * B,), the block's tile, batch and head
    found by division of an ``index``-typed block index."""
    cast = "(unsigned)" if index == "unsigned" else ""
    return [(TILE_OF, f"""__device__ __forceinline__ void tile_of(int tiles, int H, int& tile,
                                        int& b, int& h) {{
  const {index} blk = blockIdx.x;
  tile = (int)(blk % {cast}tiles);
  const int bh = (int)(blk / {cast}tiles);
  b = bh / H;
  h = bh % H;
}}"""), *DKV_SITES,
            ("  tile_of(tile, b, h);", "  tile_of(nqt, H, tile, b, h);"),
            (GRID, "  return dim3((unsigned)((long long)tiles * B * H));")]


VARIANTS = [
    ("as built", []),
    ("1-D grid, 32-bit division", one_d("unsigned")),
    ("1-D grid, 64-bit division", one_d("long long")),
    ("2-D grid (tiles, B * nh)", [
        (TILE_OF, """__device__ __forceinline__ void tile_of(int H, int& tile, int& b,
                                        int& h) {
  tile = blockIdx.x;
  b = blockIdx.y / H;
  h = blockIdx.y % H;
}"""),
        ("  tile_of(tile, b, h);", "  tile_of(H, tile, b, h);"),
        (GRID, "  return dim3((unsigned)tiles, (unsigned)(B * H));")]),
    ("forward and dk/dv with no register cap", [
        ("__global__ void __launch_bounds__(MT, D == 256 ? 1 : 4)\n"
         "fa_fwd_mma(", "__global__ void __launch_bounds__(MT)\nfa_fwd_mma("),
        ("__global__ void __launch_bounds__(MT, D == 64 ? 3 : 1)\n"
         "fa_bwd_dkv_mma(",
         "__global__ void __launch_bounds__(MT)\nfa_bwd_dkv_mma(")]),
]
KERNELS = {"forward": "fa_fwd_mma", "dq": "fa_bwd_dq_mma",
           "dk/dv": "fa_bwd_dkv_mmaILi{hd}ELi\\d+ELb0",
           "fused": "fa_bwd_dkv_mmaILi{hd}ELi\\d+ELb1"}


def variant_source(src, pairs):
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"variant line not in the source: {old!r}")
        src = src.replace(old, new)
    return src


def ptxas_report(log):
    """[(mangled kernel name, "R regs, S stack, L spill loads")] from
    nvcc's ``-Xptxas=-v`` output."""
    out, cur, stack = [], None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        elif cur and "bytes stack frame" in line:
            m = re.search(r"(\d+) bytes stack frame.*?(\d+) bytes spill "
                          r"loads", line)
            stack = f"{m.group(1)} stack, {m.group(2)} spill loads"
        elif cur and "Used" in line and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            out.append((cur, f"{m.group(1)} regs, {stack}"))
            cur = None
    return out


def ptxas_of(report, kname, hd):
    pat = KERNELS[kname].format(hd=hd)
    if "ILi" not in pat:
        pat += f"ILi{hd}E"
    for name, rep in report:
        if re.search(pat, name):
            return rep
    return "?"


def load(path):
    lib = ctypes.CDLL(str(path))
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.pt_flash_fwd.argtypes = [p] * 5 + [i] * 5 + [ll] * 9 + [i, f, i, p]
    lib.pt_flash_bwd_dq.argtypes = ([p] * 7 + [i] * 5 + [ll] * 12
                                    + [i, f, i, p])
    lib.pt_flash_bwd_dkv.argtypes = ([p] * 8 + [i] * 5 + [ll] * 12
                                     + [i, f, i, p])
    lib.pt_flash_bwd_fused.argtypes = ([p] * 9 + [i] * 5 + [ll] * 12
                                       + [i, f, i, p])
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another flash_attn.cu to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    sources = [(name, variant_source(src, pairs)) for name, pairs in VARIANTS]
    if args.against:
        sources.append((f"--against {args.against}",
                        open(args.against).read()))
    nvcc = build.nvcc_path()
    procs = []
    for n, (_, text) in enumerate(sources):
        (OUT / f"v{n}.cu").write_text(text)
        procs.append(subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(OUT / f"v{n}.so"),
             str(OUT / f"v{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = [], []
    for n, proc in enumerate(procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{sources[n][0]}: nvcc failed\n{log[-3000:]}")
        libs.append(load(OUT / f"v{n}.so"))
        regs.append(ptxas_report(log))
    names = [name for name, _ in sources]
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, N, nh, hd in SHAPES:
        def rnd():
            return torch.randn((B, N, nh, hd), device="cuda",
                               generator=gen).to(torch.bfloat16)
        sets = []
        for _ in range(COPIES):
            q, k, v, do = rnd(), rnd(), rnd(), rnd()
            sets.append({"q": q, "k": k, "v": v, "do": do,
                         "o": torch.empty_like(q), "dq": torch.empty_like(q),
                         "dk": torch.empty_like(q), "dv": torch.empty_like(q),
                         "dq32": torch.zeros(q.shape, device="cuda"),
                         "lse": torch.empty((B, nh, N), device="cuda"),
                         "delta": torch.empty((B, nh, N), device="cuda")})
        st = [N * nh * hd, nh * hd, hd]       # b, n, h strides of each
        scale = hd ** -0.5

        def ptrs(s, *names):
            return [s[n].data_ptr() for n in names]

        def fwd(lib, s):
            return lib.pt_flash_fwd(*ptrs(s, "q", "k", "v", "o", "lse"),
                                    B, nh, N, N, hd, *st, *st, *st, 1,
                                    scale, 1, stream)

        def bwd(fn, outs):
            def call(lib, s):
                return getattr(lib, fn)(
                    *ptrs(s, "q", "k", "v", "do", "lse", "delta", *outs),
                    B, nh, N, N, hd, *st, *st, *st, *st, 1, scale, 1, stream)
            return call

        calls = {"forward": fwd, "dq": bwd("pt_flash_bwd_dq", ["dq"]),
                 "dk/dv": bwd("pt_flash_bwd_dkv", ["dk", "dv"]),
                 "fused": bwd("pt_flash_bwd_fused", ["dq32", "dk", "dv"])}
        # operands for the backward from the committed forward
        for s in sets:
            if fwd(libs[0], s):
                raise SystemExit("forward failed")
            s["delta"].copy_((s["o"].float() * s["do"].float()).sum(-1)
                             .transpose(1, 2))
        # every variant's outputs equal the committed source's
        checked = {"forward": ["o", "lse"], "dq": ["dq"],
                   "dk/dv": ["dk", "dv"], "fused": ["dk", "dv"]}
        s = sets[0]
        for kname, fn in calls.items():
            if fn(libs[0], s):
                raise SystemExit(f"{kname} failed")
            torch.cuda.synchronize()
            ref = [s[n].clone() for n in checked[kname]]
            for name, lib in zip(names[1:], libs[1:]):
                if fn(lib, s):
                    raise SystemExit(f"{name}: {kname} launch failed")
                torch.cuda.synchronize()
                if not all(torch.equal(s[n], r)
                           for n, r in zip(checked[kname], ref)):
                    raise SystemExit(f"{name}: {kname} differs from as built")
        for kname, fn in calls.items():
            times = {name: [] for name in names}
            for lib in libs:                    # warm-up
                for s in sets:
                    fn(lib, s)
            for r in range(ROUNDS):
                order = [(r + j) % len(libs) for j in range(len(libs))]
                for name, lib in ((names[j], libs[j]) for j in order):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for c in range(CALLS):
                        fn(lib, sets[c % COPIES])
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end) / CALLS)
            for name, rep in zip(names, regs):
                t = sorted(times[name])
                print(f"[{B}, {N}, {nh}, {hd}] causal bf16 {kname:8s} "
                      f"{name:40s} median {t[len(t) // 2]:.5f} ms "
                      f"(min {t[0]:.5f}, max {t[-1]:.5f}, {ROUNDS} rounds "
                      f"of {CALLS}); ptxas: {ptxas_of(rep, kname, hd)}",
                      flush=True)

if __name__ == "__main__":
    main()
