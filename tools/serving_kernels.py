#!/usr/bin/env python3
"""Time the serving paths' redesigned kernels, the bf16 dequant matmul
(``dqmm_stream`` and ``dqmm_wg``), paged decode attention
(``paged_decode``), int8 paged decode attention (``paged_decode_q8``) and
the row-invariant product (``row_mm_tc``, beside its CUDA-core route and
``torch.mm``; and with its LayerNorm prologue, ``ln_row_mm_tc``, beside
the two launches it replaces and ``F.layer_norm`` + ``torch.mm``), beside
another version of the port's sources, and variants of their plans, on
one GPU in one process.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/serving_kernels.py [--against OTHER] [--rounds 5] \
        [--only dqmm|paged|row|ln]

``OTHER`` is the root of another checkout of this repository (an older
commit's, unpacked with ``git archive`` into a directory ``.gitignore``
lists).  Its ``paddle_tpu_torch/ops/cuda`` package is imported under
another name and builds its own libraries into its own ``_build``, so both
versions run through their own wrappers on the same operands.

Shapes: the dequant matmul at gpt_345m's four decode products ([8, K] x
[K, N] for qkv, proj, fc1 and fc2) and its prefill products at M = 4096;
both paged kernels at the serving decode shape (8 slots, 16 heads of 64,
page 16, 32 pages a slot, lengths 17-331), 16 ragged slots over 64 pages
and one slot of 8,191 positions; the row-invariant product at the same
four products at the decode's M = 8 and the verify's M = 40.  Operands are cycled in copies that pass
the 50 MB L2, as ``chip_smoke.py`` (c) does.  For each shape and version:
the device ms of a call (CUDA-graph replay, ``chip_smoke.device_ms``) and
the eager ms of a call (host launch cost included, ``chip_smoke.time_ms``),
each the median of ``--rounds`` rounds that visit the versions in turn,
each round starting one version later; the lowest and highest round
beside it.  Then this tree's kernels under other plans and as patched
variants (``DQMM_VARIANTS``, ``PAGED_VARIANTS``, ``Q8_VARIANTS``,
``ROW_VARIANTS``; those named "cut" break the result on purpose and only
their time counts: it shows what the part they cut costs): the cluster
size at the decode
shapes, the streaming kernel against the wgmma kernel at M = 8 and 16
(``_SMALL_M``), the fp paged kernel on the int8 kernel's grid-sized plan,
the int8 kernel on other split counts and ring shapes, the row product's
tensor route on other cluster sizes and warp counts, and the cuts at the
decode, prefill, paged and row shapes; for the row product also a
clock64() timeline of a block's phases (as built and with cuts), from one
eager call at each shape.  The card's name and power limit come
first.
"""
import argparse
import importlib
import importlib.util
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch import card_info  # noqa: E402
from paddle_tpu_torch.models import gpt  # noqa: E402
from paddle_tpu_torch.ops.cuda import build  # noqa: E402
from paddle_tpu_torch.ops.cuda import dequant_matmul as dqmm  # noqa: E402
from paddle_tpu_torch.ops.cuda import paged_attn, row_matmul  # noqa: E402

DQMM = [((8, 1024, 3072), "decode qkv"), ((8, 1024, 1024), "decode proj"),
        ((8, 1024, 4096), "decode fc1"), ((8, 4096, 1024), "decode fc2"),
        ((4096, 1024, 3072), "prefill qkv"),
        ((4096, 1024, 1024), "prefill proj"),
        ((4096, 1024, 4096), "prefill fc1"),
        ((4096, 4096, 1024), "prefill fc2")]
PAGED = [("S8 nh16 hd64 ps16 maxP32 (decode)", 8, 32, None),
         ("S16 nh16 hd64 ps16 maxP64 ragged", 16, 64, None),
         ("S1 nh16 hd64 ps16 maxP512, 8191 positions", 1, 512, [8190])]


def other_package(root):
    """``OTHER/paddle_tpu_torch/ops/cuda`` imported as ``other_cuda``:
    (its dequant_matmul module, its paged_attn module, its row_matmul
    module)."""
    pkg = Path(root).resolve() / "paddle_tpu_torch" / "ops" / "cuda"
    spec = importlib.util.spec_from_file_location(
        "other_cuda", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_cuda"] = mod
    spec.loader.exec_module(mod)
    importlib.import_module("other_cuda.build").build(
        ["dequant_matmul", "paged_attn", "row_matmul"])
    return (importlib.import_module("other_cuda.dequant_matmul"),
            importlib.import_module("other_cuda.paged_attn"),
            importlib.import_module("other_cuda.row_matmul"))


def rounds(fns, sets, n, calls):
    """{name: (median, low, high) device ms, (median, low, high) eager
    ms} over ``n`` rounds visiting ``fns`` in turn."""
    names = list(fns)
    dev = {k: [] for k in names}
    eager = {k: [] for k in names}
    for r in range(n):
        for i in range(len(names)):
            k = names[(i + r) % len(names)]
            dev[k].append(cs.device_ms(fns[k], sets, per_graph=len(sets)))
            eager[k].append(cs.time_ms(fns[k], sets, calls))
    return {k: ((statistics.median(dev[k]), min(dev[k]), max(dev[k])),
                (statistics.median(eager[k]), min(eager[k]),
                 max(eager[k]))) for k in names}


def show(label, res, bound=None):
    line = [f"  {label}:"]
    for k, (d, e) in res.items():
        line.append(f"{k} {d[0]:.5f} ms [{d[1]:.5f}, {d[2]:.5f}], eager "
                    f"{e[0]:.5f} [{e[1]:.5f}, {e[2]:.5f}];")
    if bound:
        line.append(f"bound {bound[0]:.6f} ({bound[1]})")
    print(" ".join(line), flush=True)


def dqmm_sets(M, K, N):
    copies = (max(2, min(64, -(-96 * 2 ** 20 // (K * N)))) if M <= 64
              else 2)
    sets = []
    for _ in range(copies):
        x = torch.randn((M, K), device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (K, N), device="cuda", dtype=torch.int8)
        sc = (torch.rand(N, device="cuda") + 0.1) / 64
        sets.append((x, w, sc))
    return sets


# design variants of this tree's sources and cuts of them: (name,
# [(text, replacement)]), each built as a library of its own and called
# through its C entry point on the wrapper's plan.  A "cut" breaks the
# result on purpose; only its time counts: it shows what the part it cuts
# costs.
STREAM_BODY = ("      const int r = 16 * (st & 3) + 2 * t;       "
               "// row of the stage")
DQMM_VARIANTS = [
    ("dqmm_wg cut: no conversion", [
        ("        convert_tile(sw + s * L::W_BYTES, bt, ct);\n", "")],
     "prefill"),
    ("dqmm_wg cut: no products", [
        ("            wgmma_ss<TN, 0, 1>(\n",
         "            if (M < 0) wgmma_ss<TN, 0, 1>(\n")],
     "prefill"),
    ("dqmm_wg cut: no stores", [
        ("            if (rr < M)\n              *reinterpret_cast",
         "            if (rr < 0)\n              *reinterpret_cast")],
     "prefill"),
    ("dqmm_stream: the weight map prefetched", [
        ("  if (threadIdx.x == 0) {\n"
         "    for (int i = 0; i < stages; ++i) mbar_init(full + 8 * i, 1);",
         "  if (threadIdx.x == 32 * ST_WARPS)\n"
         "    asm volatile(\"prefetch.tensormap [%0];\" :: \"l\"("
         "reinterpret_cast<uint64_t>(&tm_w)) : \"memory\");\n"
         "  if (threadIdx.x == 0) {\n"
         "    for (int i = 0; i < stages; ++i) mbar_init(full + 8 * i, 1);")],
     "decode"),
    ("dqmm_stream cut: return at once", [
        ("  uint32_t ncta;\n", "  if (M > 0) return;\n  uint32_t ncta;\n")],
     "decode"),
    ("dqmm_stream cut: no weight loads", [
        ("        mbar_expect_tx(full + 8 * i, ST_STAGE);",
         "        mbar_arrive(full + 8 * i); continue;")], "decode"),
    ("dqmm_stream cut: no x loads", [
        ("      if (m < M && k0 + c < kend)", "      if (m < 0)")], "decode"),
    ("dqmm_stream cut: no main loop", [
        ("    for (int st = warp; st < 4 * stages; st += ST_WARPS) {",
         "    for (int st = warp; st < 0; st += ST_WARPS) {")], "decode"),
    # (without the barrier no block may store to a peer, which may have
    # exited: both go)
    ("dqmm_stream cut: no cluster barrier and no stores to peers", [
        ("  __syncwarp();\n  cluster_sync();\n  if (warp < ST_WARPS) {",
         "  __syncwarp();\n  __syncthreads();\n  if (warp < ST_WARPS) {"),
        ("      st_cluster_f32(dst, o, sum);",
         "      if (sum == 12345.f) out[0] = __float2bfloat16(dst);")],
     "decode"),
]
PAGED_VARIANTS = [
    ("paged_decode cut: return at once", [
        ("  const int gi = threadIdx.x / G, li = threadIdx.x % G;\n",
         "  if (nh > 0) return;\n"
         "  const int gi = threadIdx.x / G, li = threadIdx.x % G;\n")]),
    ("paged_decode cut: no merge of the splits", [
        ("  if (ns == 1) return;\n  if (threadIdx.x == 0) {\n",
         "  if (ns >= 1) return;\n  if (threadIdx.x == 0) {\n")]),
]
# (name, pairs, cluster factor: the variant runs on this tree's tensor
# plan with the cluster that many times larger)
ROW_KQ = "constexpr int TC_KQ = 2; "
ROW_EXPECT = ("        mbar_expect_tx(full + 8 * s, (LN ? 0 : L.xbox()) + "
              "TC_STAGE);\n")
ROW_X_TMA = ("        if (!LN)\n"
             "          tma_load(sx + s * L.xbox(), &tm_x, full + 8 * s, "
             "k0 + s * TC_BOX,\n                   r0);\n")
ROW_W_LOOP = ("        for (int wb = 0; wb < TC_N / 64; ++wb)\n"
              "          tma_load(base + s * TC_STAGE")
ROW_NO_W_LOOP = (ROW_W_LOOP, ROW_W_LOOP.replace("wb < TC_N / 64", "wb < 0"))
ROW_NO_W = [(ROW_EXPECT, ROW_EXPECT.replace("(LN ? 0 : L.xbox()) + TC_STAGE",
                                            "(LN ? 0 : L.xbox())")),
            ROW_NO_W_LOOP]
ROW_NO_X = [(ROW_EXPECT + ROW_X_TMA,
             ROW_EXPECT.replace("(LN ? 0 : L.xbox()) + TC_STAGE",
                                "TC_STAGE"))]
ROW_NO_LOADS = [(ROW_EXPECT + ROW_X_TMA,
                 ROW_EXPECT.replace("(LN ? 0 : L.xbox()) + TC_STAGE", "0")),
                ROW_NO_W_LOOP]
ROW_NO_LOOP = ("  load(a0, b0, 0);\n  for (int i = 0; i < steps; i += 2) {",
               "  if (steps < 0) load(a0, b0, 0);\n"
               "  for (int i = 0; i < 0; i += 2) {")
ROW_NO_MMA = ("    for (int c = 0; c < NCH; ++c) mma16816(",
              "    for (int c = 0; c < NCH; ++c) if (steps < 0) mma16816(")
ROW_NO_LDSM = [("    ldsm_x4_t(a, a_lane + s * TC_STAGE + 16 * j * 128);",
                "    a[0] = a_lane + s; a[1] = j; a[2] = 1; a[3] = 2;"),
               ("    for (int c = 0; c < NCH; ++c) ldsm_x2(b[c], xk + c * 8 * 128);",
                "    for (int c = 0; c < NCH; ++c) { b[c][0] = xk + c; b[c][1] = 3; }")]
ROW_VARIANTS = [
    ("row_mm_tc: 4 warps a column group", [
        (ROW_KQ, "constexpr int TC_KQ = 4; ")], 1),
    ("row_mm_tc: 1 warp a column group", [
        (ROW_KQ, "constexpr int TC_KQ = 1; ")], 1),
    ("row_mm_tc: 128 columns a block, twice the cluster", [
        ("constexpr int TC_N = 64; ", "constexpr int TC_N = 128; ")], 2),
    ("row_mm_tc cut: return at once", [
        ("  const int cs = (int)cluster_size(), q = (int)cluster_rank();\n"
         "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
         "  const int n0 = blockIdx.y * TC_N",
         "  if (M > 0) return;\n"
         "  const int cs = (int)cluster_size(), q = (int)cluster_rank();\n"
         "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
         "  const int n0 = blockIdx.y * TC_N")], 1),
    ("row_mm_tc cut: no weight loads", ROW_NO_W, 1),
    ("row_mm_tc cut: no x loads", ROW_NO_X, 1),
    ("row_mm_tc cut: no products", [ROW_NO_MMA], 1),
    # (without the second barrier no block may store to a peer, which may
    # have exited: both go)
    ("row_mm_tc cut: no stores to peers and no second cluster barrier", [
        ("    st_cluster_v4(rb + ((q * L.mp + m) * L.cw + col - o * L.cw) * 4,"
         "\n                  (uint32_t)o, sum);",
         "    if (sum.x == 12345.f) y[0] = __float2bfloat16((float)o);"),
        ("  }\n  cluster_sync();\n  // this rank's columns",
         "  }\n  __syncthreads();\n  // this rank's columns")], 1),
    ("row_mm_tc cut: no loads", ROW_NO_LOADS, 1),
    ("row_mm_tc cut: no loads, no stage loop", [*ROW_NO_LOADS, ROW_NO_LOOP],
     1),
]
# the LayerNorm prologue of ln_row_mm_tc (pt_ln_row_matmul, g and b fp32,
# on this tree's tensor-route plan): its cuts
LN_NORMALISE = "      if (j < ng) {\n        uint4* p = chunk("
LN_PASS = "    for (int j = lane; j < kg; j += 32) {\n"
LN_VARIANTS = [
    ("ln_row_mm_tc cut: no normalisation (x as loaded)", [
        (LN_NORMALISE, LN_NORMALISE.replace("j < ng", "j < ng && M < 0"))]),
    ("ln_row_mm_tc cut: no moment sums, no normalisation", [
        (LN_NORMALISE, LN_NORMALISE.replace("j < ng", "j < ng && M < 0")),
        (LN_PASS, LN_PASS.replace("j < kg", "j < kg && M < 0"))]),
    # (the producer then waits for no consumer before issuing x and W)
    ("ln_row_mm_tc cut: no prologue (rows of x still loaded whole)", [
        ("    if (warp < TC_WARPS)\n      tc_ln_prologue(",
         "    if (warp < 0)\n      tc_ln_prologue("),
        ("    if constexpr (LN) named_sync(2, TC_THREADS);\n", "")]),
]

# the kernel with clock64() stamps at its phase boundaries, which thread 0
# of each block writes over y (26 int64 a block, as many blocks as y holds:
# 8 stamps less the first, the globaltimer at entry and at exit, 16
# zeros); its result is not the product
ROW_TIMELINE = [
    ("  const int cs = (int)cluster_size(), q = (int)cluster_rank();\n"
     "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
     "  const int n0 = blockIdx.y * TC_N",
     "  long long tl[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long g0, g1;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"
     "  tl[0] = clock64();\n"
     "  const int cs = (int)cluster_size(), q = (int)cluster_rank();\n"
     "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
     "  const int n0 = blockIdx.y * TC_N"),
    ("  __syncthreads();\n\n  float acc[TC_CHUNKS][4];",
     "  __syncthreads();\n  tl[1] = tl[2] = clock64();\n\n"
     "  float acc[TC_CHUNKS][4];"),
    ("  // every warp has waited for every stage and read its last one",
     "  tl[3] = clock64();\n"
     "  // every warp has waited for every stage and read its last one"),
    ("  __syncthreads();\n  // each output's partials in k16-position order",
     "  __syncthreads();\n  tl[4] = clock64();\n"
     "  // each output's partials in k16-position order"),
    ("  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n"
     "  const uint32_t rb = base + L.rb_off();",
     "  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n"
     "  tl[5] = clock64();\n  const uint32_t rb = base + L.rb_off();"),
    ("  cluster_sync();\n  // this rank's columns: the ranks' partials",
     "  cluster_sync();\n  tl[6] = clock64();\n"
     "  // this rank's columns: the ranks' partials"),
    ("    *reinterpret_cast<uint2*>(y + (long long)(r0 + m) * N + n) = out;"
     "\n  }\n}",
     "    if (out.x == 12345u) y[0] = __float2bfloat16(sum.x);\n  }\n"
     "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
     "    tl[7] = clock64();\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "    const long long b = blockIdx.x + gridDim.x * (blockIdx.y + "
     "gridDim.y * blockIdx.z);\n"
     "    long long* o = reinterpret_cast<long long*>(y) + 26 * b;\n"
     "    if (26 * 8 * (b + 1) <= 2LL * M * N) {\n"
     "      for (int i = 0; i < 8; ++i) o[i] = tl[i] - tl[0];\n"
     "      o[8] = (long long)g0;\n      o[9] = (long long)g1;\n"
     "      for (int i = 10; i < 26; ++i) o[i] = 0;\n"
     "    }\n  }\n}"),
]
ROW_TIMELINES = [("as built", []), ("no weight loads", ROW_NO_W),
                 ("no loads, no products", [*ROW_NO_LOADS, ROW_NO_MMA]),
                 ("no loads, no fragment loads",
                  [*ROW_NO_LOADS, *ROW_NO_LDSM])]
ROW_PHASES = ("barriers set, x and W issued", "-", "waits and products",
              "partials to shared memory", "cluster wait",
              "sums to peers + cluster sync", "final sums and stores")
LN_PHASES = ("barriers set, loads issued, the prologue", *ROW_PHASES[1:])
Q8_VARIANTS = [
    ("paged_decode_q8: 1 position a group a stage, 8 stages", [
        ("constexpr int QU = 2; ", "constexpr int QU = 1; "),
        ("constexpr int QSTAGES = 4; ", "constexpr int QSTAGES = 8; ")]),
    ("paged_decode_q8: 4 positions a group a stage, 2 stages", [
        ("constexpr int QU = 2; ", "constexpr int QU = 4; "),
        ("constexpr int QSTAGES = 4; ", "constexpr int QSTAGES = 2; ")]),
    ("paged_decode_q8: 512 threads, 2 stages", [
        ("constexpr int QT = 256; ", "constexpr int QT = 512; "),
        ("constexpr int QSTAGES = 4; ", "constexpr int QSTAGES = 2; ")]),
    ("paged_decode_q8 cut: no K/V loads", [
        ("  auto issue = [&](int st) {\n    if (st < nst) {",
         "  auto issue = [&](int st) {\n    if (st < 0) {")]),
    ("paged_decode_q8 cut: return at once", [
        ("  const int t = threadIdx.x, gi = t / G, li = t % G, i0 = li * 16;"
         "\n", "  if (nh > 0) return;\n"
         "  const int t = threadIdx.x, gi = t / G, li = t % G, i0 = li * 16;"
         "\n")]),
    ("paged_decode_q8 cut: no merge of the splits", [
        ("  if (ns == 1) return;\n  float* ml = ws",
         "  if (ns >= 1) return;\n  float* ml = ws")]),
]


def variant_libs(specs):
    """Patched copies of this tree's csrc sources, built with the port's
    nvcc flags, one nvcc each, all at once, and loaded with ctypes: for
    (name, source, pairs) in ``specs``, {name: ctypes.CDLL}."""
    import ctypes
    import hashlib
    import subprocess
    patched = []
    for name, source, pairs in specs:       # every patch applies, or none
        src = (build.CSRC / source).read_text()
        for old, new in pairs:
            if old not in src:
                raise SystemExit(f"{name}: variant line not in the source: "
                                 f"{old!r}")
            src = src.replace(old, new)
        patched.append((name, source, src))
    procs = []
    for name, source, src in patched:
        out = build.BUILD_DIR / "serving_variants" / hashlib.blake2b(
            src.encode(), digest_size=6).hexdigest()
        out.mkdir(parents=True, exist_ok=True)
        (out / source).write_text(src)
        (out / "hopper.cuh").write_text(
            (build.CSRC / "hopper.cuh").read_text())
        lib = out / "lib.so"
        proc = None if lib.exists() else subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(out / source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append((name, lib, proc))
    logs = {name: proc.communicate()[0] for name, _, proc in procs
            if proc is not None}           # every nvcc ends before a raise
    libs = {}
    for name, lib, proc in procs:
        if proc is not None and proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{logs[name]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def dqmm_variant(name, lib):
    """fn(x, w, s) calling a variant's ``pt_dqmm_bf16`` on this tree's
    plan."""
    import ctypes
    fn = lib.pt_dqmm_bf16
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll] + [p] * 3 + [i] * 7 + [p]
    fn.restype = i

    def call(x, w, s):
        M, K = x.shape
        N = w.shape[1]
        sms = dqmm._sm_count(x.device)
        regime, cs_, kb = dqmm._plan(M, N, K, sms)
        out_t = torch.empty((M, N), dtype=x.dtype, device=x.device)
        err = fn(x.data_ptr(), K, w.data_ptr(), s.data_ptr(),
                 out_t.data_ptr(), M, N, K, dqmm._REGIME[regime], cs_, kb,
                 sms, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: CUDA error {err}")
        return out_t
    return call


def paged_variant(name, lib, quant=False, plan=None):
    """fn(q, k, v, table, lens), or with ``quant`` fn(q, kq, ks, vq, vs,
    table, lens), calling a library's ``pt_paged_attention_fwd`` (or
    ``pt_paged_attention_quant_fwd``) as the wrapper does, on the
    wrapper's plan or on ``plan(S, nh, maxP, ps)``."""
    import ctypes
    import math
    fn = (lib.pt_paged_attention_quant_fwd if quant
          else lib.pt_paged_attention_fwd)
    ptrs = 10 if quant else 8
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, *rest):
        k, table = rest[0], rest[-2]
        S, _, nh, hd = q.shape
        P, ps = k.shape[:2]
        maxP = table.shape[1]
        if plan is not None:
            pps, splits = plan(S, nh, maxP, ps)
        elif quant:
            pps, splits = paged_attn._grid_plan(
                S, nh, maxP, ps, paged_attn._sm_count(q.device))
        else:
            pps, splits = paged_attn._split_plan(maxP, ps)
        ws, tickets = paged_attn._workspace(
            q.device, S * nh * splits * (hd + 2), S * nh)
        out_t = torch.empty_like(q)
        err = fn(q.data_ptr(), *(t.data_ptr() for t in rest),
                 out_t.data_ptr(), ws, tickets, S, nh, hd, P, ps, maxP,
                 pps, splits, math.sqrt(hd), 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: CUDA error {err}")
        return out_t
    return call


def splits_plan(n):
    """A plan of whole pages in about ``n`` splits."""
    def plan(S, nh, maxP, ps):
        pps = -(-maxP // min(n, maxP))
        return pps, -(-maxP // pps)
    return plan


def grid_plan(S, nh, maxP, ps):
    return paged_attn._grid_plan(S, nh, maxP, ps,
                                 paged_attn._sm_count(torch.device("cuda")))


def table_plan(S, nh, maxP, ps):
    return paged_attn._split_plan(maxP, ps)


def with_plan(plan):
    """This tree's dequant_matmul under a fixed bf16 plan."""
    def fn(x, w, s):
        keep = dqmm._plan
        dqmm._plan = lambda *a: plan
        try:
            return dqmm.dequant_matmul(x, w, s)
        finally:
            dqmm._plan = keep
    return fn


def stream_plan(M, N, K, cs_):
    boxes = -(-K // 64)
    per = -(-boxes // min(cs_, boxes))
    return ("stream", -(-boxes // per), 64 * per)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="root of another checkout")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", choices=("dqmm", "paged", "row", "ln"),
                    help="time one kernel family only (ln: the row "
                         "product's LayerNorm prologue; row includes it)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    name, limit = card_info()
    print(f"card: {name}, {limit}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["dequant_matmul", "paged_attn", "row_matmul"])
    other = other_package(args.against) if args.against else None
    rng = np.random.default_rng(cs.SEED)
    want = ({"dqmm", "paged", "row", "ln"} if args.only is None
            else {args.only, "ln"} if args.only == "row" else {args.only})

    libs = variant_libs(
        ([(n, "dequant_matmul.cu", pairs) for n, pairs, _ in DQMM_VARIANTS]
         if "dqmm" in want else [])
        + ([(n, "paged_attn.cu", pairs)
            for n, pairs in PAGED_VARIANTS + Q8_VARIANTS]
           + [("as built", "paged_attn.cu", [])]
           if "paged" in want else [])
        + ([(n, "row_matmul.cu", pairs) for n, pairs, _ in ROW_VARIANTS]
           + [(f"row timeline, {n}", "row_matmul.cu", pairs + ROW_TIMELINE)
              for n, pairs in ROW_TIMELINES]
           if "row" in want else [])
        + ([(n, "row_matmul.cu", pairs) for n, pairs in LN_VARIANTS]
           + [("ln timeline", "row_matmul.cu", ROW_TIMELINE)]
           if "ln" in want else []))
    if "dqmm" in want:
        time_dqmm(args, other, libs)
    if "paged" in want:
        time_paged(args, other, libs, rng)
    if "ln" in want:
        time_ln(args, libs)
    if "row" in want:
        time_row(args, other, libs)


def time_dqmm(args, other, libs):
    print("dequant matmul, bf16 (this tree / other):", flush=True)
    for (M, K, N), label in DQMM:
        sets = dqmm_sets(M, K, N)
        fns = {"this": dqmm.dequant_matmul}
        if other:
            fns["other"] = other[0].dequant_matmul
        got = dqmm.dequant_matmul(*sets[0])
        ref = dqmm._ref_dequant_matmul(*sets[0])
        err = cs.gate([(got, ref, ref)], cs.BF16_ATOL, cs.BF16_RTOL)[0]
        show(f"[{M}, {K}] x [{K}, {N}] ({label}), plan "
             f"{dqmm._plan(M, N, K, dqmm._sm_count(got.device))}, gate "
             f"{err:.3f}", rounds(fns, sets, args.rounds, 50),
             cs.dqmm_bound(M, K, N, torch.bfloat16))
        del sets
    print("dequant matmul plans (this tree):", flush=True)
    for (M, K, N), label in DQMM[:4]:
        sets = dqmm_sets(M, K, N)
        fns = {f"cluster {c}": with_plan(stream_plan(M, N, K, c))
               for c in (2, 4, 8, 16)
               if stream_plan(M, N, K, c)[2] <= 16 * 64}
        show(f"[{M}, {K}] x [{K}, {N}] ({label})",
             rounds(fns, sets, args.rounds, 50))
        del sets
    variants = [(n, dqmm_variant(n, libs[n]), where)
                for n, _, where in DQMM_VARIANTS]
    for (M, K, N), label in DQMM:
        sets = dqmm_sets(M, K, N)
        fns = {"as built": dqmm.dequant_matmul,
               **{n: f for n, f, where in variants if label.startswith(where)}}
        show(f"[{M}, {K}] x [{K}, {N}] ({label})",
             rounds(fns, sets, args.rounds, 20),
             cs.dqmm_bound(M, K, N, torch.bfloat16))
        del sets
    for M in (8, 16, 17, 64, 256, 511, 512, 1000, 4096):
        K, N = 1024, 4096
        sets = dqmm_sets(M, K, N)
        sms = dqmm._sm_count(sets[0][0].device)
        plan = dqmm._plan(M, N, K, sms)
        fns = {**({"stream": with_plan(plan if plan[0] == "stream"
                                       else stream_plan(M, N, K, 8))}
                  if M <= 16 else {}),
               "wg128": with_plan(("wg128", 0, 0)),
               "wg256": with_plan(("wg256", 0, 0))}
        show(f"[{M}, {K}] x [{K}, {N}]", rounds(fns, sets, args.rounds, 50),
             cs.dqmm_bound(M, K, N, torch.bfloat16))
        del sets



def time_paged(args, other, libs, rng):
    built = libs["as built"]
    paged_variants = [(n, paged_variant(n, libs[n]))
                      for n, _ in PAGED_VARIANTS]
    paged_variants.append(("this, grid-sized plan", paged_variant(
        "grid plan", built, plan=grid_plan)))
    print("paged decode attention, bf16 (this tree / other):", flush=True)
    paged_lens = {}
    for label, S, maxP, lens in PAGED:
        if lens is None:
            hi = 332 if S == 8 else maxP * 16 - 1
            lens = [int(n) for n in rng.integers(17, hi, S)]
        paged_lens[label] = lens
        sets = cs.paged_inputs(torch, rng, torch.bfloat16, S, 16, 64, 16,
                               maxP, lens, copies=8 if S <= 8 else 2)
        fns = {"this": paged_attn.paged_attention}
        if other:
            fns["other"] = other[1].paged_attention
        fns.update({n: f for n, f in paged_variants})
        got = paged_attn.paged_attention(*sets[0])
        ref = paged_attn._ref_paged_attention(*sets[0])
        show(f"{label}, lens {lens if S <= 8 else '...'}, plan "
             f"{paged_attn._split_plan(maxP, 16)}, grid-sized "
             f"{grid_plan(S, 16, maxP, 16)}, max_abs_err "
             f"{cs.max_err(got, ref):.3e}",
             rounds(fns, sets, args.rounds, 200),
             cs.paged_bound(sets[0][0], sets[0][1], sets[0][3], sets[0][4]))
        del sets

    q8_variants = [(n, paged_variant(n, libs[n], quant=True))
                   for n, _ in Q8_VARIANTS]
    print("int8 paged decode attention, bf16 (this tree / other):",
          flush=True)
    for label, S, maxP, _ in PAGED:
        lens = paged_lens[label]
        sets = cs.paged_quant_inputs(
            torch, gpt, rng, torch.bfloat16, S, 16, 64, 16, maxP, lens,
            copies=8 if S <= 8 else 4, v_mean=S == 1)
        fns = {"this": paged_attn.paged_attention_quant}
        if other:
            fns["other"] = other[1].paged_attention_quant
        plans = {"this, table-sized plan": table_plan,
                 **{f"this, {n} splits": splits_plan(n) for n in (
                     (2,) if S == 8 else (2, 4) if S == 16 else
                     (4, 16, 32))}}
        fns.update({n: paged_variant(n, built, quant=True, plan=p)
                    for n, p in plans.items()})
        fns.update({n: f for n, f in q8_variants})
        got = paged_attn.paged_attention_quant(*sets[0])
        ref = paged_attn._ref_paged_attention_quant(*sets[0])
        show(f"{label}, lens {lens if S <= 8 else '...'}, plan "
             f"{grid_plan(S, 16, maxP, 16)}, max_abs_err "
             f"{cs.max_err(got, ref):.3e}",
             rounds(fns, sets, args.rounds, 200),
             cs.paged_quant_bound(sets[0][0], sets[0][1], sets[0][5],
                                  sets[0][6]))
        del sets



def row_sets(M, K, N):
    """bf16 (x [M, K], W [K, N]) pairs, W in copies that pass the L2."""
    return [(torch.randn((M, K), device="cuda").to(torch.bfloat16),
             (torch.randn((K, N), device="cuda") * 0.02).to(torch.bfloat16))
            for _ in range(cs.l2_copies(K * N * 2))]


def row_route(route):
    """fn(x, w): one launch of this tree's row product on ``route``."""
    return lambda x, w: row_matmul._launch(x, w, route)


def cluster_plan(K, cs_):
    """The tensor route's (cs, kb) on a cluster of about ``cs_`` blocks
    (whole 64-row boxes, as ``_plan`` cuts them)."""
    boxes = -(-K // 64)
    most = row_matmul._TC_MAX_BOXES
    per = -(-boxes // max(min(cs_, boxes), -(-boxes // most)))
    return -(-boxes // per), 64 * per


def row_cluster(cs_):
    """fn(x, w): this tree's tensor route on a cluster of about ``cs_``
    blocks."""
    def fn(x, w):
        plan = cluster_plan(w.shape[0], cs_)
        keep = row_matmul._plan
        row_matmul._plan = lambda route, k, n: (
            plan if route == "tensor" else keep(route, k, n))
        try:
            return row_matmul._launch(x, w, "tensor")
        finally:
            row_matmul._plan = keep
    return fn


def row_variant(name, lib, factor=1):
    """fn(x, w) calling a variant's ``pt_row_matmul`` on this tree's
    tensor-route plan, its cluster ``factor`` times larger."""
    import ctypes
    fn = lib.pt_row_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, w):
        _, ints = row_matmul._args(x, w, "tensor")
        if factor != 1:
            ints = ints[:5] + cluster_plan(ints[1], factor * ints[5])
        y = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                        device=x.device)
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), *ints,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: CUDA error {err}")
        return y
    return call


def ln_sets(M, K, N):
    """bf16 (x [M, K], g, b [K] fp32, W [K, N]) sets, W in copies that
    pass the L2."""
    g = 1 + 0.1 * torch.randn(K, device="cuda")
    b = 0.1 * torch.randn(K, device="cuda")
    return [(x, g, b, w) for x, w in row_sets(M, K, N)]


def ln_variant(name, lib):
    """fn(x, g, b, w) calling a variant's ``pt_ln_row_matmul`` on this
    tree's tensor-route plan."""
    import ctypes
    fn = lib.pt_ln_row_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, g, b, w):
        _, (M, K, N, dt, rc, cs_, kb) = row_matmul._args(x, w, "tensor")
        y = torch.empty((M, N), dtype=x.dtype, device=x.device)
        err = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(),
                 y.data_ptr(), M, K, N, dt, 0, rc, cs_, kb, 1e-5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: CUDA error {err}")
        return y
    return call


def time_ln(args, libs):
    """The row product with its LayerNorm prologue at qkv and fc1, M = 8
    and 40, bf16 with g and b fp32 (the model's): the fused call, the
    product alone, the LayerNorm kernel and the product launched apart,
    ``F.layer_norm`` + ``torch.mm`` and the prologue's cuts; then a
    clock64() timeline of the fused kernel's blocks."""
    from paddle_tpu_torch.ops.cuda import norms
    F = torch.nn.functional
    print("row product with the LayerNorm prologue, bf16, g and b fp32 "
          "(fused / row product alone / two launches / F.layer_norm + "
          "torch.mm / variants):", flush=True)
    for M in (8, 40):
        for K, N, name in cs.LN_SHAPES:
            sets = ln_sets(M, K, N)
            fns = {"fused": lambda x, g, b, w: row_matmul.ln_matmul(
                       x, g, b, 1e-5, w),
                   "row product alone": lambda x, g, b, w: row_matmul.matmul(
                       x, w),
                   "two launches": lambda x, g, b, w: row_matmul.matmul(
                       norms.layer_norm(x, g, b, 1e-5), w),
                   "F.layer_norm + torch.mm": lambda x, g, b, w: torch.mm(
                       F.layer_norm(x, (K,), g.bfloat16(), b.bfloat16(),
                                    1e-5), w)}
            ref = row_matmul._ref_ln_matmul(sets[0][0], sets[0][1],
                                            sets[0][2], 1e-5, sets[0][3])
            gates = []
            for n, _ in LN_VARIANTS:
                fns[n] = ln_variant(n, libs[n])
                if "cut" not in n:
                    got = fns[n](*sets[0])
                    gates.append(f"{n}: gate "
                                 f"{cs.gate([(got, ref, ref)], 2.0 ** -8, 2.0 ** -6)[0]:.3f}")
            got = fns["fused"](*sets[0])
            err = cs.gate([(got, ref, ref)], 2.0 ** -8, 2.0 ** -6)[0]
            show(f"[{M}, {K}] x [{K}, {N}] ({name}), gate {err:.3f}; "
                 + "; ".join(gates),
                 rounds(fns, sets, args.rounds, 50),
                 cs.ln_mm_bound(M, K, N, torch.bfloat16, torch.float32))
            del sets
    print("row product with the LayerNorm prologue: where a block's time "
          "goes (clock64 cycles from its entry, mean / max over blocks; "
          "the first phase holds the prologue):", flush=True)
    stamp = ln_variant("ln timeline", libs["ln timeline"])
    for M in (8, 40):
        for K, N, name in cs.LN_SHAPES:
            sets = ln_sets(M, K, N)
            for a in sets:
                stamp(*a)
            torch.cuda.synchronize()
            cs_, kb = row_matmul._plan("tensor", K, N)
            blocks = min(cs_ * -(-N // 64) * -(-M // 64), M * N * 2 // 208)
            t = stamp(*sets[0]).view(torch.int64).flatten()[:26 * blocks]
            t = t.view(blocks, 26).cpu().numpy()
            d = np.diff(t[:, :8], axis=1)
            print(f"  [{M}, {K}] x [{K}, {N}] ({name}), {blocks} blocks: "
                  + "; ".join(f"{p} {d[:, i].mean():.0f} / {d[:, i].max()}"
                              for i, p in enumerate(LN_PHASES))
                  + f"; span {t[:, 9].max() - t[:, 8].min()} ns",
                  flush=True)
            del sets


def time_row(args, other, libs):
    bf16 = torch.bfloat16
    shapes = [(M, K, N, name) for M in (8, 40)
              for K, N, name in cs.ROW_SHAPES]
    print("row-invariant product, bf16 (this tree's routes / torch.mm / "
          "other):", flush=True)
    for M, K, N, name in shapes:
        sets = row_sets(M, K, N)
        fns = {"tensor": row_matmul.matmul,
               "cuda_core": row_route("cuda_core"), "torch.mm": torch.mm}
        if other:
            fns["other"] = other[2].matmul
        got = row_matmul.matmul(*sets[0])
        ref = row_matmul._ref_matmul(*sets[0])
        err = cs.gate([(got, ref, ref)], 2.0 ** -8, 2.0 ** -6)[0]
        show(f"[{M}, {K}] x [{K}, {N}] ({name}), plan "
             f"{row_matmul._plan('tensor', K, N)}, gate {err:.3f}",
             rounds(fns, sets, args.rounds, 50),
             cs.row_mm_bound(M, K, N, bf16))
        del sets
    print("row product, tensor route by cluster size (this tree):",
          flush=True)
    for M, K, N, name in shapes:
        sets = row_sets(M, K, N)
        fns = {f"cluster {c}": row_cluster(c) for c in (1, 2, 4, 8, 16)}
        show(f"[{M}, {K}] x [{K}, {N}] ({name})",
             rounds(fns, sets, args.rounds, 50))
        del sets
    print("row product, tensor route: where a block's time goes (clock64 "
          "cycles from its entry, mean / max over blocks; one eager call "
          "each; the globaltimer spread of the blocks' entries and the span "
          "from the first entry to the last exit, ns):", flush=True)
    for tname, _ in ROW_TIMELINES:
        stamp = row_variant(tname, libs[f"row timeline, {tname}"])
        for M, K, N, name in shapes:
            sets = row_sets(M, K, N)
            for a in sets:
                stamp(*a)
            torch.cuda.synchronize()
            cs_, kb = row_matmul._plan("tensor", K, N)
            blocks = min(cs_ * -(-N // 64) * -(-M // 64), M * N * 2 // 208)
            t = stamp(*sets[0]).view(torch.int64).flatten()[:26 * blocks]
            t = t.view(blocks, 26).cpu().numpy()
            d = np.diff(t[:, :8], axis=1)
            print(f"  {tname}: [{M}, {K}] x [{K}, {N}] ({name}), {blocks} "
                  "blocks: " + "; ".join(
                      f"{p} {d[:, i].mean():.0f} / {d[:, i].max()}"
                      for i, p in enumerate(ROW_PHASES))
                  + f"; entries spread {t[:, 8].max() - t[:, 8].min()} ns,"
                  f" span {t[:, 9].max() - t[:, 8].min()} ns",
                  flush=True)
            del sets
    variants = [(n, row_variant(n, libs[n], f)) for n, _, f in ROW_VARIANTS]
    for M, K, N, name in shapes:
        sets = row_sets(M, K, N)
        fns = {"as built": row_matmul.matmul, **dict(variants)}
        show(f"[{M}, {K}] x [{K}, {N}] ({name})",
             rounds(fns, sets, args.rounds, 20),
             cs.row_mm_bound(M, K, N, bf16))
        del sets


if __name__ == "__main__":
    main()
