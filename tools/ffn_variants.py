#!/usr/bin/env python3
"""Time variants of the bf16 fused-FFN kernel (``paddle_tpu_torch/ops/
cuda/csrc/fused_ffn.cu``) on one GPU, to see what bounds it.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/ffn_variants.py

Each variant is the committed source with a few lines replaced: the
design's alternatives (x multicast to the cluster, whose code lives here
and not in the kernel; a 64-wide F tile; 64-row w2 steps at 256 columns a
block; 232 consumer registers) and diagnostic cuts whose results are wrong
on purpose (no TMA loads, the first product alone, no DSMEM loads of h, no
h barriers).  A replaced line that is no longer in the source stops the
script.  Every variant is built with the port's own nvcc flags into
``paddle_tpu_torch/_build/ffn_variants/``, launched through its C entry
point on the same operands, timed with CUDA events (two warm-up calls,
then five), and gated against ``_ref_fused_ffn`` where its result should
be right (bf16 per element 2^-8 + 2^-6 |ref|).  ptxas' "Potential
Performance Loss" notes are printed beside each variant.  The card's name
and power limit come first.
"""
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
from paddle_tpu_torch.ops.cuda import build, fused_ffn  # noqa: E402

SRC = build.CSRC / build.SOURCES["fused_ffn"]
OUT = build.BUILD_DIR / "ffn_variants"
SHAPES = [(12288, 2048, 8192), (8192, 1024, 4096)]

NO_LOADS = [("    if (threadIdx.x == 256) {", "    if (false) {"),
            ("    } else if (threadIdx.x == 288) {", "    } else if (false) {"),
            ("        mbar_wait(full1 + 8 * s1, p1);\n", ""),
            ("  mbar_wait(full, parity);\n", "")]
FIRST_ONLY = [("      for (int n = 0; n < steps; n += 2) {",
               "      for (int n = 0; n < 0; n += 2) {"),
              ("        for (int n = 0; n < cs * SUB; ++n) {",
               "        for (int n = 0; n < 0; ++n) {"),
              ("      wgmma_wait<0>();\n      release(empty2 + 8 * prev2, wg);",
               "      wgmma_wait<0>();")]
# x multicast: each block loads BM / cs rows of every x slice into every
# block of the cluster, and a stage is free once all 2 cs consumer
# warpgroups of the cluster have released it
MULTICAST = [
    ("// Synchronise the 128 threads of consumer warpgroup",
     """__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* m,
                                                   uint32_t bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0),
         "r"(c1), "h"(mask)
      : "memory");
}
// Synchronise the 128 threads of consumer warpgroup"""),
    ("// Thread `tid`'s h fragment of second-product step",
     """__device__ __forceinline__ void release_cs(uint32_t bar, int n, int wg) {
  wg_sync(wg);
  const int i = threadIdx.x & 127;
  if (i < n) mbar_arrive_cluster(bar, i);
}
// Thread `tid`'s h fragment of second-product step"""),
    ("mbar_init(empty1 + 8 * i, 2);", "mbar_init(empty1 + 8 * i, 2 * cs);"),
    ("          tma_load(sx + s1 * X_BYTES, &tm_x, full1 + 8 * s1, kb * BK, m0);",
     """          if (cs == 1)
            tma_load(sx + s1 * X_BYTES, &tm_x, full1 + 8 * s1, kb * BK, m0);
          else
            tma_load_multicast(sx + s1 * X_BYTES + rank * (BM / cs) * 128,
                               &tm_x, full1 + 8 * s1, kb * BK,
                               m0 + rank * (BM / cs),
                               (uint16_t)((1u << cs) - 1));"""),
    ("        if (prev >= 0) release(empty1 + 8 * prev, wg);",
     "        if (prev >= 0) release_cs(empty1 + 8 * prev, cs, wg);"),
    ("      release(empty1 + 8 * prev, wg);",
     "      release_cs(empty1 + 8 * prev, cs, wg);"),
    ("bf16_map(&tx, x, M, H, BM)", "bf16_map(&tx, x, M, H, BM / cs)"),
]
# (name, replacements, result is right)
VARIANTS = [
    ("as built", [], True),
    ("x multicast", MULTICAST, True),
    ("F tile 64", [("constexpr int FFN_BF = 128;", "constexpr int FFN_BF = 64;")],
     True),
    ("w2 steps of 64 rows", [("return NC == 256 ? 32 : 64;", "return 64;")],
     True),
    ("232 consumer registers",
     [("setmaxnreg.dec.sync.aligned.u32 24;", "setmaxnreg.dec.sync.aligned.u32 40;"),
      ("setmaxnreg.inc.sync.aligned.u32 240;",
       "setmaxnreg.inc.sync.aligned.u32 232;")], True),
    ("no TMA loads", NO_LOADS, False),
    ("first product only", FIRST_ONLY, False),
    ("first product only, no TMA loads", FIRST_ONLY + NO_LOADS, False),
    ("no DSMEM loads of h",
     [('    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\\n"\n'
       '                 : "=r"(h[4 * q]), "=r"(h[4 * q + 1]), "=r"(h[4 * q + 2]),\n'
       '                   "=r"(h[4 * q + 3])\n'
       '                 : "r"(a) : "memory");',
       "    h[4 * q] = h[4 * q + 1] = h[4 * q + 2] = h[4 * q + 3] = a;")], False),
    ("no h barriers", [("      mbar_wait(hfull + 8 * buf, hpar);", "")],
     False),
]


def variant_source(src, pairs):
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"variant line not in the source: {old!r}")
        src = src.replace(old, new)
    return src


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    nvcc = build.nvcc_path()
    procs = []
    for i, (name, pairs, _) in enumerate(VARIANTS):
        cu = OUT / f"v{i}.cu"
        cu.write_text(variant_source(src, pairs))
        procs.append(subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(OUT / f"v{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for i, p in enumerate(procs):
        log, _ = p.communicate()
        name = VARIANTS[i][0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        for line in log.splitlines():
            if "Performance Loss" in line:
                print(f"{name}: {line.split('Potential')[1][:120]}")
        lib = ctypes.CDLL(str(OUT / f"v{i}.so"))
        lib.pt_fused_ffn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                     + [ctypes.c_void_p])
        libs.append(lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, H, F in SHAPES:
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, device="cuda", generator=gen)
                    * scale).to(torch.bfloat16)
        args = (rnd(M, H), rnd(H, F, scale=H ** -0.5), rnd(F, scale=0.1),
                rnd(F, H, scale=F ** -0.5), rnd(H, scale=0.1))
        ref = fused_ffn._ref_fused_ffn(*args).float()
        out = torch.empty((M, H), dtype=torch.bfloat16, device="cuda")
        for (name, _, right), lib in zip(VARIANTS, libs):
            def run():
                err = lib.pt_fused_ffn(
                    *(t.data_ptr() for t in args), out.data_ptr(), M, H, F, 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
            run()
            run()
            torch.cuda.synchronize()
            gate = float(((out.float() - ref).abs()
                          / (2.0 ** -8 + 2.0 ** -6 * ref.abs())).max())
            if right and not gate <= 1.0:
                raise SystemExit(f"{name}: gate {gate} at {M}x{H}x{F}")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            print(f"[{M}, {H}] x [{H}, {F}]  {name:34s} "
                  f"{start.elapsed_time(end) / 5:.4f} ms"
                  + (f"  gate {gate:.3f}" if right else "  (result not kept)"),
                  flush=True)


if __name__ == "__main__":
    main()
