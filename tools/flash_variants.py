#!/usr/bin/env python3
"""Time the bf16 flash-attention kernels (forward, the split backward's dq
and dk/dv, and the fused backward, ``paddle_tpu_torch/ops/cuda/csrc/
flash_attn.cu``) beside another version of the source and variants of
it, on one GPU, in one process.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/flash_variants.py [--against OTHER/flash_attn.cu]

The sources are the committed one ("as built"), the variants below (each
a patch of it, timed only for the kernels it names), and, with
``--against``, another version with the same C interface (an older
commit's, unpacked with ``git archive`` into a directory ``.gitignore``
lists).  Some variants are designs; the ones named "cut" break the result
on purpose and only their time counts: it shows what the part they cut
costs.

For every source the fused backward is timed twice: the kernel alone, and
as the wrapper runs it, with the fp32 dq buffer zeroed before and cast to
bf16 after ("+ zero, cast").  Each source is built with the port's own
nvcc flags into ``paddle_tpu_torch/_build/flash_variants/`` and called
through its C entry points on the same operands (up to eight copies, at
most 400 MB, cycled, so that a call does not find its inputs in L2), at
the 345M training shape [8, 1024, 16, 64] and the flagship's [6, 2048,
16, 128], causal, the encoder's [8, 512, 12, 64] with no mask, hd 256 at
[2, 512, 8, 256] causal, and short rows at many heads, [4100, 128, 16,
64], with no mask (its forward only).  Beside each time is the largest
|difference| of the variant's outputs from the committed source's (out
and lse; dq; dk, dv; for the fused backward dk, dv and dq, whose adds'
order varies).  Times are CUDA-event means over 20 calls, taken in rounds
that visit the sources in turn, each round starting one source later; the
median round is printed with the lowest and highest, and ptxas'
registers, stack and spill loads for the kernel beside them.  The card's
name and power limit come first.
"""
import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from paddle_tpu_torch.ops.cuda import build  # noqa: E402

SRC = build.CSRC / build.SOURCES["flash_attn"]
OUT = build.BUILD_DIR / "flash_variants"
# B, N, nh, hd, causal, the kernels timed at the shape
SHAPES = [(8, 1024, 16, 64, True, None), (6, 2048, 16, 128, True, None),
          (8, 512, 12, 64, False, ("forward", "dq", "dk/dv")),
          (2, 512, 8, 256, True, ("dq", "dk/dv", "fused")),
          (4100, 128, 16, 64, False, ("forward",))]
COPIES, CALLS, ROUNDS = 8, 20, 7      # copies: at most, and at most 400 MB

# design variants of the committed kernels and cuts of them: (name,
# [(text, replacement)], the kernels it is timed for)
DQ_PRODUCER = """          mbar_expect_tx(bar, L::STAGE);
          if constexpr (WIDE) {
            const int c = chunk_of(grp, ci, nch);
            tma_load_4d(st + L::S_Q, &tm_q, bar, 64 * c, h, q0, b);"""
DKV_PRODUCER = """              mbar_expect_tx(bar, 2 * NB * L::QBOX);
              for (int kb = 0; kb < NB; ++kb) {"""
VARIANTS = [
    # 64-key K/V tiles at hd 64 too (the s and dp products at n = 64)
    ("dq: 64-key tiles at hd 64", [
        ("static constexpr int BKR = D == 128 ? 64 : 128;",
         "static constexpr int BKR = 64;")], ("dq",)),
    ("dk/dv: 4 stages", [
        ("static constexpr int ST = FUSED && D == 128 ? 2 : 3;",
         "static constexpr int ST = FUSED && D == 128 ? 2 : FUSED ? 3 : 4;")],
     ("dk/dv",)),
    # cuts: K/V (dq) or Q/dO (dk/dv and the fused kernel) loaded only while
    # the ring first fills, later stages reusing what is there; and the
    # exponentials of p replaced by a multiply
    ("dq cut: K/V loaded once a stage", [
        (DQ_PRODUCER, "          if (kt >= ST) { mbar_arrive(bar); if (++s "
         "== ST) { s = 0; ph ^= 1; } continue; }\n" + DQ_PRODUCER)], ("dq",)),
    ("dq cut: no exponentials", [
        ("      float p = exp2f(fmaf(s[4 * j + e], c2, -lse2[hi]));",
         "      float p = fmaf(s[4 * j + e], c2, -lse2[hi]) * 0.001f;")],
     ("dq",)),
    ("dk/dv cut: Q/dO loaded once a stage", [
        (DKV_PRODUCER, """              const bool cut = qt - qt0 >= ST;
              if (cut) mbar_arrive(bar);
              else mbar_expect_tx(bar, 2 * NB * L::QBOX);
              for (int kb = 0; kb < (cut ? 0 : NB); ++kb) {""")],
     ("dk/dv", "fused")),
    ("dk/dv cut: no exponentials", [
        ("        float p = exp2f(fmaf(sT[4 * j + e], c2, -lse2));",
         "        float p = fmaf(sT[4 * j + e], c2, -lse2) * 0.001f;")],
     ("dk/dv", "fused")),
]
# kernel -> ptxas name patterns of its instance at head width hd (this
# source's, then an older source's); hd 256 runs the backward's 64-column
# groups
NARROW = {"forward": [r"fa_fwd_wgILi{hd}ELb0"],
          "dq": [r"fa_bwd_dq_wgILi{hd}ELb0", r"fa_bwd_dq_mmaILi{hd}ELb0"],
          "dk/dv": [r"fa_bwd_wgILi{hd}ELb0ELb0",
                    r"fa_bwd_dkv_mmaILi{hd}ELi\d+ELb0"],
          "fused": [r"fa_bwd_wgILi{hd}ELb0ELb1", r"fa_bwd_wgILi{hd}ELb0EE"]}
GROUPS = {"dq": [r"fa_bwd_dq_wgILi64ELb1", r"fa_bwd_dq_mmaILi256ELb0"],
          "dk/dv": [r"fa_bwd_wgILi64ELb1ELb0",
                    r"fa_bwd_dkv_mmaILi256ELi\d+ELb0"],
          "fused": [r"fa_bwd_wgILi64ELb1ELb1", r"fa_bwd_wgILi64ELb1EE"]}


def patterns(kname, hd):
    kname = "fused" if kname.startswith("fused") else kname
    if hd == 256 and kname in GROUPS:
        return GROUPS[kname]
    return [p.format(hd=hd) for p in NARROW[kname]]


def patched(src, pairs):
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
    for pat in patterns(kname, hd):
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


def build_all(sources):
    """nvcc every (name, text, directory) at once; (libs, ptxas reports)."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = []
    for n, (_, text, srcdir) in enumerate(sources):
        path = OUT / f"v{n}.cu"
        path.write_text(text)
        # -I: its #includes resolve beside the file it came from
        procs.append(subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, f"-I{srcdir}", "-o",
             str(OUT / f"v{n}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = [], []
    for n, proc in enumerate(procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{sources[n][0]}: nvcc failed\n{log[-3000:]}")
        libs.append(load(OUT / f"v{n}.so"))
        regs.append(ptxas_report(log))
    return libs, regs


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
    committed = SRC.read_text()
    sources = [("as built", committed, SRC.parent)]
    timed_for = [None]              # the kernels each source is timed for
    for name, pairs, kernels in VARIANTS:
        sources.append((name, patched(committed, pairs), SRC.parent))
        timed_for.append(kernels)
    if args.against:
        other = Path(args.against)
        sources.append((f"against {args.against}", other.read_text(),
                        other.parent))
        timed_for.append(None)
    t0 = time.perf_counter()
    libs, regs = build_all(sources)
    print(f"built {len(sources)} sources in {time.perf_counter() - t0:.1f} s",
          flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, N, nh, hd, causal, only in SHAPES:
        def rnd():
            return torch.randn((B, N, nh, hd), device="cuda",
                               generator=gen).to(torch.bfloat16)
        sets = []
        nbytes = B * N * nh * hd * 2
        for _ in range(max(1, min(COPIES, (400 << 20) // nbytes))):
            q, k, v, do = rnd(), rnd(), rnd(), rnd()
            sets.append({"q": q, "k": k, "v": v, "do": do,
                         "o": torch.empty_like(q), "dq": torch.empty_like(q),
                         "dk": torch.empty_like(q), "dv": torch.empty_like(q),
                         "dq32": torch.zeros(q.shape, device="cuda"),
                         "dqc": torch.empty_like(q),
                         "lse": torch.empty((B, nh, N), device="cuda"),
                         "delta": torch.empty((B, nh, N), device="cuda")})
        st = [N * nh * hd, nh * hd, hd]       # b, n, h strides of each
        scale = hd ** -0.5

        def ptrs(s, *names):
            return [s[n].data_ptr() for n in names]

        def fwd(lib, s):
            return lib.pt_flash_fwd(*ptrs(s, "q", "k", "v", "o", "lse"),
                                    B, nh, N, N, hd, *st, *st, *st,
                                    int(causal), scale, 1, stream)

        def bwd(fn, outs):
            def call(lib, s):
                return getattr(lib, fn)(
                    *ptrs(s, "q", "k", "v", "do", "lse", "delta", *outs),
                    B, nh, N, N, hd, *st, *st, *st, *st, int(causal), scale,
                    1, stream)
            return call

        fused = bwd("pt_flash_bwd_fused", ["dq32", "dk", "dv"])

        def fused_wrapped(lib, s):
            # as the wrapper runs it: zeroed buffer, kernel, cast
            s["dq32"].zero_()
            err = fused(lib, s)
            s["dqc"].copy_(s["dq32"])
            return err

        calls = {"forward": fwd, "dq": bwd("pt_flash_bwd_dq", ["dq"]),
                 "dk/dv": bwd("pt_flash_bwd_dkv", ["dk", "dv"]),
                 "fused": fused, "fused + zero, cast": fused_wrapped}
        if only:
            calls = {k: f for k, f in calls.items() if k in only}
        compared = {"forward": ["o", "lse"], "dq": ["dq"],
                    "dk/dv": ["dk", "dv"], "fused": ["dk", "dv", "dq32"],
                    "fused + zero, cast": ["dk", "dv", "dqc"]}
        # operands for the backward from the committed forward
        for s in sets:
            if fwd(libs[0], s):
                raise SystemExit("forward failed")
            s["delta"].copy_((s["o"].float() * s["do"].float()).sum(-1)
                             .transpose(1, 2))
        o0, lse0 = sets[0]["o"].clone(), sets[0]["lse"].clone()
        for kname, fn in calls.items():
            active = [j for j, ks in enumerate(timed_for)
                      if ks is None or kname in ks]
            names = [sources[j][0] for j in active]
            kl = [libs[j] for j in active]
            diffs = {}
            for name, lib in zip(names, kl):
                s = sets[0]
                s["dq32"].zero_()
                if fn(lib, s):
                    raise SystemExit(f"{name}: {kname} launch failed")
                torch.cuda.synchronize()
                got = [s[n].float().clone() for n in compared[kname]]
                if name == names[0]:
                    ref = got
                diffs[name] = max(float((g - r).abs().max())
                                  for g, r in zip(got, ref))
            # the backward reads the committed forward's out and lse
            sets[0]["o"].copy_(o0)
            sets[0]["lse"].copy_(lse0)
            times = {name: [] for name in names}
            for lib in kl:                      # warm-up
                for s in sets:
                    fn(lib, s)
            for r in range(ROUNDS):
                order = [(r + j) % len(kl) for j in range(len(kl))]
                for name, lib in ((names[j], kl[j]) for j in order):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for c in range(CALLS):
                        fn(lib, sets[c % len(sets)])
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end) / CALLS)
            for s in sets:                      # the forward's outputs back
                fwd(libs[0], s)
            for name, rep in zip(names, (regs[j] for j in active)):
                t = sorted(times[name])
                print(f"[{B}, {N}, {nh}, {hd}] "
                      f"{'causal' if causal else 'full'} bf16 "
                      f"{kname:18s} {name:44s} median {t[len(t) // 2]:.5f} "
                      f"ms (min {t[0]:.5f}, max {t[-1]:.5f}, {ROUNDS} "
                      f"rounds of {CALLS}); max |diff| from as built "
                      f"{diffs[name]:.3e}; ptxas: "
                      f"{ptxas_of(rep, kname, hd)}", flush=True)


if __name__ == "__main__":
    main()
