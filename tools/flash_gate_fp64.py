#!/usr/bin/env python3
"""Find the worst element of a bf16 split-backward gate and say whether the
kernel or the plain version lies closer to fp64 arithmetic on the same bf16
inputs.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 tools/flash_gate_fp64.py [B N nh hd causal]

The default shape, [65537, 16, 1, 64] with no mask, is that of
``tests/test_torch_cuda.py::test_flash_kernels_match_plain[shape6-dtype1]``,
and the inputs are drawn as that test draws them (q, k, v strided views of
one fused [B, N, 3, nh * hd] projection, the generator seeded with N).  The
kernels' dq, dk and dv are held against ``_ref_flash_bwd`` on the kernel
forward's out and lse, as the test holds them: per element, |got - ref| <=
2^-8 + 2^-6 |ref|.  For each gradient the element with the largest ratio is
printed with the kernel's and the plain version's values and two fp64
computations of the same element over its (batch, head) from the same bf16
q, k, v, dO, out and lse: "exact", with p and ds kept in fp64, and
"rounded", with p and ds rounded to bf16 before their products as the
kernels and the reference do.  The card's name and power limit come first.
"""
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from paddle_tpu_torch.ops.cuda import flash_attn  # noqa: E402

ATOL, RTOL = 2.0 ** -8, 2.0 ** -6


def fp64_grads(q, k, v, out, lse, do, causal, rounded):
    """dq, dk, dv of one (batch, head): q, out, do [N, hd], k, v [Nk, hd],
    lse [N], in fp64 from their stored values."""
    q, k, v, out, do = (t.double() for t in (q, k, v, out, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = q @ k.T * scale
    N, Nk = s.shape
    if causal:
        s = s.masked_fill(~torch.ones(N, Nk, dtype=torch.bool,
                                      device=s.device).tril(Nk - N),
                          float("-inf"))
    p = torch.exp(s - lse.double()[:, None])
    delta = (do * out).sum(-1)
    ds = p * (do @ v.T - delta[:, None]) * scale
    if rounded:
        p = p.to(torch.bfloat16).double()
        ds = ds.to(torch.bfloat16).double()
    return ds @ k, ds.T @ q, p.T @ do


def closer(kernel, plain, x):
    """Which of the two values lies closer to x."""
    dk, dp = abs(kernel - x), abs(plain - x)
    return "kernel" if dk < dp else "plain" if dp < dk else "equal"


def main():
    args = sys.argv[1:]
    B, N, nh, hd = (int(a) for a in args[:4]) if args else (65537, 16, 1, 64)
    causal = len(args) > 4 and args[4].lower() in ("1", "true", "causal")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    g = torch.Generator(device=dev).manual_seed(N)
    qkv = torch.randn(B, N, 3, nh * hd, device=dev, generator=g).to(
        torch.bfloat16)
    q, k, v = [qkv[:, :, i].reshape(B, N, nh, hd) for i in range(3)]
    do = torch.randn(B, N, nh, hd, device=dev, generator=g).to(torch.bfloat16)
    out, lse = flash_attn.flash_fwd(q, k, v, causal)
    got = flash_attn.flash_bwd(q, k, v, out, lse, do, causal)
    refs = flash_attn._ref_flash_bwd(q, k, v, out, lse, do, causal)
    print(f"[{B}, {N}, {nh}, {hd}] {'causal' if causal else 'full'} bf16; "
          f"gate |got - ref| <= {ATOL} + {RTOL} |ref|", flush=True)
    for i, (name, a, r) in enumerate(zip(("dq", "dk", "dv"), got, refs)):
        ratio = ((a.float() - r.float()).abs()
                 / (ATOL + RTOL * r.float().abs()))
        flat = int(ratio.argmax())
        b, row, h, col = (int(x) for x in
                          torch.unravel_index(torch.tensor(flat), ratio.shape))
        sl = (b, slice(None), h)
        exact, rounded = (
            fp64_grads(q[sl], k[sl], v[sl], out[sl], lse[b, h], do[sl],
                       causal, rnd)[i][row, col].item()
            for rnd in (False, True))
        kv, rv = a[b, row, h, col].item(), r[b, row, h, col].item()
        print(f"  {name}: worst ratio {float(ratio.max()):.4f} at "
              f"[{b}, {row}, {h}, {col}]: kernel {kv:.6g}, plain {rv:.6g}, "
              f"fp64 exact {exact:.6g}, fp64 with p and ds rounded to bf16 "
              f"{rounded:.6g}; closer to fp64 exact: {closer(kv, rv, exact)}, to fp64 "
              f"rounded: {closer(kv, rv, rounded)}; elements "
              f"past the gate {int((ratio > 1).sum())} of {ratio.numel()}",
              flush=True)


if __name__ == "__main__":
    main()
