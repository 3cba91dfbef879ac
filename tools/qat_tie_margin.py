#!/usr/bin/env python3
"""Where the card's and the CPU's quantisation quotients part in
``chip_smoke.py`` (au), and which tie margin tells a sound card from a
faulty one (one GPU).

(au) runs QAT, ``QAT.convert`` with its int8 eval, and PTQ at 2 layers of
ERNIE-3.0-Base width in fp32 on the card and then on the CPU, and the CPU
takes the card's rounding wherever its quotient lies within ``TIE_MARGIN``
steps of the boundary the two sides round across (a tie).  Each run here
is (au) with no margin (every flip taken as a tie), so its readings are
the smallest margin and tie share that would pass it: the flip farthest
from its boundary, the share of rounded values taken from the card, and
the largest card-CPU quotient gap of each stage.  The runs:

* ``sound``: the shipped code;
* ``convert untaped``: the CPU keeps its own rounding of the weights in
  ``QAT.convert`` (as (au) did before every rounding of the module went
  through ``quantization._round_clip``);
* ``round +d``: a planted fault, the card rounding ``r + d`` for
  ``r`` (an offset rounding);
* ``flash x(1+e)``: a planted fault, the card's flash forward output
  multiplied by ``1 + e``.

For each: the readings and the gates of (au) that fail with no margin.

    python3 tools/qat_tie_margin.py
"""
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        print("qat_tie_margin: no CUDA device is visible", file=sys.stderr)
        return 2
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import card_info
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.ops.cuda import build, flash_attn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    name, limit = card_info()
    print(f"card: {name}, {limit}", flush=True)
    pt.set_device("gpu")
    with tempfile.TemporaryDirectory() as tmp:
        _, stream = C.tokenizer_path(torch, pt, tmp)

    plain_round, plain_fwd = Q._round_clip, flash_attn._fwd_kernel
    tape_take = C.RoundingTape.take

    def convert_untaped(tape, r, q, inside, qmax):
        if tape.mode == "replay" and tape.stage == "convert":
            tape.i += 1
            return q, inside
        return tape_take(tape, r, q, inside, qmax)

    def offset_round(d):
        def fn(r, qmax, mask=False):
            return plain_round(r + d if r.is_cuda else r, qmax, mask)
        return fn

    def scaled_fwd(e):
        def fn(*args):
            out, lse = plain_fwd(*args)
            return out * (1 + e), lse
        return fn

    runs = [("sound", None, None, None),
            ("convert untaped", convert_untaped, None, None)]
    runs += [(f"round +{d:g}", None, offset_round(d), None)
             for d in (1e-3, 1e-2)]
    runs += [(f"flash x(1+2^-{k})", None, None, scaled_fwd(2.0 ** -k))
             for k in (20, 16, 13, 10)]
    for label, take, rnd, fwd in runs:
        t0 = time.perf_counter()
        C.RoundingTape.take = take or tape_take
        Q._round_clip = rnd or plain_round
        flash_attn._fwd_kernel = fwd or plain_fwd
        try:
            res = C.qat_parity(torch, pt, flash_attn, stream,
                               margin=math.inf, share=1.0)
        finally:
            C.RoundingTape.take = tape_take
            Q._round_clip = plain_round
            flash_attn._fwd_kernel = plain_fwd
        gaps = ", ".join(f"{k} {g:.3e} at {list(sh)}"
                         for k, (g, sh) in res["gap"].items())
        print(f"{label}: farthest flip {res['tie_worst']:.3e} steps from "
              f"its boundary; flips {res['ties']} of {res['rounded']} "
              f"values ({res['ties'] / res['rounded']:.3e}); largest gap by "
              f"stage: {gaps}; losses "
              f"{[f'{x:.2e}' for x in res['loss_rel_err']]}, params "
              f"{res['param_rel_err_max']:.2e}, observer scales "
              f"{res['scale_rel_err_max']:.2e}, int8 logits "
              f"{res['int8_logit_err']:.2e}, PTQ activation scales "
              f"{res['ptq_a_scale_err']:.2e}; gates failed with no margin "
              f"{res['failed']}; {time.perf_counter() - t0:.1f} s  "
              f"[{name}, {limit}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
