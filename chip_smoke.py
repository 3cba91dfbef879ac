#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU and check
that it is right.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

  (a) the card's name and power limit, torch and CUDA versions;
  (b) build every kernel from ``paddle_tpu_torch/ops/cuda/csrc`` (one nvcc
      per source, in parallel; the data ring's host library from
      ``paddle_tpu_torch/runtime/csrc`` by g++ beside them, then loaded)
      and report ptxas' register and spill counts,
      one line for each instance of the warp-specialised kernels
      (``fa_fwd_wg``, the split backward's ``fa_bwd_dq_wg`` and
      ``fa_bwd_wg<D, WIDE, false>``, the fused ``fa_bwd_wg<D, WIDE,
      true>``, ``ffn_wg``) and of the serving kernels redesigned for
      Hopper (``dqmm_stream``, ``dqmm_wg``, ``paged_decode``,
      ``paged_decode_q8``), any of which last must not spill;
  (c) every kernel's wrapper against its plain PyTorch version on the card,
      in fp32 and bf16, at the shapes the serving and training paths give
      it, with the device times (CUDA-graph replay) of the kernel, the
      plain version and a library call that computes the same function
      (the port never calls the latter), and the kernel wrapper's eager
      per-call time; the flash-attention forward and its split backward's
      dq and dk/dv kernels at the training shape [8, 1024, 16, 64] causal,
      a ragged [1, 1000, 16, 64], q 128 / kv 320 causal and
      [2, 256, 4, 128] non-causal.  Each flash gate must also reject two
      mutants, one scaling the rows past the first 128-row tile by
      1 + 2^-4 and one the second consumer warpgroup's rows (64-127) of
      the first tile;
  (d) the main path: ``gpt_345m`` (full width, 24 layers) with
      ``use_pallas_norm``, weights drawn from a numpy seed, served by
      ``PagedServingEngine(slots=8, max_len=512, page_size=16)`` after
      ``warmup()``: 12 requests of 17-300 prompt tokens (two share a
      64-token prefix) x 32 new tokens.  The engine's decode step is one
      CUDA graph, captured in ``warmup()``: ``decode_compiles`` must be 1
      and no capture may happen during the traffic.  Kernel launch counts
      are zeroed just before and read just after (each replay counts its
      launches).  Then 8 slots at mixed lengths decode while one replay
      is held against ``gpt.decode_step_paged`` on clones of the pool with
      the same inputs (next tokens equal; the bf16 logit difference
      printed), and 50 replays are timed against 50 eager steps (five
      host-to-device copies, the step, argmax, readback), alternated;
  (e) the engine in fp32 (``capture_logits=True``) against the port's own
      ``generate`` (greedy tokens) and a teacher-forced ``forward``
      (logits) on the card, and its replay against the eager step with
      logits within 1e-3;
  (f) only with ``--profile STEPS``: where the main path's decode step
      spends its time, from a ``torch.profiler`` trace of STEPS steady
      steps with every slot decoding (host and device ms per step, the
      device's idle share, device time by kernel); (j) then traces its
      quantized engine the same way;
  (g) the training main path: ``gpt_345m`` (full width and depth) with
      ``use_pallas_norm``, flash attention and full remat, bf16 compute
      over fp32 masters and fp32 AdamW moments, one warm-up step and 10
      timed steps of ``gpt_hybrid.make_train_step`` on one numpy-seeded
      [8, 1024] batch (labels = tokens).  Launch counts are zeroed just
      before the timed steps and must equal their per-step formulas; the
      loss must be finite and fall;
  (h) fp32 parity of the train step, card (kernels) against CPU (plain
      versions), at ``gpt_345m`` widths with 2 layers, B=2, N=256:
      ``loss_and_grads`` and 3 steps of ``make_train_step``;
  (i) only with ``--profile-train STEPS``: a ``torch.profiler`` trace of
      STEPS training steps (device busy ms per step, idle share, device
      time by kernel);
  (j) after (d)-(i), which run as they did before it: the quantized main
      path, the same ``gpt_345m`` weights served by
      ``PagedServingEngine(quant="int8", kv_dtype="int8", slots=8,
      max_len=512, page_size=16)`` after ``warmup()``, the same 12
      requests x 32 tokens as (d).  Launch counts are zeroed just before
      and must equal their formulas (dequant matmul 4L per forward, int8
      paged attention L per decode step, LayerNorm 2L + 1 per forward);
      its tokens/s, step times, peak memory and pool bytes are printed
      beside (d)'s, with the share of request 0's tokens that equal (d)'s
      (reported, not asserted: random weights); ``decode_compiles`` and
      the replay-against-eager check and timing as in (d);
  (k) fp32 parity of the quantized engine, card (kernels) against CPU
      (plain versions), at ``gpt_345m`` widths with 2 layers, on 4 of the
      requests: greedy tokens exact, logits within 1e-3; the card engine's
      replay against its eager step, logits within 1e-3;
  (l) the reference bench's flagship training step (``bench.py``'s GPT-3
      1.3B recipe, ``BASELINE.json`` configs[3]): V=50304, H=2048, L=24,
      nh=16, hd=128, N=2048, bf16 params and bf16 AdamW moments, bf16
      compute, ``use_flash`` with ``set_default_blocks(bwd_fused=True)``,
      ``use_fused_ffn``, ``use_pallas_norm``, full remat, weights drawn on
      the card from a seed; one warm-up step and 8 timed steps of
      ``gpt_hybrid.make_train_step`` on one [6, 2048] batch (labels =
      tokens, lr 1e-4).  Launch counts are zeroed just before the timed
      steps and must equal their per-step formulas (flash forward 2L,
      fused backward L, split backward 0, fused FFN L: the remat
      recompute keeps the FFN op's output, LayerNorm 4L + 1);
      the loss must be finite and fall.  With ``--profile-train`` its steps
      are traced as (i) traces (g)'s, and one more step's allocations are
      replayed to find where its memory peaks and what is live there;
  (m) fp32 parity of the flagship step, card (kernels) against CPU (plain
      versions), at its widths (H=2048, nh=16, hd=128, F=8192) with 2
      layers, B=2, N=256 and both fused routes, at (h)'s tolerances;
  (n) eager nn-API inference: a user's encoder built from
      ``paddle_tpu_torch.nn`` at ERNIE-3.0-Base widths (V=40064, H=768,
      L=12, nh=12, F=3072, learned positions up to 512): ``Embedding`` x 2,
      a pre-LN ``TransformerEncoder`` (gelu, dropout 0) with an
      ``RMSNorm`` final norm, a ``Linear`` head; weights from a numpy seed
      through ``set_state_dict``; ``eval()`` under ``no_grad()``, one
      warm-up and 5 timed batches of [8, 512] token ids, in fp32 and again
      after ``.to(dtype="bfloat16")``.  Launch counts are zeroed just
      before the timed batches and must equal 2L LayerNorm, L flash
      forward and 1 RMSNorm a forward; one forward that records (grad
      mode on) must launch L flash forwards and no norm kernel;
      With ``--profile STEPS`` it also traces STEPS forwards in each
      dtype as (f) traces decode steps;
  (o) fp32 parity of (n)'s model at its widths with 2 layers, B=2, N=128,
      card (kernels) against CPU (plain versions): the final RMSNorm
      output within 1e-4 of its max|ref|, the logits within 1e-3;
  (p) ERNIE-3.0-Base pretraining (``paddle_tpu_torch.models.bert``,
      ``bench.py``'s second line): V=40064, H=768, L=12, nh=12, F=3072,
      N=512, type vocab 4, B=64, bf16 compute over fp32 params and AdamW
      moments, remat, ``use_flash`` (the flash forward and split backward
      non-causal), weights drawn on the card from a seed; tokens, 15%
      masked-LM labels and NSP labels drawn as ``_time_ernie_batch`` draws
      them, lr 1e-4; one warm-up step and 10 timed steps of
      ``bert.make_train_step``, each closed by ``float(loss)``.  Launch
      counts are zeroed just before the timed steps and must equal 2L
      flash forwards, L dq, L dk/dv and no fused-backward, no-key or norm
      kernel a step; no flash operand may be copied (q, k, v are strided
      views of the fused projection); the loss must be finite and fall.
      Then 10 steps of the dense route (``use_flash=False``) on the same
      state, timed and reported, not asserted.  With ``--profile-train``
      its steps are traced as (i) traces (g)'s and one more step's memory
      peak is found as (l)'s is;
  (q) fp32 parity of (p), card (kernels) against CPU (plain versions), at
      ERNIE widths with 2 layers, B=2, N=256, NSP labels, numpy-drawn
      weights (no leaf starting at zero): ``pretrain_loss`` and its
      gradients, 3 steps of ``make_train_step`` (Adam eps 1e-6) and the
      params after them, at (h)'s tolerances;
      then one loss with a pad mask, which takes the dense route and
      launches no flash kernel;
  (r) eager dygraph pretraining of ERNIE-3.0-Base through the user API,
      nothing cut (``models.bert.ErnieForPretraining(ernie_3_base())``,
      weights from seed 1256, (p)'s batch of [64, 512]): ``AdamW(weight
      decay 0.01, grad_clip=ClipGradByGlobalNorm(1.0))`` on
      ``lr.LinearWarmup(1e-4, 10, 0.0, 1e-4)``, one warm-up step and 10
      timed steps of ``loss = model(t, ml, nl); loss.backward();
      opt.step(); opt.clear_grad(); sched.step()``, each closed by
      ``float(loss)``.  Launch counts are zeroed just before the timed
      steps and must equal (p)'s (2L flash forwards, L dq, L dk/dv, no
      fused, no-key or norm kernel a step); no flash operand may be
      copied; the optimizer must take one multi-tensor step a step on one
      plan; the loss must be finite and fall.  Prints (r)'s step time over
      (p)'s in the same run, and where one more step's memory peaks; with
      ``--profile-train`` its steps are traced (idle share, launches and
      host-to-device copies a step);
  (s) (r)'s loop in fp32 at ERNIE widths with 2 layers, B=2, N=256, every
      leaf drawn from numpy as (q) draws them, 3 steps on the card and on
      the CPU: the losses within 1e-5 relative, every first-step ``.grad``
      within 1e-4 of its max|grad| and the params after 3 steps within
      1e-4 of their max;
  (t) eager nn-API training of (n)'s encoder under AMP: dropout 0.1 and
      attention dropout 0 in every layer (flash, with the residual and FFN
      dropout masks drawn on the card), ``train()``, one warm-up step and
      10 timed steps of ``with amp.auto_cast(dtype="bfloat16"):`` forward
      and ``nn.CrossEntropyLoss()`` on shifted ids [8, 512], then
      ``GradScaler`` ``scale(loss).backward()``, ``step(opt)``,
      ``update()``, ``opt.clear_grad()`` (AdamW with
      ``ClipGradByGlobalNorm(1.0)``).  Launch counts zeroed just before the
      timed steps must equal L flash forwards, L dq and L dk/dv and no
      LayerNorm or RMSNorm kernel a step (both norms record, so they take
      the plain formula, as in the reference); the loss must fall; with
      ``--profile-train`` its steps are traced as (r)'s;
  (u) the high-level API, nothing cut: an ERNIE-3.0-Base classifier
      (``models.bert.ErnieModel(ernie_3_base())``'s pooled output into a
      ``Linear(768, 2)``, bf16 compute over fp32 params, remat, flash)
      fitted through ``paddle_tpu_torch.Model`` (``InputSpec`` inputs and
      labels; AdamW wd 0.01 + ``ClipGradByGlobalNorm(1.0)`` on
      ``LinearWarmup`` to 1e-4, ``CrossEntropyLoss``, ``Accuracy``) from
      an ``io.DataLoader(batch_size=64, shuffle=True, num_workers=2,
      use_native_ring=True, prefetch_to_device=2)`` over 768 numpy-seeded
      samples of 512 token ids (label: the first id mod 2), 2 epochs of 12
      steps, the second timed by a callback on the host clock.  Launch
      counts zeroed just before ``fit`` and read just after must equal 2L
      flash forwards, L dq, L dk/dv and no fused, no-key or norm kernel a
      step; the loss must be finite and fall (epoch 2's mean below epoch
      1's).  Alternated with a hand-written eager loop (forward, loss,
      ``backward``, ``step``, ``clear_grad``, ``float(loss)``) on the same
      network, optimizer and batches already on the card: hapi's step ms
      over the loop's.  Then ``evaluate`` and ``predict`` over 256 more
      samples (L flash forwards a batch, no backward launch), ``save``,
      ``load`` into a fresh ``Model`` and ``predict`` again: bit-equal.
      Prints step ms, tokens/s, model-FLOP share (6N + 12LHS at the
      classifier's parameters), peak memory and prefetch hits; with
      ``--profile-train`` both steps are traced (idle share, launches,
      host-to-device copies, which must be pinned copies on a stream
      where no kernel runs);
  (v) (u)'s path in fp32 at ERNIE widths with 2 layers, [4, 256], numpy
      weights as (q)'s, card (the ring loader, kernels) against CPU (the
      single-process loader, plain versions): 3 ``fit`` steps, losses
      within 1e-5 relative, params within 1e-5 of their max; ``evaluate``
      (equal accuracy, loss within 1e-4 relative) and ``predict`` within
      1e-4 of max|ref|.

(c) also holds the flagship's two kernels against their plain versions:
the fused FFN (against the plain version of its own function, which
rounds h and the output once each) at the flagship shape [12288, 2048] x
[2048, 8192], the 345M shape [8192, 1024] x [1024, 4096], a decode shape
(M = 8), a ragged M = 1000, the JAX tests' shapes, H = 4096 (F = 16384),
H = 768 and H = 6 / F = 10 (zero-padded), timed against cuBLAS ``addmm`` +
gelu + ``addmm``; the flash forward and both backward strategies also at
hd 256, hd 32 and 96 (zero-padded to 64 and 128), B * nh = 65,600,
(p)'s [64, 512, 12, 64] non-causal and
heads wider than 256 (hd 320, 384, 512, 640: the kernels' head-width
groups);
LayerNorm also at the 345M training rows [8, 1024, 1024], H = 6, 7, 1001
and 70001, a transposed view and a view 4 bytes off alignment; both paged kernels also at hd 24 and 80; the
paged attention also at one slot of 8,191 positions (V with a mean per
channel, gated per element at 2^-8 + 2^-6 sum_j p_j |v_j| in bf16), each
paged case rejecting a mutant whose later slots (later heads, for one
slot) are scaled by 1 + 2^-4; the bf16 gradient gates of the split and
fused flash backward scale their rtol by the magnitude of the terms each
gradient sums (``flash_attn._ref_flash_bwd_terms``), not by |ref|; the
fused flash backward at [6, 2048, 16, 128] causal, [8, 1024, 16, 64]
causal (with the split kernels' time beside it), a ragged [1, 1000, 16,
64], q 128 / kv 320 causal, [1, 512, 1, 128] non-causal, hd 256, hd 96
and the four wide heads, with the largest |dq| difference between two
launches on the same inputs (the adds' order varies; reported, not
asserted).
(c) also holds the kernels at the inputs they used to refuse or read
otherwise than the reference (``check_queue3``): paged attention with
table entries -1, -5, -P - 3, P and P + 40 (both pools), at heads of
fp32 160, bf16 and fp32 320 and int8 640 (head-width groups) and at
65,537 slots (two launches); RMSNorm on a transposed view and one 4
bytes off alignment; the dequant matmul at K = 13, N = 10 and K = 1030,
N = 1000 on a strided weight (padded per call and once); flash attention
causal with N = Nk + 1 and 2 Nk (rows that see no key), forward and both
backward strategies; each gate rejecting its wrong-scale mutant.
(c) also holds the RMSNorm kernel against its plain version at (n)'s
shape [8, 512, 768] (fp32; bf16 with bf16 g; bf16 with fp32 g), [4, 8,
256], a ragged [3, 1000], [2, 8] and [3, 1001] (one-element loads), each
rejecting a mutant whose rows past the first 32 (past the first, for
fewer rows) are scaled by 1 + 2^-4, timed against
``torch.nn.functional.rms_norm``; and LayerNorm and the flash forward at
(n)'s shapes, [8, 512, 768] and [8, 512, 12, 64] non-causal.
(c) also holds the two quantized-path kernels against their plain
versions: the dequant matmul at the four decode shapes (M = 8), the
prefill shapes M = 4096 x (1024, 4096), (1024, 3072) and (4096, 1024), M
= 16 and 17 (the two sides of its regime threshold), 64, 65 and 1000 at
(1024, 4096), and the JAX tests' shapes, each
also timed against cuBLAS on weights dequantized beforehand; int8 paged
attention at the serving decode shape, the JAX tests' shapes, a lane of
length 0, hd 24 and 80, 16 ragged slots over 64 pages and one slot of
8,191 positions (V with a mean per channel in the last two).  The fp
paged attention cases are also timed on the int8 kernel's grid-sized
split plan (``grid_plan_ms``) beside their own.

Before its last line it prints one JSON object ``{"kernels": [...]}`` (the
three flash rows with their launches on each training path, among them
``launches_eager_ernie``, ``launches_eager_encoder``, ``launches_hapi``
and ``launches_hapi_eval``) and the
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``.  TF32 is off for every float32 matmul
and convolution here, so fp32 comparisons are fp32.
"""
import argparse
import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

SEED = 1234
HBM_BYTES_PER_S = 3.35e12     # H100 SXM published HBM3 rate
FP32_FLOPS_PER_S = 67e12      # H100 SXM published fp32 (non-tensor) rate
FP32_TOL = 1e-5
PARITY_LOGIT_TOL = 1e-3       # fp32 engine vs teacher-forced forward
BF16_FLOPS_PER_S = 989e12     # H100 SXM published dense bf16 tensor rate
FLASH_GRAD_TOL = 2e-4         # fp32 flash gradients (JAX flash test's own)
DQMM_FP32_RTOL = 1e-5         # fp32 dequant matmul: x max|ref| (JAX test's)
PAGED_BF16_CAP = 2e-2         # bf16 int8 paged attention never looser than
                              # the JAX kernel test's own 2e-2
# bf16 flash out and gradients, per element: |got - ref| <= atol + rtol*|ref|
# (bf16 rounding is relative: rtol is two steps of an output's own scale)
BF16_ATOL, BF16_RTOL = 2.0 ** -8, 2.0 ** -6
WRONG_SCALE = 1 + 2.0 ** -4   # the mutant each gate must reject (see gate)
TRAIN_SHAPE = (8, 1024, 1024, 16, 64, True)   # B, N, Nk, nh, hd, causal
# heads wider than 256 (the kernels' head-width groups of 64 columns)
WIDE_SHAPES = [((2, 256, 256, 4, 320, True), "hd 320, 5 groups"),
               ((1, 256, 256, 4, 384, False), "hd 384, 6 groups"),
               ((1, 200, 200, 2, 512, True), "hd 512, 8 groups"),
               ((1, 250, 250, 2, 640, True), "hd 640, 10 groups, ragged")]
TRAIN_LOSS_RTOL = 1e-5        # (h), (m): card loss vs CPU loss
TRAIN_GRAD_TOL = 1e-4         # (h), (m): x max|leaf grad on the CPU|
FLAGSHIP_SHAPE = (6, 2048)    # (l): B, N of bench.py's first 1.3B batch
FLAGSHIP_STEPS = 8            # (l): timed steps (bench.py: steps=8)
# (n): ERNIE-3.0-Base widths (paddle_tpu/models/bert.py:93-97, max_seq_len
# :49): V, H, L, nh, F, N
ENCODER = dict(V=40064, H=768, L=12, nh=12, F=3072, N=512)
ENCODER_BATCH = 8             # (n): [8, 512] token ids a batch
ENCODER_BATCHES = 5           # (n): timed batches per dtype
RMS_PARITY_TOL = 1e-4         # (o): final norm output, x max|ref|
ERNIE_BATCH = 64              # (p): bench.py's first ERNIE batch, N = 512
ERNIE_STEPS = 10              # (p): timed steps (bench.py: steps=10)
ERNIE_PARITY_N = 256          # (q): B=2, 2 layers
HAPI_TRAIN = 768              # (u): samples, 12 steps of 64 an epoch
HAPI_EVAL = 256               # (u): evaluate / predict samples
HAPI_PARITY = (4, 256)        # (v): B, N at ERNIE widths, 2 layers
HAPI_PARITY_TOL = 1e-4        # (v): evaluate loss and predict, x max|ref|


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def fp32_reduction(torch):
    """bf16 cuBLAS products reduce in fp32 inside, as the kernels do, for
    the reference side of a gate only: the port runs cuBLAS's default."""
    mm = torch.backends.cuda.matmul
    was = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = was


def time_ms(fn, arg_sets, iters):
    """Mean milliseconds per eager call of ``fn`` (host launch cost
    included) over ``iters`` calls cycling through ``arg_sets``, timed
    with CUDA events after two warm-up calls."""
    import torch
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_SIDE = []    # the one side stream of every capture (cuBLAS keeps a
              # workspace per stream: a new stream per capture piles them up)


def device_ms(fn, arg_sets, per_graph=20, replays=10):
    """Mean device milliseconds per call of ``fn``: ``per_graph`` calls
    cycling through ``arg_sets`` (distinct buffers, so data the real
    caller finds cold in L2 is cold here too) are captured in one CUDA
    graph and replayed, which takes the host's launch cost out."""
    import torch
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    return ms


def paged_inputs(torch, rng, dtype, S, nh, hd, ps, maxP, lens, copies=1,
                 v_mean=False):
    """``copies`` sets of paged-attention operands sharing q/table/lens,
    each with its own K/V pools; each lane's unused table entries point
    at scratch page 0.  With ``v_mean`` every (head, channel) of V gets
    its own N(0, 1) mean, as a model's values have, so that a long
    context does not average the output to nearly zero."""
    P = S * maxP + 1
    q = torch.from_numpy(rng.standard_normal((S, 1, nh, hd),
                                             dtype=np.float32))
    table = np.zeros((S, maxP), np.int32)
    pages = rng.permutation(np.arange(1, P)).astype(np.int32)
    for s, ln in enumerate(lens):
        n = int(ln) // ps + 1
        table[s, :n] = pages[s * maxP:s * maxP + n]
    q = q.cuda().to(dtype)
    table = torch.from_numpy(table).cuda()
    lens_t = torch.tensor(np.asarray(lens, np.int32)).cuda()
    sets = []
    for _ in range(copies):
        k = torch.randn((P, ps, nh, hd), device="cuda").to(dtype)
        v = torch.randn((P, ps, nh, hd), device="cuda")
        if v_mean:
            v += torch.randn((nh, hd), device="cuda")
        sets.append((q, k, v.to(dtype), table, lens_t))
    return sets


def library_paged(q, k, v, table, lens):
    """Gather + ``scaled_dot_product_attention``: the library yardstick
    for paged decode attention (timed only)."""
    import torch
    import torch.nn.functional as F
    S, maxP = table.shape
    _, ps, nh, hd = k.shape
    view = maxP * ps
    kc = k[table.long()].reshape(S, view, nh, hd).transpose(1, 2)
    vc = v[table.long()].reshape(S, view, nh, hd).transpose(1, 2)
    mask = (torch.arange(view, device=q.device)[None, :]
            <= lens[:, None].long())
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), kc, vc, attn_mask=mask[:, None, None, :])


def paged_bound(q, k, table, lens):
    """Least time for paged attention on these inputs: bytes it must move
    (K and V of every attended position once, q, out, the table rows it
    reads, lens) over the HBM rate, or its flops over the fp32 rate."""
    S, _, nh, hd = q.shape
    isz = q.element_size()
    ps = k.shape[1]
    lens_np = lens.cpu().numpy().astype(np.int64) + 1
    kv = int(lens_np.sum()) * nh * hd * 2 * isz
    tbl = int((-(-lens_np // ps)).sum()) * 4
    byts = kv + 2 * q.numel() * isz + tbl + S * 4
    flops = 4 * int(lens_np.sum()) * nh * hd
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def norm_bound(x, g, n_weights, flops_per_element):
    """Least time for a row norm: x read and y written once, plus its
    ``n_weights`` [H] vectors of g's dtype, over the HBM rate; or its
    flops over the fp32 rate."""
    rows, H = x.numel() // x.shape[-1], x.shape[-1]
    byts = (2 * rows * H * x.element_size()
            + n_weights * H * g.element_size())
    flops = flops_per_element * rows * H
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def l2_copies(nbytes):
    """How many copies of an operand of ``nbytes`` a timing cycles
    through so that together they pass the 50 MB L2 (100 MB, 1 to 8
    copies): each call then reads its operand from HBM, as the model's
    calls do."""
    return max(1, min(8, (100 << 20) // max(nbytes, 1)))


# the warp-specialised kernels whose ptxas lines (b) prints one by one
WG_KERNELS = ("fa_fwd_wg", "fa_bwd_dq_wg", "fa_bwd_wg", "ffn_wg",
              "dqmm_stream", "dqmm_wg", "12paged_decodeI",
              "15paged_decode_q8I")
# the serving kernels redesigned for Hopper: (b) fails if one spills
NO_SPILL = ("dqmm_stream", "dqmm_wg", "12paged_decodeI",
            "15paged_decode_q8I")


def spilled(line):
    """The bytes of spill stores and loads a ptxas line reports."""
    return sum(int(line.split(f" bytes spill {w}")[0].split()[-1])
               for w in ("stores", "loads") if f" bytes spill {w}" in line)


def ptxas_kernels(text, stems):
    """[(kernel, "Used ... registers ...", "... spill ...")] from nvcc's
    ``-Xptxas=-v`` output for the instances whose names hold a stem."""
    out, name, spill = [], None, ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and " bytes spill stores" in ln:
            spill = ln.strip()
        elif name and "Used " in ln:
            stem = next((st for st in stems if st in name), None)
            if stem:
                inst = name[name.index(stem):].split("EEv")[0] + "E"
                out.append((inst, "Used " + ln.split("Used ")[1].strip(),
                            spill))
            name = None
    return out


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def later_tiles(m):
    """The rows past the first 64-row tile (axis 1)."""
    return m[:, 64:]


def later_slots(m):
    """Every slot but the first (axis 0, one row per slot)."""
    return m[1:]


def later_heads(m):
    """Every head but the first of [S, 1, nh, hd] (for one slot)."""
    return m[:, :, 1:]


def past_first_tile(m):
    """The rows past the first 128-row tile of the bf16 flash kernels
    (axis 1: q rows of the forward, keys of the fused backward)."""
    return m[:, 128:]


def second_warpgroup(m):
    """Rows 64-127 (axis 1): the second consumer warpgroup's rows of the
    first tile."""
    return m[:, 64:128]


FLASH_ROWS = (past_first_tile, second_warpgroup)


def gate(pairs, atol, rtol, cap=None, rows=later_tiles):
    """For (got, ref, scale) triples: the worst ratio over elements of
    |got - ref| / (atol + rtol * |scale|), which passes at most 1
    (``torch.testing.assert_close``'s rule when scale is ref), and the same
    ratio for a mutant of ``got`` whose ``rows`` are scaled by
    ``WRONG_SCALE``, which must fail: a gate that lets a wrong scale on
    later tiles through could not catch a wrong kernel.  ``rows`` may be a
    tuple of selectors: each one that selects an element makes a mutant,
    and the smallest of their ratios is returned (every one must fail).
    ``cap`` bounds the per-element tolerance from above."""
    sel = rows if isinstance(rows, tuple) else (rows,)
    ok, muts = 0.0, [None] * len(sel)
    for got, ref, scale in pairs:
        g, r = got.float(), ref.float()
        den = atol + rtol * scale.float().abs()
        if cap is not None:
            den = den.clamp(max=cap)
        ok = max(ok, float(((g - r).abs() / den).max()))
        for i, pick in enumerate(sel):
            m = g.clone()
            part = pick(m)
            if part.numel() == 0:
                continue
            part.mul_(WRONG_SCALE)
            muts[i] = max(muts[i] or 0.0,
                          float(((m - r).abs() / den).max()))
    picked = [x for x in muts if x is not None]
    return ok, min(picked) if picked else 0.0


def check_kernels(torch, paged_attn, norms):
    """Phase (c).  Returns the per-kernel case lists; raises on a
    disagreement beyond the stated tolerance."""
    rng = np.random.default_rng(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"paged_attention": [], "layer_norm": []}

    def paged_case(dt, label, S, maxP, lens, copies, hd=64, v_mean=False):
        """The absolute gate (1e-5 in fp32, 2^-6 in bf16), or, with
        ``v_mean``, 2^-8 + 2^-6 sum_j p_j |v_j| per element in bf16 (the
        int8 path's rule: outputs of size 1 and more round at 2^-7 and
        coarser); both must reject the wrong-scale mutant of every slot but
        the first (of every head but the first, for one slot)."""
        sets = paged_inputs(torch, rng, dt, S, 16, hd, 16, maxP, lens,
                            copies=copies, v_mean=v_mean)
        got = paged_attn.paged_attention(*sets[0])
        torch.cuda.synchronize()
        q, k, v, table, lens_t = sets[0]
        ref = paged_attn._ref_paged_attention(*sets[0])
        if dt == f32 or not v_mean:
            atol, rtol, scale = FP32_TOL if dt == f32 else 2.0 ** -6, 0.0, ref
        else:
            atol, rtol = BF16_ATOL, BF16_RTOL
            scale = paged_attn._ref_paged_attention(q, k, v.abs(), table,
                                                    lens_t)
        ratio, mutant = gate([(got, ref, scale)], atol, rtol,
                             rows=later_slots if S > 1 else later_heads)
        bound, by = paged_bound(q, k, table, lens_t)
        plain_kw = dict(per_graph=2, replays=3) if maxP >= 512 else {}
        grid = paged_attn._grid_plan(S, 16, maxP, 16,
                                     paged_attn._sm_count(q.device))
        out["paged_attention"].append(
            {"shape": label, "dtype": str(dt),
             "max_abs_err": max_err(got, ref),
             "max_abs_ref": float(ref.float().abs().max()),
             "atol": atol, "rtol": rtol, "gate": ratio,
             "mutant_gate": mutant,
             "ms": device_ms(paged_attn.paged_attention, sets),
             "plan": paged_attn._split_plan(maxP, 16), "grid_plan": grid,
             "grid_plan_ms": device_ms(
                 with_split_plan(paged_attn, grid), sets),
             "call_ms": time_ms(paged_attn.paged_attention, sets, 200),
             "plain_ms": device_ms(paged_attn._ref_paged_attention, sets,
                                   **plain_kw),
             "library_ms": device_ms(library_paged, sets),
             "bound_ms": bound, "bound_by": by})

    # the contract's shapes: ragged lens with 0, ps-1, ps and a full table
    # (S=16, nh=16, hd=64, ps=16, maxP=64); one pool set is 67 MB (bf16)
    lens = [0, 15, 16, 64 * 16 - 1] + [int(n) for n in
                                       rng.integers(1, 64 * 16 - 1, 12)]
    for dt in (f32, bf16):
        paged_case(dt, "S16 nh16 hd64 ps16 maxP64 ragged", 16, 64, lens, 2)
    # the serving path's decode shape: 8 slots, max_len 512 (maxP 32),
    # lengths as the main path sees them; 8 pool sets exceed the L2
    lens = [int(n) for n in rng.integers(17, 332, 8)]
    for dt in (f32, bf16):
        paged_case(dt, "S8 nh16 hd64 ps16 maxP32 (decode)", 8, 32, lens, 8)
    # head widths that mask lanes of the last 16-byte slice (24 in fp32:
    # rows off 16 bytes, one-element loads)
    for hd in (24, 80):
        for dt in (f32, bf16):
            paged_case(dt, f"S8 nh16 hd{hd} ps16 maxP32 (masked lanes)", 8,
                       32, lens, 8, hd=hd)
    # one slot at 8,191 positions: a full table of 512 pages, the largest
    # split plan (32 splits of 16 pages), merged in one launch
    for dt in (f32, bf16):
        paged_case(dt, "S1 nh16 hd64 ps16 maxP512, 8191 positions", 1, 512,
                   [8190], 2, v_mean=True)

    # LayerNorm: the model's rows in the compute dtype; fp32 weights (the
    # 345M paths' fp32 masters) and, at the flagship's rows, weights in
    # the compute dtype (its bf16 params)
    def view_of(x, kind):
        """x as the view a case names: "T" a transposed view of x's
        transpose (same values, strided), "+4" a copy 4 bytes off 16-byte
        alignment; None x itself."""
        if kind == "T":
            return x.t().contiguous().t()
        if kind == "+4":
            off = 4 // x.element_size()
            flat = torch.empty(x.numel() + off, dtype=x.dtype,
                               device=x.device)
            v = flat[off:].view(x.shape)
            v.copy_(x)
            return v
        return x

    for shape, name, own, kind in (
            ((16, 1, 1024), "decode 16 rows", False, None),
            ((4, 256, 1024), "prefill 4x256 rows", False, None),
            ((8, 1, 1024), "decode 8 rows (serving)", False, None),
            ((6, 2048, 2048), "flagship, g b in x's dtype", True, None),
            ((8, 1024, 1024), "345M training rows", False, None),
            ((8, 512, 768), "encoder, g b in x's dtype", True, None),
            ((2, 6), "H=6, one-element loads", True, None),
            ((3, 7), "H=7, one-element loads", True, None),
            ((5, 1001), "H=1001, one-element loads", True, None),
            ((2, 70001), "H=70001, rows read thrice", True, None),
            ((768, 512), "transposed view", True, "T"),
            ((512, 768), "view 4 bytes off alignment", True, "+4")):
        for dt in (f32, bf16):
            g = torch.randn(shape[-1], device="cuda").to(dt if own else f32)
            b = torch.randn(shape[-1], device="cuda").to(dt if own else f32)
            sets = [(view_of((torch.randn(shape, device="cuda") * 2
                              + 1).to(dt), kind), g, b)
                    for _ in range(l2_copies(math.prod(shape) * 4))]
            x = sets[0][0]
            got = norms.layer_norm(x, g, b)
            torch.cuda.synchronize()
            ref = norms._ref_layer_norm(x, g, b, 1e-5)
            tol = FP32_TOL if dt == f32 else 2.0 ** -7 * max(
                1.0, float(ref.float().abs().max()))
            gl, bl = g.to(dt), b.to(dt)
            bound, by = norm_bound(x, g, 2, 8)
            out["layer_norm"].append(
                {"shape": f"{list(shape)} ({name})", "dtype": str(dt),
                 "max_abs_err": max_err(got, ref), "tol": tol,
                 "ms": device_ms(norms.layer_norm, sets),
                 "call_ms": time_ms(norms.layer_norm, sets, 500),
                 "plain_ms": device_ms(
                     lambda a, c, d: norms._ref_layer_norm(a, c, d, 1e-5),
                     sets),
                 "library_ms": device_ms(
                     lambda a, c, d: torch.nn.functional.layer_norm(
                         a, (a.shape[-1],), c, d, 1e-5),
                     [(a, gl, bl) for a, _, _ in sets]),
                 "bound_ms": bound, "bound_by": by})
    bad = [(k, c["shape"], c["dtype"]) for k, cases in out.items()
           for c in cases if not case_ok(c)]
    for k, cases in out.items():
        for c in cases:
            log(f"  {k:16s} {c['dtype']:15s} {c['shape'][:44]:44s} "
                f"max_abs_err {c['max_abs_err']:.3e} "
                + (f"gate {c['gate']:.3f} (atol {c['atol']:.1e} rtol "
                   f"{c['rtol']:.1e}; max|ref| {c['max_abs_ref']:.2e}; "
                   f"wrong-scale mutant {c['mutant_gate']:.2f})"
                   if "gate" in c else f"(tol {c['tol']:.1e})")
                + f"  device ms: kernel {c['ms']:.5f}  plain "
                  f"{c['plain_ms']:.5f}  library {c['library_ms']:.5f}  "
                  f"bound {c['bound_ms']:.6f} ({c['bound_by']}); eager "
                  f"call {c['call_ms']:.5f}"
                + (f"; plan {c['plan']}, on the grid-sized plan "
                   f"{c['grid_plan']} {c['grid_plan_ms']:.5f}"
                   if "grid_plan" in c else ""))
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return out


def with_split_plan(paged_attn, plan):
    """``paged_attention`` on the split plan ``plan`` (pages a split,
    splits) in place of its own (timed only)."""
    def fn(*args):
        keep = paged_attn._split_plan
        paged_attn._split_plan = lambda maxP, ps: plan
        try:
            return paged_attn.paged_attention(*args)
        finally:
            paged_attn._split_plan = keep
    return fn


def flash_sets(torch, gen, dt, B, N, Nk, nh, hd, copies):
    """``copies`` operand sets (q, k, v, dO).  For self-attention q/k/v are
    strided views of one fused [B, N, 3, nh*hd] projection, as the model
    passes them; for cross lengths they are separate tensors."""
    sets = []
    for _ in range(copies):
        def rnd(*shape):
            return torch.randn(shape, device="cuda", generator=gen).to(dt)
        if N == Nk:
            qkv = rnd(B, N, 3, nh * hd)
            q, k, v = [qkv[:, :, i].reshape(B, N, nh, hd) for i in range(3)]
        else:
            q, k, v = rnd(B, N, nh, hd), rnd(B, Nk, nh, hd), rnd(B, Nk, nh, hd)
        sets.append((q, k, v, rnd(B, N, nh, hd)))
    return sets


def kernel_bwd_sets(flash_attn, sets, o, lse, causal):
    """The backward kernels' operand sets (q, k, v, dO, lse, delta, causal,
    scale) as the wrapper hands them over: padded to the kernels' head
    width (:func:`flash_attn._padded_bwd`), at the true width's scale."""
    hd = sets[0][0].shape[-1]
    D = flash_attn._kernel_width(hd)
    out = []
    for a, b, c, d in sets:
        a, b, c, oo, d = flash_attn._pad_hd((a, b, c, o, d), D)
        *qkvd, delta = flash_attn._bwd_operands(a, b, c, oo, d)
        out.append((*qkvd, lse, delta, causal, 1.0 / math.sqrt(hd)))
    return out


def unpad(t, hd):
    """A kernel's padded output sliced back to head width ``hd``."""
    return t[..., :hd]


def attended_keys(B, N, Nk, nh, causal):
    """V = sum over rows of the keys each row attends (bottom-right
    causal: row i sees i + Nk - N + 1 keys)."""
    per = N * (Nk - N + 1) + N * (N - 1) // 2 if causal else N * Nk
    return B * nh * per


def flash_bounds(q, k, causal):
    """Least times (ms, bound_by) for the forward, the dq kernel, the dk/dv
    kernel and the whole backward pass on these inputs.  Bytes: each input
    read once, each output written once (lse and delta fp32 [B, nh, N]);
    flops: 2*V*hd per product (forward 2 products; dq 3; dk/dv 4; a
    backward pass needs 5) over the card's peak for the dtype."""
    import torch
    B, N, nh, hd = q.shape
    Nk = k.shape[1]
    V = attended_keys(B, N, Nk, nh, causal)
    isz = q.element_size()
    qb, kb, rows = B * N * nh * hd * isz, B * Nk * nh * hd * isz, B * nh * N * 4
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    work = {"fwd": (4 * V * hd, 2 * qb + 2 * kb + rows),
            "dq": (6 * V * hd, 3 * qb + 2 * kb + 2 * rows),
            "dkv": (8 * V * hd, 2 * qb + 4 * kb + 2 * rows),
            "bwd_pass": (10 * V * hd, 4 * qb + 4 * kb + 2 * rows)}
    out = {}
    for name, (flops, byts) in work.items():
        t_f, t_b = flops / rate, byts / HBM_BYTES_PER_S
        out[name] = (max(t_b, t_f) * 1e3,
                     "bytes" if t_b >= t_f else "operations")
    return out


def library_attention(q, k, v, causal):
    """``scaled_dot_product_attention`` on the [B, nh, N, hd] views: the
    library yardstick for the flash forward (timed only).  Cross-length
    causal gets an explicit bottom-right mask (``is_causal`` aligns top
    left)."""
    import torch
    import torch.nn.functional as F
    N, Nk = q.shape[1], k.shape[1]
    mask = None
    if causal and N != Nk:
        mask = torch.ones((N, Nk), dtype=torch.bool,
                          device=q.device).tril(Nk - N)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal and N == Nk)


def library_attention_fwd_bwd(q, k, v, do, causal):
    import torch
    out = library_attention(q, k, v, causal)
    return torch.autograd.grad(out, (q, k, v), do.transpose(1, 2))


def check_flash(torch, flash_attn):
    """Phase (c), flash attention: the forward wrapper and the two backward
    kernels against ``_ref_flash_fwd`` / ``_ref_flash_bwd`` on the same
    inputs (the backward's plain version gets the kernel's out and lse).
    Returns {kernel: [case, ...]}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out = {"flash_attention_fwd": [], "flash_attention_bwd_dq": [],
           "flash_attention_bwd_dkv": []}
    shapes = [(TRAIN_SHAPE, "training"),
              ((1, 1000, 1000, 16, 64, True), "ragged tail"),
              ((1, 128, 320, 16, 64, True), "cross length"),
              ((2, 256, 256, 4, 128, False), "hd 128 non-causal"),
              ((6, 2048, 2048, 16, 128, True), "flagship"),
              ((8, 512, 512, 12, 64, False), "encoder"),
              ((64, 512, 512, 12, 64, False), "ERNIE pretraining"),
              ((2, 512, 512, 8, 256, True), "hd 256"),
              ((2, 128, 128, 8, 32, False), "hd 32, padded to 64"),
              ((2, 512, 512, 4, 96, True), "hd 96, padded to 128"),
              ((4100, 128, 128, 16, 32, False), "B*nh 65600"),
              *WIDE_SHAPES]
    for (B, N, Nk, nh, hd, causal), name in shapes:
        big = B * N * Nk * nh >= 2 ** 26
        plain_kw = dict(per_graph=4, replays=5) if big else {}
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            sets = flash_sets(torch, gen, dt, B, N, Nk, nh, hd, 2)
            q, k, v, do = sets[0]
            o, lse = flash_attn.flash_fwd(q, k, v, causal)
            # (q, k, v, dO, lse, delta, causal, scale), as the wrapper
            # passes them
            bwd_sets = kernel_bwd_sets(flash_attn, sets, o, lse, causal)
            dq = unpad(flash_attn._launch_dq(*bwd_sets[0]), hd)
            dk, dv = (unpad(t, hd)
                      for t in flash_attn._launch_dkv(*bwd_sets[0]))
            torch.cuda.synchronize()
            ro, rl = flash_attn._ref_flash_fwd(q, k, v, causal)
            rdq, rdk, rdv = flash_attn._ref_flash_bwd(q, k, v, o, lse, do,
                                                     causal)
            # bf16 gradients: rtol scales the magnitude of the terms each
            # sums (|ds| |k|, |ds|^T |q|, |p|^T |dO|), not |ref|
            tdq, tdk, tdv = ((rdq, rdk, rdv) if f32 else
                             flash_attn._ref_flash_bwd_terms(
                                 q, k, v, o, lse, do, causal))

            def gated(pairs, fp32_atol):
                atol, rtol = ((fp32_atol, 0.0) if f32
                              else (BF16_ATOL, BF16_RTOL))
                ratio, mutant = gate(pairs, atol, rtol, rows=FLASH_ROWS)
                return {"max_abs_err": max(max_err(g, r)
                                           for g, r, _ in pairs),
                        "mean_abs_ref": float(np.mean(
                            [float(r.float().abs().mean())
                             for _, r, _ in pairs])),
                        "atol": atol, "rtol": rtol, "gate": ratio,
                        "mutant_gate": mutant}
            # the forward's bf16 error follows sum_j p_j |v_j| (each side
            # rounds every p_j), not |out|: its rtol scales that sum
            o_scale = flash_attn._ref_flash_fwd(q, k, v.abs(), causal)[0]
            label = (f"[{B}, {N}, {nh}, {hd}] kv {Nk} "
                     f"{'causal' if causal else 'full'} ({name})")
            bounds = flash_bounds(q, k, causal)
            fwd_sets = [(a, b, c, causal) for a, b, c, _ in sets]
            plain_bwd = [(a, b, c, o, lse, d, causal) for a, b, c, d in sets]
            lib_sets = [(a.detach().requires_grad_(),
                         b.detach().requires_grad_(),
                         c.detach().requires_grad_(), d, causal)
                        for a, b, c, d in sets]
            lib_fwd = device_ms(library_attention, fwd_sets)
            lib_bwd = max(device_ms(library_attention_fwd_bwd, lib_sets)
                          - lib_fwd, 0.0)
            plain_bwd_ms = device_ms(flash_attn._ref_flash_bwd, plain_bwd,
                                     **plain_kw)
            common = {"shape": label, "dtype": str(dt),
                      "bwd_pass_bound_ms": bounds["bwd_pass"][0],
                      "bwd_pass_bound_by": bounds["bwd_pass"][1]}
            out["flash_attention_fwd"].append({
                **common, **gated([(o, ro, o_scale)], FP32_TOL),
                "lse_err": max_err(lse, rl), "lse_tol": FP32_TOL,
                "ms": device_ms(flash_attn.flash_fwd, fwd_sets),
                "call_ms": time_ms(flash_attn.flash_fwd, fwd_sets, 50),
                "plain_ms": device_ms(flash_attn._ref_flash_fwd, fwd_sets,
                                      **plain_kw),
                "library_ms": lib_fwd,
                "bound_ms": bounds["fwd"][0], "bound_by": bounds["fwd"][1]})
            out["flash_attention_bwd_dq"].append({
                **common, **gated([(dq, rdq, tdq)], FLASH_GRAD_TOL),
                "ms": device_ms(flash_attn._launch_dq, bwd_sets),
                "call_ms": time_ms(flash_attn._launch_dq, bwd_sets, 50),
                "plain_ms": plain_bwd_ms, "library_ms": lib_bwd,
                "bound_ms": bounds["dq"][0], "bound_by": bounds["dq"][1]})
            out["flash_attention_bwd_dkv"].append({
                **common, **gated([(dk, rdk, tdk), (dv, rdv, tdv)],
                                  FLASH_GRAD_TOL),
                "ms": device_ms(flash_attn._launch_dkv, bwd_sets),
                "call_ms": time_ms(flash_attn._launch_dkv, bwd_sets, 50),
                "plain_ms": plain_bwd_ms, "library_ms": lib_bwd,
                "bound_ms": bounds["dkv"][0], "bound_by": bounds["dkv"][1]})
            del sets, lib_sets, fwd_sets, bwd_sets, plain_bwd, tdq, tdk, tdv
            torch.cuda.empty_cache()
    for k, cases in out.items():
        for c in cases:
            log(f"  {k:24s} {c['dtype']:15s} {c['shape']:46s} "
                f"max_abs_err {c['max_abs_err']:.3e} gate {c['gate']:.3f} "
                f"(atol {c['atol']:.1e} rtol {c['rtol']:.1e}; mean|ref| "
                f"{c['mean_abs_ref']:.3e}; wrong-scale mutant "
                f"{c['mutant_gate']:.2f})"
                + (f" lse_err {c['lse_err']:.1e}" if "lse_err" in c else "")
                + f"  device ms: kernel {c['ms']:.5f}  plain "
                  f"{c['plain_ms']:.5f}  library {c['library_ms']:.5f}  "
                  f"bound {c['bound_ms']:.6f} ({c['bound_by']}); eager "
                  f"call {c['call_ms']:.5f}")
    bad = [(k, c["shape"], c["dtype"]) for k, cases in out.items()
           for c in cases if not case_ok(c)]
    if bad:
        raise SystemExit(f"flash kernel disagrees with its plain version: "
                         f"{bad}")
    return out


def case_ok(c):
    if "gate" in c:
        ok = c["gate"] <= 1.0 and c["mutant_gate"] > 1.0
    else:
        ok = c["max_abs_err"] <= c["tol"]
    return ok and c.get("lse_err", 0.0) <= c.get("lse_tol", 0.0)


def later_rows(m):
    """The rows past the first 32 of a [..., H] output, or past the first
    row where there are 32 or fewer."""
    m2 = m.view(-1, m.shape[-1])
    return m2[min(32, m2.shape[0] - 1):]


def check_rms_norm(torch, norms):
    """Phase (c), RMSNorm: the kernel against ``_ref_rms_norm`` on the
    same inputs.  fp32 within 1e-5 of max|ref|; bf16 within one bf16 step
    (2^-7) of each |ref|; each case also rejects the later-rows mutant.
    Timed (CUDA-graph replay over enough copies of x to pass the L2) with
    the plain version and ``torch.nn.functional.rms_norm`` on g in x's
    dtype."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [((8, 512, 768), "encoder final norm, g bf16", bf16, bf16),
             ((8, 512, 768), "encoder final norm, g fp32", bf16, f32),
             ((8, 512, 768), "encoder final norm", f32, f32)]
    for shape, name in (((4, 8, 256), "JAX test"), ((3, 1000), "ragged"),
                        ((2, 8), "JAX nn test"),
                        ((3, 1001), "one-element loads")):
        cases += [(shape, name, f32, f32), (shape, name, bf16, bf16)]
    out = []
    for shape, name, dt, gdt in cases:
        H = shape[-1]
        g = torch.randn(H, device="cuda", generator=gen).to(gdt)
        sets = [((torch.randn(shape, device="cuda", generator=gen) * 2
                  + 0.5).to(dt), g)
                for _ in range(l2_copies(math.prod(shape) * 4))]
        x, g = sets[0]
        got = norms.rms_norm(x, g)
        torch.cuda.synchronize()
        ref = norms._ref_rms_norm(x, g, 1e-6)
        if dt == f32:
            atol, rtol = FP32_TOL * float(ref.abs().max()), 0.0
        else:
            atol, rtol = 1e-6, 2.0 ** -7
        ratio, mutant = gate([(got, ref, ref)], atol, rtol, rows=later_rows)
        bound, by = norm_bound(x, g, 1, 4)
        lib = [(a, c.to(dt)) for a, c in sets]
        out.append({
            "shape": f"{list(shape)} ({name})", "dtype": str(dt),
            "g_dtype": str(gdt), "max_abs_err": max_err(got, ref),
            "atol": atol, "rtol": rtol, "gate": ratio, "mutant_gate": mutant,
            "ms": device_ms(norms.rms_norm, sets),
            "call_ms": time_ms(norms.rms_norm, sets, 500),
            "plain_ms": device_ms(
                lambda a, c: norms._ref_rms_norm(a, c, 1e-6), sets),
            "library_ms": device_ms(
                lambda a, c: torch.nn.functional.rms_norm(
                    a, (a.shape[-1],), c, 1e-6), lib),
            "bound_ms": bound, "bound_by": by})
        del sets, lib
    for c in out:
        log(f"  {'rms_norm':16s} {c['dtype']:15s} g {c['g_dtype']:15s} "
            f"{c['shape']:44s} max_abs_err {c['max_abs_err']:.3e} gate "
            f"{c['gate']:.3f} (atol {c['atol']:.1e} rtol {c['rtol']:.1e}; "
            f"wrong-scale mutant {c['mutant_gate']:.2f})  device ms: kernel "
            f"{c['ms']:.5f}  plain {c['plain_ms']:.5f}  library "
            f"{c['library_ms']:.5f}  bound {c['bound_ms']:.6f} "
            f"({c['bound_by']}); eager call {c['call_ms']:.5f}")
    bad = [(c["shape"], c["dtype"], c["g_dtype"]) for c in out
           if not case_ok(c)]
    if bad:
        raise SystemExit(f"rms_norm disagrees with its plain version (or "
                         f"its gate passes the mutant): {bad}")
    return {"rms_norm": out}


def ffn_bound(M, H, F, dt):
    """Least time for the fused FFN: x, w1, b1, w2, b2 read once and the
    output written once, in the dtype, over the HBM rate; or its 4MHF
    flops over the dtype's peak."""
    import torch
    e = 2 if dt == torch.bfloat16 else 4
    byts = (2 * M * H + 2 * H * F + F + H) * e
    rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_f = byts / HBM_BYTES_PER_S, 4 * M * H * F / rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def library_ffn(x, w1, b1, w2, b2):
    """cuBLAS ``addmm`` + tanh gelu + ``addmm``: the library yardstick for
    the fused FFN, which writes and reads the [M, F] intermediate (timed
    only)."""
    import torch
    import torch.nn.functional as F
    return torch.addmm(b2, F.gelu(torch.addmm(b1, x, w1),
                                  approximate="tanh"), w2)


def check_fused_ffn(torch, fused_ffn):
    """Phase (c), the fused FFN against ``_ref_fused_ffn`` (the plain
    version of its own function, taken under :func:`fp32_reduction`):
    fp32 within 1e-5 x max|ref| (sums of up to 8192 terms in another
    order), bf16 per element 2^-8 + 2^-6 |ref|, each case rejecting the
    wrong-scale mutant.  x ~ N(0, 1), weights scaled by 1/sqrt(fan-in),
    biases N(0, 0.1^2).  Returns {"fused_ffn": [case, ...]}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    out = []
    shapes = [((12288, 2048, 8192), "flagship"),
              ((8192, 1024, 4096), "345M"),
              ((8, 1024, 4096), "decode"),
              ((1000, 1024, 4096), "ragged M"),
              ((128, 128, 256), "JAX test"), ((256, 256, 512), "JAX test"),
              ((128, 128, 256), "JAX batched [2, 64]"),
              ((1024, 4096, 16384), "H=4096, two column groups"),
              ((4096, 768, 3072), "H=768, encoder widths"),
              ((37, 6, 10), "H=6 F=10, zero-padded")]
    for (M, H, F), name in shapes:
        big = M * H * F >= 2 ** 34
        kw = dict(per_graph=2, replays=3) if big else {}
        # decode: enough weight copies that replays find them cold in L2
        copies = 8 if M <= 64 else 2
        for dt in (torch.float32, torch.bfloat16):
            def rnd(*shape, scale=1.0):
                return (torch.randn(shape, device="cuda", generator=gen)
                        * scale).to(dt)
            sets = [(rnd(M, H), rnd(H, F, scale=H ** -0.5),
                     rnd(F, scale=0.1), rnd(F, H, scale=F ** -0.5),
                     rnd(H, scale=0.1)) for _ in range(copies)]
            got = fused_ffn.fused_ffn_fwd(*sets[0])
            torch.cuda.synchronize()
            with fp32_reduction(torch):
                ref = fused_ffn._ref_fused_ffn(*sets[0])
            if dt == torch.float32:
                atol, rtol = FP32_TOL * float(ref.abs().max()), 0.0
            else:
                atol, rtol = BF16_ATOL, BF16_RTOL
            # the mutant scales the columns past the first 64, or, for a
            # narrower H, the rows past the first 32
            ratio, mutant = gate([(got, ref, ref)], atol, rtol,
                                 rows=later_tiles if H > 64 else later_rows)
            out.append({
                "shape": f"[{M}, {H}] x [{H}, {F}] ({name})",
                "dtype": str(dt), "max_abs_err": max_err(got, ref),
                "max_abs_ref": float(ref.float().abs().max()),
                "atol": atol, "rtol": rtol, "gate": ratio,
                "mutant_gate": mutant,
                "ms": device_ms(fused_ffn.fused_ffn_fwd, sets, **kw),
                "call_ms": time_ms(fused_ffn.fused_ffn_fwd, sets,
                                   4 if big else 50),
                "plain_ms": device_ms(fused_ffn._ref_fused_ffn, sets, **kw),
                "library_ms": device_ms(library_ffn, sets, **kw),
                "library": "cuBLAS addmm + gelu + addmm",
                "bound_ms": ffn_bound(M, H, F, dt)[0],
                "bound_by": ffn_bound(M, H, F, dt)[1]})
            del sets, got, ref
            torch.cuda.empty_cache()
    for c in out:
        log(f"  fused_ffn {c['dtype']:15s} {c['shape']:44s} max_abs_err "
            f"{c['max_abs_err']:.3e} (max|ref| {c['max_abs_ref']:.2e}) gate "
            f"{c['gate']:.3f} (atol {c['atol']:.1e} rtol {c['rtol']:.1e}; "
            f"wrong-scale mutant {c['mutant_gate']:.2f})  device ms: "
            f"kernel {c['ms']:.5f}  plain {c['plain_ms']:.5f}  library "
            f"{c['library_ms']:.5f}  bound {c['bound_ms']:.6f} "
            f"({c['bound_by']}); eager call {c['call_ms']:.5f}")
    bad = [(c["shape"], c["dtype"]) for c in out if not case_ok(c)]
    if bad:
        raise SystemExit(f"fused FFN disagrees with its plain version: {bad}")
    return {"fused_ffn": out}


def check_fused_bwd(torch, flash_attn):
    """Phase (c), the fused flash backward (``_launch_fused``) against
    ``_ref_flash_bwd`` on the kernel forward's out and lse, at the split
    kernels' tolerances; beside its time the split kernels' (dq + dk/dv)
    on the same inputs and the largest |dq| difference between two fused
    launches (the atomics' order varies).  Returns
    {"flash_attention_bwd_fused": [case, ...]}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    out = []
    shapes = [((6, 2048, 2048, 16, 128, True), "flagship"),
              (TRAIN_SHAPE, "345M training"),
              ((1, 1000, 1000, 16, 64, True), "ragged tail"),
              ((1, 128, 320, 16, 64, True), "cross length"),
              ((1, 512, 512, 1, 128, False), "hd 128 non-causal"),
              ((2, 512, 512, 8, 256, True), "hd 256"),
              ((2, 512, 512, 4, 96, True), "hd 96, padded to 128"),
              *WIDE_SHAPES]
    for (B, N, Nk, nh, hd, causal), name in shapes:
        big = B * N * Nk * nh >= 2 ** 26
        kw = dict(per_graph=2, replays=3) if big else {}
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            sets = flash_sets(torch, gen, dt, B, N, Nk, nh, hd, 2)
            q, k, v, do = sets[0]
            o, lse = flash_attn.flash_fwd(q, k, v, causal)
            bwd_sets = kernel_bwd_sets(flash_attn, sets, o, lse, causal)
            dq, dk, dv = (unpad(t, hd)
                          for t in flash_attn._launch_fused(*bwd_sets[0]))
            dq2 = unpad(flash_attn._launch_fused(*bwd_sets[0])[0], hd)
            torch.cuda.synchronize()
            rdq, rdk, rdv = flash_attn._ref_flash_bwd(q, k, v, o, lse, do,
                                                     causal)
            atol, rtol = ((FLASH_GRAD_TOL, 0.0) if f32
                          else (BF16_ATOL, BF16_RTOL))
            # bf16: rtol scales the magnitude of the terms each gradient
            # sums, as in the split backward's gates
            terms = ((rdq, rdk, rdv) if f32 else
                     flash_attn._ref_flash_bwd_terms(q, k, v, o, lse, do,
                                                     causal))
            pairs = list(zip((dq, dk, dv), (rdq, rdk, rdv), terms))
            ratio, mutant = gate(pairs, atol, rtol, rows=FLASH_ROWS)
            bounds = flash_bounds(q, k, causal)
            lib_sets = [(a.detach().requires_grad_(),
                         b.detach().requires_grad_(),
                         c.detach().requires_grad_(), d, causal)
                        for a, b, c, d in sets]
            lib_fwd = device_ms(library_attention,
                                [(a, b, c, causal) for a, b, c, _ in sets])
            plain = [(a, b, c, o, lse, d, causal) for a, b, c, d in sets]
            out.append({
                "shape": (f"[{B}, {N}, {nh}, {hd}] kv {Nk} "
                          f"{'causal' if causal else 'full'} ({name})"),
                "dtype": str(dt),
                "max_abs_err": max(max_err(g, r) for g, r, _ in pairs),
                "mean_abs_ref": float(np.mean([float(r.float().abs().mean())
                                               for _, r, _ in pairs])),
                "atol": atol, "rtol": rtol, "gate": ratio,
                "mutant_gate": mutant,
                "dq_rerun_max_abs_diff": max_err(dq, dq2),
                "ms": device_ms(flash_attn._launch_fused, bwd_sets, **kw),
                "call_ms": time_ms(flash_attn._launch_fused, bwd_sets, 20),
                "split_ms": (device_ms(flash_attn._launch_dq, bwd_sets, **kw)
                             + device_ms(flash_attn._launch_dkv, bwd_sets,
                                         **kw)),
                "plain_ms": device_ms(flash_attn._ref_flash_bwd, plain,
                                      **kw),
                "library_ms": max(device_ms(library_attention_fwd_bwd,
                                            lib_sets) - lib_fwd, 0.0),
                "library": "SDPA backward (fwd + bwd less fwd)",
                "bound_ms": bounds["bwd_pass"][0],
                "bound_by": bounds["bwd_pass"][1]})
            del sets, lib_sets, bwd_sets, plain, dq, dk, dv, dq2, terms, pairs
            torch.cuda.empty_cache()
    for c in out:
        log(f"  flash_attention_bwd_fused {c['dtype']:15s} "
            f"{c['shape']:50s} max_abs_err {c['max_abs_err']:.3e} gate "
            f"{c['gate']:.3f} (atol {c['atol']:.1e} rtol {c['rtol']:.1e}; "
            f"mean|ref| {c['mean_abs_ref']:.3e}; wrong-scale mutant "
            f"{c['mutant_gate']:.2f}); dq between two launches "
            f"{c['dq_rerun_max_abs_diff']:.2e}  device ms: kernel "
            f"{c['ms']:.5f}  split dq + dk/dv {c['split_ms']:.5f}  plain "
            f"{c['plain_ms']:.5f}  library {c['library_ms']:.5f}  bound "
            f"{c['bound_ms']:.6f} ({c['bound_by']}); eager call "
            f"{c['call_ms']:.5f}")
    bad = [(c["shape"], c["dtype"]) for c in out if not case_ok(c)]
    if bad:
        raise SystemExit(f"fused flash backward disagrees with its plain "
                         f"version: {bad}")
    return {"flash_attention_bwd_fused": out}


def dqmm_bound(M, K, N, dt):
    """Least time for the dequant matmul: K*N int8 weight bytes, 4N scale
    bytes, x and out in the compute dtype, over the HBM rate; or 2MKN
    flops over the dtype's peak (tensor cores for bf16, CUDA cores for
    fp32)."""
    import torch
    e = 2 if dt == torch.bfloat16 else 4
    byts = K * N + 4 * N + M * K * e + M * N * e
    rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_f = byts / HBM_BYTES_PER_S, 2 * M * K * N / rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def dequantized_args(x, w_q, scale):
    """The dequant matmul's operands with the weights and scale cast to
    ``x.dtype`` beforehand, for :func:`cublas_dequantized`."""
    return x, w_q.to(x.dtype), scale.to(x.dtype)


def cublas_dequantized(x, w, scale):
    """cuBLAS ``x @ w`` on weights dequantized beforehand, times the
    scale: a library yardstick that reads twice the weight bytes (bf16)
    but runs cuBLAS's own GEMM (timed only)."""
    return (x @ w) * scale


def library_dqmm():
    """The library yardstick for the dequant matmul: ``torch.
    _weight_int8pack_mm`` where it runs on this card and torch for the
    dtype, else :func:`cublas_dequantized`.  Returns (name, make_args, fn)
    per dtype, chosen by a probe call."""
    import torch
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(8, 64, device="cuda").to(dt)
        w = torch.randint(-127, 128, (64, 64), device="cuda",
                          dtype=torch.int8)
        s = torch.rand(64, device="cuda") + 0.1
        try:
            torch._weight_int8pack_mm(x, w.t().contiguous(), s.to(dt))
            torch.cuda.synchronize()
            out[dt] = ("torch._weight_int8pack_mm",
                       lambda a, b, c: (a, b.t().contiguous(), c.to(a.dtype)),
                       torch._weight_int8pack_mm)
        except (RuntimeError, NotImplementedError, AttributeError):
            out[dt] = ("cuBLAS x @ w_q.to(dtype) (dequantized beforehand) "
                       "* scale", dequantized_args, cublas_dequantized)
    return out


def paged_quant_inputs(torch, gpt, rng, dtype, S, nh, hd, ps, maxP, lens,
                       P=None, copies=1, random_table=False, v_mean=False):
    """``copies`` operand sets for int8 paged attention sharing q, table
    and lens: K/V drawn N(0, 1) and quantized by the port's
    ``quantize_kv`` (absmax scales per position and head), q N(0, 2^2).
    With ``random_table`` every table entry is a random page (entries past
    a lane's fill are garbage the kernel must not read), as in the JAX
    kernel tests; else each lane owns its pages and the rest point at
    scratch page 0.  With ``v_mean`` every (head, channel) of V gets its
    own N(0, 1) mean before quantization, as in :func:`paged_inputs`."""
    P = P or S * maxP + 1
    q = torch.from_numpy(2 * rng.standard_normal((S, 1, nh, hd),
                                                 dtype=np.float32))
    if random_table:
        table = rng.integers(0, P, (S, maxP)).astype(np.int32)
    else:
        table = np.zeros((S, maxP), np.int32)
        pages = rng.permutation(np.arange(1, P)).astype(np.int32)
        for s, ln in enumerate(lens):
            n = int(ln) // ps + 1
            table[s, :n] = pages[s * maxP:s * maxP + n]
    q = q.cuda().to(dtype)
    table = torch.from_numpy(table).cuda()
    lens_t = torch.tensor(np.asarray(lens, np.int32)).cuda()
    sets = []
    for _ in range(copies):
        kq, ks = gpt.quantize_kv(torch.randn((P, ps, nh, hd), device="cuda"))
        v = torch.randn((P, ps, nh, hd), device="cuda")
        if v_mean:
            v += torch.randn((nh, hd), device="cuda")
        vq, vs = gpt.quantize_kv(v)
        sets.append((q, kq, ks, vq, vs, table, lens_t))
    return sets


def library_paged_quant(q, kq, ks, vq, vs, table, lens):
    """Gather + dequantize + ``scaled_dot_product_attention``: the library
    yardstick for int8 paged decode attention (timed only)."""
    k = (kq.float() * ks[..., None]).to(q.dtype)
    v = (vq.float() * vs[..., None]).to(q.dtype)
    return library_paged(q, k, v, table, lens)


def paged_quant_bound(q, kq, table, lens):
    """Least time for int8 paged attention on these inputs: the int8 K
    and V of every attended position once, their fp32 scales, q, out, the
    table rows it reads and lens, over the HBM rate; or its flops
    (dequantize K and V, q.k, p.v: 6 per element) over the fp32 rate."""
    S, _, nh, hd = q.shape
    ps = kq.shape[1]
    maxP = table.shape[1]
    n = np.minimum(lens.cpu().numpy().astype(np.int64) + 1, maxP * ps)
    byts = (int(n.sum()) * nh * (2 * hd + 8) + 2 * q.numel()
            * q.element_size() + int((-(-n // ps)).sum()) * 4 + S * 4)
    flops = 6 * int(n.sum()) * nh * hd
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def check_quant_kernels(torch, gpt, dqmm, paged_attn):
    """Phase (c), the quantized path's kernels.  Dequant matmul: fp32
    within 1e-5 x max|ref| (the JAX kernel test's gate); bf16 per element
    |got - ref| <= 2^-8 + 2^-6 |ref| (the kernel rounds once, the plain
    version twice).  Int8 paged attention: fp32 within 1e-5; bf16 per
    element 2^-8 + 2^-6 sum_j p_j |v_j|, capped at 2e-2.  Every case must
    also reject the wrong-scale mutant.  The references of the gates are
    taken under :func:`fp32_reduction`; every time under cuBLAS's default.
    Each dequant-matmul case also times :func:`cublas_dequantized`
    (``library_cublas_ms``).  Returns {kernel: [case, ...]}."""
    rng = np.random.default_rng(SEED + 8)
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}

    def record(name, dt, label, got, ref, scale, atol, rtol, sets, fn,
               plain, lib, bound, cap=None, rows=later_tiles, lib_name=None):
        ratio, mutant = gate([(got, ref, scale)], atol, rtol, cap, rows)
        per = len(sets)
        out.setdefault(name, []).append({
            "shape": label, "dtype": str(dt),
            "max_abs_err": max_err(got, ref),
            "max_abs_ref": float(ref.float().abs().max()),
            "atol": atol, "rtol": rtol, "gate": ratio,
            "mutant_gate": mutant,
            "ms": device_ms(fn, sets, per_graph=per),
            "call_ms": time_ms(fn, sets, max(50, per)),
            "plain_ms": device_ms(plain, sets, per_graph=per),
            "library_ms": device_ms(lib[1], lib[0], per_graph=per),
            "library": lib_name, "bound_ms": bound[0],
            "bound_by": bound[1]})

    libs = library_dqmm()
    shapes = [((8, 1024, 3072), "decode qkv"),
              ((8, 1024, 1024), "decode proj"),
              ((8, 1024, 4096), "decode fc1"),
              ((8, 4096, 1024), "decode fc2"),
              ((4096, 1024, 4096), "prefill fc1"),
              ((16, 1024, 4096), "M=16, the last streamed M"),
              ((17, 1024, 4096), "M=17, the first wgmma M"),
              ((64, 1024, 4096), "M=64"), ((65, 1024, 4096), "M=65"),
              ((1000, 1024, 4096), "M=1000, ragged row tile"),
              ((4096, 1024, 3072), "prefill qkv"),
              ((4096, 4096, 1024), "prefill fc2"),
              ((8, 128, 256), "JAX test"), ((128, 256, 128), "JAX test"),
              ((32, 128, 512), "JAX test"), ((3, 128, 256), "M=3")]
    for (M, K, N), name in shapes:
        # enough weight copies that the replayed calls find them cold
        # in the 50 MB L2, as the decode path does
        copies = (max(2, min(64, -(-96 * 2 ** 20 // (K * N))))
                  if M <= 64 else 2)
        for dt in (f32, bf16):
            sets = []
            for _ in range(copies):
                x = torch.randn((M, K), device="cuda").to(dt)
                w = torch.randint(-127, 128, (K, N), device="cuda",
                                  dtype=torch.int8)
                sc = (torch.rand(N, device="cuda") + 0.1) / 64
                sets.append((x, w, sc))
            got = dqmm.dequant_matmul(*sets[0])
            torch.cuda.synchronize()
            with fp32_reduction(torch):
                ref = dqmm._ref_dequant_matmul(*sets[0])
            if dt == f32:
                atol = DQMM_FP32_RTOL * float(ref.abs().max())
                rtol = 0.0
            else:
                atol, rtol = BF16_ATOL, BF16_RTOL
            lname, largs, lfn = libs[dt]
            lib_sets = [largs(*a) for a in sets]
            record("dequant_matmul", dt,
                   f"[{M}, {K}] x [{K}, {N}] ({name})", got, ref, ref,
                   atol, rtol, sets, dqmm.dequant_matmul,
                   dqmm._ref_dequant_matmul, (lib_sets, lfn),
                   dqmm_bound(M, K, N, dt), lib_name=lname)
            deq_sets = [dequantized_args(*a) for a in sets]
            out["dequant_matmul"][-1]["library_cublas_ms"] = device_ms(
                cublas_dequantized, deq_sets, per_graph=len(sets))
            del sets, lib_sets, deq_sets
    torch.cuda.empty_cache()

    cases = [
        # the serving decode shape, lengths as the main path sees them
        (dict(S=8, nh=16, hd=64, ps=16, maxP=32,
              lens=[int(n) for n in rng.integers(17, 332, 8)]),
         "S8 nh16 hd64 ps16 maxP32 (decode)", 8, False),
        # the JAX kernel tests' (S, nh, hd, P, ps, maxP), random tables
        (dict(S=4, nh=4, hd=16, ps=8, maxP=4, P=12), "JAX (4,4,16,12,8,4)",
         2, True),
        (dict(S=2, nh=2, hd=64, ps=16, maxP=2, P=6), "JAX (2,2,64,6,16,2)",
         2, True),
        (dict(S=3, nh=4, hd=32, ps=8, maxP=6, P=16), "JAX (3,4,32,16,8,6)",
         2, True),
        (dict(S=4, nh=16, hd=64, ps=16, maxP=8, lens=[0, 0, 9, 127]),
         "S4 nh16 hd64 ps16 maxP8, len-0 lanes", 2, False),
        # head widths off the powers of two: hd 24 (rows off 16 bytes,
        # one-byte loads) and 80 (lanes of the last slice masked)
        (dict(S=8, nh=16, hd=24, ps=16, maxP=32,
              lens=[int(n) for n in rng.integers(17, 332, 8)]),
         "S8 nh16 hd24 ps16 maxP32 (masked lanes)", 8, False),
        (dict(S=8, nh=16, hd=80, ps=16, maxP=32,
              lens=[int(n) for n in rng.integers(17, 332, 8)]),
         "S8 nh16 hd80 ps16 maxP32 (masked lanes)", 8, False),
        # long contexts, the int8 pool's reason to be (V with a mean per
        # channel, so the long average stays large enough for the mutant
        # to show): 16 ragged slots, lens 0, ps-1, ps and a full table,
        # one split a slot; one slot of 8,191 positions, split over the SMs
        (dict(S=16, nh=16, hd=64, ps=16, maxP=64, v_mean=True,
              lens=[0, 15, 16, 64 * 16 - 1] + [
                  int(n) for n in rng.integers(1, 64 * 16 - 1, 12)]),
         "S16 nh16 hd64 ps16 maxP64 ragged", 4, False),
        (dict(S=1, nh=16, hd=64, ps=16, maxP=512, v_mean=True, lens=[8190]),
         "S1 nh16 hd64 ps16 maxP512, 8191 positions", 4, False),
    ]
    for kw, label, copies, rnd in cases:
        if rnd:
            kw["lens"] = [int(n) for n in
                          rng.integers(0, kw["maxP"] * kw["ps"], kw["S"])]
        for dt in (f32, bf16):
            sets = paged_quant_inputs(torch, gpt, rng, dt, copies=copies,
                                      random_table=rnd, **kw)
            got = paged_attn.paged_attention_quant(*sets[0])
            torch.cuda.synchronize()
            q, kq, ks, vq, vs, table, lens = sets[0]
            with fp32_reduction(torch):
                ref = paged_attn._ref_paged_attention_quant(*sets[0])
                # bf16: both sides round every p_j, so sum_j p_j |v_j|
                # bounds the difference
                scale = (ref if dt == f32 else
                         paged_attn._ref_paged_attention_quant(
                             q, kq, ks, vq.abs(), vs, table, lens))
            if dt == f32:
                atol, rtol, cap = FP32_TOL, 0.0, None
            else:
                atol, rtol, cap = BF16_ATOL, BF16_RTOL, PAGED_BF16_CAP
            if len(kw["lens"]) <= 4:
                label = label.split(" lens")[0] + f" lens {kw['lens']}"
            record("paged_attention_quant", dt, label, got, ref, scale,
                   atol, rtol, sets, paged_attn.paged_attention_quant,
                   paged_attn._ref_paged_attention_quant,
                   (sets, library_paged_quant),
                   paged_quant_bound(q, kq, table, lens), cap=cap,
                   rows=later_slots if kw["S"] > 1 else later_heads,
                   lib_name="gather + dequantize + SDPA")
    for k, cs in out.items():
        for c in cs:
            log(f"  {k:22s} {c['dtype']:15s} {c['shape'][:52]:52s} "
                f"max_abs_err {c['max_abs_err']:.3e} (max|ref| "
                f"{c['max_abs_ref']:.2e}) gate {c['gate']:.3f} (atol "
                f"{c['atol']:.1e} rtol {c['rtol']:.1e}; wrong-scale mutant "
                f"{c['mutant_gate']:.2f})  device ms: kernel {c['ms']:.5f}  "
                f"plain {c['plain_ms']:.5f}  library {c['library_ms']:.5f}  "
                f"bound {c['bound_ms']:.6f} ({c['bound_by']}); eager call "
                f"{c['call_ms']:.5f}"
                + (f"; cuBLAS on dequantized weights "
                   f"{c['library_cublas_ms']:.5f}"
                   if "library_cublas_ms" in c else ""))
    for k, cs in out.items():
        log(f"  {k} library: {cs[0]['library']}"
            + (f" / {cs[1]['library']}" if cs[1]["library"]
               != cs[0]["library"] else ""))
    bad = [(k, c["shape"], c["dtype"]) for k, cs in out.items() for c in cs
           if not case_ok(c)]
    if bad:
        raise SystemExit(f"quantized-path kernel disagrees with its plain "
                         f"version: {bad}")
    return out


def first_rows(m):
    """The first 64 rows (axis 1): of a causal N > Nk problem, rows that
    see no key."""
    return m[:, :64]


def last_rows(m):
    """The last 64 rows (axis 1)."""
    return m[:, -64:]


def check_queue3(torch, gpt, flash_attn, paged_attn, norms, dqmm):
    """Phase (c), the inputs the kernels used to refuse or read otherwise
    than the reference (ROADMAP Queue 3), each kernel against its plain
    version, each gate also rejecting its wrong-scale mutant: paged
    attention (fp and int8 pools) with table entries -1, -5, -P - 3, P and
    P + 40 (a negative entry wraps once, then the index is clamped);
    RMSNorm on a transposed view and one 4 bytes off alignment; the
    dequant matmul at K = 13, N = 10 and K = 1030, N = 1000 (padded per
    call and, as the engine does, once); flash attention causal with N =
    Nk + 1 and N = 2 Nk (rows that see no key), forward and both backward
    strategies; paged attention at heads of fp32 160, bf16 320 and int8
    640 (head-width groups) and at S = 65,537 slots (two launches).
    Returns {kernel: [case, ...]}, each case timed (kernel device ms)."""
    rng = np.random.default_rng(SEED + 21)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    bf16, f32 = torch.bfloat16, torch.float32
    out = collections.defaultdict(list)

    def record(name, label, dt, pairs, atol, rtol, rows, fn, sets, cap=None,
               per_graph=4, **extra):
        ratio, mutant = gate(pairs, atol, rtol, cap, rows)
        out[name].append({
            "shape": label, "dtype": str(dt),
            "max_abs_err": max(max_err(g, r) for g, r, _ in pairs),
            "atol": atol, "rtol": rtol, "gate": ratio,
            "mutant_gate": mutant,
            "ms": device_ms(fn, sets, per_graph=per_graph, replays=3),
            **extra})

    def wild_table(table, P):
        """Entries outside [0, P) in filled pages of slots 0 and 2."""
        t = table.clone()
        t[0, 1:6] = torch.tensor([-1, -5, -P - 3, P, P + 40])
        t[2, 3:8] = torch.tensor([P + 40, P, -P - 3, -5, -1])
        return t

    # paged attention: table entries outside [0, P) -----------------------
    lens = [300, 200, 450, 100]
    for dt in (f32, bf16):
        q, k, v, table, lens_t = paged_inputs(torch, rng, dt, 4, 16, 64, 16,
                                              32, lens)[0]
        table = wild_table(table, k.shape[0])
        args = (q, k, v, table, lens_t)
        got = paged_attn.paged_attention(*args)
        ref = paged_attn._ref_paged_attention(*args)
        atol = FP32_TOL if dt == f32 else 2.0 ** -6
        record("paged_attention", "S4 nh16 hd64 table entries outside "
               "[0, P)", dt, [(got, ref, ref)], atol, 0.0, later_slots,
               paged_attn.paged_attention, [args])
        sets = paged_quant_inputs(torch, gpt, rng, dt, 4, 16, 64, 16, 32,
                                  lens)
        qq, kq, ks, vq, vs, table, lens_t = sets[0]
        qargs = (qq, kq, ks, vq, vs, wild_table(table, kq.shape[0]), lens_t)
        got = paged_attn.paged_attention_quant(*qargs)
        ref = paged_attn._ref_paged_attention_quant(*qargs)
        scale = (ref if dt == f32 else paged_attn._ref_paged_attention_quant(
            *qargs[:3], vq.abs(), *qargs[4:]))
        atol, rtol, cap = ((FP32_TOL, 0.0, None) if dt == f32
                           else (BF16_ATOL, BF16_RTOL, PAGED_BF16_CAP))
        record("paged_attention_quant", "S4 nh16 hd64 table entries outside "
               "[0, P)", dt, [(got, ref, scale)], atol, rtol, later_slots,
               paged_attn.paged_attention_quant, [qargs], cap=cap)

    # paged attention: wide heads (head-width groups) ---------------------
    lens = [int(n) for n in rng.integers(17, 500, 8)]
    for dt, hd in ((f32, 160), (bf16, 320), (f32, 320)):
        sets = paged_inputs(torch, rng, dt, 8, 8, hd, 16, 32, lens, copies=2)
        got = paged_attn.paged_attention(*sets[0])
        ref = paged_attn._ref_paged_attention(*sets[0])
        q, k, v, table, lens_t = sets[0]
        if dt == f32:
            atol, rtol, scale = FP32_TOL, 0.0, ref
        else:
            atol, rtol = BF16_ATOL, BF16_RTOL
            scale = paged_attn._ref_paged_attention(q, k, v.abs(), table,
                                                    lens_t)
        record("paged_attention", f"S8 nh8 hd{hd} ps16 maxP32 (head-width "
               f"groups)", dt, [(got, ref, scale)], atol, rtol, later_slots,
               paged_attn.paged_attention, sets)
    for dt in (f32, bf16):
        sets = paged_quant_inputs(torch, gpt, rng, dt, 8, 8, 640, 16, 32,
                                  lens, copies=2)
        got = paged_attn.paged_attention_quant(*sets[0])
        ref = paged_attn._ref_paged_attention_quant(*sets[0])
        qq, kq, ks, vq, vs, table, lens_t = sets[0]
        scale = (ref if dt == f32 else paged_attn._ref_paged_attention_quant(
            qq, kq, ks, vq.abs(), vs, table, lens_t))
        atol, rtol, cap = ((FP32_TOL, 0.0, None) if dt == f32
                           else (BF16_ATOL, BF16_RTOL, PAGED_BF16_CAP))
        record("paged_attention_quant", "S8 nh8 hd640 ps16 maxP32 "
               "(head-width groups)", dt, [(got, ref, scale)], atol, rtol,
               later_slots, paged_attn.paged_attention_quant, sets, cap=cap)

    # paged attention: S = 65,537 slots (two launches), a small pool ------
    S, P = 65537, 33
    q = torch.randn((S, 1, 1, 64), device="cuda", generator=gen)
    k, v = (torch.randn((P, 16, 1, 64), device="cuda", generator=gen)
            for _ in range(2))
    table = torch.randint(1, P, (S, 8), device="cuda", generator=gen,
                          dtype=torch.int32)
    lens_t = torch.randint(0, 128, (S,), device="cuda", generator=gen,
                           dtype=torch.int32)
    for dt in (f32, bf16):
        args = (q.to(dt), k.to(dt), v.to(dt), table, lens_t)
        before = paged_attn.launches
        got = paged_attn.paged_attention(*args)
        launched = paged_attn.launches - before
        ref = paged_attn._ref_paged_attention(*args)
        # bf16: outputs past 2 (few positions a slot) round at 2^-6 and
        # coarser, so the per-element rule of the int8 cases
        if dt == f32:
            atol, rtol, scale = FP32_TOL, 0.0, ref
        else:
            atol, rtol = BF16_ATOL, BF16_RTOL
            scale = paged_attn._ref_paged_attention(*args[:2],
                                                    args[2].abs(), *args[3:])
        record("paged_attention", "S65537 nh1 hd64 ps16 maxP8 (two "
               "launches)", dt, [(got, ref, scale)], atol, rtol,
               later_slots, paged_attn.paged_attention, [args], per_graph=1,
               launches_a_call=launched)
        if launched != 2:
            raise SystemExit(f"(c): S=65537 took {launched} launches")
    kq, ks = gpt.quantize_kv(k)
    vq, vs = gpt.quantize_kv(v)
    qargs = (q, kq, ks, vq, vs, table, lens_t)
    got = paged_attn.paged_attention_quant(*qargs)
    ref = paged_attn._ref_paged_attention_quant(*qargs)
    record("paged_attention_quant", "S65537 nh1 hd64 ps16 maxP8 (two "
           "launches)", f32, [(got, ref, ref)], FP32_TOL, 0.0, later_slots,
           paged_attn.paged_attention_quant, [qargs], per_graph=1)
    del q, k, v, table, lens_t, kq, vq, got, ref, args, qargs
    torch.cuda.empty_cache()

    # RMSNorm: strided and unaligned views --------------------------------
    for dt in (f32, bf16):
        base = (torch.randn((768, 512 + 4), device="cuda", generator=gen)
                * 2 + 0.5).to(dt)
        g = torch.randn(768, device="cuda", generator=gen)
        off = 4 // base.element_size()
        for label, x in (("transposed view [512, 768]", base[:, :512].t()),
                         ("view 4 bytes off alignment [512, 768]",
                          base.reshape(-1)[off:off + 512 * 768]
                          .view(512, 768))):
            got = norms.rms_norm(x, g)
            ref = norms._ref_rms_norm(x, g, 1e-6)
            atol, rtol = ((FP32_TOL * float(ref.abs().max()), 0.0)
                          if dt == f32 else (1e-6, 2.0 ** -7))
            record("rms_norm", label, dt, [(got, ref, ref)], atol, rtol,
                   later_rows, norms.rms_norm, [(x, g)], g_dtype=str(f32))

    # dequant matmul: K and N off the kernels' multiples ------------------
    for M, K, N in ((8, 13, 10), (100, 13, 10), (8, 1030, 1000),
                    (100, 1030, 1000)):
        for dt in (f32, bf16):
            x = torch.randn((M, K), device="cuda", generator=gen).to(dt)
            wb = torch.randint(-127, 128, (K, N + 3), device="cuda",
                               generator=gen, dtype=torch.int8)
            w = wb[:, 3:]                       # strided, 3 bytes off
            sc = (torch.rand(N, device="cuda", generator=gen) + 0.1) / 64
            wp, sp = dqmm.pad_weight(w, sc)
            got = dqmm.dequant_matmul(x, w, sc)
            pre = dqmm.dequant_matmul(x, wp, sp, n=N)
            with fp32_reduction(torch):
                ref = dqmm._ref_dequant_matmul(x, w, sc)
            if dt == f32:
                atol, rtol = DQMM_FP32_RTOL * float(ref.abs().max()), 0.0
            else:
                atol, rtol = BF16_ATOL, BF16_RTOL
            record("dequant_matmul", f"[{M}, {K}] x [{K}, {N}] (K, N off "
                   "the multiples; strided weight)", dt,
                   [(got, ref, ref), (pre, ref, ref)], atol, rtol,
                   later_slots,
                   lambda a, b, c, d: dqmm.dequant_matmul(a, b, c, n=d),
                   [(x, wp, sp, N)])

    # flash attention: causal with N > Nk ---------------------------------
    for B, N, Nk, nh, hd in ((2, 257, 256, 4, 64), (2, 512, 256, 4, 64)):
        for dt in (f32, bf16):
            # V with a mean per (head, channel): the rows that see no key
            # average all of V, and the mean must stay large enough for
            # the wrong-scale mutant to show against the bf16 gate
            q = torch.randn((B, N, nh, hd), device="cuda",
                            generator=gen).to(dt)
            k = torch.randn((B, Nk, nh, hd), device="cuda",
                            generator=gen).to(dt)
            v = (torch.randn((B, Nk, nh, hd), device="cuda", generator=gen)
                 + torch.randn((nh, hd), device="cuda",
                               generator=gen)).to(dt)
            do = torch.randn((B, N, nh, hd), device="cuda",
                             generator=gen).to(dt)
            o, lse = flash_attn.flash_fwd(q, k, v, True)
            ro, rl = flash_attn._ref_flash_fwd(q, k, v, True)
            rdq, rdk, rdv = flash_attn._ref_flash_bwd(q, k, v, o, lse, do,
                                                     True)
            f = dt == f32
            terms = ((rdq, rdk, rdv) if f else
                     flash_attn._ref_flash_bwd_terms(q, k, v, o, lse, do,
                                                     True))
            label = f"[{B}, {N}, {nh}, {hd}] kv {Nk} causal (N > Nk)"
            o_scale = ro if f else flash_attn._ref_flash_fwd(
                q, k, v.abs(), True)[0]
            atol, rtol = (FP32_TOL, 0.0) if f else (BF16_ATOL, BF16_RTOL)
            record("flash_attention_fwd", label, dt, [(o, ro, o_scale)],
                   atol, rtol, (first_rows, last_rows), flash_attn.flash_fwd,
                   [(q, k, v, True)], lse_err=max_err(lse, rl),
                   lse_tol=FP32_TOL)
            gatol, grtol = ((FLASH_GRAD_TOL, 0.0) if f
                            else (BF16_ATOL, BF16_RTOL))
            bwd = [(q, k, v, o, lse, do, True)]
            for fused, names in ((False, ("flash_attention_bwd_dq",
                                          "flash_attention_bwd_dkv")),
                                 (True, ("flash_attention_bwd_fused",))):
                flash_attn.set_default_blocks(bwd_fused=fused)
                try:
                    dq, dk, dv = flash_attn.flash_bwd(q, k, v, o, lse, do,
                                                      True)
                    torch.cuda.synchronize()
                    if not fused:
                        # dq is 0 on the rows that see no key: a scaled 0
                        # is 0, so its mutant scales the last rows only
                        record(names[0], label, dt, [(dq, rdq, terms[0])],
                               gatol, grtol, (last_rows,),
                               flash_attn.flash_bwd, bwd)
                        record(names[1], label, dt,
                               [(dk, rdk, terms[1]), (dv, rdv, terms[2])],
                               gatol, grtol, (first_rows, last_rows),
                               flash_attn.flash_bwd, bwd)
                    else:
                        record(names[0], label, dt,
                               list(zip((dq, dk, dv), (rdq, rdk, rdv),
                                        terms)), gatol, grtol,
                               (first_rows, last_rows),
                               flash_attn.flash_bwd, bwd)
                    if bool(dq[:, :N - Nk].any()):
                        raise SystemExit(f"(c): dq on rows with no key is "
                                         f"not 0 ({label}, {dt})")
                finally:
                    flash_attn.set_default_blocks(bwd_fused=False)
    torch.cuda.empty_cache()
    for name, cs in out.items():
        for c in cs:
            log(f"  {name:24s} {c['dtype']:15s} {c['shape'][:56]:56s} "
                f"max_abs_err {c['max_abs_err']:.3e} gate {c['gate']:.3f} "
                f"(atol {c['atol']:.1e} rtol {c['rtol']:.1e}; wrong-scale "
                f"mutant {c['mutant_gate']:.2f})"
                + (f" lse_err {c['lse_err']:.1e}" if "lse_err" in c else "")
                + f"  device ms: kernel {c['ms']:.5f}")
    bad = [(k, c["shape"], c["dtype"]) for k, cs in out.items() for c in cs
           if not case_ok(c)]
    if bad:
        raise SystemExit(f"(c): a kernel disagrees with its plain version "
                         f"on an input it used to refuse: {bad}")
    return dict(out)


def numpy_gpt_params(cfg, seed):
    """GPT params in the JAX layout drawn with numpy: the reference
    ``init_params`` distribution (N(0, 0.02), residual projections scaled
    by 1/sqrt(2L), unit gains, zero biases)."""
    rng = np.random.default_rng(seed)
    H, L, F, V = (cfg.hidden_size, cfg.num_layers, cfg.ffn_size,
                  cfg.vocab_size)
    std = cfg.initializer_range
    res = std / math.sqrt(2.0 * L)

    def nrm(shape, scale=std):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return a

    blocks = {
        "ln1_g": np.ones((L, H), np.float32),
        "ln1_b": np.zeros((L, H), np.float32),
        "qkv_w": nrm((L, H, 3, H)), "qkv_b": np.zeros((L, 3, H), np.float32),
        "proj_w": nrm((L, H, H), res), "proj_b": np.zeros((L, H), np.float32),
        "ln2_g": np.ones((L, H), np.float32),
        "ln2_b": np.zeros((L, H), np.float32),
        "fc1_w": nrm((L, H, F)), "fc1_b": np.zeros((L, F), np.float32),
        "fc2_w": nrm((L, F, H), res), "fc2_b": np.zeros((L, H), np.float32),
    }
    return {"wte": nrm((V, H)), "wpe": nrm((cfg.max_seq_len, H)),
            "blocks": blocks, "lnf_g": np.ones((H,), np.float32),
            "lnf_b": np.zeros((H,), np.float32)}


def make_prompts(V):
    """12 prompts of 17-300 tokens; requests 0 and 6 share a 64-token
    (four-page) prefix."""
    rng = np.random.default_rng(SEED + 1)
    lens = [int(n) for n in rng.integers(17, 301, 12)]
    lens[0], lens[6] = max(lens[0], 80), max(lens[6], 100)
    lens[1], lens[2] = 17, 300             # both ends of the range
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in lens]
    prompts[6][:64] = prompts[0][:64]
    return prompts


def merged_busy(intervals):
    """Total length of the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def trace_summary(prof, trace_path, span, steps):
    """Device time inside the ``span`` annotations of a profiler run:
    window and device-busy ms per step (union of kernels and copies), the
    device's idle share, kernel launches and host-to-device copies (count
    and bytes) per step and device ms per step by kernel name (top 12)."""
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") == span
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise SystemExit(f"profile: the trace holds no {span} span")
    w0 = min(e["ts"] for e in marks)
    w1 = max(e["ts"] + e["dur"] for e in marks)
    dev = [e for e in events if e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset") and w0 <= e["ts"] <= w1]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    if not kernels:
        raise SystemExit("profile: the trace holds no device kernel")
    busy_us = merged_busy([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    h2d = [e for e in dev if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "steps": steps,
        "window_ms_per_step": (w1 - w0) / 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / (w1 - w0),
        "kernel_launches_per_step": len(kernels) / steps,
        "h2d_copies_per_step": len(h2d) / steps,
        "h2d_bytes_per_step": sum(e.get("args", {}).get("bytes", 0)
                                  for e in h2d) / steps,
        "h2d_streams": sorted({e.get("args", {}).get("stream")
                               for e in h2d}, key=str),
        "h2d_names": sorted({e.get("name", "") for e in h2d}),
        "h2d_first": [(e.get("name", ""), e.get("args", {}).get("bytes"),
                       e.get("args", {}).get("stream")) for e in h2d[:8]],
        "kernel_streams": sorted({e.get("args", {}).get("stream")
                                  for e in kernels}, key=str),
        "device_ms_per_step_by_kernel": [
            {"name": k[:90], "launches_per_step": c / steps,
             "ms_per_step": t / 1e3 / steps} for k, (c, t) in top],
        "trace": trace_path}


def profile_steps(torch, step_fn, steps, span, trace_path):
    """Trace ``steps`` calls of ``step_fn`` with ``torch.profiler``, each
    under a ``span`` annotation; returns host ms per step beside
    :func:`trace_summary`."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with torch.profiler.record_function(span):
                step_fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    return {"host_ms_per_step": 1e3 * host_s / steps,
            **trace_summary(prof, trace_path, span, steps)}


def repo_frame(frames):
    """``file:function`` of the innermost frame of an allocation's Python
    stack inside this repo (``-`` when it has none, as in the autograd
    engine's own allocations)."""
    for fr in frames:
        f = fr.get("filename", "")
        if "paddle_tpu_torch" in f or f.endswith("chip_smoke.py"):
            return f"{os.path.basename(f)}:{fr.get('name', '?')}"
    return "-"


def memory_peak(torch, step_fn, top=8):
    """Where one call of ``step_fn`` peaks in device memory.  Records the
    caching allocator's history over the call
    (``torch.cuda.memory._record_memory_history``, Python stacks) and
    replays it from the bytes allocated before the call; returns the
    replayed and the reported peak, the repo frame of the allocation that
    reached it, and the bytes live at that moment grouped by the repo
    frame that allocated them (largest ``top``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python",
        max_entries=1 << 22)
    try:
        step_fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    reported = torch.cuda.max_memory_allocated()
    dev = torch.cuda.current_device()
    events = snap["device_traces"][dev]

    def replay(stop):
        live, cur, best, at = {}, base, base, -1
        for i, e in enumerate(events[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = (e["size"], e.get("frames", []))
                cur += e["size"]
                if cur > best:
                    best, at = cur, i
            elif e["action"] in ("free_requested", "free_completed"):
                blk = live.pop(e["addr"], None)
                if blk is not None:
                    cur -= blk[0]
        return live, best, at

    _, best, at = replay(len(events))
    live, _, _ = replay(at + 1)
    groups = collections.Counter()
    for size, frames in live.values():
        groups[repo_frame(frames)] += size
    gib = 2 ** 30
    return {"base_gib": base / gib, "peak_replayed_gib": best / gib,
            "peak_reported_gib": reported / gib, "events": len(events),
            "peak_alloc_at": repo_frame(events[at].get("frames", []))
            if at >= 0 else "-",
            "live_at_peak_gib_by_frame": [
                {"frame": k, "gib": v / gib}
                for k, v in groups.most_common(top)]}


def profile_decode(torch, eng, prompts, steps, trace_path):
    """Phase (f): fill every slot of ``eng``, then trace ``steps`` steady
    decode steps."""
    for p in prompts[:eng.slots]:
        eng.submit(p, 64)
    eng.step()                          # admission waves + first decode
    eng.step()
    if int(eng.stats()["slot_occupancy"]) != eng.slots:
        raise SystemExit("profile: not every slot is decoding")
    out = profile_steps(torch, eng.step, steps, "decode_step", trace_path)
    eng.run()
    return {"active_slots": eng.slots, **out}


def train_tokens(torch, V, B, N, seed):
    """[B, N] tokens from a numpy seed on the card; labels = tokens, as
    the reference bench does."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, V, (B, N))).cuda()
    return toks, toks


def timed_loop(torch, run, steps, counters, want, label, B, N):
    """One warm-up call ``run(1)``, then ``steps`` timed calls ``run(t)``,
    t = 2, 3, ... (each a full training step on one [B, N] batch that
    returns the loss as a float, which closes the step).  ``counters``
    maps a kernel to the (module, attribute) of its launch count; they
    are zeroed after the warm-up step, so they cover the timed steps
    only, and must equal ``want`` (launches a step) times ``steps``; the
    loss must be finite and fall.  Returns the measurements."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [run(1)]
    warm_s = time.perf_counter() - t0
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    times = []
    for t in range(2, steps + 2):
        t0 = time.perf_counter()
        losses.append(run(t))
        times.append(time.perf_counter() - t0)
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    step_s = float(np.mean(times))
    res = {"steps": steps, "warmup_s": warm_s, "step_ms": 1e3 * step_s,
           "step_ms_each": [1e3 * x for x in times],
           "tokens_per_s": B * N / step_s,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "launches": launches,
           "launches_per_step_expected": want}
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: a non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{label}: the loss did not fall: {losses}")
    for k, per in want.items():
        if launches[k] != per * steps:
            raise SystemExit(f"{label}: {k} launched {launches[k]} times "
                             f"in {steps} steps, expected {per} per step")
    return res


def flop_share(res, cfg):
    """``res`` with the model-FLOP share of its tokens/s."""
    res.update(flops_per_token=cfg.flops_per_token(),
               model_flop_share=res["tokens_per_s"] * cfg.flops_per_token()
               / BF16_FLOPS_PER_S)
    return res


def timed_training(torch, step, state, batch, cfg, steps, counters, want,
                   label, lr=1e-4):
    """:func:`timed_loop` over ``step(params, m, v, t, *batch, lr)`` (a
    single-device train step; ``state`` = (params, m, v)) on one batch
    whose first tensor is the [B, N] tokens.  Returns the measurements
    and (step, params, m, v, batch, lr) (for ``--profile-train``)."""
    params, m, v = state
    B, N = batch[0].shape
    res = timed_loop(
        torch, lambda t: float(step(params, m, v, t, *batch, lr)[3]), steps,
        counters, want, label, B, N)
    return flop_share(res, cfg), (step, params, m, v, batch, lr)


def train_path(torch, gpt_hybrid, flash_attn, norms, cfg, params, steps):
    """Phase (g): :func:`timed_training` on fp32 masters and fp32 moments
    at ``TRAIN_SHAPE``."""
    m, v = gpt_hybrid.init_train_state(params)
    L = cfg.num_layers
    counters = {"flash_attention_fwd": (flash_attn, "fwd_launches"),
                "flash_attention_bwd_dq": (flash_attn, "dq_launches"),
                "flash_attention_bwd_dkv": (flash_attn, "dkv_launches"),
                "layer_norm": (norms, "launches")}
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "layer_norm": 4 * L + 1}
    batch = train_tokens(torch, cfg.vocab_size, *TRAIN_SHAPE[:2], SEED + 3)
    return timed_training(torch, gpt_hybrid.make_train_step(cfg),
                          (params, m, v), batch, cfg, steps, counters, want,
                          "training")


def train_parity(torch, gpt, gpt_hybrid, cfg=None, seed=SEED + 4):
    """Phases (h) and (m): the fp32 train step on the card (kernels)
    against the CPU (plain versions), by default at ``gpt_345m`` widths
    with 2 layers."""
    if cfg is None:
        cfg = dataclasses.replace(gpt.gpt_345m(), num_layers=2,
                                  dtype="float32", use_pallas_norm=True)
    tree = numpy_gpt_params(cfg, seed)
    dev_p = gpt.params_from_numpy(tree, "cuda")
    cpu_p = gpt.params_from_numpy(copy.deepcopy(tree), "cpu")
    toks, labels = train_tokens(torch, cfg.vocab_size, 2, 256, SEED + 6)
    lg, gg = gpt_hybrid.loss_and_grads(dev_p, toks, labels, cfg)
    lc, gc = gpt_hybrid.loss_and_grads(cpu_p, toks.cpu(), labels.cpu(), cfg)
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    grad_rel = {}
    for path, g in gpt_hybrid._leaves(gc):
        ref = g.abs().max().item()
        err = (gpt_hybrid._at(gg, path).cpu() - g).abs().max().item()
        grad_rel["/".join(path)] = err / max(ref, 1e-30)
    step = gpt_hybrid.make_train_step(cfg)
    dev_s = (dev_p, *gpt_hybrid.init_train_state(dev_p))
    cpu_s = (cpu_p, *gpt_hybrid.init_train_state(cpu_p))
    step_rel = []
    for t in (1, 2, 3):
        a = float(step(*dev_s, t, toks, labels, 1e-4)[3])
        b = float(step(*cpu_s, t, toks.cpu(), labels.cpu(), 1e-4)[3])
        step_rel.append(abs(a - b) / abs(b))
    res = {"loss_card": float(lg), "loss_cpu": float(lc),
           "loss_rel_err": loss_rel, "grad_rel_err_max": max(
               grad_rel.values()), "grad_rel_err": grad_rel,
           "step_loss_rel_err": step_rel}
    if not (loss_rel <= TRAIN_LOSS_RTOL
            and res["grad_rel_err_max"] <= TRAIN_GRAD_TOL
            and max(step_rel) <= TRAIN_LOSS_RTOL):
        raise SystemExit(f"train step on the card disagrees with the CPU: "
                         f"{json.dumps(res)}")
    return res


def eager_step(torch, gpt, eng, pool, host):
    """The decode step as the engine ran it before its CUDA graph: the
    five host arrays ``host`` (table, write pages, write offsets, lens,
    tokens) copied to the card one by one, the eager step function on the
    pool tensors ``pool`` (int8: k, v, k_scale, v_scale), the argmax and
    the readback.  Returns (next tokens, logits)."""
    table, wp, wo, lens, toks = (torch.from_numpy(np.ascontiguousarray(a))
                                 .to(eng.device) for a in host)
    with torch.inference_mode():
        if eng._kv_quant:
            logits, *_ = gpt.decode_step_paged_quant(
                eng.params, toks, eng.cfg, pool[0], pool[2], pool[1],
                pool[3], table, wp, wo, lens)
        else:
            logits, *_ = gpt.decode_step_paged(
                eng.params, toks, eng.cfg, pool[0], pool[1], table, wp, wo,
                lens)
        nxt = torch.argmax(logits, -1)
    return nxt.cpu().numpy(), logits


def replay_vs_eager(torch, gpt, eng, prompts, tag, logit_tol=None,
                    timed=50):
    """Inside (d), (e), (j) and (k): 8 slots at mixed lengths decoding,
    one step's graph replay held against the eager step function on
    clones of the pool with the same inputs (next tokens equal; logits
    within ``logit_tol`` where given, else the largest difference is
    printed), then ``timed`` replays (staging copy, replay, readback)
    against as many eager steps (five copies, the step on the clones,
    argmax, readback), alternated, host clock, each ending in its sync.
    The replays repeat one step's writes, so the engine's state holds;
    the requests then drain."""
    reqs = [eng.submit(p, 16) for p in prompts[:eng.slots]]
    eng.step()
    if int(eng._active.sum()) != eng.slots or eng._step is None:
        raise SystemExit(f"{tag}: not every slot is decoding")
    real, rec = eng._decode, {}

    def probe(wpages, woffs):
        host = [np.array(a, np.int32) for a in (
            eng._tables_np, wpages, woffs, eng._lens, eng._last_tok)]
        pool = [t.clone() for t in eng._cache_operands()]
        rec["eager"] = eager_step(torch, gpt, eng, pool, host)
        rec["host"], rec["pool"] = host, pool
        out = real(wpages, woffs)
        rec["replay"] = (out[0], eng._step.logits.float().clone())
        return out
    eng._decode = probe
    try:
        eng.step()
    finally:
        del eng._decode
    (e_nxt, e_lg), (r_nxt, r_lg) = rec["eager"], rec["replay"]
    diff = float((e_lg.float() - r_lg).abs().max())
    res = {"slots": eng.slots,
           "lens": [int(n) for n in rec["host"][3]],
           "tokens_equal": bool(np.array_equal(e_nxt, r_nxt)),
           "max_logit_diff": diff, "logit_tol": logit_tol}
    if not res["tokens_equal"] or (logit_tol is not None
                                   and not diff <= logit_tol):
        raise SystemExit(f"{tag}: the graph replay disagrees with the "
                         f"eager step: {res}")
    st = eng._step
    graph_s, eager_s = [], []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st()
        graph_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        eager_step(torch, gpt, eng, rec["pool"], rec["host"])
        eager_s.append(time.perf_counter() - t0)
    res.update(timed=timed,
               replay_step_ms=1e3 * float(np.mean(graph_s)),
               eager_step_ms=1e3 * float(np.mean(eager_s)))
    del rec
    eng.run()
    if not all(r.done for r in reqs):
        raise SystemExit(f"{tag}: a request did not finish after the check")
    return res


def quant_path(torch, gpt, PagedServingEngine, dqmm, paged_attn, norms,
               cfg, holder, prompts, new_tokens, fp_run, args):
    """Phase (j): the quantized main path on the params in ``holder``
    (fp32 masters on the card, handed over: the engine quantizes them
    once, and no other reference keeps a float block weight on the card).
    Returns the measurements; raises if a launch count or a stat is
    off."""
    eng = PagedServingEngine((holder.pop(), cfg), device="cuda",
                             quant="int8",
                             kv_dtype="int8", slots=8, max_len=512,
                             page_size=16)
    t0 = time.perf_counter()
    waves = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    captures = eng._step.captures
    dqmm.launches = paged_attn.quant_launches = 0
    paged_attn.launches = norms.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dequant_matmul": dqmm.launches,
                "paged_attention_quant": paged_attn.quant_launches,
                "layer_norm": norms.launches,
                "paged_attention": paged_attn.launches}
    st = eng.stats()
    L = cfg.num_layers
    forwards = st["decode_steps"] + st["prefill_calls"]
    want = {"dequant_matmul": 4 * L * forwards,
            "paged_attention_quant": L * st["decode_steps"],
            "layer_norm": (2 * L + 1) * forwards, "paged_attention": 0}
    if not all(r.done and len(r.tokens) == new_tokens for r in reqs):
        raise SystemExit("(j): not every request finished with its tokens")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        raise SystemExit("(j): a generated token is outside the vocabulary")
    if launches != want:
        raise SystemExit(f"(j): launches {launches}, expected {want} for "
                         f"{st['decode_steps']} decode steps and "
                         f"{st['prefill_calls']} prefill waves")
    if st["prefix_page_hits"] <= 0 or st["kv_quant_bytes_saved"] <= 0:
        raise SystemExit(f"(j): no prefix page hit or no KV bytes saved: "
                         f"{st}")
    if st["quant_matmuls"] != 4 * L * forwards:
        raise SystemExit(f"(j): quant_matmuls {st['quant_matmuls']} for "
                         f"{forwards} forwards")
    if st["dequant_kernel_calls"] != (launches["dequant_matmul"]
                                      + launches["paged_attention_quant"]):
        raise SystemExit(f"(j): dequant_kernel_calls "
                         f"{st['dequant_kernel_calls']} against {launches}")
    if st["decode_compiles"] != 1 or (captures, eng._step.captures) != (1,
                                                                       1):
        raise SystemExit(f"(j): decode_compiles {st['decode_compiles']}, "
                         f"captures {captures} -> {eng._step.captures}: the "
                         "traffic must replay the one graph captured in "
                         "warmup")
    gen = sum(len(r.tokens) for r in reqs)
    res = {"warmup_waves": waves, "warmup_s": warm_s, "wall_s": wall,
           "tokens_per_s": gen / wall,
           "decode_steps": st["decode_steps"],
           "prefill_waves": st["prefill_calls"],
           "decode_step_ms": 1e3 * float(np.mean(eng.decode_step_s)),
           "prefill_wave_ms": 1e3 * float(np.mean(eng.prefill_s)),
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "resident_gib": resident / 2 ** 30,
           "kv_bytes_total": st["kv_bytes_total"],
           "kv_quant_bytes_saved": st["kv_quant_bytes_saved"],
           "prefix_page_hits": st["prefix_page_hits"],
           "quant_matmuls": st["quant_matmuls"],
           "dequant_kernel_calls": st["dequant_kernel_calls"],
           "decode_compiles": st["decode_compiles"],
           "launches": launches,
           "request0_tokens_equal_fp_share": float(np.mean(
               np.asarray(reqs[0].tokens)
               == np.asarray(fp_run["request0_tokens"])))}
    res["replay_vs_eager"] = replay_vs_eager(torch, gpt, eng, prompts, "(j)")
    if args.profile:
        res["profile"] = profile_decode(torch, eng, prompts, args.profile,
                                        args.trace.replace(".json",
                                                           "_quant.json"))
    del eng
    torch.cuda.empty_cache()
    return res


def quant_parity(torch, gpt, PagedServingEngine, prompts, new_tokens):
    """Phase (k): the fp32 quantized engine (int8 weights, int8 pool) on
    the card against the same engine on the CPU, ``gpt_345m`` widths with
    2 layers, 4 requests: greedy tokens exact, logits within 1e-3."""
    cfg = dataclasses.replace(gpt.gpt_345m(), num_layers=2,
                              dtype="float32", use_pallas_norm=True)
    tree = numpy_gpt_params(cfg, SEED + 7)
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = PagedServingEngine(
            (gpt.params_from_numpy(tree, dev), cfg), device=dev,
            quant="int8", kv_dtype="int8", slots=8, max_len=512,
            page_size=16, capture_logits=True)
        reqs = [eng.submit(p, new_tokens) for p in prompts[:4]]
        eng.run()
        runs[dev] = reqs
        if dev == "cuda":
            rv = replay_vs_eager(torch, gpt, eng, prompts, "(k)",
                                 logit_tol=PARITY_LOGIT_TOL, timed=10)
            compiles = eng.stats()["decode_compiles"]
        del eng
    tok_equal = all(a.tokens == b.tokens
                    for a, b in zip(runs["cuda"], runs["cpu"]))
    logit_err = max(float(np.abs(np.stack(a.logits)
                                 - np.stack(b.logits)).max())
                    for a, b in zip(runs["cuda"], runs["cpu"]))
    res = {"tokens_equal": tok_equal, "max_logit_err": logit_err,
           "replay_vs_eager": rv, "decode_compiles": compiles}
    if not tok_equal or not logit_err <= PARITY_LOGIT_TOL or compiles != 1:
        raise SystemExit(f"(k): the quantized engine on the card disagrees "
                         f"with the CPU: {res}")
    torch.cuda.empty_cache()
    return res


def main():
    ap = argparse.ArgumentParser(
        description="Drive paddle_tpu_torch on one GPU and check it.")
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="also trace STEPS steady decode steps of the main "
                         "path with torch.profiler (phase f), of the "
                         "quantized engine (j) and STEPS encoder forwards "
                         "in each dtype (n)")
    ap.add_argument("--trace", default="paddle_tpu_torch/_build/"
                    "decode_trace.json",
                    help="where phase (f) writes its Chrome trace")
    ap.add_argument("--profile-train", type=int, default=0, metavar="STEPS",
                    help="also trace STEPS training steps of the training "
                         "path (phase i), the flagship path (l), ERNIE "
                         "pretraining (p), eager training (r), (t) and "
                         "the hapi step and its hand-written loop (u) with "
                         "torch.profiler")
    ap.add_argument("--train-trace", default="paddle_tpu_torch/_build/"
                    "train_trace.json",
                    help="where phase (i) writes its Chrome trace")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from paddle_tpu_torch import card_info
    from paddle_tpu_torch.inference.serving import PagedServingEngine
    from paddle_tpu_torch.models import gpt, gpt_hybrid
    from paddle_tpu_torch.ops.cuda import (build, flash_attn, fused_ffn,
                                          norms, paged_attn)
    from paddle_tpu_torch.ops.cuda import dequant_matmul as dqmm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    t_start = time.perf_counter()

    # (a) ---------------------------------------------------------------
    name, limit = card_info()
    card = f"{name}, {limit}"
    log(f"(a) card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # (b) ---------------------------------------------------------------
    # the data ring's host library (g++) builds while nvcc runs
    from paddle_tpu_torch import runtime
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        t0 = time.perf_counter()
        ring_build = ex.submit(runtime._b.build)
        build_s = build.build()
        ring_lib = ring_build.result()
        ring_s = time.perf_counter() - t0
    if not runtime.is_available():
        raise SystemExit("(b): the native ring library does not load")
    log(f"(b) built {sorted(build.SOURCES)} in {build_s:.2f} s; the data "
        f"ring {os.path.basename(str(ring_lib))} (g++) by {ring_s:.2f} s")
    for lib, text in sorted(build.build_log.items()):
        regs = [ln.split("Used ")[1] for ln in text.splitlines()
                if "Used " in ln]
        spills, name = [], None
        for ln in text.splitlines():        # ptxas names, then reports
            if "Function properties for " in ln:
                name = ln.split("Function properties for ")[1].strip()
            elif " bytes spill stores" in ln:
                spills.append((name, ln.strip()))
        log(f"    {lib}: {len(regs)} kernels; "
            f"{'; '.join(sorted({s for _, s in spills}))}; "
            f"registers {sorted({r.split(' ')[0] for r in regs}, key=int)}")
        for name, ln in spills:
            if int(ln.split(" bytes spill stores")[0].split()[-1]):
                log(f"      spills in {name}: {ln}")
        for kname, regs_ln, spill_ln in ptxas_kernels(text, WG_KERNELS):
            log(f"      {kname}: {regs_ln}; {spill_ln}")
    spills = [(k, sp) for text in build.build_log.values()
              for k, _, sp in ptxas_kernels(text, NO_SPILL) if spilled(sp)]
    if spills:
        raise SystemExit(f"(b): a redesigned serving kernel spills: {spills}")
    for lib in build.SOURCES:
        build.load(lib)

    # (c) ---------------------------------------------------------------
    log("(c) kernels against their plain versions on the card:")
    cases = check_kernels(torch, paged_attn, norms)
    cases.update(check_flash(torch, flash_attn))
    cases.update(check_quant_kernels(torch, gpt, dqmm, paged_attn))
    cases.update(check_fused_bwd(torch, flash_attn))
    cases.update(check_fused_ffn(torch, fused_ffn))
    cases.update(check_rms_norm(torch, norms))
    for k, extra in check_queue3(torch, gpt, flash_attn, paged_attn, norms,
                                 dqmm).items():
        cases[k].extend(extra)

    # (d)-(i), in the order and process state of the slices before -------
    cfg = dataclasses.replace(gpt.gpt_345m(), use_pallas_norm=True)
    prompts = make_prompts(cfg.vocab_size)
    new_tokens = 32
    t0 = time.perf_counter()
    params = gpt.params_from_numpy(numpy_gpt_params(cfg, SEED), "cuda")
    log(f"    gpt_345m ({cfg.num_params() / 1e6:.1f}M params, "
        f"{cfg.num_layers} layers, H={cfg.hidden_size}, dtype "
        f"{cfg.dtype}) weights from numpy seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    fp_run = serve_fp(torch, PagedServingEngine, gpt, paged_attn, norms,
                      cfg, params, prompts, new_tokens, card, args, launches)
    train = train_phases(torch, gpt_hybrid, flash_attn, norms, cfg, params,
                         card, args, launches)
    train_parity_phase(torch, gpt, gpt_hybrid)

    # (j): the engine quantizes the fp32 masters on the card; handing the
    # last reference over leaves no float block weight there -------------
    t0 = time.perf_counter()
    holder, params = [params], None
    qrun = quant_path(torch, gpt, PagedServingEngine, dqmm, paged_attn,
                      norms, cfg, holder, prompts, new_tokens, fp_run, args)
    launches.update({k: qrun["launches"][k] for k in
                     ("dequant_matmul", "paged_attention_quant")})
    launches["layer_norm_quant_path"] = qrun["launches"]["layer_norm"]
    log(f"(j) quantized serving (quant='int8', kv_dtype='int8') of "
        f"gpt_345m, the same 12 requests x {new_tokens} tokens, on "
        f"{card}:")
    log(f"    tokens/s {qrun['tokens_per_s']} (fp path (d): "
        f"{fp_run['tokens_per_s']}); decode steps "
        f"{qrun['decode_steps']}, mean decode step "
        f"{qrun['decode_step_ms']} ms ((d): {fp_run['decode_step_ms']});"
        f" prefill waves {qrun['prefill_waves']}, mean prefill wave "
        f"{qrun['prefill_wave_ms']} ms ((d): {fp_run['prefill_wave_ms']}"
        f"); max_memory_allocated {qrun['max_memory_allocated_gib']} GiB"
        f" ((d): {fp_run['max_memory_allocated_gib']}); allocated before "
        f"the traffic (weights, pool) {qrun['resident_gib']} GiB ((d): "
        f"{fp_run['resident_gib']}); kv_bytes_total "
        f"{qrun['kv_bytes_total']} ((d): {fp_run['kv_bytes_total']}); "
        f"kv_quant_bytes_saved {qrun['kv_quant_bytes_saved']}; prefix "
        f"page hits {qrun['prefix_page_hits']}; quant_matmuls "
        f"{qrun['quant_matmuls']}; dequant_kernel_calls "
        f"{qrun['dequant_kernel_calls']}; decode_compiles "
        f"{qrun['decode_compiles']}; launches {qrun['launches']}; "
        f"warmup {qrun['warmup_waves']} waves in "
        f"{qrun['warmup_s']:.1f} s  [{card}]")
    rv = qrun["replay_vs_eager"]
    log(f"    replay against the eager step (8 slots, lens {rv['lens']}):"
        f" next tokens equal {rv['tokens_equal']}; max |logit diff| "
        f"{rv['max_logit_diff']:.3e} (bf16, reported); {rv['timed']} "
        f"replays {rv['replay_step_ms']} ms a step against "
        f"{rv['eager_step_ms']} ms a step eager, alternated  [{card}]")
    jk_s = time.perf_counter() - t0
    log(f"    request 0: {qrun['request0_tokens_equal_fp_share']} of its "
        "tokens equal the bf16 fp path's (int8 rounding on random "
        f"weights, not asserted); phase {jk_s:.1f} s")
    if "profile" in qrun:
        log(f"    quantized decode-step profile on {card}: "
            f"{json.dumps(qrun['profile'])}")
    torch.cuda.empty_cache()

    # (k) ---------------------------------------------------------------
    t0 = time.perf_counter()
    par = quant_parity(torch, gpt, PagedServingEngine, prompts, new_tokens)
    log(f"(k) fp32 quantized engine, card against CPU (gpt_345m widths, "
        f"2 layers, 4 requests x {new_tokens} tokens): greedy tokens "
        f"equal {par['tokens_equal']}; max |logit diff| "
        f"{par['max_logit_err']:.3e} (tol {PARITY_LOGIT_TOL:.0e}); "
        f"decode_compiles {par['decode_compiles']}; replay against the "
        f"eager step: next tokens equal "
        f"{par['replay_vs_eager']['tokens_equal']}, max |logit diff| "
        f"{par['replay_vs_eager']['max_logit_diff']:.3e} (tol "
        f"{PARITY_LOGIT_TOL:.0e}); phase {time.perf_counter() - t0:.1f} s")
    jk_s += time.perf_counter() - t0
    log(f"    (j) and (k) together {jk_s:.1f} s")

    # (l), (m): the flagship recipe ------------------------------------
    flagship_phases(torch, gpt, gpt_hybrid, flash_attn, fused_ffn, norms,
                    card, args, launches)

    # (n), (o): eager nn-API inference ----------------------------------
    _, enc = encoder_phases(torch, flash_attn, norms, card, args)
    launches["rms_norm"] = enc["rms_norm"]
    launches["layer_norm_encoder"] = enc["layer_norm"]
    launches["flash_attention_fwd_encoder"] = enc["flash_attention_fwd"]

    # (p), (q): ERNIE-3.0-Base pretraining ------------------------------
    p_res = ernie_phases(torch, flash_attn, norms, card, args, launches)

    # (r), (s), (t): eager dygraph training -------------------------------
    eager_phases(torch, flash_attn, norms, card, args, launches, p_res)

    # (u), (v): the high-level API (hapi.Model, io.DataLoader) ------------
    hapi_phases(torch, flash_attn, norms, card, args, launches)

    # report --------------------------------------------------------------
    report(torch, cases, launches, train, t_start)
    return 0


def serve_fp(torch, PagedServingEngine, gpt, paged_attn, norms, cfg, params,
             prompts, new_tokens, card, args, launches):
    """Phases (d), (e) and (f): the fp main path, its fp32 parity and the
    optional decode profile.  Returns (d)'s measurements."""
    # (d) ---------------------------------------------------------------
    log(f"(d) serving gpt_345m, dtype {cfg.dtype}, fp weights and pool")
    eng = PagedServingEngine((params, cfg), device="cuda", slots=8,
                             max_len=512, page_size=16)
    t0 = time.perf_counter()
    waves = eng.warmup()
    torch.cuda.synchronize()
    log(f"    warmup: {waves} waves in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    captures = eng._step.captures
    paged_attn.launches = 0
    norms.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update({"paged_attention": paged_attn.launches,
                     "layer_norm": norms.launches})
    st = eng.stats()
    L = cfg.num_layers
    if st["decode_compiles"] != 1 or (captures, eng._step.captures) != (1,
                                                                       1):
        raise SystemExit(f"(d): decode_compiles {st['decode_compiles']}, "
                         f"captures {captures} -> {eng._step.captures}: the "
                         "traffic must replay the one graph captured in "
                         "warmup")
    if not all(r.done and len(r.tokens) == new_tokens for r in reqs):
        raise SystemExit("not every request finished with its tokens")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        raise SystemExit("a generated token is outside the vocabulary")
    if st["prefix_page_hits"] <= 0:
        raise SystemExit(f"no prefix page hit: {st}")
    if launches["paged_attention"] != st["decode_steps"] * L:
        raise SystemExit(f"paged attention launched "
                         f"{launches['paged_attention']} times for "
                         f"{st['decode_steps']} decode steps x {L} layers")
    forwards = st["decode_steps"] + st["prefill_calls"]
    if launches["layer_norm"] != (2 * L + 1) * forwards:
        raise SystemExit(f"layer norm launched {launches['layer_norm']} "
                         f"times for {forwards} forwards")
    gen = sum(len(r.tokens) for r in reqs)
    dec_ms = 1e3 * float(np.mean(eng.decode_step_s))
    pre_ms = 1e3 * float(np.mean(eng.prefill_s))
    mem = torch.cuda.max_memory_allocated()
    log(f"    served {len(reqs)} requests (prompts {min(map(len, prompts))}"
        f"-{max(map(len, prompts))} tokens) x {new_tokens} new tokens "
        f"in {wall:.3f} s on {card}:")
    log(f"    tokens/s {gen / wall}; decode steps {st['decode_steps']}, "
        f"mean decode step {dec_ms} ms; prefill waves {st['prefill_calls']},"
        f" mean prefill wave {pre_ms} ms; max_memory_allocated "
        f"{mem / 2**30} GiB (allocated before the traffic "
        f"{resident / 2**30} GiB); kv_bytes_total {st['kv_bytes_total']}; prefix "
        f"page hits {st['prefix_page_hits']}; decode_compiles "
        f"{st['decode_compiles']}; launches "
        f"{ {k: launches[k] for k in ('paged_attention', 'layer_norm')} }  "
        f"[{card}]")
    rv = replay_vs_eager(torch, gpt, eng, prompts, "(d)")
    log(f"    replay against the eager step (8 slots, lens {rv['lens']}):"
        f" next tokens equal {rv['tokens_equal']}; max |logit diff| "
        f"{rv['max_logit_diff']:.3e} (bf16, reported); {rv['timed']} "
        f"replays {rv['replay_step_ms']} ms a step against "
        f"{rv['eager_step_ms']} ms a step eager, alternated  [{card}]")
    run = {"tokens_per_s": gen / wall, "decode_step_ms": dec_ms,
           "prefill_wave_ms": pre_ms, "replay_vs_eager": rv,
           "max_memory_allocated_gib": mem / 2 ** 30,
           "resident_gib": resident / 2 ** 30,
           "kv_bytes_total": st["kv_bytes_total"],
           "request0_tokens": list(reqs[0].tokens)}

    # (e) ---------------------------------------------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    eng32 = PagedServingEngine((params, cfg32), device="cuda", slots=8,
                               max_len=512, page_size=16,
                               capture_logits=True)
    r32 = [eng32.submit(p, new_tokens) for p in prompts[:4]]
    eng32.run()
    rv32 = replay_vs_eager(torch, gpt, eng32, prompts, "(e)",
                           logit_tol=PARITY_LOGIT_TOL, timed=10)
    p0 = torch.from_numpy(prompts[0]).cuda()[None]
    want = gpt.generate(params, cfg32, p0, new_tokens)[0, p0.shape[1]:]
    agree = float(np.mean(np.asarray(r32[0].tokens) == want.cpu().numpy()))
    seq = torch.cat([p0[0], torch.tensor(r32[0].tokens[:-1],
                                         device="cuda",
                                         dtype=p0.dtype)])[None]
    with torch.inference_mode():
        tf = gpt.forward(params, seq, cfg32)[0, p0.shape[1] - 1:]
    logit_err = float(np.abs(np.stack(r32[0].logits)
                             - tf.cpu().numpy()).max())
    bf16_agree = float(np.mean(np.asarray(reqs[0].tokens)
                               == np.asarray(r32[0].tokens)))
    log(f"(e) fp32 engine vs generate: greedy token agreement {agree}; "
        f"max |logit - teacher-forced forward| {logit_err:.3e} (tol "
        f"{PARITY_LOGIT_TOL:.0e}); bf16 main path agrees with fp32 on "
        f"{bf16_agree:.3f} of request 0's tokens (bf16 rounding, "
        f"not asserted); decode_compiles "
        f"{eng32.stats()['decode_compiles']}; replay against the eager "
        f"step: next tokens equal {rv32['tokens_equal']}, max |logit diff| "
        f"{rv32['max_logit_diff']:.3e} (tol {PARITY_LOGIT_TOL:.0e})")
    if (agree != 1.0 or not logit_err <= PARITY_LOGIT_TOL
            or eng32.stats()["decode_compiles"] != 1):
        raise SystemExit("fp32 engine disagrees with generate/forward")

    # (f) ---------------------------------------------------------------
    if args.profile:
        prof = profile_decode(torch, eng, prompts, args.profile, args.trace)
        log(f"(f) decode-step profile on {card}: {json.dumps(prof)}")
    del eng, eng32
    torch.cuda.empty_cache()
    return run


def train_phases(torch, gpt_hybrid, flash_attn, norms, cfg, params, card,
                 args, launches):
    """Phases (g) and (i): the training main path and its optional
    profile.  Returns (g)'s measurements."""
    # (g) ---------------------------------------------------------------
    t0 = time.perf_counter()
    train, state = train_path(torch, gpt_hybrid, flash_attn, norms, cfg,
                              copy.deepcopy(params), 10)
    launches.update({k: n for k, n in train["launches"].items()
                     if k.startswith("flash")})
    log(f"(g) training gpt_345m ({cfg.num_layers} layers, B={TRAIN_SHAPE[0]},"
        f" N={TRAIN_SHAPE[1]}, {cfg.dtype} over fp32 masters, fp32 moments, "
        f"use_flash, use_pallas_norm, remat {cfg.remat_policy}) on {card}: "
        f"tokens/s {train['tokens_per_s']}; mean step {train['step_ms']} ms "
        f"over {train['steps']} steps (warm-up step {train['warmup_s']:.2f} "
        f"s); model-FLOP share {train['model_flop_share']}; "
        f"max_memory_allocated {train['max_memory_allocated_gib']} GiB; "
        f"loss {train['first_loss']} -> {train['last_loss']}; launches "
        f"{train['launches']} (per step {train['launches_per_step_expected']}"
        f"); phase {time.perf_counter() - t0:.1f} s  [{card}]")
    log(f"    losses {train['losses']}; step ms {train['step_ms_each']}")

    # (i) ---------------------------------------------------------------
    if args.profile_train:
        step, tp, tm, tv, batch, lr = state
        counter = iter(range(12, 12 + args.profile_train))
        prof = profile_steps(
            torch, lambda: step(tp, tm, tv, next(counter), *batch, lr),
            args.profile_train, "train_step", args.train_trace)
        log(f"(i) training-step profile on {card}: {json.dumps(prof)}")
    del state
    torch.cuda.empty_cache()
    return train


def train_parity_phase(torch, gpt, gpt_hybrid):
    """Phase (h), logged."""
    t0 = time.perf_counter()
    par = train_parity(torch, gpt, gpt_hybrid)
    log(f"(h) fp32 train step, card against CPU (gpt_345m widths, 2 layers,"
        f" B=2, N=256): loss rel err {par['loss_rel_err']:.2e} (tol "
        f"{TRAIN_LOSS_RTOL:.0e}); max grad err / max|grad| "
        f"{par['grad_rel_err_max']:.2e} (tol {TRAIN_GRAD_TOL:.0e}); 3-step "
        f"loss rel errs {[f'{x:.2e}' for x in par['step_loss_rel_err']]}; "
        f"phase {time.perf_counter() - t0:.1f} s")


def flagship_cfg(gpt):
    """``bench.py``'s GPT-3 1.3B-class config (``BASELINE.json``
    configs[3]) with its two fused routes on, plus the kernel LayerNorm."""
    return gpt.GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                         num_heads=16, max_seq_len=2048,
                         param_dtype="bfloat16", use_flash=True,
                         use_fused_ffn=True, use_pallas_norm=True)


def flagship_path(torch, gpt, gpt_hybrid, flash_attn, fused_ffn, norms,
                  args):
    """Phase (l): :func:`timed_training` of the flagship recipe, bf16
    params and bf16 moments, at ``FLAGSHIP_SHAPE`` (the caller sets
    ``bwd_fused``)."""
    cfg = flagship_cfg(gpt)
    params = gpt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 9), "cuda")
    m, v = gpt_hybrid.init_train_state(params, moment_dtype=torch.bfloat16)
    L = cfg.num_layers
    counters = {"flash_attention_fwd": (flash_attn, "fwd_launches"),
                "flash_attention_bwd_fused": (flash_attn, "fused_launches"),
                "flash_attention_bwd_dq": (flash_attn, "dq_launches"),
                "flash_attention_bwd_dkv": (flash_attn, "dkv_launches"),
                "fused_ffn": (fused_ffn, "launches"),
                "layer_norm": (norms, "launches")}
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_fused": L,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "fused_ffn": L, "layer_norm": 4 * L + 1}
    res, state = timed_training(
        torch, gpt_hybrid.make_train_step(cfg), (params, m, v),
        train_tokens(torch, cfg.vocab_size, *FLAGSHIP_SHAPE, SEED + 12),
        cfg, FLAGSHIP_STEPS, counters, want, "(l)")
    res["num_params"] = cfg.num_params()
    if args.profile_train:
        step, tp, tm, tv, batch, lr = state
        counter = iter(range(100, 100 + args.profile_train))
        res["profile"] = profile_steps(
            torch, lambda: step(tp, tm, tv, next(counter), *batch, lr),
            args.profile_train, "train_step_flagship",
            args.train_trace.replace(".json", "_flagship.json"))
        res["memory_peak"] = memory_peak(
            torch, lambda: step(tp, tm, tv, next(counter, 200), *batch, lr))
    return res


def flagship_phases(torch, gpt, gpt_hybrid, flash_attn, fused_ffn, norms,
                    card, args, launches):
    """Phases (l) and (m), with ``bwd_fused=True`` (reset after), as
    ``bench.py`` installs it.  Returns (l)'s measurements."""
    try:
        flash_attn.set_default_blocks(bwd_fused=True)
        t0 = time.perf_counter()
        res = flagship_path(torch, gpt, gpt_hybrid, flash_attn, fused_ffn,
                            norms, args)
        torch.cuda.empty_cache()
        launches.update({k: res["launches"][k] for k in
                         ("flash_attention_bwd_fused", "fused_ffn")})
        launches["layer_norm_flagship"] = res["launches"]["layer_norm"]
        launches["flash_attention_fwd_flagship"] = res["launches"][
            "flash_attention_fwd"]
        B, N = FLAGSHIP_SHAPE
        log(f"(l) training the flagship GPT-3 1.3B recipe "
            f"({res['num_params'] / 1e9:.3f}B params, 24 layers, H=2048, "
            f"nh=16, hd=128, B={B}, N={N}, bf16 params and AdamW moments, "
            f"bf16 compute, use_flash + bwd_fused, use_fused_ffn, "
            f"use_pallas_norm, remat full) on {card}: tokens/s "
            f"{res['tokens_per_s']}; mean step {res['step_ms']} ms over "
            f"{res['steps']} steps (warm-up step {res['warmup_s']:.2f} s); "
            f"model-FLOP share {res['model_flop_share']} "
            f"({res['flops_per_token']:.4e} flops/token); "
            f"max_memory_allocated {res['max_memory_allocated_gib']} GiB; "
            f"loss {res['first_loss']} -> {res['last_loss']}; launches "
            f"{res['launches']} (per step "
            f"{res['launches_per_step_expected']}); phase "
            f"{time.perf_counter() - t0:.1f} s  [{card}]")
        log(f"    losses {res['losses']}; step ms {res['step_ms_each']}")
        if "profile" in res:
            log(f"    flagship training-step profile on {card}: "
                f"{json.dumps(res['profile'])}")
            log(f"    flagship training-step memory peak on {card}: "
                f"{json.dumps(res['memory_peak'])}")
        # (m) -----------------------------------------------------------
        t0 = time.perf_counter()
        cfg = dataclasses.replace(flagship_cfg(gpt), num_layers=2,
                                  dtype="float32", param_dtype="float32")
        par = train_parity(torch, gpt, gpt_hybrid, cfg, SEED + 13)
        log(f"(m) fp32 flagship train step with both fused routes, card "
            f"against CPU (H=2048, nh=16, hd=128, F=8192, 2 layers, B=2, "
            f"N=256): loss rel err {par['loss_rel_err']:.2e} (tol "
            f"{TRAIN_LOSS_RTOL:.0e}); max grad err / max|grad| "
            f"{par['grad_rel_err_max']:.2e} (tol {TRAIN_GRAD_TOL:.0e}); "
            f"3-step loss rel errs "
            f"{[f'{x:.2e}' for x in par['step_loss_rel_err']]}; phase "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        flash_attn.set_default_blocks(bwd_fused=False)
    torch.cuda.empty_cache()
    return res


def make_encoder(pt, V, H, L, nh, F, N, dropout=0.0, attn_dropout=None):
    """A user's script on the port's nn API: token and learned position
    embeddings, a pre-LN ``TransformerEncoder`` (gelu, ``dropout``, 0 by
    default; every layer's attention dropout ``attn_dropout`` when given)
    with an ``RMSNorm`` final norm, and a ``Linear`` head.  Returns the
    model in ``eval()``; its forward gives (final norm output, logits)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.tensor import arange

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(V, H)
            self.pos = nn.Embedding(N, H)
            self.encoder = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(H, nh, F, dropout=dropout,
                                           activation="gelu",
                                           attn_dropout=attn_dropout,
                                           normalize_before=True),
                L, norm=nn.RMSNorm(H))
            if attn_dropout is not None:
                # the encoder's clones of the first layer take
                # ``dropout`` for attention too, as the reference's
                # ``_clone_layer`` builds them
                for layer in self.encoder.layers:
                    layer.self_attn.dropout = attn_dropout
            self.head = nn.Linear(H, V)

        def forward(self, ids):
            h = self.word(ids) + self.pos(arange(ids.shape[1]))
            h = self.encoder(h)
            return h, self.head(h)

    return Encoder().eval()


def numpy_state(model, seed):
    """Random weights for ``model`` from a numpy seed: matrices and biases
    N(0, 0.02), norm weights 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, p in model.state_dict().items():
        w = rng.standard_normal(p.shape, dtype=np.float32)
        out[k] = (1 + 0.1 * w) if "norm" in k else 0.02 * w
    return out


def encoder_counts(flash_attn, norms):
    return {"layer_norm": norms.launches,
            "flash_attention_fwd": flash_attn.fwd_launches,
            "rms_norm": norms.rms_launches}


def encoder_run(torch, pt, model, flash_attn, norms, batches, L):
    """One warm-up batch, then the timed batches under ``no_grad`` with
    the launch counts zeroed just before; checks the counts and the
    outputs.  Returns the measurements and batch 0's final norm output."""
    B, N = batches[0].shape
    H, V = model.head.weight.shape
    finite, first = [], None
    with pt.no_grad():
        model(batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        norms.launches = norms.rms_launches = flash_attn.fwd_launches = 0
        t0 = time.perf_counter()
        for ids in batches[1:]:
            h, logits = model(ids)
            if h.shape != [B, N, H] or logits.shape != [B, N, V]:
                raise SystemExit(f"(n) output shapes {h.shape}, "
                                 f"{logits.shape}")
            # a device flag: the check reads it after the timed batches
            finite.append(torch.isfinite(h.value).all()
                          & torch.isfinite(logits.value).all())
            first = h.value if first is None else first
            del h, logits
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = encoder_counts(flash_attn, norms)
    n = len(finite)
    want = {"layer_norm": 2 * L * n, "flash_attention_fwd": L * n,
            "rms_norm": n}
    if got != want:
        raise SystemExit(f"(n) launches {got}, want {want}")
    if not all(bool(f) for f in finite):
        raise SystemExit("(n) non-finite output")
    return {"batches": n, "batch_ms": 1e3 * wall / n,
            "tokens_per_s": n * B * N / wall,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated()
            / 2 ** 30, "launches": got}, first


def encoder_phases(torch, flash_attn, norms, card, args):
    """Phases (n) and (o); with ``--profile STEPS``, (n) also traces STEPS
    forwards in each dtype.  Returns (n)'s measurements by dtype and its
    launch counts."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    e = ENCODER
    t0 = time.perf_counter()
    pt.set_device("gpu")
    model = make_encoder(pt, **e)
    state = numpy_state(model, SEED + 15)
    model.set_state_dict(state)
    rng = np.random.default_rng(SEED + 16)
    batches = [pt.to_tensor(rng.integers(0, e["V"], (ENCODER_BATCH, e["N"])))
               for _ in range(ENCODER_BATCHES + 1)]
    setup_s = time.perf_counter() - t0
    runs, finals = {}, {}
    for dt in ("float32", "bfloat16"):
        model.to(dtype=dt)
        runs[dt], finals[dt] = encoder_run(torch, pt, model, flash_attn,
                                           norms, batches, e["L"])
        if args.profile:
            # each span ends in a synchronize, so it holds its forward's
            # device work even where the device runs behind the host
            def forward():
                model(batches[1])
                torch.cuda.synchronize()
            runs[dt]["profile"] = profile_steps(
                torch, pt.no_grad()(forward), args.profile,
                "encoder_forward",
                args.trace.replace(".json", f"_encoder_{dt}.json"))
    drift = float((finals["bfloat16"].float() - finals["float32"]).abs().max()
                  / finals["float32"].abs().max())
    # one forward that records: the reference's tape route (plain norms)
    before = encoder_counts(flash_attn, norms)
    h, logits = model(batches[0])
    torch.cuda.synchronize()
    rec = {k: v - before[k] for k, v in encoder_counts(flash_attn,
                                                      norms).items()}
    if h.stop_gradient or rec != {"layer_norm": 0,
                                  "flash_attention_fwd": e["L"],
                                  "rms_norm": 0}:
        raise SystemExit(f"(n) recording forward launched {rec}")
    del h, logits, model
    torch.cuda.empty_cache()
    launches = {k: runs["float32"]["launches"][k]
                + runs["bfloat16"]["launches"][k] for k in rec}
    log(f"(n) eager nn-API inference, pre-LN TransformerEncoder at "
        f"ERNIE-3.0-Base widths (V={e['V']}, H={e['H']}, L={e['L']}, "
        f"nh={e['nh']}, F={e['F']}) with an RMSNorm final norm, "
        f"[{ENCODER_BATCH}, {e['N']}] token ids, {ENCODER_BATCHES} timed "
        f"batches a dtype, on {card}:")
    for dt, r in runs.items():
        log(f"    {dt}: tokens/s {r['tokens_per_s']}; ms a batch "
            f"{r['batch_ms']}; max_memory_allocated "
            f"{r['max_memory_allocated_gib']} GiB; launches {r['launches']}"
            f"  [{card}]")
        if "profile" in r:
            log(f"    {dt} forward profile on {card}: "
                f"{json.dumps(r['profile'])}")
    log(f"    recording forward (grad mode on) launched {rec}; bf16 final "
        f"norm output differs from fp32 by {drift:.3e} of max|fp32| "
        f"(bf16 weights and compute, not asserted); set-up (build, numpy "
        f"weights, set_state_dict) {setup_s:.1f} s; phase "
        f"{time.perf_counter() - t0:.1f} s")

    # (o) ---------------------------------------------------------------
    t0 = time.perf_counter()
    small = dict(e, L=2)
    ids = np.random.default_rng(SEED + 17).integers(0, e["V"], (2, 128))
    res = {}
    prev = core._state.expected_place
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            m = make_encoder(pt, **small)
            if place == "gpu":
                weights = numpy_state(m, SEED + 18)
            m.set_state_dict(weights)
            with pt.no_grad():
                h, logits = m(pt.to_tensor(ids))
            res[place] = (h.numpy(), logits.numpy())
            del m
    finally:
        core._state.expected_place = prev
    (hg, lg), (hc, lc) = res["gpu"], res["cpu"]
    h_err = float(np.abs(hg - hc).max() / np.abs(hc).max())
    l_err = float(np.abs(lg - lc).max())
    log(f"(o) fp32 encoder, card against CPU (widths of (n), 2 layers, B=2, "
        f"N=128): final norm max err / max|ref| {h_err:.3e} (tol "
        f"{RMS_PARITY_TOL:.0e}); max |logit diff| {l_err:.3e} (tol "
        f"{PARITY_LOGIT_TOL:.0e}); phase {time.perf_counter() - t0:.1f} s")
    if not (h_err <= RMS_PARITY_TOL and l_err <= PARITY_LOGIT_TOL):
        raise SystemExit("(o) the card's encoder disagrees with the CPU's")
    torch.cuda.empty_cache()
    return runs, launches


def ernie_batch(torch, V, B, N, seed=0):
    """Tokens, 15% masked-LM labels (-100 elsewhere) and NSP labels, int32
    on the card, drawn as ``bench.py``'s ``_time_ernie_batch`` draws them
    (``np.random.RandomState``)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (B, N))
    mask = rng.rand(B, N) < 0.15
    mlm = np.where(mask, toks, -100)
    nsp = rng.randint(0, 2, (B,))
    return tuple(torch.from_numpy(a.astype(np.int32)).cuda()
                 for a in (toks, mlm, nsp))


@contextlib.contextmanager
def operand_copies(flash_attn):
    """Counts the flash operands ``_kernel_operand`` copies (q, k, v or dO
    that reach a kernel as another tensor) while the block runs."""
    real, copies = flash_attn._kernel_operand, []

    def counted(t):
        out = real(t)
        if out is not t:
            copies.append(tuple(t.shape))
        return out
    flash_attn._kernel_operand = counted
    try:
        yield copies
    finally:
        flash_attn._kernel_operand = real


def ernie_path(torch, bert, flash_attn, norms, args):
    """Phase (p): ERNIE-3.0-Base pretraining at full width and depth,
    weights drawn on the card from a seed, :func:`timed_training` on
    ``bench.py``'s first batch, then the same steps on the dense route
    (``use_flash=False``), reported, not asserted."""
    cfg = bert.ernie_3_base()
    L = cfg.num_layers
    state = bert.init_pretrain_state(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 19), "cuda")
    batch = ernie_batch(torch, cfg.vocab_size, ERNIE_BATCH, cfg.max_seq_len)
    counters = {"flash_attention_fwd": (flash_attn, "fwd_launches"),
                "flash_attention_bwd_dq": (flash_attn, "dq_launches"),
                "flash_attention_bwd_dkv": (flash_attn, "dkv_launches"),
                "flash_attention_bwd_fused": (flash_attn, "fused_launches"),
                "flash_attention_nokey": (flash_attn, "nokey_launches"),
                "layer_norm": (norms, "launches"),
                "rms_norm": (norms, "rms_launches")}
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_fused": 0,
            "flash_attention_nokey": 0, "layer_norm": 0, "rms_norm": 0}
    with operand_copies(flash_attn) as copies:
        res, run = timed_training(
            torch, bert.make_train_step(cfg), state, batch, cfg,
            ERNIE_STEPS, counters, want, "(p)")
    if copies:
        raise SystemExit(f"(p): flash operands copied: {copies}")
    res.update(num_params=cfg.num_params(), operand_copies=len(copies))
    step, *state, batch, lr = run
    if args.profile_train:
        counter = iter(range(100, 100 + args.profile_train))
        # each traced step ends in float(loss), as the timed steps do, so
        # the span holds its device work
        res["profile"] = profile_steps(
            torch, lambda: float(step(*state, next(counter), *batch, lr)[3]),
            args.profile_train, "train_step_ernie",
            args.train_trace.replace(".json", "_ernie.json"))
        res["memory_peak"] = memory_peak(
            torch, lambda: step(*state, next(counter, 200), *batch, lr))
    # the dense route on the same state (step counts past the profile's):
    # one warm-up step, then the timed steps
    dense = bert.make_train_step(dataclasses.replace(cfg, use_flash=False))
    float(dense(*state, 300, *batch, lr)[3])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = flash_attn.fwd_launches
    times, losses = [], []
    for t in range(301, 301 + ERNIE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(dense(*state, t, *batch, lr)[3]))
        times.append(time.perf_counter() - t0)
    step_s = float(np.mean(times))
    res["dense"] = {
        "step_ms": 1e3 * step_s, "step_ms_each": [1e3 * x for x in times],
        "tokens_per_s": ERNIE_BATCH * cfg.max_seq_len / step_s,
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30,
        "losses": losses,
        "flash_launches": flash_attn.fwd_launches - before}
    return res


def ernie_parity(torch, bert, common, flash_attn):
    """Phase (q): the fp32 pretrain loss with its gradients and 3 steps of
    ``make_train_step``, card (kernels) against CPU (plain versions), at
    ERNIE widths with 2 layers, B=2, N=256, NSP labels; then one loss
    with a pad mask (the dense route: no flash launch)."""
    cfg = dataclasses.replace(bert.ernie_3_base(), num_layers=2,
                              dtype="float32")
    # numpy-drawn weights in init_params' layout: gains 1 + N(0, 0.1),
    # every other leaf N(0, 0.02), biases too, so no leaf starts at zero
    # (an update's rounding is then measured against a leaf's own scale)
    rng = np.random.default_rng(SEED + 20)
    paths, shapes = zip(*((p, x.shape) for p, x in common._leaves(
        bert.init_params(cfg, torch.Generator(), "cpu"))))
    tree = common._build(paths, [
        (1 + 0.1 * rng.standard_normal(sh) if p[-1].endswith("_g")
         else 0.02 * rng.standard_normal(sh)).astype(np.float32)
        for p, sh in zip(paths, shapes)])
    cpu_p = bert.params_from_numpy(copy.deepcopy(tree), "cpu")
    dev_p = bert.params_from_numpy(tree, "cuda")
    toks, mlm, nsp = ernie_batch(torch, cfg.vocab_size, 2, ERNIE_PARITY_N,
                                 SEED + 21)
    host = tuple(x.cpu() for x in (toks, mlm, nsp))

    def loss_fn(toks, mlm, nsp, pad=None):
        return lambda p: bert.pretrain_loss(p, toks, mlm, cfg, None, pad,
                                            nsp)
    before = flash_attn.fwd_launches, flash_attn.dq_launches
    lg, gg = common.value_and_grad(loss_fn(toks, mlm, nsp), dev_p)
    launched = (flash_attn.fwd_launches - before[0],
                flash_attn.dq_launches - before[1])
    lc, gc = common.value_and_grad(loss_fn(*host), cpu_p)
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    grad_rel = {}
    for path, g in common._leaves(gc):
        err = (common._at(gg, path).cpu() - g).abs().max().item()
        grad_rel["/".join(path)] = err / max(g.abs().max().item(), 1e-30)
    # Adam's eps 1e-6: with 1e-8 the update of a weight whose gradient is
    # near 1e-8 is a ratio of rounding noise, which the card's and the
    # CPU's fp32 sums do not share (tests/test_torch_bert.py does the same)
    step = bert.make_train_step(cfg, eps=1e-6)
    dev_s = (dev_p, *bert.init_train_state(dev_p))
    cpu_s = (cpu_p, *bert.init_train_state(cpu_p))
    step_rel = []
    for t in (1, 2, 3):
        a = float(step(*dev_s, t, toks, mlm, nsp, 1e-4)[3])
        b = float(step(*cpu_s, t, *host, 1e-4)[3])
        step_rel.append(abs(a - b) / abs(b))
    param_rel = {}
    for path, p in common._leaves(cpu_p):
        err = (common._at(dev_p, path).cpu() - p).abs().max().item()
        param_rel["/".join(path)] = err / max(p.abs().max().item(), 1e-30)
    pad = torch.ones_like(toks)
    pad[1, ERNIE_PARITY_N // 2:] = 0
    before = flash_attn.fwd_launches
    with torch.no_grad():
        pg = float(loss_fn(toks, mlm, nsp, pad)(dev_p))
        pad_launches = flash_attn.fwd_launches - before
        pc = float(loss_fn(*host, pad.cpu())(cpu_p))
    res = {"loss_card": float(lg), "loss_cpu": float(lc),
           "loss_rel_err": loss_rel, "flash_launches_fwd_dq": launched,
           "grad_rel_err_max": max(grad_rel.values()),
           "grad_rel_err": grad_rel, "step_loss_rel_err": step_rel,
           "param_rel_err_max": max(param_rel.values()),
           "param_rel_err": param_rel,
           "pad_loss_rel_err": abs(pg - pc) / abs(pc),
           "pad_flash_launches": pad_launches}
    if not (loss_rel <= TRAIN_LOSS_RTOL
            and res["grad_rel_err_max"] <= TRAIN_GRAD_TOL
            and max(step_rel) <= TRAIN_LOSS_RTOL
            and res["param_rel_err_max"] <= TRAIN_GRAD_TOL
            and res["pad_loss_rel_err"] <= TRAIN_LOSS_RTOL
            and launched == (2 * cfg.num_layers, cfg.num_layers)
            and pad_launches == 0):
        raise SystemExit(f"(q) the ERNIE step on the card disagrees with "
                         f"the CPU: {json.dumps(res)}")
    return res


def ernie_phases(torch, flash_attn, norms, card, args, launches):
    """Phases (p) and (q), logged; (p)'s launches go into ``launches``.
    Returns (p)'s measurements."""
    from paddle_tpu_torch.models import bert, common
    t0 = time.perf_counter()
    res = ernie_path(torch, bert, flash_attn, norms, args)
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        launches[f"{k}_ernie"] = res["launches"][k]
    torch.cuda.empty_cache()
    d = res["dense"]
    log(f"(p) ERNIE-3.0-Base pretraining ({res['num_params'] / 1e6:.1f}M "
        f"params, V=40064, H=768, L=12, nh=12, F=3072, N=512, type vocab "
        f"4, B={ERNIE_BATCH}, bf16 compute over fp32 params and AdamW "
        f"moments, remat, use_flash: non-causal flash forward and split "
        f"backward) on {card}: tokens/s {res['tokens_per_s']}; mean step "
        f"{res['step_ms']} ms over {res['steps']} steps (warm-up step "
        f"{res['warmup_s']:.2f} s); model-FLOP share "
        f"{res['model_flop_share']} ({res['flops_per_token']:.4e} "
        f"flops/token); max_memory_allocated "
        f"{res['max_memory_allocated_gib']} GiB; loss {res['first_loss']} "
        f"-> {res['last_loss']}; launches {res['launches']} (per step "
        f"{res['launches_per_step_expected']}); flash operand copies "
        f"{res['operand_copies']}  [{card}]")
    log(f"    losses {res['losses']}; step ms {res['step_ms_each']}")
    log(f"    dense route (use_flash=False, reported, not asserted): "
        f"tokens/s {d['tokens_per_s']}; mean step {d['step_ms']} ms over "
        f"{ERNIE_STEPS} steps (flash route above: {res['step_ms']}); "
        f"max_memory_allocated {d['max_memory_allocated_gib']} GiB; flash "
        f"launches {d['flash_launches']}; losses {d['losses']}; step ms "
        f"{d['step_ms_each']}; phase {time.perf_counter() - t0:.1f} s  "
        f"[{card}]")
    if "profile" in res:
        log(f"    ERNIE training-step profile on {card}: "
            f"{json.dumps(res['profile'])}")
        log(f"    ERNIE training-step memory peak on {card}: "
            f"{json.dumps(res['memory_peak'])}")
    # (q) ---------------------------------------------------------------
    t0 = time.perf_counter()
    par = ernie_parity(torch, bert, common, flash_attn)
    log(f"(q) fp32 ERNIE pretrain step, card against CPU (ERNIE widths, 2 "
        f"layers, B=2, N={ERNIE_PARITY_N}, NSP labels): loss rel err "
        f"{par['loss_rel_err']:.2e} (tol {TRAIN_LOSS_RTOL:.0e}); max grad "
        f"err / max|grad| {par['grad_rel_err_max']:.2e} (tol "
        f"{TRAIN_GRAD_TOL:.0e}); flash forward / dq launches "
        f"{par['flash_launches_fwd_dq']}; 3-step loss rel errs "
        f"{[f'{x:.2e}' for x in par['step_loss_rel_err']]}; max param err "
        f"/ max|param| after 3 steps {par['param_rel_err_max']:.2e} (tol "
        f"{TRAIN_GRAD_TOL:.0e}); pad-mask loss rel err "
        f"{par['pad_loss_rel_err']:.2e} with {par['pad_flash_launches']} "
        f"flash launches; phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return res


FLASH_COUNTERS = {"flash_attention_fwd": "fwd_launches",
                  "flash_attention_bwd_dq": "dq_launches",
                  "flash_attention_bwd_dkv": "dkv_launches",
                  "flash_attention_bwd_fused": "fused_launches",
                  "flash_attention_nokey": "nokey_launches"}


def eager_counters(flash_attn, norms):
    """(module, attribute) of every launch count an eager path reads."""
    out = {k: (flash_attn, a) for k, a in FLASH_COUNTERS.items()}
    out.update(layer_norm=(norms, "launches"), rms_norm=(norms, "rms_launches"))
    return out


def eager_ernie(pt, bert, cfg, batch, lr_warmup=10, epsilon=1e-8):
    """A user's eager pretraining loop on ``ErnieForPretraining(cfg)``:
    AdamW (weight decay 0.01, ``ClipGradByGlobalNorm(1.0)``) on a
    ``LinearWarmup`` schedule to 1e-4.  Returns (model, optimizer, step):
    ``step()`` runs ``loss = model(t, ml, nl); loss.backward();
    opt.step(); opt.clear_grad(); sched.step()`` and returns ``float(loss)``
    (``grads``, when given, gets every parameter's grad before the
    update)."""
    model = bert.ErnieForPretraining(cfg)
    sched = pt.optimizer.lr.LinearWarmup(1e-4, lr_warmup, 0.0, 1e-4)
    opt = pt.optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                             epsilon=epsilon,
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
                             parameters=model.parameters())
    t, ml, nl = (pt.to_tensor(x) for x in batch)

    def step(grads=None):
        loss = model(t, ml, nl)
        loss.backward()
        if grads is not None:
            grads.update({k: p.grad.value.clone()
                          for k, p in model.state_dict().items()})
        opt.step()
        opt.clear_grad()
        sched.step()
        return float(loss)
    return model, opt, step


def eager_ernie_path(torch, pt, bert, flash_attn, norms, args):
    """Phase (r): ERNIE-3.0-Base pretraining through the eager API at full
    width and depth, on (p)'s batch."""
    from paddle_tpu_torch.optimizer import optimizer as opt_mod
    cfg = bert.ernie_3_base()
    L = cfg.num_layers
    t0 = time.perf_counter()
    pt.seed(SEED + 22)
    batch = ernie_batch(torch, cfg.vocab_size, ERNIE_BATCH, cfg.max_seq_len)
    model, opt, step = eager_ernie(pt, bert, cfg, batch)
    setup_s = time.perf_counter() - t0
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_fused": 0,
            "flash_attention_nokey": 0, "layer_norm": 0, "rms_norm": 0}
    opt_mod.reset_fused_stats()
    with operand_copies(flash_attn) as copies:
        res = timed_loop(torch, lambda t: step(), ERNIE_STEPS,
                         eager_counters(flash_attn, norms), want, "(r)",
                         ERNIE_BATCH, cfg.max_seq_len)
    if copies:
        raise SystemExit(f"(r): flash operands copied: {copies}")
    fused = dict(opt_mod._fused_stats)
    if fused != {"calls": ERNIE_STEPS + 1, "compiles": 1, "eager_steps": 0}:
        raise SystemExit(f"(r): the optimizer did not take one fused step "
                         f"a step on one plan: {fused}")
    res.update(setup_s=setup_s, operand_copies=len(copies),
               optimizer_stats=fused, num_params=cfg.num_params())
    flop_share(res, cfg)
    res["memory_peak"] = memory_peak(torch, step)
    if args.profile_train:
        res["profile"] = profile_steps(
            torch, step, args.profile_train, "train_step_eager_ernie",
            args.train_trace.replace(".json", "_eager_ernie.json"))
    del model, opt, step
    torch.cuda.empty_cache()
    return res


def eager_ernie_parity(torch, pt, bert, flash_attn):
    """Phase (s): (r)'s eager loop in fp32 at ERNIE widths with 2 layers,
    B=2, N=256, every leaf drawn from numpy as (q) draws them, 3 steps on
    the card (kernels) and on the CPU (plain versions): the losses, every
    ``.grad`` of the first step and the params after the third."""
    from paddle_tpu_torch.framework import core
    cfg = dataclasses.replace(bert.ernie_3_base(), num_layers=2,
                              dtype="float32")
    batch = ernie_batch(torch, cfg.vocab_size, 2, ERNIE_PARITY_N, SEED + 23)
    rng = np.random.default_rng(SEED + 24)
    weights, out = None, {}
    prev = core._state.expected_place
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            # Adam's eps 1e-6, as (q): see ernie_parity
            model, _, step = eager_ernie(
                pt, bert, cfg, batch if place == "gpu"
                else tuple(x.cpu() for x in batch), lr_warmup=1,
                epsilon=1e-6)
            if weights is None:
                weights = {k: (1 + 0.1 * rng.standard_normal(p.shape)
                               if k.endswith("_g") else
                               0.02 * rng.standard_normal(p.shape)
                               ).astype(np.float32)
                           for k, p in model.state_dict().items()}
            model.set_state_dict(weights)
            before = flash_attn.fwd_launches, flash_attn.dq_launches
            grads = {}
            losses = [step(grads), step(), step()]
            launched = (flash_attn.fwd_launches - before[0],
                        flash_attn.dq_launches - before[1])
            out[place] = (losses, {k: g.cpu() for k, g in grads.items()},
                          {k: p.value.detach().cpu()
                           for k, p in model.state_dict().items()}, launched)
            del model, step
    finally:
        core._state.expected_place = prev
    (lg, gg, pg, launched), (lc, gc, pc, _) = out["gpu"], out["cpu"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(lg, lc)]
    grad_rel = {k: float((gg[k] - g).abs().max()
                         / max(float(g.abs().max()), 1e-30))
                for k, g in gc.items()}
    param_rel = {k: float((pg[k] - p).abs().max()
                          / max(float(p.abs().max()), 1e-30))
                 for k, p in pc.items()}
    res = {"loss_rel_err": loss_rel, "grad_rel_err_max":
           max(grad_rel.values()), "param_rel_err_max":
           max(param_rel.values()), "grad_rel_err": grad_rel,
           "param_rel_err": param_rel, "flash_launches_fwd_dq": launched}
    if not (max(loss_rel) <= TRAIN_LOSS_RTOL
            and res["grad_rel_err_max"] <= TRAIN_GRAD_TOL
            and res["param_rel_err_max"] <= TRAIN_GRAD_TOL
            and launched == (3 * 2 * cfg.num_layers, 3 * cfg.num_layers)):
        raise SystemExit(f"(s) the eager ERNIE loop on the card disagrees "
                         f"with the CPU: {json.dumps(res)}")
    return res


def eager_encoder_path(torch, pt, flash_attn, norms, args):
    """Phase (t): (n)'s encoder trained through the nn API under AMP."""
    e = ENCODER
    t0 = time.perf_counter()
    pt.seed(SEED + 25)
    model = make_encoder(pt, **e, dropout=0.1, attn_dropout=0.0).train()
    model.set_state_dict(numpy_state(model, SEED + 26))
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
                             parameters=model.parameters())
    scaler = pt.amp.GradScaler()
    ce = pt.nn.CrossEntropyLoss()
    ids = pt.to_tensor(np.random.default_rng(SEED + 27).integers(
        0, e["V"], (ENCODER_BATCH, e["N"])))
    skipped = []

    def step():
        with pt.amp.auto_cast(dtype="bfloat16"):
            _, logits = model(ids)
            loss = ce(logits[:, :-1], ids[:, 1:])
        scaler.scale(loss).backward()
        scaler.step(opt)
        skipped.append(scaler._found())
        scaler.update()
        opt.clear_grad()
        return float(loss)
    setup_s = time.perf_counter() - t0
    L = e["L"]
    want = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_fused": 0,
            "flash_attention_nokey": 0, "layer_norm": 0, "rms_norm": 0}
    res = timed_loop(torch, lambda t: step(), ERNIE_STEPS,
                     eager_counters(flash_attn, norms), want, "(t)",
                     ENCODER_BATCH, e["N"])
    res.update(setup_s=setup_s, skipped_steps=sum(skipped),
               loss_scale=scaler.get_init_loss_scaling())
    if args.profile_train:
        res["profile"] = profile_steps(
            torch, step, args.profile_train, "train_step_eager_encoder",
            args.train_trace.replace(".json", "_eager_encoder.json"))
    del model, opt
    torch.cuda.empty_cache()
    return res


def eager_phases(torch, flash_attn, norms, card, args, launches, p_res):
    """Phases (r), (s) and (t), logged; (r)'s and (t)'s flash launches go
    into ``launches``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.models import bert
    prev = core._state.expected_place
    pt.set_device("gpu")
    try:
        t0 = time.perf_counter()
        r = eager_ernie_path(torch, pt, bert, flash_attn, norms, args)
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            launches[f"{k}_eager_ernie"] = r["launches"][k]
        log(f"(r) eager ERNIE-3.0-Base pretraining (ErnieForPretraining, "
            f"{r['num_params'] / 1e6:.1f}M params, B={ERNIE_BATCH}, N=512, "
            f"bf16 compute over fp32 params, remat, use_flash; AdamW wd "
            f"0.01 + ClipGradByGlobalNorm(1.0) on LinearWarmup to 1e-4; "
            f"loss.backward(), opt.step(), opt.clear_grad(), sched.step()) "
            f"on {card}: tokens/s {r['tokens_per_s']}; mean step "
            f"{r['step_ms']} ms over {r['steps']} steps (warm-up step "
            f"{r['warmup_s']:.2f} s); (r) / (p) step time "
            f"{r['step_ms'] / p_res['step_ms']} ((p): {p_res['step_ms']} ms,"
            f" same run); model-FLOP share {r['model_flop_share']}; "
            f"max_memory_allocated {r['max_memory_allocated_gib']} GiB; "
            f"loss {r['first_loss']} -> {r['last_loss']}; launches "
            f"{r['launches']} (per step {r['launches_per_step_expected']}); "
            f"flash operand copies {r['operand_copies']}; optimizer "
            f"{r['optimizer_stats']}  [{card}]")
        log(f"    losses {r['losses']}; step ms {r['step_ms_each']}; set-up "
            f"{r['setup_s']:.1f} s")
        log(f"    memory peak of one more step on {card}: "
            f"{json.dumps(r['memory_peak'])}")
        if "profile" in r:
            log(f"    eager ERNIE step profile on {card}: "
                f"{json.dumps(r['profile'])}")
        log(f"    phase {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        s = eager_ernie_parity(torch, pt, bert, flash_attn)
        log(f"(s) fp32 eager ERNIE loop, card against CPU (ERNIE widths, 2 "
            f"layers, B=2, N={ERNIE_PARITY_N}, 3 steps): loss rel errs "
            f"{[f'{x:.2e}' for x in s['loss_rel_err']]} (tol "
            f"{TRAIN_LOSS_RTOL:.0e}); max .grad err / max|grad| "
            f"{s['grad_rel_err_max']:.2e} (tol {TRAIN_GRAD_TOL:.0e}); max "
            f"param err / max|param| after 3 steps "
            f"{s['param_rel_err_max']:.2e} (tol {TRAIN_GRAD_TOL:.0e}); "
            f"flash forward / dq launches {s['flash_launches_fwd_dq']}; "
            f"phase {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        t = eager_encoder_path(torch, pt, flash_attn, norms, args)
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            launches[f"{k}_eager_encoder"] = t["launches"][k]
        e = ENCODER
        log(f"(t) eager nn-API encoder training under AMP ((n)'s model, "
            f"V={e['V']}, H={e['H']}, L={e['L']}, pre-LN, dropout 0.1, "
            f"attn_dropout 0, RMSNorm final norm; auto_cast bf16, "
            f"CrossEntropyLoss on shifted ids, GradScaler, AdamW + "
            f"ClipGradByGlobalNorm(1.0), [{ENCODER_BATCH}, {e['N']}]) on "
            f"{card}: tokens/s {t['tokens_per_s']}; mean step {t['step_ms']} "
            f"ms over {t['steps']} steps (warm-up step {t['warmup_s']:.2f} "
            f"s); max_memory_allocated {t['max_memory_allocated_gib']} GiB; "
            f"loss {t['first_loss']} -> {t['last_loss']}; launches "
            f"{t['launches']} (per step {t['launches_per_step_expected']}); "
            f"skipped steps {t['skipped_steps']}, loss scale "
            f"{t['loss_scale']}  [{card}]")
        log(f"    losses {t['losses']}; step ms {t['step_ms_each']}")
        if "profile" in t:
            log(f"    eager encoder step profile on {card}: "
                f"{json.dumps(t['profile'])}")
        log(f"    phase {time.perf_counter() - t0:.1f} s")
    finally:
        core._state.expected_place = prev


def token_dataset(pt, V, N, n, seed):
    """A map-style ``io.Dataset`` of ``n`` samples drawn from a numpy seed:
    N token ids in [0, V) (int64) and the first id mod 2 as the label, so
    that a classifier can learn it."""
    class Tokens(pt.io.Dataset):
        def __init__(self):
            rng = np.random.default_rng(seed)
            self.t = rng.integers(0, V, (n, N), dtype=np.int64)
            self.y = self.t[:, :1] % 2

        def __len__(self):
            return n

        def __getitem__(self, i):
            return self.t[i], self.y[i]
    return Tokens()


def ernie_classifier(pt, bert, cfg):
    """A user's sequence classifier: ``ErnieModel(cfg)``'s pooled output
    into a ``Linear(H, 2)``."""
    class ErnieClassifier(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ernie = bert.ErnieModel(cfg)
            self.cls = pt.nn.Linear(cfg.hidden_size, 2)

        def forward(self, tokens):
            _, pooled = self.ernie(tokens)
            return self.cls(pooled)
    return ErnieClassifier()


def hapi_model(pt, net, N, warmup, epsilon=1e-8):
    """``Model(net)`` with [None, N] int64 inputs and [None, 1] labels,
    prepared with AdamW (weight decay 0.01, ``ClipGradByGlobalNorm(1.0)``)
    on ``LinearWarmup`` to 1e-4 over ``warmup`` steps,
    ``CrossEntropyLoss()`` and ``Accuracy()``."""
    sched = pt.optimizer.lr.LinearWarmup(1e-4, warmup, 0.0, 1e-4)
    opt = pt.optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                             epsilon=epsilon,
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
                             parameters=net.parameters())
    model = pt.Model(net, inputs=[pt.static.InputSpec([None, N], "int64")],
                     labels=[pt.static.InputSpec([None, 1], "int64")])
    model.prepare(opt, pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    return model


def card_loader(pt, ds, batch, shuffle):
    """The loader of (u): two workers staging through the native ring,
    two batches copied ahead on a side stream."""
    return pt.io.DataLoader(ds, batch_size=batch, shuffle=shuffle,
                            num_workers=2, use_native_ring=True,
                            prefetch_to_device=2)


def read_counts(counters):
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def zero_counts(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def check_counts(label, got, want, n):
    for k, per in want.items():
        if got[k] != per * n:
            raise SystemExit(f"{label}: {k} launched {got[k]} times in {n} "
                             f"steps, expected {per} a step")


def hapi_fit(torch, pt, model, loader, epochs, counters, want, label):
    """``model.fit(loader, epochs)`` with the launch counts zeroed just
    before and read just after (they must equal ``want`` a step); the
    last epoch is timed on the host clock by a callback (its step ms
    include the loader's waits) with its own counts, memory peak and
    prefetch hits."""
    steps = len(loader)
    last = epochs - 1
    rec = {"losses": [], "step_ms_each": []}

    class Timer(pt.callbacks.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            if epoch == last:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                pt.io.reset_prefetch_stats()
                rec["counts_before"] = read_counts(counters)
                rec["t0"] = time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            rec["t"] = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            rec["losses"].append(logs["loss"])
            if len(rec["losses"]) > last * steps:
                rec["step_ms_each"].append(
                    1e3 * (time.perf_counter() - rec["t"]))

        def on_epoch_end(self, epoch, logs=None):
            if epoch == last:
                torch.cuda.synchronize()
                rec["epoch_s"] = time.perf_counter() - rec["t0"]
                after = read_counts(counters)
                rec["epoch_launches"] = {
                    k: after[k] - rec["counts_before"][k] for k in after}
                rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
                rec["prefetch"] = pt.io.prefetch_stats()

    zero_counts(counters)
    t0 = time.perf_counter()
    model.fit(loader, epochs=epochs, verbose=0, callbacks=[Timer()])
    fit_s = time.perf_counter() - t0
    launches = read_counts(counters)
    check_counts(label, launches, want, epochs * steps)
    check_counts(label + " timed epoch", rec["epoch_launches"], want, steps)
    step_s = rec["epoch_s"] / steps
    return {"fit_s": fit_s, "steps": steps, "step_ms": 1e3 * step_s,
            "step_ms_each": rec["step_ms_each"],
            "tokens_per_s": loader.batch_sampler.batch_size
            * model._inputs[0].shape[1] / step_s,
            "losses": rec["losses"], "launches": launches,
            "launches_timed_epoch": rec["epoch_launches"],
            "max_memory_allocated_gib": rec["peak_gib"],
            "prefetch": rec["prefetch"]}


def hand_loop(torch, pt, model, batches, counters, want):
    """The same network and optimizer in a hand-written eager loop over
    batches already on the card: forward, loss, ``backward``, ``step``,
    ``clear_grad``, the scheduler's step, ``float(loss)``; timed on the
    host clock, launch counts checked."""
    net, opt = model.network, model._optimizer
    ce = pt.nn.CrossEntropyLoss()
    net.train()
    zero_counts(counters)
    torch.cuda.synchronize()
    times, losses = [], []
    t_all = time.perf_counter()
    for x, y in batches:
        t0 = time.perf_counter()
        loss = ce(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        opt._learning_rate.step()
        losses.append(float(loss))
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = 1e3 * (time.perf_counter() - t_all) / len(batches)
    check_counts("(u) hand-written loop", read_counts(counters), want,
                 len(batches))
    return {"step_ms": step_ms, "step_ms_each": times, "losses": losses}


def hapi_path(torch, pt, bert, flash_attn, norms, args):
    """Phase (u): an ERNIE-3.0-Base classifier fitted, evaluated, used to
    predict, saved and loaded through ``Model`` and ``io.DataLoader`` at
    full width and depth, and held against a hand-written loop."""
    cfg = bert.ernie_3_base()
    V, N, L, B = cfg.vocab_size, cfg.max_seq_len, cfg.num_layers, ERNIE_BATCH
    t0 = time.perf_counter()
    pt.seed(SEED + 30)
    net = ernie_classifier(pt, bert, cfg)
    steps = HAPI_TRAIN // B
    model = hapi_model(pt, net, N, warmup=steps)
    train_ds = token_dataset(pt, V, N, HAPI_TRAIN, SEED + 31)
    eval_ds = token_dataset(pt, V, N, HAPI_EVAL, SEED + 32)
    n_params = sum(p.size for k, p in net.state_dict().items()
                   if not k.startswith(("ernie.mlm_", "ernie.nsp_")))
    flops_per_token = 6 * n_params + 12 * L * cfg.hidden_size * N
    setup_s = time.perf_counter() - t0
    counters = eager_counters(flash_attn, norms)
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_fused": 0,
            "flash_attention_nokey": 0, "layer_norm": 0, "rms_norm": 0}
    want_fwd = {"flash_attention_fwd": L, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0, "flash_attention_bwd_fused": 0,
                "flash_attention_nokey": 0, "layer_norm": 0, "rms_norm": 0}
    # batches for the hand-written loop, staged on the card beforehand
    np.random.seed(SEED + 33)
    staged = list(pt.io.DataLoader(train_ds, batch_size=B, shuffle=True))
    # fit: 2 epochs, the first the warm-up; then alternated with the loop
    np.random.seed(SEED + 34)
    fit = hapi_fit(torch, pt, model, card_loader(pt, train_ds, B, True), 2,
                   counters, want, "(u) fit")
    losses = fit["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"(u): a non-finite loss: {losses}")
    if not np.mean(losses[steps:]) < np.mean(losses[:steps]):
        raise SystemExit(f"(u): the loss did not fall: {losses}")
    loops = [hand_loop(torch, pt, model, staged, counters, want)]
    again = hapi_fit(torch, pt, model, card_loader(pt, train_ds, B, True),
                     1, counters, want, "(u) fit again")
    loops.append(hand_loop(torch, pt, model, staged, counters, want))
    hapi_ms = [fit["step_ms"], again["step_ms"]]
    loop_ms = [lp["step_ms"] for lp in loops]
    res = {"setup_s": setup_s, "fit": fit, "fit_again": again,
           "loops": loops, "hapi_step_ms": hapi_ms, "loop_step_ms": loop_ms,
           "hapi_over_loop": [a / b for a, b in zip(hapi_ms, loop_ms)],
           "num_params": n_params, "flops_per_token": flops_per_token,
           "model_flop_share": fit["tokens_per_s"] * flops_per_token
           / BF16_FLOPS_PER_S,
           "launches": fit["launches"]}
    # evaluate and predict over 256 more samples: forwards only
    n_eval = HAPI_EVAL // B
    zero_counts(counters)
    t0 = time.perf_counter()
    res["eval"] = model.evaluate(card_loader(pt, eval_ds, B, False),
                                 verbose=0)
    res["eval_s"] = time.perf_counter() - t0
    res["eval_launches"] = read_counts(counters)
    check_counts("(u) evaluate", res["eval_launches"], want_fwd, n_eval)
    zero_counts(counters)
    t0 = time.perf_counter()
    pred = model.predict(card_loader(pt, eval_ds, B, False),
                         stack_outputs=True)[0]
    res["predict_s"] = time.perf_counter() - t0
    res["predict_launches"] = read_counts(counters)
    check_counts("(u) predict", res["predict_launches"], want_fwd, n_eval)
    if pred.shape != (HAPI_EVAL, 2) or not np.isfinite(pred).all():
        raise SystemExit(f"(u): predict gave {pred.shape}, finite "
                         f"{np.isfinite(pred).all()}")
    # save, load into a fresh Model, predict again: bit-equal
    ckpt = os.path.join("paddle_tpu_torch", "_build", "hapi_ckpt")
    try:
        t0 = time.perf_counter()
        model.save(os.path.join(ckpt, "final"))
        res["save_s"] = time.perf_counter() - t0
        res["ckpt_bytes"] = {f: os.path.getsize(os.path.join(ckpt, f))
                             for f in sorted(os.listdir(ckpt))}
        pt.seed(SEED + 35)
        fresh = hapi_model(pt, ernie_classifier(pt, bert, cfg), N,
                           warmup=steps)
        t0 = time.perf_counter()
        fresh.load(os.path.join(ckpt, "final"))
        res["load_s"] = time.perf_counter() - t0
        again_pred = fresh.predict(card_loader(pt, eval_ds, B, False),
                                   stack_outputs=True)[0]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    res["reload_bit_equal"] = bool(np.array_equal(pred, again_pred))
    res["reload_step_count"] = (fresh._optimizer._step_count,
                                model._optimizer._step_count)
    if not res["reload_bit_equal"] or len(set(res["reload_step_count"])) != 1:
        raise SystemExit(f"(u): the reloaded Model predicts otherwise "
                         f"(max diff {np.abs(pred - again_pred).max()}) or "
                         f"resumes another step {res['reload_step_count']}")
    del fresh
    if args.profile_train:
        it = iter(card_loader(pt, train_ds, B, True))

        def hapi_step():
            model.train_batch(*model._split_batch(next(it)))
        res["profile"] = profile_steps(
            torch, hapi_step, args.profile_train, "train_step_hapi",
            args.train_trace.replace(".json", "_hapi.json"))
        h2d = set(res["profile"]["h2d_streams"])
        if h2d & set(res["profile"]["kernel_streams"]) or not all(
                "Pinned" in n for n in res["profile"]["h2d_names"]):
            raise SystemExit(f"(u): the loader's copies are not pinned "
                             f"copies on a side stream: "
                             f"{json.dumps(res['profile'])}")
        ce = pt.nn.CrossEntropyLoss()
        batch_it = iter(staged)

        def loop_step():
            x, y = next(batch_it)
            loss = ce(net(x), y)
            loss.backward()
            model._optimizer.step()
            model._optimizer.clear_grad()
            float(loss)
        res["profile_loop"] = profile_steps(
            torch, loop_step, args.profile_train, "train_step_hand_loop",
            args.train_trace.replace(".json", "_hand_loop.json"))
    del model, net, staged
    torch.cuda.empty_cache()
    return res


def hapi_parity(torch, pt, bert, flash_attn):
    """Phase (v): (u)'s path in fp32 at ERNIE widths with 2 layers, [4,
    256] batches, every leaf drawn from numpy as (q) draws them: 3 ``fit``
    steps, ``evaluate`` and ``predict`` over 8 more samples, on the card
    (the ring loader, kernels) and on the CPU (the single-process loader,
    plain versions)."""
    from paddle_tpu_torch.framework import core
    B, N = HAPI_PARITY
    cfg = dataclasses.replace(bert.ernie_3_base(), num_layers=2,
                              dtype="float32")
    train_ds = token_dataset(pt, cfg.vocab_size, N, 3 * B, SEED + 36)
    eval_ds = token_dataset(pt, cfg.vocab_size, N, 2 * B, SEED + 37)
    rng = np.random.default_rng(SEED + 38)
    weights, out = None, {}
    prev = core._state.expected_place
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            net = ernie_classifier(pt, bert, cfg)
            if weights is None:
                weights = {k: (1 + 0.1 * rng.standard_normal(p.shape)
                               if k.endswith("_g") else
                               0.02 * rng.standard_normal(p.shape)
                               ).astype(np.float32)
                           for k, p in net.state_dict().items()}
            net.set_state_dict(weights)
            # Adam's eps 1e-6, as (q) and (s): see ernie_parity
            model = hapi_model(pt, net, N, warmup=1, epsilon=1e-6)
            kw = (dict(num_workers=2, use_native_ring=True,
                       prefetch_to_device=2) if place == "gpu" else {})
            losses = []

            class Record(pt.callbacks.Callback):
                def on_train_batch_end(self, step, logs=None):
                    losses.append(logs["loss"])
            before = (flash_attn.fwd_launches, flash_attn.dq_launches,
                      flash_attn.dkv_launches)
            np.random.seed(SEED + 39)
            model.fit(pt.io.DataLoader(train_ds, batch_size=B, shuffle=True,
                                       **kw), epochs=1, verbose=0,
                      callbacks=[Record()])
            params = {k: p.numpy() for k, p in net.state_dict().items()}
            ev = model.evaluate(pt.io.DataLoader(eval_ds, batch_size=B, **kw),
                                verbose=0)
            pred = model.predict(pt.io.DataLoader(eval_ds, batch_size=B,
                                                  **kw),
                                 stack_outputs=True)[0]
            launched = tuple(a - b for a, b in zip(
                (flash_attn.fwd_launches, flash_attn.dq_launches,
                 flash_attn.dkv_launches), before))
            out[place] = (losses, params, ev, pred, launched)
            del model, net
    finally:
        core._state.expected_place = prev
    (lg, pg, eg, dg, launched), (lc, pc, ec, dc, _) = out["gpu"], out["cpu"]
    L = cfg.num_layers
    param_rel = {k: float(np.abs(pg[k] - p).max()
                          / max(float(np.abs(p).max()), 1e-30))
                 for k, p in pc.items()}
    res = {"loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(lg, lc)],
           "param_rel_err_max": max(param_rel.values()),
           "param_rel_err_worst": max(param_rel, key=param_rel.get),
           "eval_card": eg, "eval_cpu": ec,
           "eval_loss_rel_err": abs(eg["loss"] - ec["loss"]) / abs(ec["loss"]),
           "predict_err": float(np.abs(dg - dc).max()
                                / max(float(np.abs(dc).max()), 1e-30)),
           "flash_launches": launched,
           "flash_launches_expected": (3 * 2 * L + 4 * L, 3 * L, 3 * L)}
    if not (len(lg) == len(lc) == 3
            and max(res["loss_rel_err"]) <= TRAIN_LOSS_RTOL
            and res["param_rel_err_max"] <= FP32_TOL
            and eg["acc"] == ec["acc"]
            and res["eval_loss_rel_err"] <= HAPI_PARITY_TOL
            and res["predict_err"] <= HAPI_PARITY_TOL
            and launched == res["flash_launches_expected"]):
        raise SystemExit(f"(v) the hapi path on the card disagrees with the "
                         f"CPU: {json.dumps(res)}")
    return res


def hapi_phases(torch, flash_attn, norms, card, args, launches):
    """Phases (u) and (v), logged; (u)'s flash launches go into
    ``launches``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.models import bert
    prev = core._state.expected_place
    pt.set_device("gpu")
    try:
        t0 = time.perf_counter()
        u = hapi_path(torch, pt, bert, flash_attn, norms, args)
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            launches[f"{k}_hapi"] = u["launches"][k]
            launches[f"{k}_hapi_eval"] = u["eval_launches"][k]
        f = u["fit"]
        log(f"(u) hapi: ERNIE-3.0-Base classifier (ErnieModel pooled -> "
            f"Linear(768, 2), {u['num_params'] / 1e6:.1f}M params used, "
            f"B={ERNIE_BATCH}, N=512, bf16 compute over fp32 params, remat, "
            f"use_flash) through Model.fit on io.DataLoader(shuffle, 2 "
            f"workers, native ring, prefetch_to_device=2), AdamW wd 0.01 + "
            f"ClipGradByGlobalNorm(1.0) on LinearWarmup to 1e-4, "
            f"CrossEntropyLoss, Accuracy; epoch 2 of 2 timed, on {card}: "
            f"step {f['step_ms']} ms, tokens/s {f['tokens_per_s']}, "
            f"model-FLOP share {u['model_flop_share']} (flops/token "
            f"{u['flops_per_token']}); max_memory_allocated "
            f"{f['max_memory_allocated_gib']} GiB; prefetch {f['prefetch']}; "
            f"launches {f['launches']} over 2 epochs, timed epoch "
            f"{f['launches_timed_epoch']}  [{card}]")
        log(f"    losses {f['losses']}; step ms (batch begin to end) "
            f"{f['step_ms_each']}; fit {f['fit_s']:.2f} s; set-up "
            f"{u['setup_s']:.1f} s")
        log(f"    hapi step ms {u['hapi_step_ms']} against the hand-written "
            f"loop's {u['loop_step_ms']}, alternated in this process: "
            f"hapi / loop {u['hapi_over_loop']}; loop losses "
            f"{[lp['losses'][-1] for lp in u['loops']]}  [{card}]")
        log(f"    evaluate {u['eval']} in {u['eval_s']:.2f} s, launches "
            f"{u['eval_launches']}; predict {u['predict_s']:.2f} s, "
            f"launches {u['predict_launches']}; save {u['save_s']:.2f} s "
            f"({u['ckpt_bytes']}), load {u['load_s']:.2f} s, reloaded "
            f"predictions bit-equal {u['reload_bit_equal']}, step count "
            f"{u['reload_step_count']}  [{card}]")
        for key in ("profile", "profile_loop"):
            if key in u:
                log(f"    {key} on {card}: {json.dumps(u[key])}")
        log(f"    phase {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        v = hapi_parity(torch, pt, bert, flash_attn)
        log(f"(v) fp32 hapi path, card (ring loader, kernels) against CPU "
            f"(single-process loader, plain versions), ERNIE widths, 2 "
            f"layers, {list(HAPI_PARITY)}, 3 fit steps: loss rel errs "
            f"{[f'{x:.2e}' for x in v['loss_rel_err']]} (tol "
            f"{TRAIN_LOSS_RTOL:.0e}); max param err / max|param| "
            f"{v['param_rel_err_max']:.2e} ({v['param_rel_err_worst']}; tol "
            f"{FP32_TOL:.0e}); evaluate {v['eval_card']} against "
            f"{v['eval_cpu']} (loss rel err {v['eval_loss_rel_err']:.2e}); "
            f"predict err / max|ref| {v['predict_err']:.2e} (tol "
            f"{HAPI_PARITY_TOL:.0e}); flash fwd / dq / dk-dv launches "
            f"{v['flash_launches']}; phase {time.perf_counter() - t0:.1f} s")
    finally:
        core._state.expected_place = prev


# kernel -> (source, the TPU kernel it replaces, the case that stands for
# the main path in the result line)
REPORT = {
    "paged_attention": (
        "paddle_tpu_torch/ops/cuda/csrc/paged_attn.cu",
        "paddle_tpu/ops/pallas/paged_attn.py:63",
        "S8 nh16 hd64 ps16 maxP32 (decode)"),
    "layer_norm": (
        "paddle_tpu_torch/ops/cuda/csrc/layer_norm.cu",
        "paddle_tpu/ops/pallas/norms.py:47",
        "[8, 1, 1024] (decode 8 rows (serving))"),
    "flash_attention_fwd": (
        "paddle_tpu_torch/ops/cuda/csrc/flash_attn.cu",
        "paddle_tpu/ops/pallas/flash_attn.py:94", "[8, 1024, 16, 64]"),
    "flash_attention_bwd_dq": (
        "paddle_tpu_torch/ops/cuda/csrc/flash_attn.cu",
        "paddle_tpu/ops/pallas/flash_attn.py:262", "[8, 1024, 16, 64]"),
    "flash_attention_bwd_dkv": (
        "paddle_tpu_torch/ops/cuda/csrc/flash_attn.cu",
        "paddle_tpu/ops/pallas/flash_attn.py:291", "[8, 1024, 16, 64]"),
    "dequant_matmul": (
        "paddle_tpu_torch/ops/cuda/csrc/dequant_matmul.cu",
        "paddle_tpu/ops/pallas/dequant_matmul.py:45",
        "[8, 1024] x [1024, 4096] (decode fc1)"),
    "paged_attention_quant": (
        "paddle_tpu_torch/ops/cuda/csrc/paged_attn.cu",
        "paddle_tpu/ops/pallas/paged_attn.py:193",
        "S8 nh16 hd64 ps16 maxP32 (decode)"),
    "flash_attention_bwd_fused": (
        "paddle_tpu_torch/ops/cuda/csrc/flash_attn.cu",
        "paddle_tpu/ops/pallas/flash_attn.py:326", "[6, 2048, 16, 128]"),
    "fused_ffn": (
        "paddle_tpu_torch/ops/cuda/csrc/fused_ffn.cu",
        "paddle_tpu/ops/pallas/fused_ffn.py:38",
        "[12288, 2048] x [2048, 8192] (flagship)"),
    "rms_norm": (
        "paddle_tpu_torch/ops/cuda/csrc/layer_norm.cu",
        "paddle_tpu/ops/pallas/norms.py:57",
        "[8, 512, 768] (encoder final norm, g bf16)"),
}


def report(torch, cases, launches, train, t_start):
    """The ``kernels`` JSON line, the nvidia-smi line and the last line."""
    kernels = []
    for k, (src, rep, main_shape) in REPORT.items():
        main = next(c for c in cases[k] if c["shape"].startswith(main_shape)
                    and c["dtype"] == "torch.bfloat16")
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[k], "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "call_ms": main["call_ms"],
            **{t: main[t] for t in ("tol", "atol", "rtol", "gate",
                                    "mutant_gate", "g_dtype",
                                    "library", "library_cublas_ms",
                                    "split_ms", "dq_rerun_max_abs_diff")
               if t in main},
            "pass": all(case_ok(c) for c in cases[k]),
            "shape": main["shape"], "dtype": main["dtype"],
            "cases": cases[k]})
    ln = next(k for k in kernels if k["name"] == "layer_norm")
    ln["launches_train"] = train["launches"]["layer_norm"]
    ln["launches_quant_path"] = launches["layer_norm_quant_path"]
    ln["launches_flagship"] = launches["layer_norm_flagship"]
    ln["launches_encoder"] = launches["layer_norm_encoder"]
    fwd = next(k for k in kernels if k["name"] == "flash_attention_fwd")
    fwd["launches_flagship"] = launches["flash_attention_fwd_flagship"]
    fwd["launches_encoder"] = launches["flash_attention_fwd_encoder"]
    for k in kernels:
        for path in ("ernie", "eager_ernie", "eager_encoder", "hapi",
                     "hapi_eval"):
            if f"{k['name']}_{path}" in launches:
                k[f"launches_{path}"] = launches[f"{k['name']}_{path}"]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
