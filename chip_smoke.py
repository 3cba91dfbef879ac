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
      ``paged_decode_q8``, ``row_mm_tc`` and its LayerNorm-prologue
      instances ``ln_row_mm_tc``), any of which last must not spill;
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
      the first tile.  The row-invariant matmul (``row_matmul``, which the
      paged decode and the fp verify take) at gpt_345m's four block
      products, M = 8 and 40, fp32 and bf16, bf16 on both routes (the
      tensor-core kernel the wrapper picks and the CUDA-core kernel, timed
      on the same inputs), each row of an [M, N] launch bit-equal to the
      M = 1 launch on that row for M in 1, 2, 8, 10, 40, 64, 320
      (asserted); the same product with its LayerNorm prologue
      (``ln_matmul``, one launch for ln1 -> qkv and ln2 -> fc1) at qkv
      and fc1, M = 8 and 40, bf16 with g and b fp32 and bf16 on both
      routes and fp32, against its plain version and timed beside the
      LayerNorm kernel and the row product launched apart, the row product
      alone and ``F.layer_norm`` + ``torch.mm``, its rows bit-equal to the
      M = 1 launch at the same M and at K, N = 1032, 1000 and 1030, 1001
      (asserted);
  (d) the main path: ``gpt_345m`` (full width, 24 layers) with
      ``use_pallas_norm``, weights drawn from a numpy seed, served by
      ``PagedServingEngine(slots=8, max_len=512, page_size=16)`` after
      ``warmup()``: 12 requests of 17-300 prompt tokens (two share a
      64-token prefix) x 32 new tokens.  The engine's decode step is one
      CUDA graph, and so is each (batch, seq) rung of its prefill ladder,
      all captured in ``warmup()`` (the prefill graphs into one shared
      memory pool): ``decode_compiles`` must be 1, ``prefill_compiles``
      the rungs ``warmup()`` reached (its return value), and no capture
      may happen during the traffic; ``torch.cuda.max_memory_reserved()``
      after warmup is printed.  Kernel launch counts
      are zeroed just before and read just after (each replay counts its
      launches): a decode step launches 4L row products, 2L of them with
      the LayerNorm prologue (ln1 -> qkv, ln2 -> fc1), and the LayerNorm
      kernel once (lnf); a prefill wave 2L + 1 LayerNorms.  The decode
      step is timed on three routes, alternated: fused, the LayerNorm
      kernel and the row product launched apart, and the LayerNorm kernel
      and cuBLAS.  Then 8 slots at mixed lengths decode while one replay
      is held against ``gpt.decode_step_paged`` on clones of the pool with
      the same inputs (next tokens equal; the bf16 logit difference
      printed), and 50 replays are timed against 50 eager steps (five
      host-to-device copies, the step, argmax, readback), alternated;
      then every wave of 6 requests is held against the eager
      ``_prefill`` on clones of the pool (next tokens equal; the pool
      bytes past scratch page 0 and the host ms of both reported);
  (e) the engine in fp32 (``capture_logits=True``) against the port's own
      ``generate`` (greedy tokens) and a teacher-forced ``forward``
      (logits) on the card, and its replay against the eager step with
      logits within 1e-3, and its wave replays against the eager
      ``_prefill`` with the pool bytes past page 0 equal;
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
      1e-4 of max|ref|;
  (w) chunked prefill at full width: (d)'s ``gpt_345m`` weights and 12
      requests x 32 tokens through ``PagedServingEngine(slots=8,
      max_len=512, page_size=16, prefill_chunk=16)`` after ``warmup()``,
      then the same with ``quant="int8", kv_dtype="int8"``, each
      alternated (two rounds) with the unchunked engine of (d) / (j) on the
      same requests.  Launch counts, zeroed just before each pass and read
      just after, must equal (2L + 1) LayerNorms a chunk and a decode
      step (fp: 1 a decode step, lnf, and 2L LayerNorm-prologue row
      products), L paged (int8 paged) attentions a decode step and, on
      the int8 path, 4L dequant matmuls a forward, 4L a chunk at M = 16
      and 4L a decode step at M = 8; every prompt must take the chunked
      path; the decode step stays one graph, the chunk is one graph too
      (every chunk of every prompt), and every engine's prefill graphs
      (its rungs' and the chunk's) are captured in ``warmup()`` and none
      during the traffic; two long prompts' chunks (prefix-hit pages
      held) are then held against the eager ``forward_paged_chunk(_quant)``
      on clones of the pool (tokens equal; pool bytes past page 0 and
      host ms reported).  Prints prefill-chunk and
      decode-step ms, tokens/s, decode tokens/s (tokens from decode steps
      over their host time), prefix hits and the share of tokens equal to
      the unchunked engine's (bf16, not asserted).  With ``--profile
      STEPS`` it also traces up to STEPS iterations that each run one
      chunk and nothing else, fp and int8;
  (x) speculative decoding at full width: ``gpt_345m`` with weights from
      the port's ``init_params`` (seed 1234), 12 numpy-seeded requests of
      24-120 tokens (3 of every 4 share a 16-token prefix) x 32 tokens
      through ``SpeculativeServingEngine(spec_k=4, prefill_chunk=16)`` in
      ``ngram`` mode and in ``draft`` mode with a self-draft (the target's
      config and seed), on the fp pool and then with int8 weights and
      pool, alternated (two rounds) with the non-speculative engine on the
      same requests.  ``decode_compiles`` must be 1 (one verify graph,
      captured once; the prefill graphs captured in warmup and none in the
      traffic, as in (w)), ``spec_draft_compiles`` 0 / 2, the self-draft's
      accepted tokens per verify above 1.5, and the launches exact: per
      verify W = 5 paged attentions a layer (one a lane, at the decode's
      call shape) and 2L + 1 LayerNorms ([8, 5, 1024]; fp: 1, lnf, and
      2L LayerNorm-prologue row products), 4L dequant
      matmuls at M = 40 on the int8 path; the draft model's W + k - 1
      slot decodes a verify and its blocks a 16-token ingestion chunk.
      Prints accepted tokens per verify, a verify step's ms and its
      drafting's (ngram: host clock; draft mode: the draft model's span
      on the card, from CUDA events), tokens/s and decode tokens/s beside
      the non-speculative engine's.  With ``--profile STEPS`` it also
      traces STEPS iterations of the fp self-draft engine with every slot
      decoding, then STEPS replays of its draft step alone;
  (y) fp32 parity at V=4096, H=256, 2 layers: the chunked engine and
      both speculative engines, fp and int8 pools, on the card against the
      CPU (tokens exact, logits within 1e-3), the speculative engines
      against the non-speculative one on the card (tokens exact), every
      verify leaving the pool as it was but for its committed positions;
      then one request through the non-speculative engine, an all-reject
      speculative run (the reference's ``spec_reject``, every verify forced
      to accept nothing) and an accepting run: the prompt's positions
      byte-equal, and the whole pool equal in both runs, int8 and fp, the
      fp pool also in bf16 (asserted: the paged decode and the verify take
      the row-invariant products); lane 0 of a [2, 5] window against
      [2, 1] rows bit-equal in the four weight products on that route and
      in ln1 -> qkv and ln2 -> fc1 with the LayerNorm prologue (asserted,
      fp32 and bf16; cuBLAS's reported beside them).  The
      engines' prefill waves and chunks run as graphs, each step captured
      once;
  (z) the slot-contiguous ``ServingEngine(slots=8, max_len=512)`` on
      (d)'s weights and 12 requests x 32 tokens, after ``warmup()``, in
      bf16 and then with ``quant="int8"``: ``decode_compiles`` 1,
      ``prefill_compiles`` the rungs warmup reached, no capture during the
      traffic, launches zeroed before it equal to 2L + 1 LayerNorms and
      (int8) 4L dequant matmuls a forward; decode-step ms, wave ms,
      tokens/s and ``kv_bytes_reserved`` printed beside (d)'s and (j)'s
      paged engines (the reference bench's base and paged phases); then
      fp32 at V=4096, H=256, 2 layers, the engine on the card against the
      CPU (tokens exact, logits within 1e-3), its decode replays against
      the eager ``gpt.decode_step_slots`` and its wave replays against
      the eager ``_prefill`` on clones of the pool (tokens and pool bytes
      equal);
  (aa) ``bench.py``'s third line, the ResNet50 static train step, through
      the port: ``enable_static``, ``static.Program`` and
      ``program_guard``, ``static.data``, ``resnet50(num_classes=1000)``
      under ``amp.auto_cast()`` (bf16), cross entropy, Momentum(0.002,
      0.9, weight decay 1e-4) ``minimize``, ``Executor.run(startup)``;
      224 x 224, batch 128, device feeds, weights from a seed; the fetch
      and the fetchless run once each, then 10 timed steps ending in one
      fetch.  The loss must be finite and fall, the Executor build exactly
      twice, none in the timed steps.  Prints imgs/s, ms a step, the
      model-FLOP share (3 x 2 x 4.09e9 FLOPs an image over 989 TFLOP/s)
      and the peak of ``max_memory_reserved``; with ``--profile-train
      STEPS`` also STEPS fetchless steps traced (idle share, leading
      kernels);
  (ab) ResNet50 (10 classes) at 32 x 32, batch 4, one static step on the
      card (cuDNN, TF32 off) against the CPU from the same weights: loss
      and every parameter and buffer at rtol 1e-4, atol 1e-5, asserted in
      float64 and reported in fp32 (ill-conditioned there);
  (ac) LeNet on the synthetic MNIST through ``io.DataLoader``, 40 dygraph
      Adam steps on the card; the loss must fall;
  (ad) the eager tensor API swept op by op (``tools/op_sweep.py``, the
      tables the CPU tests hold against the JAX package): every case of
      the ``paddle.*`` ops, the Tensor's methods and operators
      (``__setitem__`` with its gradient included), the activations, the
      losses and their layers with its inputs on the card, against the
      same case on the CPU: fp32 within the case's tolerance x max|ref|
      (1e-5; 1e-4 for linear algebra and ``ctc_loss``, decompositions
      through their values and reconstructions), integer, bool and index
      outputs exact, every output on the card, and the gradient of
      sum(out * w) within the same tolerance; the random ops in shape,
      dtype, range, one seed one draw on the card, and a two-sample
      moment check against the CPU's draw.  Prints the ops and cases
      checked and every reference op left out with its reason;
  (ae) ERNIE-3.0-Base (``ErnieModel`` pooled -> ``Linear(768, 16)``)
      fine-tuned as a 16-label classifier by a hand-written eager loop:
      B = 64, N = 512, bf16 compute over fp32 params, remat, flash,
      ``BCEWithLogitsLoss`` on labels drawn from the seed, AdamW (weight
      decay 0.01, ``ClipGradByGlobalNorm(1.0)``) on ``LinearWarmup`` to
      1e-4; one warm-up and 10 timed steps, exact flash launch counts
      (2L forwards, L dq, L dk/dv a step), a falling loss; then the
      predictions by ``F.sigmoid``, ``paddle.greater_than`` and
      ``paddle.cast``, micro-F1 from ``paddle.logical_and`` and
      ``paddle.sum`` and each row's top 3 labels by ``paddle.topk``.
      Prints step ms, tokens/s, the model-FLOP share and
      ``max_memory_allocated``; with ``--profile-train STEPS`` also STEPS
      steps traced;
  (af) (ae) in fp32 at ERNIE widths with 2 layers, [4, 256], 3 steps at
      learning rate 1e-4 on the card (kernels) and on the CPU (plain
      versions) from the same numpy-drawn weights: the three steps'
      losses and the loss after the third update within 1e-5
      (relative), every parameter
      within 1e-5 of its leaf's max|param|, flash launches exact; the
      predictions, F1 and top-3 labels reported;
  (ag) ``paddle.jit.to_static`` of (n)'s encoder at ERNIE-3.0-Base
      widths, [8, 512] token ids, ``eval()``, ``no_grad``, fp32 then
      bf16 (one CUDA graph per dtype, the bf16 one captured after
      ``Layer.to`` rebinds the weights): 5 timed replays alternated with
      (n)'s eager forward on the same batches, each replay launching
      exactly 2L LayerNorm, L flash forward and 1 RMSNorm kernels, the
      final norm output and logits against the eager forward's (bit
      equality reported; fp32 within (o)'s tolerances, bf16 within two
      bf16 steps of max|ref|), ``cache_stats()`` with one capture a
      dtype, hits equal to the replays and no fallback; a second shape
      [4, 256] captures a second graph without evicting the first; an
      in-place update of the head's bias shows in the next replay;
      ``jit.save`` then ``jit.load`` of the bf16 model gives the same
      outputs.  Prints ms a batch, tokens/s and the ratio to eager;
  (ah) the profiler around 3 eager bf16 forwards of (ag)'s model: the 10
      ops with the most host us a call and the host us a forward; the
      chrome trace reads back with one event per dispatched op, and a
      ``log_dir`` run writes a device trace with kernel events; with
      ``enable_check_nan_inf``, an inf written into one weight raises
      ``NanInfError`` naming the first op with a non-finite output;
      ``check_numerics`` inside a ``to_static`` graph raises at the call
      that replays it and not with finite weights;
  (ai) a static ``Program`` with ``while_loop`` (a fixed-point
      iteration), ``cond`` and ``switch_case`` replayed by the
      ``Executor`` on the card against the CPU (integers exact, floats
      within 1e-5 of max|ref|); ``to_static`` of a function with ``cond``
      on a tensor predicate against its eager result; a training-mode
      ``to_static`` forward with dropout 0.1 drawing different masks on
      two replays and the first again after re-seeding; ``static.save`` /
      ``load`` and ``serialize_persistables`` round-tripping a program's
      parameters on the card;
  (aj) ``inference.save_inference_model`` of (n)'s encoder at full width,
      fp32 and bf16, ``InputSpec([None, 512])`` (``dynamic_batch``), served
      by ``create_predictor`` with ``enable_use_gpu`` in a fresh process
      that imports no model code, at batches 8, 5 and 8: 2L LayerNorm, L
      flash-forward and 1 RMSNorm ``torch.library`` nodes in the graph and
      no plain attention or LayerNorm op, one CUDA graph for the 8-bucket
      (``standalone_compiles`` 1), 2L / L / 1 launches a pass (batch 5:
      two probe passes), the same bits as this process's artifact, which
      agrees with the eager forward (bitwise, or (o)'s / (ag)'s
      tolerances); the Predictor's replay, ``to_static`` and eager timed
      alternated; ``Predictor.from_layer`` and a ``jit.save`` pair equal to
      eager; (aa)'s ResNet50 eval clone through
      ``static.save_inference_model`` / ``load_inference_model`` against
      its own fetch;
  (ak) (aa)'s ResNet50 train program fed by ``fluid.layers`` ``py_reader``
      + ``double_buffer`` for 3 steps, ``EOFException``, ``reset()``,
      against ``exe.run(feed=...)`` from the same seed (cuDNN
      deterministic); Paddle's CTR-DNN through ``train_from_dataset`` over
      a ``QueueDataset`` of MultiSlot files, card against CPU within 1e-5
      of max|loss|, steps/s and the reader's wait share;
      ``infer_from_dataset`` keeping every parameter bit;
  (al) on (ae)'s classifier in fp32: ``GradientMergeOptimizer(AdamW,
      k_steps=2)`` against one step of the whole batch (1e-5 of
      max|param|), ``LookAhead(k=2)`` against its update by hand,
      ``ModelAverage`` / ``ExponentialMovingAverage`` ``apply`` /
      ``restore`` bitwise, ``CheckpointManager(async_save=True)`` saved at
      step 2 with step 3 launched before ``wait()`` and resumed in a fresh
      model (1e-6 of max|param|); ``incubate.fused_feedforward`` at (l)'s
      shape, one FFN launch.
  (ap) MobileNet-SSD300 as PaddleCV's object_detection example builds it
      (MobileNetV1 x1.0, four extra blocks, ``fluid.layers.multi_box_head``
      over six maps, 1,917 priors, 21 classes), a static program trained
      by RMSProp (lr 1e-3, L2 5e-5) at batch 64 on 300 x 300 images made
      by ``transforms.Resize`` + ``Normalize``: one warm-up step and 8
      timed, the loss finite and falling; kernel launches a step and the
      idle share from one profiled step; ``detection_output`` at batch 64
      (nms 0.45) timed with the NMS's share, kept boxes an image; card
      against CPU in fp32 on 2 images: the loss within 1e-5, gradients
      within 1e-4 of the largest, the NMS rows and kept indices equal (on
      each device's own outputs, parted only at a CPU margin under 1e-4);
  (aq) MobileNetV2 x1.0 fit through ``DatasetFolder`` (1,024 synthetic
      256 x 256 ``.npy`` images) -> RandomResizedCrop(224),
      RandomHorizontalFlip, Normalize, Transpose -> ``io.DataLoader``
      (batch 128, 4 workers) -> ``Model.fit`` (Momentum 0.9): imgs/s, step
      ms, the host's wait on the loader, peak memory; a batch normalised
      per image and by one ``runtime.preprocess_images`` call (ms, equal);
      VGG16's eval forward at [64, 3, 224, 224] in fp32 and bf16; card
      against CPU on 2 images: both models' logits within 1e-4 of max and
      one MobileNetV2 training step as in (ap);
  (ar) every public function of ``vision.ops`` and ``vision.detection``
      (but ``multi_box_head``, which (ap) drives, and the host image io)
      on the card against the CPU at the shapes of named models (YOLOv3-608's
      three heads, ResNet-50 res5's deformable 3 x 3, the RPN at 800 x 1088,
      the SSD's 1,917 priors, RetinaNet's P3-P7): outputs and gradients
      within 1e-5 of max, indices and counts equal, each one's ms.
  (as) the WordPiece tokenizer on the host: a 40,000-entry vocabulary
      (ERNIE 3.0's size: special tokens, punctuation, CJK characters,
      whole words, ``##`` pieces) and 8,192 documents of 100-400 words
      drawn with Zipf frequencies (mixed case, punctuation, accented and
      CJK characters, control characters), all from a numpy seed;
      ``text.FullTokenizer``'s native path (the default) and its Python
      path over the whole corpus, tokens a second each, ids equal;
  (at) a QAT fine-tune at ERNIE-3.0-Base width: (n)'s encoder (V =
      40,000, H = 768, L = 12) with a ``Linear(768, 2)`` head on the first
      position, ``QAT(QuantConfig()).quantize`` wrapping all 73 Linears,
      AdamW on ``LinearWarmup`` to 5e-5 (the first steps of a 3-epoch
      fine-tune over (as)'s corpus with a 10% warm-up) under
      ``amp.auto_cast`` bf16 on one batch of [32, 128] rows of (as)'s ids
      (PaddleNLP text classification's defaults; a row's label 1 where
      its first id is a multiple of 8), one warm-up step and 10 timed
      steps alternated with the unwrapped model's: step ms, tokens/s,
      the ratio, the batch's loss without dropout falling, the memory
      peak, exact
      launches (L flash forwards, L dq, L dk/dv; no norm kernel: the
      training route records the norms' plain versions); then
      ``QAT.convert`` and 8 int8 eval batches (int8 x int8 -> int32
      products) alternated with the float model's: ms a batch, exact
      launches (2L LayerNorm, L flash, 1 RMSNorm a forward), the share of
      predictions agreeing with the fake-quantised forward; then PTQ of a
      fresh copy calibrated on 8 batches, ``save_quantized_model`` (a
      ``torch.export`` artifact) and one batch through
      ``inference.create_predictor``, its logits within 1e-5 of max of
      the in-process int8 forward's;
  (au) (at) in fp32 at 2 layers, [4, 128], card against CPU on the same
      numpy weights: three QAT steps' losses within 1e-5 relative, every
      parameter within 1e-5 of its leaf's max, the observers' scales
      within 1e-5, the converted int8 logits within 1e-5 of max, PTQ's
      int8 weights equal and its scales within 1e-5; fake quantisation
      turns fp32 differences into whole steps where a quotient sits on a
      rounding boundary, so the CPU takes the card's rounding at such
      ties (every rounding of ``quantization``, the conversion's weights
      too, goes through its ``_round_clip``; within 3e-3 of a step from
      the boundary, at most 2e-5 of the values; counted), and any other
      difference of rounding fails the phase; the largest card-CPU
      quotient gap of each stage is printed;
  (av) PaddleNLP's lexical-analysis BiGRU-CRF on the 2.x API
      (``Embedding(20940, 128)``, ``nn.GRU(128, 128, num_layers=2,
      direction="bidirect")``, ``Linear(256, 59)``,
      ``text.ViterbiDecoder`` with BOS/EOS) at batch 300, lengths 8-64,
      eval fp32: ms a batch, sentences a second, the Viterbi's share;
      card against CPU on the same numpy weights: paths exact, scores
      within 1e-5 relative, and a batch of integer emissions (ties)
      exact.

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
LayerNorm also at the prefill chunk's [1, 16, 1024] and the verify's
[8, 5, 1024], the 345M training rows [8, 1024, 1024], H = 6, 7, 1001
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
(1024, 4096), the prefill chunk's M = 16 at (1024, 3072) and (4096, 1024),
the verify's M = 40 at all four weights, and the JAX tests' shapes, each
also timed against cuBLAS on weights dequantized beforehand; int8 paged
attention at the serving decode shape, the JAX tests' shapes, a lane of
length 0, hd 24 and 80, 16 ragged slots over 64 pages and one slot of
8,191 positions (V with a mean per channel in the last two).  The fp
paged attention cases are also timed on the int8 kernel's grid-sized
split plan (``grid_plan_ms``) beside their own.

Before its last line it prints one JSON object ``{"kernels": [...]}`` (the
three flash rows with their launches on each training path, among them
``launches_eager_ernie``, ``launches_eager_encoder``, ``launches_hapi``,
``launches_hapi_eval``, (ae)'s ``launches_multilabel``, (ag)'s
``launches_to_static``, (aj)'s ``launches_predictor`` and (at)'s
``launches_qat`` and ``launches_int8_eval``, which the LayerNorm and
RMSNorm rows carry too (the int8 eval's), and (al)'s
``launches_gradient_merge``; the fused FFN's ``launches_incubate``;
the serving
rows with ``launches_chunked``,
``launches_chunked_quant``, ``launches_spec``, ``launches_spec_quant``,
the dequant matmul's ``launches_spec_quant_m40`` and (z)'s
``launches_slot`` and ``launches_slot_quant``) and the
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
import gc
import io
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
BF16_STEPS_TOL = 2.0 ** -6    # (ag): bf16 replay vs eager, x max|ref|
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
              "15paged_decode_q8I", "ln_row_mm_tc", "row_mm_tc")
# the serving kernels redesigned for Hopper: (b) fails if one spills
NO_SPILL = ("dqmm_stream", "dqmm_wg", "12paged_decodeI",
            "15paged_decode_q8I", "ln_row_mm_tc", "row_mm_tc")


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
    # 345M paths' fp32 masters) or weights in the compute dtype (the
    # flagship's and (am)'s bf16 params); and (am)'s bf16 decode, where
    # gen_cache's float32 caches promote x to fp32 under bf16 g and b
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

    ln_cases = []
    for shape, name, own, kind in (
            ((16, 1, 1024), "decode 16 rows", False, None),
            ((4, 256, 1024), "prefill 4x256 rows", False, None),
            ((8, 1, 1024), "decode 8 rows (serving)", False, None),
            ((1, 16, 1024), "prefill chunk 16 rows (w)", False, None),
            ((8, 5, 1024), "verify 8 x 5 rows (x)", False, None),
            ((6, 2048, 2048), "flagship, g b in x's dtype", True, None),
            ((8, 1024, 1024), "345M training rows", False, None),
            ((8, 512, 768), "encoder, g b in x's dtype", True, None),
            ((8, 32, 512), "(am) encoder, g b in x's dtype", True, None),
            ((32, 1, 512), "(am) decode, g b in x's dtype", True, None),
            ((2, 6), "H=6, one-element loads", True, None),
            ((3, 7), "H=7, one-element loads", True, None),
            ((5, 1001), "H=1001, one-element loads", True, None),
            ((2, 70001), "H=70001, rows read thrice", True, None),
            ((768, 512), "transposed view", True, "T"),
            ((512, 768), "view 4 bytes off alignment", True, "+4")):
        ln_cases += [(shape, name, dt, dt if own else f32, kind)
                     for dt in (f32, bf16)]
    ln_cases.append(((32, 1, 512), "(am) bf16 decode, x promoted, g b bf16",
                     f32, bf16, None))
    for shape, name, dt, gdt, kind in ln_cases:
        g = torch.randn(shape[-1], device="cuda").to(gdt)
        b = torch.randn(shape[-1], device="cuda").to(gdt)
        sets = [(view_of((torch.randn(shape, device="cuda") * 2
                          + 1).to(dt), kind), g, b)
                for _ in range(l2_copies(math.prod(shape) * 4))]
        x = sets[0][0]
        got = norms.layer_norm(x, g, b)
        torch.cuda.synchronize()
        ref = norms._ref_layer_norm(x, g, b, 1e-5)
        tol = FP32_TOL if dt == f32 else 2.0 ** -7 * max(
            1.0, float(ref.float().abs().max()))
        ratio, mutant = gate([(got, ref, ref)], tol, 0.0, rows=later_rows)
        gl, bl = g.to(dt), b.to(dt)
        bound, by = norm_bound(x, g, 2, 8)
        out["layer_norm"].append(
            {"shape": f"{list(shape)} ({name})", "dtype": str(dt),
             "g_dtype": str(gdt), "max_abs_err": max_err(got, ref),
             "max_abs_ref": float(ref.float().abs().max()),
             "atol": tol, "rtol": 0.0, "gate": ratio, "mutant_gate": mutant,
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
            log(f"  {k:16s} {c['dtype']:15s} "
                + (f"g {c['g_dtype']:15s} " if "g_dtype" in c else "")
                + f"{c['shape'][:46]:46s} max_abs_err "
                f"{c['max_abs_err']:.3e} gate {c['gate']:.3f} (atol "
                f"{c['atol']:.1e} rtol {c['rtol']:.1e}; max|ref| "
                f"{c['max_abs_ref']:.2e}; wrong-scale mutant "
                f"{c['mutant_gate']:.2f})"
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


# (am)'s shapes and the seq2seq path's others: [B, N, Nk, nh, hd, causal]
# (the decode steps' one query row is held in the forward alone: the
# decode runs under no_grad)
SEQ2SEQ_SHAPES = [((128, 32, 32, 8, 64, False), "(am) training, self and "
                   "cross attention"),
                  ((32, 24, 40, 8, 64, False), "cross, Nq < Nk"),
                  ((32, 40, 24, 8, 64, False), "cross, Nq > Nk"),
                  ((32, 1, 1, 8, 64, False), "decode step 1"),
                  ((32, 1, 33, 8, 64, False), "decode step 33"),
                  ((32, 1, 82, 8, 64, False), "decode step 82, (am)'s last")]


# phase (c)'s flash shapes: [B, N, Nk, nh, hd, causal], and what each is
FLASH_SHAPES = [(TRAIN_SHAPE, "training"),
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
                *WIDE_SHAPES, *SEQ2SEQ_SHAPES]


def flash_rows(N, Nk):
    """The mutants' rows: past the first tile and the second warpgroup's
    (:data:`FLASH_ROWS`) where the rows reach them; below 128 rows on
    either side, every batch but the first (the launch's later CTAs)."""
    return FLASH_ROWS if min(N, Nk) >= 128 else (later_slots,)


def check_flash_promoted(torch, flash_attn):
    """Phase (c): the nn functional's promoted call, a bf16 query against
    float32 k and v (a bf16 decode step against ``gen_cache``'s float32
    caches), at the decode's [32, 1, 8, 64] x Nk 33: the kernels' fp32
    forward on the promoted operands, its float32 output against
    ``_ref_flash_fwd`` on them, one launch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.nn.functional import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED + 69)
    sets = []
    for _ in range(2):
        q = torch.randn(32, 1, 8, 64, device="cuda", generator=gen).to(
            torch.bfloat16)
        k, v = (torch.randn(32, 33, 8, 64, device="cuda", generator=gen)
                for _ in range(2))
        sets.append((q, k, v))
    q, k, v = sets[0]
    before = flash_attn.fwd_launches
    got = flash_attention(pt.to_tensor(q), pt.to_tensor(k), pt.to_tensor(v))
    torch.cuda.synchronize()
    launched = flash_attn.fwd_launches - before
    ref = flash_attn._ref_flash_fwd(q.float(), k, v, False)[0]
    ratio, mutant = gate([(got.value, ref, ref)], FP32_TOL, 0.0,
                         rows=(later_slots,))

    def promoted(q, k, v):
        return flash_attn.flash_attention(*attention._promoted(q, k, v))
    bounds = flash_bounds(q.float(), k, False)
    case = {"shape": "[32, 1, 8, 64] kv 33 full (promoted mixed-dtype "
                     "call: q bf16, k/v fp32)",
            "dtype": "torch.float32", "out_dtype": str(got.value.dtype),
            "launches": launched, "max_abs_err": max_err(got.value, ref),
            "mean_abs_ref": float(ref.abs().mean()), "atol": FP32_TOL,
            "rtol": 0.0, "gate": ratio, "mutant_gate": mutant,
            "ms": device_ms(promoted, sets),
            "call_ms": time_ms(promoted, sets, 50),
            "plain_ms": device_ms(lambda q, k, v: flash_attn._ref_flash_fwd(
                q.float(), k, v, False), sets),
            "library_ms": device_ms(lambda q, k, v: library_attention(
                q.float(), k, v, False), sets),
            "bound_ms": bounds["fwd"][0], "bound_by": bounds["fwd"][1]}
    # the reference's plain attention rounds the probabilities to q's
    # bf16 before p . v; the fp32 kernel does not (ROADMAP Queue 3): the
    # gap must stay within one rounding's reach, bf16's unit roundoff
    # 2^-8 of sum_j p_j |v_j|
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(
        q.shape[-1])
    p = torch.softmax(logits, -1).to(q.dtype).float()
    like_ref = torch.einsum("bhqk,bkhd->bqhd", p, v)
    reach = 2.0 ** -8 * flash_attn._ref_flash_fwd(q.float(), k, v.abs(),
                                                  False)[0]
    case["reference_gap"] = max_err(got.value, like_ref) / float(
        like_ref.abs().max())
    case["reference_gap_over_reach"] = float(
        ((got.value - like_ref).abs() / reach).max())
    if (got.value.dtype != torch.float32 or launched != 1
            or case["reference_gap_over_reach"] > 1.0):
        case["gate"] = float("inf")
    return case


def check_flash_bwd(torch, flash_attn, out, sets, o, lse, causal, gated,
                    common, bounds, lib_fwd, plain_kw):
    """Phase (c): the dq and dk/dv kernels on ``sets`` against
    ``_ref_flash_bwd`` (given the kernel's out and lse), appended to
    ``out``."""
    q, k, v, do = sets[0]
    hd = q.shape[-1]
    # (q, k, v, dO, lse, delta, causal, scale), as the wrapper passes them
    bwd_sets = kernel_bwd_sets(flash_attn, sets, o, lse, causal)
    dq = unpad(flash_attn._launch_dq(*bwd_sets[0]), hd)
    dk, dv = (unpad(t, hd) for t in flash_attn._launch_dkv(*bwd_sets[0]))
    torch.cuda.synchronize()
    rdq, rdk, rdv = flash_attn._ref_flash_bwd(q, k, v, o, lse, do, causal)
    # bf16 gradients: rtol scales the magnitude of the terms each sums
    # (|ds| |k|, |ds|^T |q|, |p|^T |dO|), not |ref|
    tdq, tdk, tdv = ((rdq, rdk, rdv) if q.dtype == torch.float32 else
                     flash_attn._ref_flash_bwd_terms(q, k, v, o, lse, do,
                                                     causal))
    plain_bwd = [(a, b, c, o, lse, d, causal) for a, b, c, d in sets]
    lib_sets = [(a.detach().requires_grad_(), b.detach().requires_grad_(),
                 c.detach().requires_grad_(), d, causal)
                for a, b, c, d in sets]
    lib_bwd = max(device_ms(library_attention_fwd_bwd, lib_sets) - lib_fwd,
                  0.0)
    plain_bwd_ms = device_ms(flash_attn._ref_flash_bwd, plain_bwd,
                             **plain_kw)
    out["flash_attention_bwd_dq"].append({
        **common, **gated([(dq, rdq, tdq)], FLASH_GRAD_TOL),
        "ms": device_ms(flash_attn._launch_dq, bwd_sets),
        "call_ms": time_ms(flash_attn._launch_dq, bwd_sets, 50),
        "plain_ms": plain_bwd_ms, "library_ms": lib_bwd,
        "bound_ms": bounds["dq"][0], "bound_by": bounds["dq"][1]})
    out["flash_attention_bwd_dkv"].append({
        **common, **gated([(dk, rdk, tdk), (dv, rdv, tdv)], FLASH_GRAD_TOL),
        "ms": device_ms(flash_attn._launch_dkv, bwd_sets),
        "call_ms": time_ms(flash_attn._launch_dkv, bwd_sets, 50),
        "plain_ms": plain_bwd_ms, "library_ms": lib_bwd,
        "bound_ms": bounds["dkv"][0], "bound_by": bounds["dkv"][1]})


def check_flash(torch, flash_attn):
    """Phase (c), flash attention: the forward wrapper and the two backward
    kernels against ``_ref_flash_fwd`` / ``_ref_flash_bwd`` on the same
    inputs (the backward's plain version gets the kernel's out and lse),
    at every shape of ``FLASH_SHAPES`` (the backward's not at one query
    row: the decode runs no backward), and the promoted call.  Returns
    {kernel: [case, ...]}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out = {"flash_attention_fwd": [], "flash_attention_bwd_dq": [],
           "flash_attention_bwd_dkv": []}
    for (B, N, Nk, nh, hd, causal), name in FLASH_SHAPES:
        big = B * N * Nk * nh >= 2 ** 26
        plain_kw = dict(per_graph=4, replays=5) if big else {}
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            sets = flash_sets(torch, gen, dt, B, N, Nk, nh, hd, 2)
            q, k, v, do = sets[0]
            o, lse = flash_attn.flash_fwd(q, k, v, causal)
            torch.cuda.synchronize()
            ro, rl = flash_attn._ref_flash_fwd(q, k, v, causal)

            def gated(pairs, fp32_atol):
                atol, rtol = ((fp32_atol, 0.0) if f32
                              else (BF16_ATOL, BF16_RTOL))
                ratio, mutant = gate(pairs, atol, rtol,
                                     rows=flash_rows(N, Nk))
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
            lib_fwd = device_ms(library_attention, fwd_sets)
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
            if N > 1:
                check_flash_bwd(torch, flash_attn, out, sets, o, lse,
                                causal, gated, common, bounds, lib_fwd,
                                plain_kw)
            del sets, fwd_sets
            torch.cuda.empty_cache()
    out["flash_attention_fwd"].append(check_flash_promoted(torch,
                                                           flash_attn))
    for k, cases in out.items():
        for c in cases:
            log(f"  {k:24s} {c['dtype']:15s} {c['shape']:46s} "
                f"max_abs_err {c['max_abs_err']:.3e} gate {c['gate']:.3f} "
                f"(atol {c['atol']:.1e} rtol {c['rtol']:.1e}; mean|ref| "
                f"{c['mean_abs_ref']:.3e}; wrong-scale mutant "
                f"{c['mutant_gate']:.2f})"
                + (f" lse_err {c['lse_err']:.1e}" if "lse_err" in c else "")
                + (f"; against the reference's bf16 probabilities "
                   f"{c['reference_gap']:.2e} of max|out|, "
                   f"{c['reference_gap_over_reach']:.3f} of one rounding's "
                   f"reach" if "reference_gap" in c else "")
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
    return (c["gate"] <= 1.0 and c["mutant_gate"] > 1.0
            and c.get("lse_err", 0.0) <= c.get("lse_tol", 0.0))


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


# the four float weight products of a gpt_345m block (K, N, name) and the
# row counts the paged decode (8 slots) and the fp verify (8 slots x
# SPEC_K + 1 lanes) give them; (c) checks row invariance at ROW_MS (320:
# 64 slots x a window of 5)
ROW_SHAPES = ((1024, 3072, "qkv"), (1024, 1024, "proj"),
              (1024, 4096, "fc1"), (4096, 1024, "fc2"))
ROW_MS = (1, 2, 8, 10, 40, 64, 320)


def row_mm_bound(M, K, N, dt):
    """Least time for x [M, K] @ W [K, N]: x, W and y read or written once
    over the HBM rate, or 2MKN flops over the dtype's peak."""
    import torch
    e = 2 if dt == torch.bfloat16 else 4
    byts = (M * K + K * N + M * N) * e
    rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_f = byts / HBM_BYTES_PER_S, 2 * M * K * N / rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def check_row_matmul(torch, row_matmul):
    """Phase (c), the row-invariant matmul: the kernel against
    ``_ref_matmul`` (``x @ w``, cuBLAS reducing bf16 in fp32) on the same
    inputs at the four block products of gpt_345m, at the decode's M = 8
    and the verify's M = 40, fp32 and bf16 (fp32 within 1e-5 of max|ref|;
    bf16 per element within 2^-8 + 2^-6 |ref|, the dequant matmul's gate:
    both sum in fp32 in other orders, then round once, so an output that
    cancels can differ by more than one step of its own size; each gate
    rejects the later-rows mutant).  bf16 runs both routes on the same
    inputs: the wrapper's (the tensor cores, ``row_mm_tc``) and the
    CUDA-core kernel (``row_mm``, fp32's route), each a case of its own.
    Row invariance, asserted: for M in ``ROW_MS`` every row of the
    kernel's [M, N] output is bit-equal to the M = 1 launch on that row
    alone, on every route (cuBLAS's rows reported beside it).  Timed by
    CUDA-graph replay over copies of W that pass the L2, with the plain
    version and ``torch.mm``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    f32, bf16 = torch.float32, torch.bfloat16
    out = []
    for dt in (bf16, f32):
        for K, N, name in ROW_SHAPES:
            w = (torch.randn((K, N), device="cuda", generator=gen)
                 * 0.02).to(dt)
            xs = torch.randn((max(ROW_MS), K), device="cuda",
                             generator=gen).to(dt)
            route = row_matmul._args(xs, w)[0]
            routes = [route] + (["cuda_core"] if route != "cuda_core"
                                else [])
            rows_equal = {r: {} for r in routes}
            with torch.inference_mode():
                for r in routes:
                    ones = torch.cat([row_matmul._launch(xs[i:i + 1], w, r)
                                      for i in range(xs.shape[0])])
                    for M in ROW_MS:
                        got = row_matmul._launch(xs[:M], w, r)
                        rows_equal[r][M] = bool(torch.equal(got, ones[:M]))
                cublas_ones = torch.cat([xs[i:i + 1] @ w
                                         for i in range(xs.shape[0])])
                cublas_rows = {M: int((xs[:M] @ w != cublas_ones[:M])
                                      .any(-1).sum()) for M in ROW_MS}
            for M in (8, 40):
                sets = [((torch.randn((M, K), device="cuda", generator=gen)
                          ).to(dt), (w if i == 0 else w.clone()))
                        for i in range(l2_copies(K * N * w.element_size()))]
                x, wk = sets[0]
                with torch.inference_mode():
                    torch.cuda.synchronize()
                    with fp32_reduction(torch):
                        ref = row_matmul._ref_matmul(x, wk)
                    plain_ms = device_ms(row_matmul._ref_matmul, sets)
                    library_ms = device_ms(torch.mm, sets)
                if dt == f32:
                    atol, rtol = FP32_TOL * float(ref.abs().max()), 0.0
                else:
                    atol, rtol = 2.0 ** -8, 2.0 ** -6
                bound, by = row_mm_bound(M, K, N, dt)
                for r in routes:
                    def launch(a, b, r=r):
                        return row_matmul._launch(a, b, r)
                    with torch.inference_mode():
                        got = launch(x, wk)
                        torch.cuda.synchronize()
                        ratio, mutant = gate([(got, ref, ref)], atol, rtol,
                                             rows=later_rows)
                        tag = "" if r == route else ", CUDA-core route"
                        out.append({
                            "shape": f"[{M}, {K}] x [{K}, {N}] ({name}{tag})",
                            "dtype": str(dt), "route": r,
                            "max_abs_err": max_err(got, ref),
                            "atol": atol, "rtol": rtol, "gate": ratio,
                            "mutant_gate": mutant,
                            "rows_bit_equal_to_m1": rows_equal[r],
                            "cublas_rows_differing_from_m1": cublas_rows,
                            "ms": device_ms(launch, sets),
                            "call_ms": time_ms(row_matmul.matmul if r == route
                                               else launch, sets, 500),
                            "plain_ms": plain_ms, "library_ms": library_ms,
                            "bound_ms": bound, "bound_by": by})
                del sets
    for c in out:
        log(f"  {'row_matmul':16s} {c['dtype']:15s} {c['shape']:54s} "
            f"max_abs_err {c['max_abs_err']:.3e} gate {c['gate']:.3f} "
            f"(atol {c['atol']:.1e} rtol {c['rtol']:.1e}; wrong-scale "
            f"mutant {c['mutant_gate']:.2f})  device ms: kernel "
            f"{c['ms']:.5f}  plain {c['plain_ms']:.5f}  library (torch.mm) "
            f"{c['library_ms']:.5f}  bound {c['bound_ms']:.6f} "
            f"({c['bound_by']}); eager call {c['call_ms']:.5f}; rows "
            f"bit-equal to M = 1 at M = {ROW_MS}: "
            f"{list(c['rows_bit_equal_to_m1'].values())} (cuBLAS rows that "
            f"differ: {list(c['cublas_rows_differing_from_m1'].values())})")
    tc = {c["shape"]: c for c in out if c["route"] == "tensor"}
    for c in out:
        if c["route"] == "cuda_core" and c["dtype"] == str(bf16):
            t = tc[c["shape"].replace(", CUDA-core route", "")]
            log(f"  row_matmul bf16 {t['shape']}: tensor-core route "
                f"{t['ms']:.5f} ms, CUDA-core route {c['ms']:.5f} ms "
                f"({c['ms'] / t['ms']:.2f}x), torch.mm {t['library_ms']:.5f}"
                f" ({t['ms'] / t['library_ms']:.2f}x of it), bound "
                f"{t['bound_ms']:.6f}")
    bad = [(c["shape"], c["dtype"]) for c in out
           if not case_ok(c) or not all(c["rows_bit_equal_to_m1"].values())]
    if bad:
        raise SystemExit(f"row_matmul disagrees with its plain version, its "
                         f"gate passes the mutant, or a row's bits depend on"
                         f" M: {bad}")
    return {"row_matmul": out}


# the two products that take the LayerNorm as their prologue on the paged
# decode and the fp verify (K, N, name), timed; and shapes off TMA's
# alignment (the tensor route at K 1032, N 1000; the CUDA cores at K 1030,
# N 1001), checked but not timed
LN_SHAPES = ((1024, 3072, "qkv"), (1024, 4096, "fc1"))
LN_ODD = ((1032, 1000, "K, N off 64"), (1030, 1001, "K, N off 8"))
LN_EPS = 1e-5


def ln_mm_bound(M, K, N, dt, gdt):
    """Least time for LayerNorm(x; g, b) [M, K] @ W [K, N]: x, g, b and W
    read and y written once over the HBM rate, or the product's 2MKN flops
    over the dtype's peak plus the LayerNorm's 8MK over the fp32 rate."""
    import torch
    e = 2 if dt == torch.bfloat16 else 4
    ge = 2 if gdt == torch.bfloat16 else 4
    byts = (M * K + K * N + M * N) * e + 2 * K * ge
    rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b = byts / HBM_BYTES_PER_S
    t_f = 2 * M * K * N / rate + 8 * M * K / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def check_ln_matmul(torch, row_matmul, norms):
    """Phase (c), the row product with its LayerNorm prologue
    (``ln_matmul``: ``ln_row_mm_tc`` on the tensor cores, ``ln_row_mm`` on
    the CUDA cores) against its plain version ``_ref_ln_matmul``
    (``_ref_layer_norm`` then ``x @ w``) on the same inputs at qkv and fc1
    of gpt_345m, M = 8 and 40: bf16 x with g and b fp32 (the model's) and
    bf16, on both routes, and fp32, at the row product's tolerances (fp32
    1e-5 of max|ref|; bf16 per element 2^-8 + 2^-6 |ref|; each gate
    rejects the later-rows mutant).  Row invariance, asserted: at those
    shapes and ``LN_ODD``'s, every row of an [M, N] launch bit-equal to the
    M = 1 launch on that row for M in ``ROW_MS``.  Timed by CUDA-graph
    replay over copies that pass the L2, beside the two launches it
    replaces (``norms.layer_norm`` and the row product on the same route),
    the row product alone, the plain version and ``F.layer_norm`` +
    ``torch.mm``."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    f32, bf16 = torch.float32, torch.bfloat16
    out = []

    def operands(M, K, N, dt, gdt, w=None):
        x = (torch.randn((M, K), device="cuda", generator=gen) * 2
             + 0.5).to(dt)
        g = (1 + 0.1 * torch.randn(K, device="cuda", generator=gen)).to(gdt)
        b = (0.1 * torch.randn(K, device="cuda", generator=gen)).to(gdt)
        if w is None:
            w = (torch.randn((K, N), device="cuda", generator=gen)
                 * 0.02).to(dt)
        return x, g, b, w

    for dt, gdt in ((bf16, f32), (bf16, bf16), (f32, f32)):
        for K, N, name in LN_SHAPES + LN_ODD:
            timed = (K, N, name) in LN_SHAPES
            xs, g, b, w = operands(max(ROW_MS), K, N, dt, gdt)
            route = row_matmul._args(xs, w, ln=True)[0]
            routes = [route] + (["cuda_core"] if route != "cuda_core"
                                else [])
            rows_equal = {}
            with torch.inference_mode():
                for r in routes:
                    ones = torch.cat([row_matmul._ln_launch(
                        xs[i:i + 1], g, b, LN_EPS, w, r)
                        for i in range(xs.shape[0])])
                    rows_equal[r] = {M: bool(torch.equal(
                        row_matmul._ln_launch(xs[:M], g, b, LN_EPS, w, r),
                        ones[:M])) for M in ROW_MS}
            for M in ((8, 40) if timed else (40,)):
                sets = [operands(M, K, N, dt, gdt,
                                 w if i == 0 else w.clone())
                        for i in range(l2_copies(K * N * w.element_size()))]
                x = sets[0][0]
                with torch.inference_mode():
                    torch.cuda.synchronize()
                    with fp32_reduction(torch):
                        ref = row_matmul._ref_ln_matmul(x, g, b, LN_EPS, w)
                    sets = [(a, g, b, c) for a, _, _, c in sets]
                    if timed:
                        plain_ms = device_ms(
                            lambda a, c, d, e: row_matmul._ref_ln_matmul(
                                a, c, d, LN_EPS, e), sets)
                        gl, bl = g.to(dt), b.to(dt)
                        library_ms = device_ms(
                            lambda a, c, d, e: torch.mm(F.layer_norm(
                                a, (K,), gl, bl, LN_EPS), e), sets)
                if dt == f32:
                    atol, rtol = FP32_TOL * float(ref.abs().max()), 0.0
                else:
                    atol, rtol = 2.0 ** -8, 2.0 ** -6
                bound, by = ln_mm_bound(M, K, N, dt, gdt)
                for r in routes:
                    def launch(a, c, d, e, r=r):
                        return row_matmul._ln_launch(a, c, d, LN_EPS, e, r)

                    def two(a, c, d, e, r=r):
                        return row_matmul._launch(
                            norms.layer_norm(a, c, d, LN_EPS), e, r)
                    with torch.inference_mode():
                        got = launch(*sets[0])
                        torch.cuda.synchronize()
                        ratio, mutant = gate([(got, ref, ref)], atol, rtol,
                                             rows=later_rows)
                        # g and b are the model's fp32 unless tagged
                        tag = ("" if r == route else ", CUDA-core route") + (
                            ", g bf16" if gdt == bf16 else "")
                        c = {"shape": f"[{M}, {K}] x [{K}, {N}] ({name}{tag})",
                             "dtype": str(dt), "g_dtype": str(gdt),
                             "route": r, "max_abs_err": max_err(got, ref),
                             "atol": atol, "rtol": rtol, "gate": ratio,
                             "mutant_gate": mutant,
                             "rows_bit_equal_to_m1": rows_equal[r]}
                        if timed:
                            c.update(
                                ms=device_ms(launch, sets),
                                call_ms=time_ms(
                                    (lambda a, cc, d, e: row_matmul.ln_matmul(
                                        a, cc, d, LN_EPS, e))
                                    if r == route else launch, sets, 500),
                                two_launch_ms=device_ms(two, sets),
                                product_ms=device_ms(
                                    lambda a, cc, d, e, r=r:
                                    row_matmul._launch(a, e, r), sets),
                                plain_ms=plain_ms, library_ms=library_ms,
                                library="F.layer_norm + torch.mm",
                                bound_ms=bound, bound_by=by)
                        out.append(c)
                del sets
    for c in out:
        timing = (f"  device ms: kernel {c['ms']:.5f}  two launches "
                  f"(layer_norm + row product) {c['two_launch_ms']:.5f}  "
                  f"row product alone {c['product_ms']:.5f}  plain "
                  f"{c['plain_ms']:.5f}  library (F.layer_norm + torch.mm)"
                  f" {c['library_ms']:.5f}  bound {c['bound_ms']:.6f} "
                  f"({c['bound_by']}); eager call {c['call_ms']:.5f}"
                  if "ms" in c else "  (not timed)")
        log(f"  {'ln_row_matmul':16s} {c['dtype']:15s} {c['shape']:54s} "
            f"max_abs_err {c['max_abs_err']:.3e} gate {c['gate']:.3f} "
            f"(atol {c['atol']:.1e} rtol {c['rtol']:.1e}; wrong-scale "
            f"mutant {c['mutant_gate']:.2f}){timing}; rows bit-equal to "
            f"M = 1 at M = {ROW_MS}: "
            f"{list(c['rows_bit_equal_to_m1'].values())}")
    for c in out:
        if "ms" in c and c["dtype"] == str(bf16) and c["route"] == "tensor":
            log(f"  ln_row_matmul {c['shape']}: fused / row product alone "
                f"{c['ms'] / c['product_ms']:.2f}x, fused / two launches "
                f"{c['ms'] / c['two_launch_ms']:.2f}x, fused / F.layer_norm"
                f" + torch.mm {c['ms'] / c['library_ms']:.2f}x")
    bad = [(c["shape"], c["dtype"]) for c in out
           if not case_ok(c) or not all(c["rows_bit_equal_to_m1"].values())]
    if bad:
        raise SystemExit(f"ln_matmul disagrees with its plain version, its "
                         f"gate passes the mutant, or a row's bits depend on"
                         f" M: {bad}")
    return {"ln_row_matmul": out}


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
              ((16, 1024, 3072), "M=16 chunk qkv (w)"),
              ((16, 4096, 1024), "M=16 chunk fc2 (w)"),
              ((40, 1024, 3072), "M=40 verify qkv (x)"),
              ((40, 1024, 1024), "M=40 verify proj (x)"),
              ((40, 1024, 4096), "M=40 verify fc1 (x)"),
              ((40, 4096, 1024), "M=40 verify fc2 (x)"),
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


def drain(eng):
    """``eng.run()``, reading the engine's ``kv_bytes_reserved`` after
    every step (host bookkeeping, no device work); returns its peak."""
    peak = 0
    while eng._busy():
        eng.step()
        peak = max(peak, eng._kv_accounting()["kv_bytes_reserved"])
    return peak


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


class StepProbe:
    """Stands in for an engine's step object: attribute reads reach the
    step (the engine stages through them); a call runs ``fn(step)``."""

    def __init__(self, step, fn):
        self.__dict__.update(_step=step, _fn=fn)

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self):
        return self._fn(self._step)


def pool_names(eng):
    return (("_cache_k", "_cache_v", "_cache_ks", "_cache_vs")
            if getattr(eng, "_kv_quant", False) else ("_cache_k", "_cache_v"))


def eager_on_clones(torch, eng, fn):
    """``fn()`` (returning sampled tokens and their logits) with the
    engine's pool swapped for clones of it (the graphs keep the storage
    they baked), timed on the host clock up to the tokens' readback.
    Returns (tokens as numpy, logits, clones, ms)."""
    names = pool_names(eng)
    real = [getattr(eng, n) for n in names]
    clones = [t.clone() for t in real]
    for n, t in zip(names, clones):
        setattr(eng, n, t)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            tok, logits = fn()
            tok = tok.cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for n, t in zip(names, real):
            setattr(eng, n, t)
    return tok, logits, clones, ms


def staged(torch, st, names):
    """The step's staged host values of ``names``, as tensors on its
    device."""
    return [torch.from_numpy(np.array(getattr(st, n))).to(st.device)
            for n in names]


@contextlib.contextmanager
def prefill_probe(torch, gpt, eng, record):
    """While open, every prefill wave and chunk of ``eng`` first runs its
    eager function (``eng._prefill``; ``gpt.forward_paged_chunk(_quant)``
    with an int offset and a held list) on clones of the pool with the
    inputs the step staged, then the step itself (a graph replay), and
    ``record`` gets one dict a call: the kind and shape, whether the
    sampled tokens are equal, whether the pool's pages past scratch page 0
    (a slot pool: all of it) are byte-equal, the largest logit
    difference, and the host ms of the eager run and of the step (each
    ending in its tokens' readback)."""
    real_wave, real_chunk = eng._run_wave, getattr(eng, "_chunk_step", None)
    first = 1 if hasattr(eng, "_page_size") else 0    # page 0: scratch

    def compare(kind, shape, eager, out, logits, step_ms):
        tok, last, clones, ms = eager
        pools = [getattr(eng, n) for n in pool_names(eng)]
        record.append({
            "kind": kind, "shape": shape,
            "tokens_equal": bool(np.array_equal(tok, out[0])),
            "pool_equal": all(bool(torch.equal(a[:, first:], b[:, first:]))
                              for a, b in zip(pools, clones)),
            "max_logit_diff": float((last.float() - logits.float())
                                    .abs().max()),
            "eager_ms": ms, "step_ms": step_ms})

    def wave(st):
        b, s = st.tokens.shape
        args = staged(torch, st, [n for n, _ in eng._wave_fields(b, s)])
        eager = eager_on_clones(torch, eng, lambda: eng._prefill(*args))
        t0 = time.perf_counter()
        out = real_wave(st)
        compare("wave", [b, s], eager, out, st.logits,
                1e3 * (time.perf_counter() - t0))
        return out

    def chunk(st):
        toks, row = staged(torch, st, ("toks", "row"))
        held = [bool(h) for h in st.held]
        offset, take = int(st.offset[0]), int(st.take[0])

        def run():
            pools = [getattr(eng, n) for n in (
                ("_cache_k", "_cache_ks", "_cache_v", "_cache_vs")
                if eng._kv_quant else ("_cache_k", "_cache_v"))]
            fn = (gpt.forward_paged_chunk_quant if eng._kv_quant
                  else gpt.forward_paged_chunk)
            lg, *_ = fn(eng.params, toks, eng.cfg, *pools, row, offset,
                        held)
            last = lg[0, take - 1:take]
            return last.argmax(-1), last
        eager = eager_on_clones(torch, eng, run)
        t0 = time.perf_counter()
        out = st()
        compare("chunk", [offset, take, sum(held)], eager, out, st.logits,
                1e3 * (time.perf_counter() - t0))
        return out

    eng._run_wave = wave
    if real_chunk is not None:
        eng._chunk_step = StepProbe(real_chunk, chunk)
    try:
        yield record
    finally:
        del eng._run_wave
        if real_chunk is not None:
            eng._chunk_step = real_chunk


def prefill_vs_eager(torch, gpt, eng, prompts, tag, exact_bytes):
    """``prompts`` x 2 tokens through ``eng`` under :func:`prefill_probe`:
    every wave (and chunk) replay against its eager function on clones of
    the pool.  Tokens must be equal; with ``exact_bytes`` (fp32) the pool
    bytes past scratch page 0 too, else they are reported.  Returns the
    records' summary."""
    record = []
    with prefill_probe(torch, gpt, eng, record):
        reqs = [eng.submit(p, 2) for p in prompts]
        eng.run()
    if not record or not all(r.done for r in reqs):
        raise SystemExit(f"{tag}: no prefill step ran under the probe")
    bad = [r for r in record if not r["tokens_equal"]
           or (exact_bytes and not r["pool_equal"])]
    if bad:
        raise SystemExit(f"{tag}: a prefill graph replay disagrees with its "
                         f"eager function: {bad}")
    return {"calls": len(record),
            "kinds": sorted({r["kind"] for r in record}),
            "tokens_equal": True,
            "pool_equal": all(r["pool_equal"] for r in record),
            "max_logit_diff": max(r["max_logit_diff"] for r in record),
            "eager_ms": [round(r["eager_ms"], 3) for r in record],
            "step_ms": [round(r["step_ms"], 3) for r in record],
            "shapes": [r["shape"] for r in record]}


def prefill_steps(eng):
    """An engine's prefill step objects: its wave steps and chunk step."""
    steps = list(eng._waves.values())
    if getattr(eng, "_chunk_step", None) is not None:
        steps.append(eng._chunk_step)
    return steps


def step_captures(eng):
    """Captures of every step object of ``eng``: prefill, decode (or
    verify) and, in draft mode, the draft model's two."""
    extra = [getattr(eng, n, None) for n in ("_draft_step", "_draft_prefill")]
    return sum(st.captures for st in prefill_steps(eng) + [eng._step]
               + [x for x in extra if x is not None])


def check_warm(tag, eng, built):
    """After ``warmup()`` (which returned ``built``): every prefill step
    and the decode step built and captured once, ``prefill_compiles``
    the steps built."""
    steps = prefill_steps(eng)
    st = eng.stats()
    if (built != len(steps) or st["prefill_compiles"] != built
            or st["decode_compiles"] != 1
            or any(s.captures != 1 for s in steps + [eng._step])):
        raise SystemExit(f"{tag}: warmup built {built} prefill steps; "
                         f"{len(steps)} held, prefill_compiles "
                         f"{st['prefill_compiles']}, decode_compiles "
                         f"{st['decode_compiles']}, captures "
                         f"{[s.captures for s in steps + [eng._step]]}")
    return step_captures(eng)


def check_no_capture(tag, eng, captures, built):
    """After traffic: nothing built or captured since warmup."""
    st = eng.stats()
    if (step_captures(eng) != captures or st["prefill_compiles"] != built
            or st["decode_compiles"] != 1):
        raise SystemExit(f"{tag}: the traffic built or captured a step: "
                         f"captures {captures} -> {step_captures(eng)}, "
                         f"prefill_compiles {built} -> "
                         f"{st['prefill_compiles']}, decode_compiles "
                         f"{st['decode_compiles']}")


def log_prefill_vs_eager(pw, bytes_note, card):
    log(f"    prefill graphs against their eager functions on clones of "
        f"the pool ({pw['calls']} calls: {pw['kinds']} {pw['shapes']}): "
        f"tokens equal {pw['tokens_equal']}; pool bytes past page 0 equal "
        f"{pw['pool_equal']} ({bytes_note}); max |logit diff| "
        f"{pw['max_logit_diff']:.3e}; host ms eager {pw['eager_ms']}, "
        f"graph {pw['step_ms']}  [{card}]")


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
    built = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    captures = check_warm("(j)", eng, built)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
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
    check_no_capture("(j)", eng, captures, built)
    gen = sum(len(r.tokens) for r in reqs)
    res = {"warmup_waves": built, "warmup_s": warm_s, "wall_s": wall,
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
    res["prefill_vs_eager"] = prefill_vs_eager(torch, gpt, eng, prompts[:6],
                                               "(j)", False)
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
            pw = prefill_vs_eager(torch, gpt, eng, prompts[:4], "(k)", True)
            compiles = eng.stats()["decode_compiles"]
        del eng
    tok_equal = all(a.tokens == b.tokens
                    for a, b in zip(runs["cuda"], runs["cpu"]))
    logit_err = max(float(np.abs(np.stack(a.logits)
                                 - np.stack(b.logits)).max())
                    for a, b in zip(runs["cuda"], runs["cpu"]))
    res = {"tokens_equal": tok_equal, "max_logit_err": logit_err,
           "replay_vs_eager": rv, "prefill_vs_eager": pw,
           "decode_compiles": compiles}
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
                         "quantized engine (j), STEPS encoder forwards "
                         "in each dtype (n), up to STEPS prefill chunks "
                         "(w), STEPS self-draft iterations and draft "
                         "steps (x) and an (am) decode of STEPS steps")
    ap.add_argument("--trace", default="paddle_tpu_torch/_build/"
                    "decode_trace.json",
                    help="where phase (f) writes its Chrome trace")
    ap.add_argument("--profile-train", type=int, default=0, metavar="STEPS",
                    help="also trace STEPS training steps of the training "
                         "path (phase i), the flagship path (l), ERNIE "
                         "pretraining (p), eager training (r), (t), "
                         "the hapi step and its hand-written loop (u), "
                         "ResNet50's fetchless static step (aa), the "
                         "16-label fine-tune (ae) and the seq2seq steps "
                         "(am), (an) with torch.profiler")
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
                                          norms, paged_attn, row_matmul)
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
    t0 = time.perf_counter()
    log("(c) kernels against their plain versions on the card:")
    cases = check_kernels(torch, paged_attn, norms)
    cases.update(check_flash(torch, flash_attn))
    cases.update(check_quant_kernels(torch, gpt, dqmm, paged_attn))
    cases.update(check_fused_bwd(torch, flash_attn))
    cases.update(check_fused_ffn(torch, fused_ffn))
    cases.update(check_rms_norm(torch, norms))
    cases.update(check_row_matmul(torch, row_matmul))
    cases.update(check_ln_matmul(torch, row_matmul, norms))
    for k, extra in check_queue3(torch, gpt, flash_attn, paged_attn, norms,
                                 dqmm).items():
        cases[k].extend(extra)
    log(f"    phase {time.perf_counter() - t0:.1f} s")

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
        f"warmup: {qrun['warmup_waves']} prefill graphs and the decode "
        f"graph captured in {qrun['warmup_s']:.1f} s, none during the "
        f"traffic  [{card}]")
    rv = qrun["replay_vs_eager"]
    log(f"    replay against the eager step (8 slots, lens {rv['lens']}):"
        f" next tokens equal {rv['tokens_equal']}; max |logit diff| "
        f"{rv['max_logit_diff']:.3e} (bf16, reported); {rv['timed']} "
        f"replays {rv['replay_step_ms']} ms a step against "
        f"{rv['eager_step_ms']} ms a step eager, alternated  [{card}]")
    log_prefill_vs_eager(qrun["prefill_vs_eager"], "bf16, reported", card)
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
    log_prefill_vs_eager(par["prefill_vs_eager"], "fp32, asserted", card)
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

    # (w), (x), (y): chunked prefill and speculative decoding --------------
    spec_phases(torch, gpt, PagedServingEngine, (paged_attn, norms, dqmm),
                card, launches, args)

    # (z): the slot-contiguous engine ------------------------------------
    slot_phases(torch, gpt, (paged_attn, norms, dqmm), card, launches,
                fp_run, qrun)

    # (aa), (ab), (ac): the static graph and the vision stack ------------
    vision_phases(torch, card, args)

    # (ad), (ae), (af): the eager tensor API and a multi-label fine-tune --
    api_phases(torch, flash_attn, norms, card, args, launches)

    # (ag), (ah), (ai): jit.to_static, the profiler and nan guard, static
    # control flow ------------------------------------------------------
    jit_phases(torch, flash_attn, norms, card, launches)

    # (aj), (ak), (al): inference export and the Predictor, the reader
    # path, the optimizer extras and the checkpoint ----------------------
    deploy_phases(torch, flash_attn, norms, fused_ffn, card, launches)

    # (am), (an), (ao): the sequence-to-sequence path (Transformer base,
    # the RNN seq2seq) and the rest of nn ---------------------------------
    seq2seq_phases(torch, flash_attn, norms, card, launches, args)

    # (ap), (aq), (ar): the rest of vision/ (MobileNet-SSD300, the
    # ImageNet input path with MobileNetV2 and VGG16, the detection family)
    vision_family_phases(torch, card, args)

    # (as), (at), (au), (av): the tokenizer, QAT and PTQ at ERNIE-3.0-Base
    # width, their parity, the BiGRU-CRF tagger ---------------------------
    text_phases(torch, flash_attn, norms, card, launches)

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
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    built = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    captures = check_warm("(d)", eng, built)
    reserved = torch.cuda.max_memory_reserved()
    log(f"    warmup: {built} prefill graphs (every (batch, seq) rung) and "
        f"the decode graph captured in {warm_s:.1f} s; "
        f"max_memory_reserved {reserved / 2**30} GiB over warmup (reset "
        f"just before it; {before / 2**30} GiB reserved then), "
        f"memory_reserved {torch.cuda.memory_reserved() / 2**30} GiB "
        f"after it")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    from paddle_tpu_torch.ops.cuda import row_matmul
    paged_attn.launches = 0
    norms.launches = 0
    row_matmul.launches = row_matmul.ln_launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    kv_peak = drain(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update({"paged_attention": paged_attn.launches,
                     "layer_norm": norms.launches,
                     "row_matmul": row_matmul.launches,
                     "ln_row_matmul": row_matmul.ln_launches})
    st = eng.stats()
    L = cfg.num_layers
    check_no_capture("(d)", eng, captures, built)
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
    if launches["row_matmul"] != st["decode_steps"] * 4 * L:
        raise SystemExit(f"the row matmul launched {launches['row_matmul']} "
                         f"times for {st['decode_steps']} decode steps x "
                         f"4 x {L} products")
    if launches["ln_row_matmul"] != st["decode_steps"] * 2 * L:
        raise SystemExit(f"the row matmul launched its LayerNorm prologue "
                         f"{launches['ln_row_matmul']} times for "
                         f"{st['decode_steps']} decode steps x 2 x {L}")
    # ln1 and ln2 are the qkv and fc1 products' prologue in a decode step:
    # lnf alone launches the LayerNorm kernel there, 2L + 1 a prefill wave
    want_ln = st["decode_steps"] + (2 * L + 1) * st["prefill_calls"]
    if launches["layer_norm"] != want_ln:
        raise SystemExit(f"layer norm launched {launches['layer_norm']} "
                         f"times for {st['decode_steps']} decode steps and "
                         f"{st['prefill_calls']} prefill waves (expected "
                         f"{want_ln})")
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
        f"{resident / 2**30} GiB); kv_bytes_total {st['kv_bytes_total']}"
        f" (kv_bytes_reserved at its peak {kv_peak}); prefix "
        f"page hits {st['prefix_page_hits']}; decode_compiles "
        f"{st['decode_compiles']}; launches "
        f"{ {k: launches[k] for k in ('paged_attention', 'layer_norm', 'row_matmul', 'ln_row_matmul')} }  "
        f"[{card}]")
    routes = decode_routes(torch, gpt, PagedServingEngine, params, cfg,
                           prompts, new_tokens)
    log(f"    decode step by the products' route, the same 12 requests, "
        f"alternated (fused, two launches, cuBLAS, cuBLAS, two launches, "
        f"fused): the row-invariant kernel with ln1 / ln2 as the qkv / fc1 "
        f"products' prologue {routes['fused']} ms, the LayerNorm kernel "
        f"and the row kernel launched apart (the route before the prologue)"
        f" {routes['two']} ms, the LayerNorm kernel and cuBLAS (the route "
        f"before the row kernel) {routes['cublas']} ms  [{card}]")
    rv = replay_vs_eager(torch, gpt, eng, prompts, "(d)")
    log(f"    replay against the eager step (8 slots, lens {rv['lens']}):"
        f" next tokens equal {rv['tokens_equal']}; max |logit diff| "
        f"{rv['max_logit_diff']:.3e} (bf16, reported); {rv['timed']} "
        f"replays {rv['replay_step_ms']} ms a step against "
        f"{rv['eager_step_ms']} ms a step eager, alternated  [{card}]")
    pw = prefill_vs_eager(torch, gpt, eng, prompts[:6], "(d)", False)
    log_prefill_vs_eager(pw, "bf16, reported", card)
    run = {"tokens_per_s": gen / wall, "decode_step_ms": dec_ms,
           "decode_routes_ms": routes,
           "prefill_wave_ms": pre_ms, "replay_vs_eager": rv,
           "max_memory_allocated_gib": mem / 2 ** 30,
           "resident_gib": resident / 2 ** 30,
           "kv_bytes_total": st["kv_bytes_total"],
           "kv_bytes_reserved_peak": kv_peak,
           "prefill_graphs": built, "reserved_after_warmup_gib":
               reserved / 2 ** 30,
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
    pw32 = prefill_vs_eager(torch, gpt, eng32, prompts[:4], "(e)", True)
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
    log_prefill_vs_eager(pw32, "fp32, asserted", card)
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


@contextlib.contextmanager
def product_route(row_matmul, norms, route):
    """The paged decode's and the fp verify's float products and their
    LayerNorms on an earlier route while an engine captures its graphs; a
    measurement only.  ``"two"``: ln1 / ln2 as the LayerNorm kernel, then
    the row-invariant kernel (the route before the prologue); ``"cublas"``:
    the LayerNorm kernel, then every product on cuBLAS (``x @ w``, the
    route before the row kernel)."""
    kernels = row_matmul.matmul, row_matmul.ln_matmul
    if route == "cublas":
        row_matmul.matmul = row_matmul._ref_matmul
    row_matmul.ln_matmul = lambda x, g, b, eps, w: row_matmul.matmul(
        norms.layer_norm(x, g, b, eps), w)
    try:
        yield
    finally:
        row_matmul.matmul, row_matmul.ln_matmul = kernels


def decode_routes(torch, gpt, PagedServingEngine, params, cfg, prompts,
                  new_tokens, rounds=2):
    """(d)'s decode step on three routes: the row-invariant kernel with
    the LayerNorm prologue (``fused``), the LayerNorm kernel and the row
    kernel launched apart (``two``) and the LayerNorm kernel and cuBLAS
    (``cublas``): three engines (each graph captured in ``warmup()``, the
    latter two under :func:`product_route`) serve (d)'s requests in turns,
    fused, two, cuBLAS, cuBLAS, two, fused; returns the mean decode-step
    ms of each (host clock, each step ending in its readback)."""
    from paddle_tpu_torch.ops.cuda import norms, row_matmul
    kw = dict(device="cuda", slots=8, max_len=512, page_size=16)
    engs = {"fused": PagedServingEngine((params, cfg), **kw)}
    engs["fused"].warmup()
    for route in ("two", "cublas"):
        with product_route(row_matmul, norms, route):
            engs[route] = PagedServingEngine((params, cfg), **kw)
            engs[route].warmup()
    steps = {k: [] for k in engs}
    for k in ["fused", "two", "cublas", "cublas", "two", "fused"] * (
            rounds // 2):
        eng = engs[k]
        n0 = len(eng.decode_step_s)
        for p in prompts:
            eng.submit(p, new_tokens)
        drain(eng)
        steps[k] += list(eng.decode_step_s[n0:])
    out = {k: 1e3 * float(np.mean(v)) for k, v in steps.items()}
    del engs
    torch.cuda.empty_cache()
    return out


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


def make_encoder(pt, V, H, L, nh, F, N, dropout=0.0, attn_dropout=None,
                 classes=None):
    """A user's script on the port's nn API: token and learned position
    embeddings, a pre-LN ``TransformerEncoder`` (gelu, ``dropout``, 0 by
    default; every layer's attention dropout ``attn_dropout`` when given)
    with an ``RMSNorm`` final norm, and a ``Linear`` head.  Returns the
    model in ``eval()``; its forward gives (final norm output, logits).
    With ``classes``, the head is a ``Linear(H, classes)`` on the first
    position and the forward gives its logits."""
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
            self.head = nn.Linear(H, classes or V)

        def forward(self, ids):
            h = self.word(ids) + self.pos(arange(ids.shape[1]))
            h = self.encoder(h)
            if classes:
                return self.head(h[:, 0])
            return h, self.head(h)

    # a module-level name, so that jit.save can pickle the model ((ag))
    Encoder.__qualname__ = "Encoder"
    globals()["Encoder"] = Encoder
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


# (w), (x), (y): chunked prefill and speculative decoding ---------------

SPEC_K = 4                    # (x), (y): draft candidates a verify
CHUNK = 16                    # (w)-(y): prefill_chunk (the bench's)
SPEC_ROUNDS = 2               # (w), (x): alternated rounds of each engine
SPEC_PARITY = dict(V=4096, H=256, nh=4, L=2)   # (y): fp32, small widths


def zero_serving_counts(paged_attn, norms, dqmm):
    from paddle_tpu_torch.ops.cuda import row_matmul
    paged_attn.launches = paged_attn.quant_launches = 0
    norms.launches = dqmm.launches = row_matmul.launches = 0
    row_matmul.ln_launches = 0
    dqmm.rows_launches.clear()


def serving_counts(paged_attn, norms, dqmm):
    from paddle_tpu_torch.ops.cuda import row_matmul
    return {"layer_norm": norms.launches,
            "row_matmul": row_matmul.launches,
            "ln_row_matmul": row_matmul.ln_launches,
            "paged_attention": paged_attn.launches,
            "paged_attention_quant": paged_attn.quant_launches,
            "dequant_matmul": dqmm.launches,
            "dequant_matmul_by_rows": dict(sorted(
                dqmm.rows_launches.items()))}


def serve_run(torch, eng, prompts, new_tokens, kernels, tag):
    """One pass of ``prompts`` x ``new_tokens`` through ``eng``, the
    kernels' launch counts set to 0 just before and read just after.
    Returns the tokens, wall time, tokens/s (prefill included, as (d)),
    the mean host-clock ms of this pass's decode steps (verify steps) and
    prefill chunks, of a verify step's drafting (ngram: host clock; draft
    mode: the draft model's span on the card, from CUDA events) and the
    rest of it, the peak ``kv_bytes_reserved``, the engine counters'
    increments and the launches."""
    torch.cuda.synchronize()
    before = eng.stats()
    marks = {k: len(getattr(eng, k, ())) for k in
             ("decode_step_s", "chunk_s", "prefill_s", "verify_s",
              "draft_s")}
    zero_serving_counts(*kernels)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    kv_peak = drain(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = serving_counts(*kernels)
    after = eng.stats()
    if not all(r.done and len(r.tokens) == new_tokens for r in reqs):
        raise SystemExit(f"{tag}: not every request finished with its "
                         "tokens")
    if not all(0 <= t < eng.cfg.vocab_size for r in reqs for t in r.tokens):
        raise SystemExit(f"{tag}: a generated token is outside the "
                         "vocabulary")

    def mean_ms(k):
        xs = getattr(eng, k, [])[marks[k]:]
        return 1e3 * float(np.mean(xs)) if xs else None
    gen = sum(len(r.tokens) for r in reqs)
    # each request's first token comes from its prefill; the rest from
    # decode (verify) steps, whose host-clock seconds these are
    step_s = float(np.sum(eng.decode_step_s[marks["decode_step_s"]:]))
    return {"tokens": [list(r.tokens) for r in reqs], "wall_s": wall,
            "tokens_per_s": gen / wall,
            "decode_tokens_per_s": (gen - len(reqs)) / step_s,
            "step_ms": mean_ms("decode_step_s"),
            "chunk_ms": mean_ms("chunk_s"), "wave_ms": mean_ms("prefill_s"),
            "verify_ms": mean_ms("verify_s"),
            "draft_ms": mean_ms("draft_s"),
            "kv_bytes_reserved_peak": kv_peak,
            "delta": {k: after[k] - before[k] for k in (
                "decode_steps", "prefill_calls", "prefill_chunks",
                "prefix_page_hits", "spec_steps", "drafted_tokens",
                "accepted_tokens", "tokens_generated", "preemptions")},
            "launches": launches}


def equal_share(a, b):
    """Share of equal tokens between two runs' token lists."""
    x = np.concatenate([np.asarray(t) for t in a])
    y = np.concatenate([np.asarray(t) for t in b])
    return float(np.mean(x == y))


def check_launch(tag, got, want):
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        raise SystemExit(f"{tag}: launches (got, expected) {bad}")


def profile_chunks(torch, eng, prompt, steps, trace_path):
    """(w) with ``--profile``: one long prompt alone in ``eng``, then a
    trace of up to ``steps`` engine iterations that each run one prefill
    chunk and nothing else (its first chunk, the admission, and its last,
    which starts its decode, untraced)."""
    before = eng.stats()
    eng.submit(prompt, 2)
    eng.step()
    n = min(steps, -(-len(prompt) // CHUNK) - 2)
    out = profile_steps(torch, eng.step, n, "prefill_chunk", trace_path)
    d = {k: eng.stats()[k] - before[k]
         for k in ("prefill_chunks", "decode_steps")}
    if d != {"prefill_chunks": n + 1, "decode_steps": 0}:
        raise SystemExit(f"(w) profile: the traced iterations were not "
                         f"chunks alone: {d}")
    eng.run()
    return {"prompt_tokens": len(prompt), **out}


def profile_spec(torch, eng, prompts, steps, trace_dir):
    """(x) with ``--profile``: every slot of the draft-mode ``eng``
    decoding, then traces of ``steps`` engine iterations (the draft
    model's catch-up-and-draft step and the verify) and of ``steps``
    replays of the draft step alone on its last inputs (they rewrite the
    same draft-cache positions with the same values)."""
    for p in prompts[:eng.slots]:
        eng.submit(p, 256)
    while int(eng.stats()["slot_occupancy"]) != eng.slots:
        eng.step()                  # chunked admissions, one an iteration
    eng.step()
    before = eng.stats()["spec_steps"]
    out = {"spec_step": profile_steps(
        torch, eng.step, steps, "spec_step",
        os.path.join(trace_dir, "spec_step_trace.json"))}
    if eng.stats()["spec_steps"] - before != steps or \
            int(eng.stats()["slot_occupancy"]) != eng.slots:
        raise SystemExit("(x) profile: not every traced iteration was a "
                         "verify over every slot")
    out["draft_step"] = profile_steps(
        torch, eng._draft_step, steps, "draft_step",
        os.path.join(trace_dir, "draft_step_trace.json"))
    eng.run()
    return {"active_slots": eng.slots, **out}


def chunked_path(torch, gpt, PagedServingEngine, kernels, cfg, params,
                 prompts, new_tokens, card, profile=0, trace_dir=None):
    """Phase (w): (d)'s requests through ``prefill_chunk=16`` engines (fp;
    then int8 weights and pool) beside (d)'s and (j)'s unchunked engines,
    alternated, exact launch counts on every chunked pass; with
    ``profile``, :func:`profile_chunks` on each chunked engine."""
    L = cfg.num_layers
    res = {}
    for kv in ("fp", "int8"):
        kw = dict(quant="int8", kv_dtype="int8") if kv == "int8" else {}
        engs, warm = {}, {}
        t0 = time.perf_counter()
        for name, chunk in (("chunked", CHUNK), ("unchunked", None)):
            engs[name] = PagedServingEngine(
                (params, cfg), device="cuda", slots=8, max_len=512,
                page_size=16, prefill_chunk=chunk, **kw)
            built = engs[name].warmup()
            warm[name] = (built, check_warm(f"(w) {kv} {name}", engs[name],
                                            built))
        warm_s = time.perf_counter() - t0
        runs = collections.defaultdict(list)
        for _ in range(SPEC_ROUNDS):
            for name, eng in engs.items():
                runs[name].append(serve_run(torch, eng, prompts, new_tokens,
                                            kernels, f"(w) {kv} {name}"))
        for name, eng in engs.items():
            check_no_capture(f"(w) {kv} {name}", eng, warm[name][1],
                             warm[name][0])
        for r in runs["chunked"]:
            d, got = r["delta"], r["launches"]
            fwd = d["decode_steps"] + d["prefill_calls"] + d["prefill_chunks"]
            if d["prefill_calls"] or d["prefill_chunks"] < len(prompts):
                raise SystemExit(f"(w) {kv}: every prompt is longer than a "
                                 f"chunk, yet {d}")
            want = {"layer_norm": (2 * L + 1) * fwd}
            if kv == "fp":
                # a decode step launches lnf alone (ln1, ln2: the qkv and
                # fc1 products' prologue)
                want = {"layer_norm": (2 * L + 1) * d["prefill_chunks"]
                        + d["decode_steps"],
                        "ln_row_matmul": 2 * L * d["decode_steps"]}
            if kv == "int8":
                want.update(paged_attention_quant=L * d["decode_steps"],
                            paged_attention=0, dequant_matmul=4 * L * fwd)
                check_launch(f"(w) {kv}", got["dequant_matmul_by_rows"],
                             {CHUNK: 4 * L * d["prefill_chunks"],
                              8: 4 * L * d["decode_steps"]})
            else:
                want.update(paged_attention=L * d["decode_steps"],
                            paged_attention_quant=0, dequant_matmul=0)
            check_launch(f"(w) {kv}", got, want)
        step = engs["chunked"]._step
        if engs["chunked"].stats()["decode_compiles"] != 1 or \
                step.captures != 1:
            raise SystemExit(f"(w) {kv}: the decode step was built "
                             f"{engs['chunked'].stats()['decode_compiles']} "
                             f"times, captured {step.captures}")
        res[kv] = {"warmup_s": warm_s, "runs": dict(runs),
                   "prefill_graphs": {n: w[0] for n, w in warm.items()},
                   "tokens_equal_unchunked_share": equal_share(
                       runs["chunked"][0]["tokens"],
                       runs["unchunked"][0]["tokens"]),
                   "chunk_vs_eager": prefill_vs_eager(
                       torch, gpt, engs["chunked"], [prompts[0], prompts[6]],
                       f"(w) {kv}", False)}
        if profile:
            res[kv]["profile"] = profile_chunks(
                torch, engs["chunked"], max(prompts, key=len), profile,
                os.path.join(trace_dir, f"chunk_trace_{kv}.json"))
        del engs
        torch.cuda.empty_cache()
    return res


def spec_prompts(V, n=12):
    """12 numpy-seeded prompts of 24-120 tokens; 3 of every 4 start with
    the same 16 tokens (a shared system prompt)."""
    rng = np.random.default_rng(SEED + 15)
    shared = rng.integers(0, V, 16).astype(np.int32)
    out = []
    for i, ln in enumerate(rng.integers(24, 121, n)):
        p = rng.integers(0, V, int(ln)).astype(np.int32)
        if i % 4 != 3:
            p[:16] = shared
        out.append(p)
    return out


def spec_engines(gpt, PagedServingEngine, SpeculativeServingEngine, cfg,
                 params, seed, kv, device="cuda", **extra):
    """The non-speculative engine and the two speculative ones (ngram,
    and draft with a self-draft: the target's config and ``seed``, the
    target's ``init_params`` seed) on one pool kind, all with
    ``prefill_chunk=16``."""
    kw = dict(device=device, prefill_chunk=CHUNK, **extra)
    if kv == "int8":
        kw.update(quant="int8", kv_dtype="int8")
    return {"base": PagedServingEngine((params, cfg), **kw),
            "ngram": SpeculativeServingEngine(
                (params, cfg), spec_mode="ngram", spec_k=SPEC_K, **kw),
            "draft": SpeculativeServingEngine(
                (params, cfg), spec_mode="draft", spec_k=SPEC_K,
                spec_draft_cfg=dataclasses.asdict(cfg),
                spec_draft_seed=seed, **kw)}


def spec_path(torch, gpt, PagedServingEngine, SpeculativeServingEngine,
              kernels, card, profile=0, trace_dir=None):
    """Phase (x): full-width ``gpt_345m`` from the port's ``init_params``
    (seed 1234), 12 requests x 32 tokens through the non-speculative,
    ngram and self-draft engines (``spec_k=4``, ``prefill_chunk=16``),
    alternated, on the fp and the int8 pool; exact launch counts; with
    ``profile``, :func:`profile_spec` on the fp self-draft engine."""
    cfg = dataclasses.replace(gpt.gpt_345m(), use_pallas_norm=True)
    L, k = cfg.num_layers, SPEC_K
    W = k + 1
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cuda")
    init_s = time.perf_counter() - t0
    prompts = spec_prompts(cfg.vocab_size)
    new_tokens = 32
    ingest = sum(-(-len(p) // 16) for p in prompts)   # draft chunks of 16
    res = {"init_s": init_s,
           "prompt_lens": [len(p) for p in prompts]}
    for kv in ("fp", "int8"):
        t0 = time.perf_counter()
        engs = spec_engines(gpt, PagedServingEngine,
                            SpeculativeServingEngine, cfg, params, SEED, kv,
                            slots=8, max_len=512, page_size=16)
        warm = {}
        for name, eng in engs.items():
            built = eng.warmup()
            warm[name] = (built, check_warm(f"(x) {kv} {name}", eng, built))
        warm_s = time.perf_counter() - t0
        runs = collections.defaultdict(list)
        for _ in range(SPEC_ROUNDS):
            for name, eng in engs.items():
                runs[name].append(serve_run(torch, eng, prompts, new_tokens,
                                            kernels, f"(x) {kv} {name}"))
        for name, eng in engs.items():
            check_no_capture(f"(x) {kv} {name}", eng, warm[name][1],
                             warm[name][0])
        for name in ("ngram", "draft"):
            eng = engs[name]
            st = eng.stats()
            if st["decode_compiles"] != 1 or eng._step.captures != 1:
                raise SystemExit(f"(x) {kv} {name}: decode_compiles "
                                 f"{st['decode_compiles']}, captures "
                                 f"{eng._step.captures}")
            want_d = 0 if name == "ngram" else 2
            if st["spec_draft_compiles"] != want_d:
                raise SystemExit(f"(x) {kv} {name}: spec_draft_compiles "
                                 f"{st['spec_draft_compiles']}")
            for r in runs[name]:
                d, got = r["delta"], r["launches"]
                if d["preemptions"]:
                    raise SystemExit(f"(x): a preemption: {d}")
                fwd = (d["spec_steps"] + d["prefill_calls"]
                       + d["prefill_chunks"])
                dfwd = (W + k - 1) * d["spec_steps"] if name == "draft" \
                    else 0
                dblk = ingest if name == "draft" else 0
                want = {"layer_norm": (2 * L + 1) * (fwd + dfwd)
                        + 2 * L * dblk}
                if kv == "fp":
                    # a verify launches lnf alone (ln1, ln2: the qkv and
                    # fc1 products' prologue)
                    want["layer_norm"] -= 2 * L * d["spec_steps"]
                    want["ln_row_matmul"] = 2 * L * d["spec_steps"]
                attn = "paged_attention_quant" if kv == "int8" \
                    else "paged_attention"
                want[attn] = W * L * d["spec_steps"]
                want["row_matmul"] = (4 * L * d["spec_steps"] if kv == "fp"
                                      else 0)
                if kv == "int8":
                    want["dequant_matmul"] = 4 * L * fwd
                    check_launch(f"(x) {kv} {name}",
                                 got["dequant_matmul_by_rows"],
                                 {8 * W: 4 * L * d["spec_steps"],
                                  CHUNK: 4 * L * d["prefill_chunks"]})
                check_launch(f"(x) {kv} {name}", got, want)
            r["accepted_tokens_per_step"] = st["accepted_tokens_per_step"]
        acc = engs["draft"].stats()["accepted_tokens_per_step"]
        if not acc > 1.5:
            raise SystemExit(f"(x) {kv}: self-draft acceptance {acc} per "
                             "verify, not above 1.5")
        res[kv] = {
            "warmup_s": warm_s, "runs": dict(runs),
            "accepted_tokens_per_step": {
                n: engs[n].stats()["accepted_tokens_per_step"]
                for n in ("ngram", "draft")},
            "tokens_equal_base_share": {
                n: equal_share(runs[n][0]["tokens"], runs["base"][0]["tokens"])
                for n in ("ngram", "draft")}}
        if profile and kv == "fp":
            res[kv]["profile"] = profile_spec(torch, engs["draft"], prompts,
                                              profile, trace_dir)
        del engs
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def window_probe(eng, record):
    """While open, each verify of ``eng`` checks that the pool changed
    only at the positions it committed (``lens[s] .. lens[s] + n_commit[s]
    - 1`` of each active slot) and on scratch page 0, and appends the
    count of other changed positions to ``record``: rejected lanes leave
    no trace.  Wraps the verify step's ``__call__``; other engines' steps
    pass through."""
    from paddle_tpu_torch.inference import speculative
    cls = speculative._VerifyStep
    real = cls.__call__
    ps = eng._page_size

    def probe(step, before=None):
        if step._eng is not eng:
            return real(step, before)
        pre = [t.clone() for t in eng._cache_operands()]
        lens, tables = eng._lens.copy(), eng._tables_np.copy()
        active = eng._active.copy()
        out = real(step, before)
        W = eng._spec_k_val + 1
        allowed = np.zeros(pre[0].shape[1:3], bool)     # [P, ps]
        allowed[0] = True
        for s in np.nonzero(active)[0]:
            for pos in range(int(lens[s]), int(lens[s]) + int(out[0][s, W])):
                allowed[tables[s, pos // ps], pos % ps] = True
        bad = 0
        for t, p in zip(eng._cache_operands(), pre):
            ch = (t != p).reshape(t.shape[0], t.shape[1], t.shape[2], -1)
            ch = ch.any(3).any(0).cpu().numpy()
            bad += int((ch & ~allowed).sum())
        record.append(bad)
        return out

    cls.__call__ = probe
    try:
        yield record
    finally:
        cls.__call__ = real


def pool_compare(torch, a, b):
    """(pages 1.. byte-equal, max |difference| as floats) of two pools."""
    eq, diff = True, 0.0
    for x, y in zip(a._cache_operands(), b._cache_operands()):
        eq = eq and bool(torch.equal(x[:, 1:], y[:, 1:]))
        diff = max(diff, float((x[:, 1:].float() - y[:, 1:].float()).abs()
                               .max()))
    return eq, diff


def spec_parity(torch, gpt, PagedServingEngine, SpeculativeServingEngine,
                norms):
    """Phase (y), fp32, 2 layers, small widths: the chunked and both
    speculative engines (fp and int8 pools) on the card against the CPU
    (tokens exact, logits within 1e-3), the speculative ones against the
    non-speculative on the card (tokens exact), every verify's writes
    limited to its committed positions, and :func:`pool_bytes`."""
    c = SPEC_PARITY
    cfg = gpt.GPTConfig(vocab_size=c["V"], hidden_size=c["H"],
                        num_layers=c["L"], num_heads=c["nh"],
                        max_seq_len=256, dtype="float32", use_flash=False,
                        remat=False, use_pallas_norm=True)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(SEED + 16),
                             device="cpu")
    rng = np.random.default_rng(SEED + 17)
    prompts = [rng.integers(0, c["V"], n).astype(np.int32)
               for n in (40, 21, 57, 18)]
    prompts[2][:16] = prompts[0][:16]
    new_tokens = 16
    ekw = dict(slots=4, max_len=128, page_size=16, capture_logits=True)
    out = {}
    for kv in ("fp", "int8"):
        runs = {}
        for dev in ("cuda", "cpu"):
            engs = spec_engines(gpt, PagedServingEngine,
                                SpeculativeServingEngine, cfg, params,
                                SEED + 16, kv, device=dev, **ekw)
            probes = []
            runs[dev] = {}
            with contextlib.ExitStack() as stack:
                for name in ("ngram", "draft"):
                    if dev == "cuda":
                        stack.enter_context(window_probe(engs[name], probes))
                for name, eng in engs.items():
                    reqs = [eng.submit(p, new_tokens) for p in prompts]
                    eng.run()
                    runs[dev][name] = reqs
            if dev == "cuda":
                st = {n: engs[n].stats() for n in engs}
                compiles = {n: (st[n]["decode_compiles"],
                                st[n]["spec_draft_compiles"]) for n in st}
                # the prefill ran as graphs: each step captured once
                graphs = {n: [x.captures for x in prefill_steps(engs[n])]
                          for n in engs}
                if any(not g or set(g) != {1} or len(g)
                       != st[n]["prefill_compiles"]
                       for n, g in graphs.items()):
                    raise SystemExit(f"(y) {kv}: prefill graph captures "
                                     f"{graphs}")
                out.setdefault(kv, {})["prefill_graphs"] = {
                    n: len(g) for n, g in graphs.items()}
                out.setdefault(kv, {})["window_writes_outside_commit"] = (
                    sum(probes), len(probes))
                if sum(probes) or not probes:
                    raise SystemExit(f"(y) {kv}: a verify wrote outside its "
                                     f"committed positions: {probes}")
        res = out.setdefault(kv, {})
        res["compiles"] = compiles
        for name in ("base", "ngram", "draft"):
            a, b = runs["cuda"][name], runs["cpu"][name]
            tok = all(x.tokens == y.tokens for x, y in zip(a, b))
            err = max(float(np.abs(np.stack(x.logits) - np.stack(y.logits))
                            .max()) for x, y in zip(a, b))
            res[f"{name}_card_vs_cpu"] = {"tokens_equal": tok,
                                          "max_logit_err": err}
            if not tok or not err <= PARITY_LOGIT_TOL:
                raise SystemExit(f"(y) {kv} {name}: card against CPU: "
                                 f"tokens equal {tok}, max |logit diff| "
                                 f"{err:.3e}")
        for name in ("ngram", "draft"):
            same = all(x.tokens == y.tokens for x, y in zip(
                runs["cuda"][name], runs["cuda"]["base"]))
            res[f"{name}_tokens_equal_base"] = same
            if not same:
                raise SystemExit(f"(y) {kv} {name}: the speculative engine's "
                                 "tokens differ from the non-speculative "
                                 "engine's on the card")
        if compiles["ngram"] != (1, 0) or compiles["draft"] != (1, 2):
            raise SystemExit(f"(y) {kv}: compiles {compiles}")
        res.update(pool_bytes(torch, gpt, PagedServingEngine,
                              SpeculativeServingEngine, cfg, params, kv,
                              prompts[0]))
        res["row_invariance"] = row_invariance(
            torch, gpt, norms, cfg, params, kv, 2, SPEC_K + 1)
        if kv == "fp":
            cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
            res["bf16"] = pool_bytes(torch, gpt, PagedServingEngine,
                                     SpeculativeServingEngine, cfg16, params,
                                     kv, prompts[0])
            res["bf16"]["row_invariance"] = row_invariance(
                torch, gpt, norms, cfg16, params, kv, 2, SPEC_K + 1)
            rows = {n: v for r in (res, res["bf16"])
                    for n, v in r["row_invariance"].items()
                    if n in ("qkv_w", "proj_w", "fc1_w", "fc2_w",
                             "ln1_qkv_w", "ln2_fc1_w")}
            if any(v != 0.0 for v in rows.values()):
                raise SystemExit(f"(y): lane 0 of a verify window and the "
                                 f"decode's rows differ in a weight product "
                                 f"(fp32, bf16): {res['row_invariance']}, "
                                 f"{res['bf16']['row_invariance']}")
    return out


def row_invariance(torch, gpt, norms, cfg, params, kv, S, W):
    """Which of a block's ops give lane 0 of a verify window ([S, W] rows)
    other bits than the one-token decode ([S, 1] rows) on the same input
    rows: the four weight matmuls on the route the paged decode and the
    verify take (the row-invariant kernel; the dequant matmul with int8
    weights) and, with float weights, on cuBLAS (``cublas_*``), the
    LayerNorm kernel and the tied head, on random inputs in the compute
    dtype.  Returns {op: max |difference|} (0.0: the same bits)."""
    from paddle_tpu_torch.ops.cuda import row_matmul
    cd = gpt.torch_dtype(cfg.dtype)
    def to_card(t):
        return ({k: to_card(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to("cuda"))
    p = params if kv == "fp" else gpt.quantize_params(params, "int8")
    p = gpt.prepare_params(to_card(p), cfg)
    blk = gpt.layer(p, 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    out = {}

    def lanes(fn, K):
        x = torch.randn((S, W, K), device="cuda", generator=gen).to(cd)
        with torch.inference_mode():
            full = fn(x)[:, 0]
            one = fn(x[:, :1].contiguous())[:, 0]
        return float((full.float() - one.float()).abs().max())
    for name in ("qkv_w", "proj_w", "fc1_w", "fc2_w"):
        w = blk[name]
        K = (w["qw"] if isinstance(w, dict) else w).shape[0]
        if isinstance(w, dict):
            out[name] = lanes(lambda x: gpt._q_matmul(x, w, cd), K)
        else:
            w2 = w.reshape(K, -1)
            out[name] = lanes(lambda x: row_matmul.matmul(x, w2), K)
            out[f"cublas_{name}"] = lanes(lambda x: x @ w2, K)
            if name in ("qkv_w", "fc1_w"):
                n = name[:3].replace("fc1", "ln2").replace("qkv", "ln1")
                out[f"{n}_{name}"] = lanes(
                    lambda x: row_matmul.ln_matmul(
                        x, blk[f"{n}_g"], blk[f"{n}_b"],
                        cfg.layer_norm_eps, w2), K)
    H = cfg.hidden_size
    out["layer_norm"] = lanes(
        lambda x: norms.layer_norm(x, blk["ln1_g"], blk["ln1_b"]), H)
    out["head"] = lanes(lambda x: x @ p["wte_cd"].T, H)
    return out


def pool_bytes(torch, gpt, PagedServingEngine, SpeculativeServingEngine,
               cfg, params, kv, prompt):
    """(y)'s pool bytes on the card: one request through the
    non-speculative engine, an all-reject speculative run (every verify
    forced to accept nothing) and an accepting one.  Every verify must
    leave the pool as it was but for its committed positions (asserted);
    the prompt's positions, written by the same chunks, must equal the
    non-speculative engine's (asserted); whether the whole pool does, and
    the first layer whose bytes differ, are reported, and the whole pool
    must be equal in both runs (asserted: the int8 pool's codes and scales
    are the same bits on the card, and the fp pool's since the decode and
    the verify take the row-invariant products)."""
    kw = dict(device="cuda", slots=2, max_len=64, page_size=16,
              prefill_chunk=CHUNK)
    if kv == "int8":
        kw.update(quant="int8", kv_dtype="int8")
    engs = {"base": PagedServingEngine((params, cfg), **kw)}
    probes = []
    for mode in ("reject", "accept"):
        engs[mode] = SpeculativeServingEngine(
            (params, cfg), spec_mode="ngram", spec_k=SPEC_K, **kw)
    engs["reject"]._spec_reject = lambda step: True
    ps = 16
    tables = {}
    with contextlib.ExitStack() as stack:
        for mode in ("reject", "accept"):
            stack.enter_context(window_probe(engs[mode], probes))
        for name, eng in engs.items():
            req = eng.submit(prompt, 20)
            while not eng._active.any():
                eng.step()
            tables[name] = eng._tables_np[req.slot].copy()
            eng.run()
    if sum(probes) or not probes:
        raise SystemExit(f"(y) {kv}: a verify wrote outside its committed "
                         f"positions: {probes}")
    n = len(prompt)
    res = {}
    for mode in ("reject", "accept"):
        a, b = engs["base"], engs[mode]
        eq, diff = pool_compare(torch, a, b)
        prompt_eq = all(
            bool(torch.equal(x[:, int(tables["base"][p // ps]), p % ps],
                             y[:, int(tables[mode][p // ps]), p % ps]))
            for x, y in zip(a._cache_operands(), b._cache_operands())
            for p in range(n))
        layers = [all(bool(torch.equal(x[i, 1:], y[i, 1:])) for x, y in
                      zip(a._cache_operands(), b._cache_operands()))
                  for i in range(cfg.num_layers)]
        res[f"{mode}_pool_equal"] = eq
        res[f"{mode}_pool_max_diff"] = diff
        res[f"{mode}_layers_equal"] = layers
        res[f"{mode}_prompt_positions_equal"] = prompt_eq
        res[f"{mode}_accepted_tokens"] = b.stats()["accepted_tokens"]
        if not prompt_eq:
            raise SystemExit(f"(y) {kv} {mode}: the prompt's positions differ "
                             "from the non-speculative engine's")
        if not eq:
            raise SystemExit(f"(y) {kv} {cfg.dtype} {mode}: the pool differs "
                             f"from the non-speculative engine's (max diff "
                             f"{diff:.3e}, layers equal {layers})")
    res["verifies_probed"] = len(probes)
    return res


def spec_phases(torch, gpt, PagedServingEngine, kernels, card, launches,
                args):
    """Phases (w), (x), (y), logged; their launches go into
    ``launches``.  With ``--profile`` (w) and (x) are traced too."""
    trace_dir = os.path.dirname(os.path.abspath(args.trace))
    from paddle_tpu_torch.inference.speculative import (
        SpeculativeServingEngine)
    paged_attn, norms, dqmm = kernels

    # (w) ---------------------------------------------------------------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(gpt.gpt_345m(), use_pallas_norm=True)
    params = gpt.params_from_numpy(numpy_gpt_params(cfg, SEED), "cuda")
    prompts = make_prompts(cfg.vocab_size)
    w = chunked_path(torch, gpt, PagedServingEngine, kernels, cfg, params,
                     prompts, 32, card, args.profile, trace_dir)
    del params
    torch.cuda.empty_cache()
    for kv, r in w.items():
        ch, un = r["runs"]["chunked"], r["runs"]["unchunked"]
        sfx = "_quant" if kv == "int8" else ""
        for k in ("layer_norm", "paged_attention", "paged_attention_quant",
                  "dequant_matmul", "row_matmul", "ln_row_matmul"):
            if ch[0]["launches"][k]:
                launches[f"{k}_chunked{sfx}"] = ch[0]["launches"][k]
        log(f"(w) chunked prefill (prefill_chunk={CHUNK}) of gpt_345m, "
            f"{kv} {'(int8 weights and pool, (j)) ' if sfx else '((d)) '}"
            f"the 12 requests x 32 tokens, alternated with the unchunked "
            f"engine, on {card}:")
        for i, (a, b) in enumerate(zip(ch, un)):
            log(f"    round {i + 1}: chunked tokens/s {a['tokens_per_s']} "
                f"(decode tokens/s {a['decode_tokens_per_s']}), "
                f"prefill chunk {a['chunk_ms']} ms x "
                f"{a['delta']['prefill_chunks']}, decode step "
                f"{a['step_ms']} ms x {a['delta']['decode_steps']}, wall "
                f"{a['wall_s']:.3f} s, prefix hits "
                f"{a['delta']['prefix_page_hits']}; unchunked tokens/s "
                f"{b['tokens_per_s']} (decode tokens/s "
                f"{b['decode_tokens_per_s']}), prefill wave {b['wave_ms']} "
                f"ms x {b['delta']['prefill_calls']}, decode step "
                f"{b['step_ms']}"
                f" ms x {b['delta']['decode_steps']}, wall "
                f"{b['wall_s']:.3f} s")
        log(f"    launches a chunked pass {ch[0]['launches']}; tokens equal "
            f"to the unchunked engine's: {r['tokens_equal_unchunked_share']}"
            f" (bf16: chunks and waves round differently; not asserted); "
            f"warmup {r['warmup_s']:.1f} s, prefill graphs captured in it "
            f"{r['prefill_graphs']} (chunked: 3 waves and the chunk), none "
            f"during the traffic  [{card}]")
        log_prefill_vs_eager(r["chunk_vs_eager"], "bf16, reported", card)
        if "profile" in r:
            log(f"    {kv} prefill-chunk profile (one {CHUNK}-token chunk "
                f"an iteration) on {card}: {json.dumps(r['profile'])}")
    log(f"    phase {time.perf_counter() - t0:.1f} s")

    # (x) ---------------------------------------------------------------
    t0 = time.perf_counter()
    x = spec_path(torch, gpt, PagedServingEngine, SpeculativeServingEngine,
                  kernels, card, args.profile, trace_dir)
    for kv, r in x.items():
        if kv not in ("fp", "int8"):
            continue
        sfx = "_quant" if kv == "int8" else ""
        ng = r["runs"]["ngram"][0]["launches"]
        for k in ("layer_norm", "paged_attention", "paged_attention_quant",
                  "dequant_matmul", "row_matmul", "ln_row_matmul"):
            if ng[k]:
                launches[f"{k}_spec{sfx}"] = ng[k]
        if kv == "int8":
            launches["dequant_matmul_spec_quant_m40"] = ng[
                "dequant_matmul_by_rows"].get(8 * (SPEC_K + 1), 0)
        log(f"(x) speculative decoding (spec_k={SPEC_K}, prefill_chunk="
            f"{CHUNK}) of gpt_345m (init_params seed {SEED}), {kv} pool"
            f"{' and int8 weights' if sfx else ''}, 12 requests (prompts "
            f"{min(x['prompt_lens'])}-{max(x['prompt_lens'])}, 3 of 4 share 16"
            f" tokens) x 32 tokens, alternated, on {card}:")
        for name in ("base", "ngram", "draft"):
            for i, run in enumerate(r["runs"][name]):
                d = run["delta"]
                log(f"    {name:5s} round {i + 1}: tokens/s "
                    f"{run['tokens_per_s']}, decode tokens/s "
                    f"{run['decode_tokens_per_s']}, decode/verify step "
                    f"{run['step_ms']} ms x {d['decode_steps']} (drafting "
                    f"{run['draft_ms']} ms, the rest {run['verify_ms']} ms)"
                    f", prefill chunk {run['chunk_ms']} ms x "
                    f"{d['prefill_chunks']}, accepted {d['accepted_tokens']}"
                    f" of {d['drafted_tokens']} drafted, wall "
                    f"{run['wall_s']:.3f} s")
        log(f"    accepted tokens per verify (committed per row-verify) "
            f"{r['accepted_tokens_per_step']}; tokens equal to the "
            f"non-speculative engine's {r['tokens_equal_base_share']} (bf16,"
            f" not asserted); launches a pass: ngram "
            f"{r['runs']['ngram'][0]['launches']}, draft "
            f"{r['runs']['draft'][0]['launches']}; decode_compiles 1, "
            f"spec_draft_compiles 0 / 2; warmup {r['warmup_s']:.1f} s  "
            f"[{card}]")
        if "profile" in r:
            log(f"    self-draft profile (every slot decoding; the whole "
                f"iteration, then the draft step alone) on {card}: "
                f"{json.dumps(r['profile'])}")
    log(f"    phase {time.perf_counter() - t0:.1f} s (draft weights drawn on "
        f"the host in {x['init_s']:.1f} s)")

    # (y) ---------------------------------------------------------------
    t0 = time.perf_counter()
    y = spec_parity(torch, gpt, PagedServingEngine, SpeculativeServingEngine,
                    norms)
    for kv, r in y.items():
        log(f"(y) fp32 {kv} pool, V={SPEC_PARITY['V']}, H={SPEC_PARITY['H']}"
            f", {SPEC_PARITY['L']} layers, 4 requests x 16 tokens, "
            f"prefill_chunk={CHUNK}, spec_k={SPEC_K}: card against CPU "
            + "; ".join(f"{n} tokens equal "
                        f"{r[f'{n}_card_vs_cpu']['tokens_equal']}"
                        f", max |logit diff| "
                        f"{r[f'{n}_card_vs_cpu']['max_logit_err']:.3e}"
                        for n in ("base", "ngram", "draft"))
            + f" (tol {PARITY_LOGIT_TOL:.0e}); on the card ngram / draft "
            f"tokens equal the non-speculative engine's "
            f"{r['ngram_tokens_equal_base']} / {r['draft_tokens_equal_base']}"
            f"; verify writes outside the committed positions "
            f"{r['window_writes_outside_commit'][0]} in "
            f"{r['window_writes_outside_commit'][1]} verifies; compiles "
            f"{r['compiles']}; prefill graphs (each captured once) "
            f"{r['prefill_graphs']}")
        whole = "; whole pool equal in both (asserted)"
        if kv == "fp":
            b = r["bf16"]
            whole += (f"; in bf16: all-reject equal {b['reject_pool_equal']}"
                      f", accepting ({b['accept_accepted_tokens']} accepted)"
                      f" equal {b['accept_pool_equal']} (asserted), lane 0 "
                      f"against [2, 1] rows {b['row_invariance']}")
        log(f"    pool bytes against the non-speculative engine (1 request,"
            f" 20 tokens; {r['verifies_probed']} verifies, none wrote outside"
            f" its committed positions, asserted): all-reject run equal "
            f"{r['reject_pool_equal']} (max diff "
            f"{r['reject_pool_max_diff']:.3e}, layers equal "
            f"{r['reject_layers_equal']}); accepting run "
            f"({r['accept_accepted_tokens']} accepted) equal "
            f"{r['accept_pool_equal']} (max diff "
            f"{r['accept_pool_max_diff']:.3e}, layers equal "
            f"{r['accept_layers_equal']}); prompt positions equal in both "
            f"(asserted){whole}; lane 0 of a [2, {SPEC_K + 1}] window "
            f"against [2, 1] rows, max |difference| by op (0: the same "
            f"bits): "
            f"{r['row_invariance']}")
    log(f"    phase {time.perf_counter() - t0:.1f} s")
    return w, x, y


# (aa), (ab), (ac): the static graph and the vision stack -------------------
RESNET_TRAIN_FLOPS_PER_IMG = 3 * 2 * 4.09e9   # bench.py:265, ResNet50 at 224
RESNET = dict(batch=128, size=224, classes=1000, steps=10)   # bench.py:268
LENET_STEPS = 40


def resnet_program(pt, depth, size, classes, amp):
    """``bench.py:276-291``'s program through the port: static
    placeholders, ``resnet{depth}`` under ``amp.auto_cast()`` (bf16) when
    ``amp``, cross entropy, Momentum(0.002, 0.9, weight decay 1e-4)
    ``minimize``.  Returns (main, startup, net, loss, the data variables
    and the logits by name)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.vision import models
    F = pt.nn.functional
    pt.enable_static()
    try:
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            img = static.data("image", [None, 3, size, size], "float32")
            label = static.data("label", [None, 1], "int64")
            with (pt.amp.auto_cast() if amp else contextlib.nullcontext()):
                net = getattr(models, f"resnet{depth}")(num_classes=classes)
                logits = net(img)
                loss = F.cross_entropy(logits, label).mean()
            pt.optimizer.Momentum(learning_rate=0.002, momentum=0.9,
                                  weight_decay=1e-4).minimize(loss)
    finally:
        pt.disable_static()
    return main, startup, net, loss, {"image": img, "label": label,
                                      "logits": logits}


def resnet_path(torch, pt, args):
    """Phase (aa): ``bench.py``'s ResNet50 train step at full size (224 x
    224, 1000 classes, batch 128, bf16 ``auto_cast``), device feeds; the
    fetch and the fetchless run once each to warm up, then 10 timed steps
    ending in one fetch, as ``bench.py:302-313``."""
    from paddle_tpu_torch import static
    c = RESNET
    pt.seed(SEED)
    t0 = time.perf_counter()
    main, startup, net, loss, _ = resnet_program(pt, 50, c["size"],
                                                 c["classes"], True)
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    feed = {"image": pt.to_tensor(rng.randn(c["batch"], 3, c["size"],
                                            c["size"]).astype(np.float32)),
            "label": pt.to_tensor(rng.randint(0, c["classes"], (
                c["batch"], 1)).astype(np.int64))}
    stats = static.executor_stats
    exe = static.Executor()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b0 = stats["builds"]
    pt.enable_static()
    try:
        if exe.run(startup) != []:
            raise SystemExit("(aa): the startup program returned fetches")
        lv0, = exe.run(main, feed=feed, fetch_list=[loss])
        exe.run(main, feed=feed, fetch_list=[])
        torch.cuda.synchronize()
        b1 = stats["builds"]
        t0 = time.perf_counter()
        for _ in range(c["steps"] - 1):
            exe.run(main, feed=feed, fetch_list=[])
        lv, = exe.run(main, feed=feed, fetch_list=[loss])
        final = float(np.asarray(lv))
        dt = time.perf_counter() - t0
        b2 = stats["builds"]
        prof = None
        if args.profile_train:
            prof = profile_steps(
                torch, lambda: exe.run(main, feed=feed, fetch_list=[]),
                args.profile_train, "resnet_step",
                os.path.join(os.path.dirname(os.path.abspath(
                    args.train_trace)), "resnet_trace.json"))
    finally:
        pt.disable_static()
    first = float(np.asarray(lv0))
    if not (np.isfinite(first) and np.isfinite(final) and final < first):
        raise SystemExit(f"(aa): loss {first} -> {final}: not finite and "
                         "falling")
    if (b1 - b0, b2 - b1) != (2, 0):
        raise SystemExit(f"(aa): executor builds {b1 - b0} in warm-up, "
                         f"{b2 - b1} in the timed steps (want 2, 0)")
    ips = c["batch"] * c["steps"] / dt
    out = {"imgs_per_s": ips, "step_ms": 1e3 * dt / c["steps"],
           "model_flop_share": ips * RESNET_TRAIN_FLOPS_PER_IMG
           / BF16_FLOPS_PER_S,
           "loss_first": first, "loss_final": final,
           "builds": (b1 - b0, b2 - b1), "build_s": build_s,
           "ops": len(main.ops), "params": len(main.params),
           "written_back": len(main.mutated),
           "max_memory_reserved_gib": torch.cuda.max_memory_reserved()
           / 2 ** 30}
    if prof is not None:
        out["profile"] = prof
    return out


def resnet_parity(torch, pt):
    """Phase (ab): ``resnet50(num_classes=10)`` at 32 x 32, batch 4, one
    static step on the card (cuDNN, TF32 off) and on the CPU (the plain
    versions) from the same weights: loss and every parameter and buffer
    at rtol 1e-4, atol 1e-5, asserted in float64 (params, buffers and
    feeds cast after the build) and reported in fp32, where the step is
    ill-conditioned (layer4's batch statistics are over 4 values a
    channel: the JAX reference's own fp32 step is up to 5,000 times that
    tolerance from a float64 one, ``tests/test_torch_static.py``)."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 3, 32, 32)
    y = rng.randint(0, 10, (4, 1)).astype(np.int64)
    pt.seed(SEED + 20)
    init = None
    out = {}
    for dt in (torch.float64, torch.float32):
        runs = {}
        for dev in ("gpu", "cpu"):
            pt.set_device(dev)
            main, _, net, loss, _ = resnet_program(pt, 50, 32, 10, False)
            if init is None:
                init = {k: v.value.detach().cpu().numpy().copy()
                        for k, v in net.state_dict().items()}
            net.set_state_dict(init)
            for t in net.state_dict().values():
                t.value = t.value.detach().to(dt)
                if isinstance(t, pt.tensor.Parameter):
                    t._mark()
            device = "cuda" if dev == "gpu" else "cpu"
            pt.enable_static()
            try:
                lv, = pt.static.Executor().run(main, feed={
                    "image": pt.Tensor(torch.from_numpy(x).to(device, dt)),
                    "label": y}, fetch_list=[loss])
            finally:
                pt.disable_static()
            runs[dev] = (float(lv), {k: v.value.detach().double().cpu()
                                     .numpy() for k, v in
                                     net.state_dict().items()})
        (lg, wg), (lc, wc) = runs["gpu"], runs["cpu"]
        worst = max(float((np.abs(wg[k] - wc[k])
                           / (1e-5 + 1e-4 * np.abs(wc[k]))).max())
                    for k in wc)
        out[str(dt)] = {"loss_card": lg, "loss_cpu": lc,
                        "loss_rel_diff": abs(lg - lc) / abs(lc),
                        "worst_ratio_to_tol": worst}
    pt.set_device("gpu")
    r = out[str(torch.float64)]
    if not (r["loss_rel_diff"] <= 1e-4 and r["worst_ratio_to_tol"] <= 1.0):
        raise SystemExit(f"(ab): ResNet50's float64 step on the card "
                         f"differs from the CPU's: {r}")
    return out


def lenet_path(torch, pt):
    """Phase (ac): the verify flow's dygraph path on the card: LeNet on the
    synthetic MNIST through ``io.DataLoader`` (batch 64), Adam 1e-3,
    ``loss.backward()``, ``step()``, ``clear_grad()``, 40 steps; the loss
    must fall (the last five steps' mean under half the first five's)."""
    from paddle_tpu_torch import vision
    pt.seed(SEED + 21)
    net = vision.models.LeNet()
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
    loader = pt.io.DataLoader(vision.datasets.MNIST(mode="train"),
                              batch_size=64, shuffle=True)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step, (img, label) in enumerate(loader):
        if step == LENET_STEPS:
            break
        if step == 0 and img.place.device.type != "cuda":
            raise SystemExit(f"(ac): batches on {img.place}, not the card")
        loss = pt.nn.functional.cross_entropy(net(img), label).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    dt = time.perf_counter() - t0
    if not (all(np.isfinite(losses)) and
            np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])):
        raise SystemExit(f"(ac): LeNet's loss does not fall: {losses}")
    return {"losses": losses, "step_ms": 1e3 * dt / len(losses)}


def vision_phases(torch, card, args):
    """Phases (aa), (ab), (ac), logged."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    prev = core._state.expected_place
    pt.set_device("gpu")
    try:
        t0 = time.perf_counter()
        aa = resnet_path(torch, pt, args)
        c = RESNET
        log(f"(aa) bench.py's ResNet50 static train step through the port "
            f"(static.Program, Executor; resnet50 under amp.auto_cast bf16, "
            f"Momentum 0.002 / 0.9 / 1e-4), {c['size']}x{c['size']}, "
            f"{c['classes']} classes, batch {c['batch']}, device feeds, on "
            f"{card}:")
        log(f"    imgs/s {aa['imgs_per_s']} ({c['steps']} steps, the last "
            f"fetched); step {aa['step_ms']} ms; model-FLOP share "
            f"{aa['model_flop_share']} (3 x 2 x 4.09e9 FLOPs an image over "
            f"989 TFLOP/s bf16); loss {aa['loss_first']} -> "
            f"{aa['loss_final']}; executor builds {aa['builds'][0]} in the "
            f"warm-up (fetch, fetchless), {aa['builds'][1]} in the timed "
            f"steps; program: {aa['ops']} ops, {aa['params']} parameters, "
            f"{aa['written_back']} buffers written back, built in "
            f"{aa['build_s']:.1f} s; max_memory_reserved "
            f"{aa['max_memory_reserved_gib']} GiB; phase "
            f"{time.perf_counter() - t0:.1f} s  [{card}]")
        if "profile" in aa:
            log(f"    ResNet50 fetchless step profile on {card}: "
                f"{json.dumps(aa['profile'])}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ab = resnet_parity(torch, pt)
        log("(ab) ResNet50 (10 classes) at 32x32, batch 4, one static step, "
            "card (cuDNN, TF32 off) against CPU from the same weights: "
            + "; ".join(f"{dt}: loss {r['loss_card']} / {r['loss_cpu']} "
                        f"(relative diff {r['loss_rel_diff']:.3e}), "
                        f"parameters and buffers at worst "
                        f"{r['worst_ratio_to_tol']:.3e} x (1e-5 + 1e-4 "
                        f"|cpu|)" for dt, r in ab.items())
            + f" (float64 asserted, fp32 reported); phase "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ac = lenet_path(torch, pt)
        ls = ac["losses"]
        log(f"(ac) LeNet dygraph on the synthetic MNIST (io.DataLoader, "
            f"batch 64, Adam 1e-3), {len(ls)} steps on the card: loss "
            f"{ls[0]:.4f} -> {ls[-1]:.4f} (first five {np.mean(ls[:5]):.4f}"
            f", last five {np.mean(ls[-5:]):.4f}); {ac['step_ms']:.2f} ms a "
            f"step; phase {time.perf_counter() - t0:.1f} s  [{card}]")
    finally:
        core._state.expected_place = prev
    return aa, ab, ac


# (ad), (ae), (af): the eager tensor API and a multi-label fine-tune --------

MULTILABEL = 16               # (ae), (af): labels of the classifier's head
MULTILABEL_PARITY = (4, 256)  # (af): B, N at ERNIE widths, 2 layers


def op_sweep_phase(pt):
    """Phase (ad): every case of ``tools/op_sweep.py``'s tables on the
    card against the CPU, and the random ops on the card."""
    from tools import op_sweep as S
    tables = {"tensor API": S.TENSOR_CASES, "activations": S.ACT_CASES,
              "losses": S.LOSS_CASES, "loss layers": S.LOSS_LAYER_CASES}
    res, failed = {}, []
    for label, cases in tables.items():
        checked, bad, worst = S.card_sweep(pt, cases)
        w = max(worst, key=worst.get) if worst else None
        res[label] = {"cases": len(cases), "checked": len(checked),
                      "ops": len({c.split(":")[0] for c in checked}),
                      "worst": w, "worst_err": worst.get(w, 0.0),
                      "with_grads": sum(c.grad for c in cases
                                        if c.name in checked)}
        failed += [(f"{label}: {n}", e) for n, e in bad]
    checked, bad = S.card_random(pt)
    res["random"] = {"cases": len(S.RANDOM_CASES), "checked": len(checked)}
    failed += [(f"random: {n}", e) for n, e in bad]
    covered = ({c.name.split(":")[0] for c in S.TENSOR_CASES}
               | {r[0].split(":")[0] for r in S.RANDOM_CASES})
    res["left_out"] = {n: S.LEFT_OUT.get(n, "no case in tools/op_sweep.py")
                       for n in S.TENSOR_API_NAMES if n not in covered}
    if set(res["left_out"]) - set(S.LEFT_OUT):
        raise SystemExit(f"(ad): reference ops with no case: "
                         f"{sorted(set(res['left_out']) - set(S.LEFT_OUT))}")
    res["api_ops"] = len(S.TENSOR_API_NAMES) - len(res["left_out"])
    res["failed"] = failed
    return res


def multilabel_classifier(pt, bert, cfg):
    """A user's multi-label classifier: ``ErnieModel(cfg)``'s pooled
    output into a ``Linear(H, 16)``."""
    class ErnieMultiLabel(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ernie = bert.ErnieModel(cfg)
            self.cls = pt.nn.Linear(cfg.hidden_size, MULTILABEL)

        def forward(self, tokens):
            _, pooled = self.ernie(tokens)
            return self.cls(pooled)
    return ErnieMultiLabel()


def trained_params(net):
    """The parameters the classifier reads: not ERNIE's pretraining heads,
    which the pooled output never reaches."""
    return [p for n, p in net.named_parameters()
            if not n.startswith(("ernie.mlm_", "ernie.nsp_"))]


def multilabel_batch(V, B, N, seed):
    """[B, N] int64 token ids and [B, 16] float 0/1 labels (each label on
    with probability 0.25), numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, N)),
            (rng.random((B, MULTILABEL)) < 0.25).astype(np.float32))


def multilabel_loop(pt, net, batch, warmup, epsilon=1e-8, start_lr=0.0):
    """AdamW (weight decay 0.01, ``ClipGradByGlobalNorm(1.0)``) on
    ``LinearWarmup`` from ``start_lr`` to 1e-4 over the classifier's
    parameters; returns ``step()``: ``loss = BCEWithLogitsLoss()(net(t),
    y)``, ``backward``, ``step``, ``clear_grad``, the scheduler's step,
    ``float(loss)``."""
    sched = pt.optimizer.lr.LinearWarmup(1e-4, warmup, start_lr, 1e-4)
    opt = pt.optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                             epsilon=epsilon,
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
                             parameters=trained_params(net))
    crit = pt.nn.BCEWithLogitsLoss()
    t, y = (pt.to_tensor(a) for a in batch)

    def step():
        loss = crit(net(t), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return float(loss)
    return step


def multilabel_predict(pt, net, batch):
    """The user's evaluation: logits under ``no_grad``, predictions
    ``cast(greater_than(sigmoid(logits), 0.5))``, micro-F1 from
    ``logical_and`` and ``sum``, each row's top 3 labels by ``topk``."""
    F = pt.nn.functional
    t, y = (pt.to_tensor(a) for a in batch)
    net.eval()
    with pt.no_grad():
        logits = net(t)
    net.train()
    pred = pt.cast(pt.greater_than(F.sigmoid(logits), pt.full([1], 0.5)),
                   "float32")
    tp = pt.sum(pt.cast(pt.logical_and(pred > 0, y > 0), "float32"))
    f1 = 2 * tp / (pt.sum(pred) + pt.sum(y))
    top = pt.topk(logits, 3)[1]
    return logits, pred, f1, top


def multilabel_path(torch, pt, bert, flash_attn, norms, args):
    """Phase (ae): the 16-label fine-tune at full ERNIE-3.0-Base width
    and depth (with ``--profile-train``, its steps traced)."""
    cfg = bert.ernie_3_base()
    L, B, N = cfg.num_layers, ERNIE_BATCH, cfg.max_seq_len
    t0 = time.perf_counter()
    pt.seed(SEED + 70)
    net = multilabel_classifier(pt, bert, cfg)
    batch = multilabel_batch(cfg.vocab_size, B, N, SEED + 71)
    step = multilabel_loop(pt, net, batch, warmup=ERNIE_STEPS)
    setup_s = time.perf_counter() - t0
    counters = eager_counters(flash_attn, norms)
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_fused": 0,
            "flash_attention_nokey": 0, "layer_norm": 0, "rms_norm": 0}
    res = timed_loop(torch, lambda t: step(), ERNIE_STEPS, counters, want,
                     "(ae)", B, N)
    n_params = sum(p.size for p in trained_params(net))
    res.update(setup_s=setup_s, num_params=n_params,
               flops_per_token=6 * n_params + 12 * L * cfg.hidden_size * N)
    res["model_flop_share"] = (res["tokens_per_s"] * res["flops_per_token"]
                               / BF16_FLOPS_PER_S)
    zero_counts(counters)
    logits, pred, f1, top = multilabel_predict(pt, net, batch)
    f1 = float(f1)
    res["predict_launches"] = read_counts(counters)
    check_counts("(ae) predict", res["predict_launches"],
                 {"flash_attention_fwd": L, "flash_attention_bwd_dq": 0,
                  "flash_attention_bwd_dkv": 0}, 1)
    outs = {"logits": logits, "pred": pred, "top": top}
    places = {k: str(v.place) for k, v in outs.items()}
    picked = pt.take_along_axis(logits, top, 1).numpy()
    best = pt.sort(logits, 1, True).numpy()[:, :3]
    if (pred.shape != [B, MULTILABEL] or pred.dtype != pt.float32
            or top.shape != [B, 3] or top.dtype != pt.int32
            or any("cpu" in p for p in places.values())
            or not 0.0 <= f1 <= 1.0 or not np.array_equal(picked, best)):
        raise SystemExit(f"(ae): predictions {pred.shape} {pred.dtype}, top "
                         f"{top.shape} {top.dtype} at {places}, F1 {f1}, "
                         f"top logits {picked[:2]} against {best[:2]}")
    res.update(f1=f1, positive_share=float(pred.numpy().mean()),
               top3_row0=top.numpy()[0].tolist())
    if args.profile_train:
        res["profile"] = profile_steps(
            torch, step, args.profile_train, "train_step_multilabel",
            args.train_trace.replace(".json", "_multilabel.json"))
    del net, step
    torch.cuda.empty_cache()
    return res


def multilabel_parity(torch, pt, bert, flash_attn):
    """Phase (af): (ae)'s loop in fp32 at ERNIE widths with 2 layers,
    [4, 256], every leaf drawn from numpy as (v) draws them, 3 steps on
    the card (kernels) and on the CPU (plain versions).  The learning
    rate is 1e-4 from the first step, so each step moves the parameters;
    the losses compared are the three steps' and the loss of the
    evaluation after the third update."""
    from paddle_tpu_torch.framework import core
    B, N = MULTILABEL_PARITY
    cfg = dataclasses.replace(bert.ernie_3_base(), num_layers=2,
                              dtype="float32")
    batch = multilabel_batch(cfg.vocab_size, B, N, SEED + 72)
    rng = np.random.default_rng(SEED + 73)
    weights, out = None, {}
    prev = core._state.expected_place
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            net = multilabel_classifier(pt, bert, cfg)
            if weights is None:
                weights = {k: (1 + 0.1 * rng.standard_normal(p.shape)
                               if k.endswith("_g") else
                               0.02 * rng.standard_normal(p.shape)
                               ).astype(np.float32)
                           for k, p in net.state_dict().items()}
            net.set_state_dict(weights)
            # Adam's eps 1e-6, as (q), (s) and (v): see ernie_parity
            step = multilabel_loop(pt, net, batch, warmup=1, epsilon=1e-6,
                                   start_lr=1e-4)
            before = (flash_attn.fwd_launches, flash_attn.dq_launches,
                      flash_attn.dkv_launches)
            losses = [step() for _ in range(3)]
            params = {k: p.numpy() for k, p in net.state_dict().items()}
            logits, pred, f1, top = multilabel_predict(pt, net, batch)
            losses.append(float(pt.nn.BCEWithLogitsLoss()(
                logits, pt.to_tensor(batch[1]))))
            launched = tuple(a - b for a, b in zip(
                (flash_attn.fwd_launches, flash_attn.dq_launches,
                 flash_attn.dkv_launches), before))
            out[place] = (losses, params, pred.numpy(), float(f1),
                          top.numpy(), launched)
            del net, step
    finally:
        core._state.expected_place = prev
    (lg, pg, dg, fg, tg, launched), (lc, pc, dc, fc, tc, _) = (out["gpu"],
                                                               out["cpu"])
    L = cfg.num_layers
    param_rel = {k: float(np.abs(pg[k] - p).max()
                          / max(float(np.abs(p).max()), 1e-30))
                 for k, p in pc.items()}
    res = {"loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(lg, lc)],
           "param_rel_err_max": max(param_rel.values()),
           "param_rel_err_worst": max(param_rel, key=param_rel.get),
           "pred_equal": bool(np.array_equal(dg, dc)),
           "f1_card": fg, "f1_cpu": fc,
           "top3_equal": bool(np.array_equal(tg, tc)),
           "flash_launches": launched,
           "flash_launches_expected": (3 * 2 * L + L, 3 * L, 3 * L)}
    if not (max(res["loss_rel_err"]) <= TRAIN_LOSS_RTOL
            and res["param_rel_err_max"] <= FP32_TOL
            and launched == res["flash_launches_expected"]):
        raise SystemExit(f"(af) the multi-label fine-tune on the card "
                         f"disagrees with the CPU: {json.dumps(res)}")
    return res


def api_phases(torch, flash_attn, norms, card, args, launches):
    """Phases (ad), (ae), (af), logged; (ae)'s flash launches go into
    ``launches``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.models import bert
    prev = core._state.expected_place
    try:
        t0 = time.perf_counter()
        ad = op_sweep_phase(pt)
        for label in ("tensor API", "activations", "losses", "loss layers"):
            r = ad[label]
            log(f"(ad) {label}: {r['checked']} of {r['cases']} cases "
                f"({r['ops']} ops, {r['with_grads']} with gradients) on the "
                f"card equal the CPU's; the largest difference over max|ref| "
                f"{r['worst_err']:.3e} ({r['worst']})")
        log(f"    random ops: {ad['random']['checked']} of "
            f"{ad['random']['cases']} checked on the card; reference "
            f"tensor ops swept: {ad['api_ops']} of "
            f"{ad['api_ops'] + len(ad['left_out'])}; left out: "
            f"{ad['left_out'] or 'none'}; phase "
            f"{time.perf_counter() - t0:.1f} s  [{card}]")
        if ad["failed"]:
            for name, err in ad["failed"]:
                log(f"    FAILED {name}: {err}")
            raise SystemExit(f"(ad): {len(ad['failed'])} cases failed on "
                             f"the card")

        pt.set_device("gpu")
        t0 = time.perf_counter()
        ae = multilabel_path(torch, pt, bert, flash_attn, norms, args)
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            launches[f"{k}_multilabel"] = ae["launches"][k]
        log(f"(ae) ERNIE-3.0-Base 16-label fine-tune (ErnieModel pooled -> "
            f"Linear(768, 16), {ae['num_params'] / 1e6:.1f}M params trained, "
            f"B={ERNIE_BATCH}, N=512, bf16 compute over fp32 params, remat, "
            f"use_flash; BCEWithLogitsLoss, AdamW wd 0.01 + "
            f"ClipGradByGlobalNorm(1.0) on LinearWarmup to 1e-4; a "
            f"hand-written eager loop) on {card}: step {ae['step_ms']} ms, "
            f"tokens/s {ae['tokens_per_s']}, model-FLOP share "
            f"{ae['model_flop_share']} (flops/token "
            f"{ae['flops_per_token']}); max_memory_allocated "
            f"{ae['max_memory_allocated_gib']} GiB; launches "
            f"{ae['launches']} over {ae['steps']} timed steps  [{card}]")
        log(f"    losses {ae['losses']}; step ms {ae['step_ms_each']}; "
            f"warm-up {ae['warmup_s']:.1f} s, set-up {ae['setup_s']:.1f} s; "
            f"predict: micro-F1 {ae['f1']:.4f}, positive share "
            f"{ae['positive_share']:.4f}, row 0's top 3 {ae['top3_row0']}, "
            f"launches {ae['predict_launches']}; phase "
            f"{time.perf_counter() - t0:.1f} s")
        if "profile" in ae:
            log(f"    16-label fine-tune step profile on {card}: "
                f"{json.dumps(ae['profile'])}")

        t0 = time.perf_counter()
        af = multilabel_parity(torch, pt, bert, flash_attn)
        log(f"(af) fp32 16-label fine-tune, card against CPU, ERNIE widths, "
            f"2 layers, {list(MULTILABEL_PARITY)}, 3 steps at lr 1e-4: "
            f"loss rel errs (3 steps, then after the 3rd update) "
            f"{[f'{x:.2e}' for x in af['loss_rel_err']]} (tol "
            f"{TRAIN_LOSS_RTOL:.0e}); max param err / max|param| "
            f"{af['param_rel_err_max']:.2e} ({af['param_rel_err_worst']}; "
            f"tol {FP32_TOL:.0e}); predictions equal {af['pred_equal']}, "
            f"micro-F1 {af['f1_card']:.6f} / {af['f1_cpu']:.6f}, top 3 "
            f"equal {af['top3_equal']} (reported); flash fwd / dq / dk-dv "
            f"launches {af['flash_launches']}; phase "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        core._state.expected_place = prev
    return ad, ae, af


# (ag), (ah), (ai): jit.to_static, the profiler and nan guard, static
# control flow ------------------------------------------------------------

def to_static_path(torch, pt, flash_attn, norms):
    """(ag): (n)'s encoder under ``jit.to_static`` at full width, fp32 then
    bf16, replays alternated with the eager forward.  Returns the
    measurements, the bf16 model, its wrapper and the batches."""
    from paddle_tpu_torch.ops import dispatch
    e = ENCODER
    L = e["L"]
    pt.set_device("gpu")
    model = make_encoder(pt, **e)
    model.set_state_dict(numpy_state(model, SEED + 15))
    rng = np.random.default_rng(SEED + 16)
    batches = [pt.to_tensor(rng.integers(0, e["V"], (ENCODER_BATCH, e["N"])))
               for _ in range(ENCODER_BATCHES + 1)]
    sfn = pt.jit.to_static(model)
    dispatch.reset_cache_stats()
    runs, replay_counts = {}, None
    for dt in ("float32", "bfloat16"):
        model.to(dtype=dt)
        with pt.no_grad():
            t0 = time.perf_counter()
            sfn(batches[0])                   # warm-up, then the capture
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            model(batches[0])
            ts, te, h_err, l_err, bit = [], [], 0.0, 0.0, True
            for ids in batches[1:]:
                c0 = encoder_counts(flash_attn, norms)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h, lg = sfn(ids)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
                c1 = encoder_counts(flash_attn, norms)
                d = {k: c1[k] - c0[k] for k in c1}
                replay_counts = d if replay_counts is None else {
                    k: replay_counts[k] + d[k] for k in d}
                if d != {"layer_norm": 2 * L, "flash_attention_fwd": L,
                         "rms_norm": 1}:
                    raise SystemExit(f"(ag) {dt} replay launched {d}")
                t0 = time.perf_counter()
                eh, el = model(ids)
                torch.cuda.synchronize()
                te.append(time.perf_counter() - t0)
                if not (h.stop_gradient and lg.stop_gradient):
                    raise SystemExit("(ag) to_static outputs record")
                bit = bit and torch.equal(h.value, eh.value) and \
                    torch.equal(lg.value, el.value)
                h_err = max(h_err, max_err(h.value, eh.value)
                            / float(eh.value.float().abs().max()))
                l_err = max(l_err, max_err(lg.value, el.value)
                            / (1.0 if dt == "float32" else
                               float(el.value.float().abs().max())))
                del h, lg, eh, el
        ok = bit or (h_err <= RMS_PARITY_TOL and l_err <= PARITY_LOGIT_TOL
                     if dt == "float32" else
                     max(h_err, l_err) <= BF16_STEPS_TOL)
        if not ok:
            raise SystemExit(f"(ag) {dt} replays differ from eager: final "
                             f"norm {h_err:.3e}, logits {l_err:.3e}")
        B, N = batches[0].shape
        runs[dt] = {"batch_ms": 1e3 * sum(ts) / len(ts),
                    "eager_batch_ms": 1e3 * sum(te) / len(te),
                    "tokens_per_s": B * N * len(ts) / sum(ts),
                    "eager_tokens_per_s": B * N * len(te) / sum(te),
                    "replay_ms_each": [round(1e3 * t, 3) for t in ts],
                    "eager_ms_each": [round(1e3 * t, 3) for t in te],
                    "capture_s": capture_s, "bit_equal": bit,
                    "h_err": h_err, "l_err": l_err}
        runs[dt]["ratio"] = runs[dt]["batch_ms"] / runs[dt]["eager_batch_ms"]
    st = dispatch.cache_stats()
    n = 2 * ENCODER_BATCHES
    if (st["misses"], st["warming"], st["hits"], st["fallbacks"]) != (
            2, 2, n, 0):
        raise SystemExit(f"(ag) cache_stats {st}: want 2 captures, {n} "
                         "replays, no fallback")
    # a second shape: a second graph, the first kept
    with pt.no_grad():
        small = pt.to_tensor(rng.integers(0, e["V"], (4, 256)))
        sh, sl = sfn(small)
        if sl.shape != [4, 256, e["V"]]:
            raise SystemExit(f"(ag) second shape's logits {sl.shape}")
        sfn(batches[1])
    st2 = dispatch.cache_stats()
    if (st2["misses"], st2["hits"], st2["evictions"], len(sfn._graphs)) != (
            3, n + 1, 0, 2):
        raise SystemExit(f"(ag) second shape: cache_stats {st2}, "
                         f"{len(sfn._graphs)} graphs")
    # an in-place update after the capture shows in the next replay
    bias = model.head.bias
    old = bias.value.detach().clone()
    with pt.no_grad():
        _, before = sfn(batches[2])
        bias.set_value(pt.to_tensor(old.float().cpu().numpy() + 1.0))
        _, after = sfn(batches[2])
        _, eager = model(batches[2])
        bias.set_value(pt.Tensor(old))
    if torch.equal(after.value, before.value) or max_err(
            after.value, eager.value) / float(
                eager.value.float().abs().max()) > BF16_STEPS_TOL:
        raise SystemExit("(ag) an in-place bias update is not seen by the "
                         "replay")
    inplace_err = max_err(after.value, eager.value)
    # jit.save, then jit.load: the same outputs
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "paddle_tpu_torch", "_build", "jit_encoder", "model")
    t0 = time.perf_counter()
    pt.jit.save(sfn, path)
    loaded = pt.jit.load(path)
    with pt.no_grad():
        _, want = sfn(batches[3])
        first = loaded(batches[3])[1]
        again = loaded(batches[3])[1]
    saved_bytes = sum(os.path.getsize(path + s) for s in (".pdmodel",
                                                           ".pdiparams"))
    shutil.rmtree(os.path.dirname(path))
    dtypes_ok = all(v.dtype == torch.bfloat16 for k, v in
                    loaded.state_dict().items() if "norm" not in k)
    if not (torch.equal(first.value, want.value)
            and torch.equal(again.value, want.value) and dtypes_ok):
        raise SystemExit(f"(ag) jit.load's outputs differ: "
                         f"{max_err(first.value, want.value):.3e}, "
                         f"{max_err(again.value, want.value):.3e}")
    save_s = time.perf_counter() - t0
    del loaded, first, again, want, before, after, eager, sh, sl
    return {"runs": runs, "stats": st2, "launches": replay_counts,
            "inplace_err": inplace_err, "saved_mib": saved_bytes / 2 ** 20,
            "save_load_s": save_s}, model, sfn, batches


def profiler_path(torch, pt, model, batches):
    """(ah): the profiler around 3 eager bf16 forwards, its chrome trace,
    a device trace, the nan guard and ``check_numerics`` in a graph."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "paddle_tpu_torch", "_build", "profiler")
    res = {}
    with pt.no_grad():
        model(batches[0])
        torch.cuda.synchronize()
        prof = pt.profiler.Profiler()
        walls = []
        with prof:
            for ids in batches[1:4]:
                t0 = time.perf_counter()
                model(ids)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                prof.step()
        rows = [r for r in prof.summary()[1:] if r[0] != "profiler_step"]
        trace = prof.export_chrome_tracing(os.path.join(out_dir,
                                                        "host.json"))
    with open(trace) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev["name"] != "profiler_step"]
    n_ops = sum(c for _, c, _ in rows)
    if len(events) != n_ops or n_ops % 3:
        raise SystemExit(f"(ah) {len(events)} trace events for {n_ops} ops")
    res["ops_a_forward"] = n_ops // 3
    res["host_us_forward"] = 1e6 * sum(t for _, _, t in rows) / 3
    res["wall_us_forward"] = 1e6 * sum(walls) / 3
    res["top10"] = [(name, c // 3, round(1e6 * t / c, 2))
                    for name, c, t in sorted(rows, key=lambda r: -r[2] / r[1])
                    [:10]]
    res["us_an_op"] = res["host_us_forward"] / res["ops_a_forward"]
    # a device trace
    dev_dir = os.path.join(out_dir, "device")
    with pt.no_grad():
        with pt.profiler.Profiler(log_dir=dev_dir):
            model(batches[1])
            torch.cuda.synchronize()
    with open(os.path.join(dev_dir, "trace.json")) as f:
        kernels = sum(1 for ev in json.load(f).get("traceEvents", [])
                      if ev.get("cat") == "kernel")
    shutil.rmtree(out_dir)
    if not kernels:
        raise SystemExit("(ah) the device trace holds no kernel event")
    res["device_kernel_events"] = kernels
    # the nan guard: an inf in one weight
    w = model.encoder.layers[3].linear1.weight
    keep = w.value[0, 0].clone()
    with torch.no_grad():
        w.value[0, 0] = float("inf")
    pt.debug.enable_check_nan_inf(True)
    try:
        with pt.no_grad():
            model(batches[1])
        raise SystemExit("(ah) the nan guard raised nothing")
    except pt.debug.NanInfError as err:
        res["nan_guard"] = str(err)
    finally:
        pt.debug.enable_check_nan_inf(False)
        with torch.no_grad():
            w.value[0, 0] = keep
    if "op 'linear'" not in res["nan_guard"]:
        raise SystemExit(f"(ah) the guard named {res['nan_guard']}")
    # check_numerics inside a to_static graph
    ids = batches[1][:2, :128]

    def checked(ids):
        return pt.debug.check_numerics(model(ids)[1], "logits")
    sfn = pt.jit.to_static(checked)
    sfn(ids)
    sfn(ids)
    hw = model.head.weight
    keep = hw.value[0, 0].clone()
    with torch.no_grad():
        hw.value[0, 0] = float("inf")
    try:
        sfn(ids)
        raise SystemExit("(ah) check_numerics in the graph raised nothing")
    except pt.debug.NanInfError as err:
        res["check_numerics"] = str(err)
    finally:
        with torch.no_grad():
            hw.value[0, 0] = keep
    sfn(ids)                                  # finite again: no raise
    return res


def control_flow_program(pt):
    """(ai)'s program: a fixed-point iteration (``while_loop``), ``cond``
    on a fed threshold and ``switch_case`` on a fed index."""
    def build():
        x = pt.static.data("x", [64], "float32")
        t = pt.static.data("t", [], "float32")
        k = pt.static.data("k", [], "int32")
        lin = pt.nn.Linear(64, 64)
        i = pt.zeros([], "int32")
        d = pt.ones([], "float32")
        i_f, y, _ = pt.static.while_loop(
            lambda i, y, d: pt.logical_and(i < 25, d > 1e-3),
            lambda i, y, d: (i + 1, pt.cos(y), pt.max(pt.abs(pt.cos(y) - y))),
            [i, x, d])
        z = pt.static.cond(y.mean() > t, lambda: lin(y), lambda: y * 2.0)
        out = pt.static.switch_case(k, [lambda: z + 1.0, lambda: pt.tanh(z),
                                        lambda: z * z])
        return [i_f, y, z, out], lin
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.static.program_guard(main, pt.static.Program()):
            fetch, lin = build()
        rng = np.random.default_rng(SEED + 40)
        lin.weight.set_value(0.1 * rng.standard_normal((64, 64),
                                                       dtype=np.float32))
        lin.bias.set_value(0.1 * rng.standard_normal(64, dtype=np.float32))
        x = rng.uniform(0.0, 1.5, 64).astype(np.float32)
        exe = pt.static.Executor()
        outs = []
        for t, k in ((0.5, 0), (0.9, 1), (0.5, 2), (0.9, 5)):
            outs += exe.run(main, feed={"x": x, "t": np.float32(t),
                                        "k": np.int32(k)},
                            fetch_list=fetch)
        return outs
    finally:
        pt.disable_static()


def control_flow_path(torch, pt):
    """(ai): the static program card against CPU, ``to_static`` with a
    tensor ``cond`` and with dropout, and static save / load and
    serialization on the card."""
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.ops import dispatch
    res = {}
    prev = core._state.expected_place
    try:
        got = {}
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            got[place] = control_flow_program(pt)
    finally:
        core._state.expected_place = prev
    worst = 0.0
    for g, c in zip(got["gpu"], got["cpu"]):
        if c.dtype.kind != "f":
            if not np.array_equal(g, c):
                raise SystemExit(f"(ai) integer fetch {g} != {c}")
            continue
        err = float(np.abs(g - c).max()) / max(float(np.abs(c).max()), 1e-30)
        worst = max(worst, err)
    if worst > FP32_TOL:
        raise SystemExit(f"(ai) the program's fetches differ: {worst:.3e}")
    res["program_err"] = worst
    res["iterations"] = int(got["gpu"][0])
    pt.set_device("gpu")
    # cond on a tensor predicate under to_static: both branches, a select

    def f(x):
        return pt.static.cond(x.sum() > 0, lambda: pt.tanh(x) * 2,
                              lambda: -x)
    sf = pt.jit.to_static(f)
    dispatch.reset_cache_stats()
    rng = np.random.default_rng(SEED + 41)
    for _ in range(4):
        x = pt.to_tensor(rng.standard_normal(4096).astype(np.float32))
        if not torch.equal(sf(x).value, f(x).value):
            raise SystemExit("(ai) to_static cond differs from eager")
    st = dispatch.cache_stats()
    if (st["misses"], st["hits"], st["fallbacks"]) != (1, 3, 0):
        raise SystemExit(f"(ai) to_static cond cache_stats {st}")
    # dropout in a training-mode to_static forward
    net = pt.nn.Sequential(pt.nn.Linear(256, 256), pt.nn.Dropout(0.1))
    sn = pt.jit.to_static(net)
    x = pt.to_tensor(np.ones((64, 256), np.float32))
    sn(x)
    pt.seed(SEED)
    a = sn(x).numpy()
    b = sn(x).numpy()
    pt.seed(SEED)
    c = sn(x).numpy()
    if np.array_equal(a, b) or not np.array_equal(a, c):
        raise SystemExit("(ai) dropout masks: replays equal or re-seeding "
                         "does not repeat the first")
    res["dropout_zero_share"] = float((a == 0).mean())
    # static save / load and serialization on the card
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.static.program_guard(main, pt.static.Program()):
            xin = pt.static.data("x", [8, 32], "float32")
            pt.static.nn.fc(pt.static.nn.fc(xin, 64, activation="relu"), 8)
        params = main.all_parameters()
        saved = [p.numpy().copy() for p in params]
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "paddle_tpu_torch", "_build", "static_ckpt",
                            "model")
        pt.static.save(main, path)
        for p in params:
            p.set_value(np.zeros(p.shape, np.float32))
        pt.static.load(main, path)
        shutil.rmtree(os.path.dirname(path))
        ok = all(np.array_equal(p.numpy(), s) for p, s in zip(params, saved))
        blob = pt.static.serialize_persistables(program=main)
        for p in params:
            p.set_value(np.zeros(p.shape, np.float32))
        pt.static.deserialize_persistables(main, blob)
        ok = ok and all(np.array_equal(p.numpy(), s)
                        for p, s in zip(params, saved))
        on_card = all(p.value.is_cuda for p in params)
    finally:
        pt.disable_static()
    if not (ok and on_card):
        raise SystemExit("(ai) static save / load or serialization did not "
                         "round-trip the parameters on the card")
    res["params_round_tripped"] = len(params)
    return res


def jit_phases(torch, flash_attn, norms, card, launches):
    """Phases (ag), (ah), (ai), logged; (ag)'s replay launches go into
    ``launches``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    prev = core._state.expected_place
    try:
        t0 = time.perf_counter()
        ag, model, sfn, batches = to_static_path(torch, pt, flash_attn,
                                                 norms)
        e = ENCODER
        launches["layer_norm_to_static"] = ag["launches"]["layer_norm"]
        launches["flash_attention_fwd_to_static"] = \
            ag["launches"]["flash_attention_fwd"]
        launches["rms_norm_to_static"] = ag["launches"]["rms_norm"]
        log(f"(ag) paddle.jit.to_static of (n)'s encoder (V={e['V']}, "
            f"H={e['H']}, L={e['L']}, nh={e['nh']}, F={e['F']}), "
            f"[{ENCODER_BATCH}, {e['N']}] token ids, no_grad, one CUDA graph "
            f"a dtype, {ENCODER_BATCHES} replays alternated with the eager "
            f"forward, on {card}:")
        for dt, r in ag["runs"].items():
            log(f"    {dt}: replay {r['batch_ms']:.3f} ms a batch, tokens/s "
                f"{r['tokens_per_s']:.0f}; eager {r['eager_batch_ms']:.3f} "
                f"ms, tokens/s {r['eager_tokens_per_s']:.0f}; replay / eager "
                f"{r['ratio']:.4f}; bit-equal to eager {r['bit_equal']} "
                f"(final norm {r['h_err']:.3e} of max, logits "
                f"{r['l_err']:.3e}); warm-up and capture {r['capture_s']:.2f}"
                f" s; replay ms {r['replay_ms_each']}, eager ms "
                f"{r['eager_ms_each']}  [{card}]")
        log(f"    launches over the replays {ag['launches']}; cache_stats "
            f"{ag['stats']} (a [4, 256] graph beside the [8, 512] one); an "
            f"in-place bias update seen (max |diff| to eager "
            f"{ag['inplace_err']:.3e}); jit.save / jit.load of the bf16 "
            f"model ({ag['saved_mib']:.1f} MiB) bit-equal in "
            f"{ag['save_load_s']:.1f} s; phase {time.perf_counter() - t0:.1f}"
            f" s")
        del sfn
        t0 = time.perf_counter()
        ah = profiler_path(torch, pt, model, batches)
        log(f"(ah) profiler over 3 eager bf16 forwards of (ag)'s model: "
            f"{ah['ops_a_forward']} dispatched ops a forward, host "
            f"{ah['host_us_forward']:.1f} us a forward in ops "
            f"({ah['us_an_op']:.2f} us an op), wall "
            f"{ah['wall_us_forward']:.1f} us a forward; the 10 ops with the "
            f"most host us a call (op, calls a forward, us a call): "
            f"{ah['top10']}; chrome trace: one event an op; device trace "
            f"{ah['device_kernel_events']} kernel events  [{card}]")
        log(f"    nan guard: {ah['nan_guard']}; check_numerics in a graph: "
            f"{ah['check_numerics']}; phase {time.perf_counter() - t0:.1f} s")
        del model, batches
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ai = control_flow_path(torch, pt)
        log(f"(ai) a static program (while_loop fixed point, "
            f"{ai['iterations']} iterations; cond; switch_case), card "
            f"against CPU over 4 feeds: max err / max|ref| "
            f"{ai['program_err']:.3e} (tol {FP32_TOL:.0e}), integers exact; "
            f"to_static cond on a tensor predicate equal to eager (1 "
            f"capture, 3 replays); dropout 0.1 in a training-mode to_static "
            f"forward: fresh masks each replay, the first again after "
            f"re-seeding (zero share {ai['dropout_zero_share']:.4f}); "
            f"static save / load and serialize_persistables round-tripped "
            f"{ai['params_round_tripped']} parameters on the card; phase "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        core._state.expected_place = prev
        torch.cuda.empty_cache()


# (z): the slot-contiguous engine ------------------------------------------

def slot_path(torch, ServingEngine, kernels, cfg, params, prompts,
              new_tokens, quant):
    """(z)'s full-width pass: ``ServingEngine(slots=8, max_len=512)`` after
    ``warmup()``, ``prompts`` x ``new_tokens``, exact launch counts, every
    graph captured in warmup and none in the traffic."""
    tag = f"(z) {quant or 'bf16'}"
    L = cfg.num_layers
    eng = ServingEngine((params, cfg), device="cuda", slots=8, max_len=512,
                        quant=quant)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    built = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    captures = check_warm(tag, eng, built)
    reserved = torch.cuda.max_memory_reserved()
    run = serve_run(torch, eng, prompts, new_tokens, kernels, tag)
    check_no_capture(tag, eng, captures, built)
    d, got = run["delta"], run["launches"]
    fwd = d["decode_steps"] + d["prefill_calls"]
    want = {"layer_norm": (2 * L + 1) * fwd, "paged_attention": 0,
            "paged_attention_quant": 0,
            "dequant_matmul": 4 * L * fwd if quant else 0}
    check_launch(tag, got, want)
    if quant:
        check_launch(tag, {8: got["dequant_matmul_by_rows"].get(8)},
                     {8: 4 * L * d["decode_steps"]})
    st = eng.stats()
    res = {"warmup_s": warm_s, "prefill_graphs": built,
           "rungs": sorted(eng._waves),
           "reserved_after_warmup_gib": reserved / 2 ** 30,
           "kv_bytes_reserved": st["kv_bytes_reserved"],
           "decode_compiles": st["decode_compiles"], **run}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def slot_parity(torch, gpt, ServingEngine, prompts, new_tokens):
    """(z)'s fp32 parity at V=4096, H=256, 2 layers: the slot engine on
    the card against the CPU (tokens exact, logits within 1e-3); on the
    card one decode replay against the eager ``gpt.decode_step_slots`` on
    clones of the pool (tokens and pool bytes equal), and the wave
    replays against the eager ``_prefill`` (tokens and bytes equal)."""
    c = SPEC_PARITY
    cfg = gpt.GPTConfig(vocab_size=c["V"], hidden_size=c["H"],
                        num_layers=c["L"], num_heads=c["nh"],
                        max_seq_len=256, dtype="float32", use_flash=False,
                        remat=False, use_pallas_norm=True)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(SEED + 19),
                             device="cpu")
    rng = np.random.default_rng(SEED + 20)
    small = [rng.integers(0, c["V"], n).astype(np.int32)
             for n in (40, 21, 57, 18, 9, 33)]
    runs, res = {}, {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine((params, cfg), device=dev, slots=4, max_len=128,
                            capture_logits=True)
        reqs = [eng.submit(p, new_tokens) for p in small]
        eng.run()
        runs[dev] = reqs
        if dev != "cuda":
            continue
        st, rec = eng._step, []

        def decode(step):
            lens, toks, act = staged(torch, step, ("lens", "toks", "active"))

            def eager():
                lg, _ = gpt.decode_step_slots(
                    eng.params, toks, cfg, {"k": eng._cache_k,
                                            "v": eng._cache_v, "len": lens},
                    act != 0)
                return lg.argmax(-1), lg
            tok, _, clones, _ = eager_on_clones(torch, eng, eager)
            out = step()
            rec.append({"tokens_equal": bool(np.array_equal(tok, out[0])),
                        "pool_equal": all(bool(torch.equal(a, b)) for a, b
                                          in zip(eng._cache_operands(),
                                                 clones))})
            return out
        eng._step = StepProbe(st, decode)
        try:
            probe = [eng.submit(p, 3) for p in small[:4]]
            eng.run()
        finally:
            eng._step = st
        if not rec or not all(r["tokens_equal"] and r["pool_equal"]
                              for r in rec) or not all(r.done for r in probe):
            raise SystemExit(f"(z): a slot decode replay disagrees with the "
                             f"eager step: {rec}")
        res["decode_vs_eager"] = {"replays": len(rec), "tokens_equal": True,
                                  "pool_equal": True}
        res["prefill_vs_eager"] = prefill_vs_eager(torch, gpt, eng,
                                                   small[:4], "(z)", True)
        res["compiles"] = (eng.stats()["prefill_compiles"],
                           eng.stats()["decode_compiles"])
        if res["compiles"][1] != 1 or st.captures != 1:
            raise SystemExit(f"(z): decode_compiles {res['compiles']}, "
                             f"captures {st.captures}")
        del eng
    tok = all(a.tokens == b.tokens for a, b in zip(runs["cuda"], runs["cpu"]))
    err = max(float(np.abs(np.stack(a.logits) - np.stack(b.logits)).max())
              for a, b in zip(runs["cuda"], runs["cpu"]))
    res.update(tokens_equal=tok, max_logit_err=err)
    if not tok or not err <= PARITY_LOGIT_TOL:
        raise SystemExit(f"(z): the slot engine on the card disagrees with "
                         f"the CPU: tokens equal {tok}, max |logit diff| "
                         f"{err:.3e}")
    return res


def slot_phases(torch, gpt, kernels, card, launches, fp_run, qrun):
    """Phase (z), logged: the slot-contiguous engine on (d)'s weights and
    requests, bf16 then int8 weights, beside (d)'s and (j)'s paged
    engines; then its fp32 parity.  Its launches go into ``launches``."""
    from paddle_tpu_torch.inference.serving import ServingEngine
    t0 = time.perf_counter()
    cfg = dataclasses.replace(gpt.gpt_345m(), use_pallas_norm=True)
    params = gpt.params_from_numpy(numpy_gpt_params(cfg, SEED), "cuda")
    prompts = make_prompts(cfg.vocab_size)
    new_tokens = 32
    z = {q: slot_path(torch, ServingEngine, kernels, cfg, params, prompts,
                      new_tokens, q) for q in (None, "int8")}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches["layer_norm_slot"] = z[None]["launches"]["layer_norm"]
    launches["layer_norm_slot_quant"] = z["int8"]["launches"]["layer_norm"]
    launches["dequant_matmul_slot_quant"] = z["int8"]["launches"][
        "dequant_matmul"]
    for q, paged, name in ((None, fp_run, "(d)"), ("int8", qrun, "(j)")):
        r = z[q]
        d = r["delta"]
        log(f"(z) slot-contiguous ServingEngine(slots=8, max_len=512"
            f"{', quant=int8' if q else ''}) of gpt_345m, (d)'s 12 requests"
            f" x {new_tokens} tokens, on {card}:")
        log(f"    tokens/s {r['tokens_per_s']} ({name}'s paged engine: "
            f"{paged['tokens_per_s']}); decode step {r['step_ms']} ms x "
            f"{d['decode_steps']} ({name}: {paged['decode_step_ms']}); "
            f"prefill wave {r['wave_ms']} ms x {d['prefill_calls']} "
            f"({name}: {paged['prefill_wave_ms']}); kv_bytes_reserved "
            f"{r['kv_bytes_reserved']} (the whole pool, always; (d)'s paged "
            f"engine at its peak {fp_run['kv_bytes_reserved_peak']}); "
            f"launches {r['launches']}; warmup: {r['prefill_graphs']} "
            f"prefill graphs (rungs {r['rungs']}) and the decode graph "
            f"captured in {r['warmup_s']:.1f} s, none during the traffic; "
            f"max_memory_reserved over warmup (reset just before it) "
            f"{r['reserved_after_warmup_gib']} GiB  [{card}]")
    par = slot_parity(torch, gpt, ServingEngine, prompts, 16)
    log(f"(z) fp32 slot engine, V={SPEC_PARITY['V']}, H={SPEC_PARITY['H']}, "
        f"{SPEC_PARITY['L']} layers, 6 requests x 16 tokens, card against "
        f"CPU: tokens equal {par['tokens_equal']}, max |logit diff| "
        f"{par['max_logit_err']:.3e} (tol {PARITY_LOGIT_TOL:.0e}); "
        f"(prefill, decode) compiles {par['compiles']}; "
        f"{par['decode_vs_eager']['replays']} decode replays against the "
        f"eager decode_step_slots on clones of the pool: tokens and pool "
        f"bytes equal (asserted)")
    log_prefill_vs_eager(par["prefill_vs_eager"], "fp32, asserted", card)
    log(f"    phase {time.perf_counter() - t0:.1f} s")
    return z, par


# (am), (an), (ao): the sequence-to-sequence path and the rest of nn -------

# (am): Transformer "base" (Vaswani et al. 2017, Table 3) on the WMT14
# en-de shared BPE vocabulary: V, d_model, nh, layers (each side), F
NMT = dict(V=37000, d=512, nh=8, L=6, F=2048)
NMT_DROPOUT = 0.1             # residual and embedding dropout (the paper's)
NMT_BATCH = (128, 32, 32)     # pairs, source and target tokens: 4,096 a side
NMT_WARMUP, NMT_STEPS = 2, 5  # untimed, then timed steps a dtype
NMT_WARMUP_STEPS = 4000       # NoamDecay; the steps start at its peak
NMT_BEAM = (8, 4, 32 + 50)    # sentences, beam_size, max_step_num (sec. 6.1)
NMT_MAX_LEN = 128             # the sinusoid table's rows
NMT_PARITY = (8, 2, 16)       # card vs CPU: pairs a step; sentences, steps
NMT_BF16_LOGIT_TOL = 2.0 ** -8  # bf16 decode card vs CPU: one bf16 step
NMT_START, NMT_END = 1, 2
# (an): Paddle's IWSLT'15 en-vi seq2seq example: vocabularies, hidden and
# embedding width, encoder layers, dropout, batch, padded length, beam
RNN_NMT = dict(src_V=17191, tgt_V=7709, H=512, L=2, dropout=0.2, B=128,
               T=50, beam=10)
RNN_STEPS = 5
RNN_PARITY = (16, 2, 16)      # card vs CPU: batch; sentences, steps


def nmt_batch(V, B, Ns, Nt, seed):
    """Tokens in [3, V) from a numpy seed: source [B, Ns], target input
    (start token first) and output [B, Nt]."""
    rng = np.random.default_rng(seed)
    src = rng.integers(3, V, (B, Ns))
    tgt = rng.integers(3, V, (B, Nt + 1))
    tgt[:, 0] = NMT_START
    return src, tgt[:, :-1], tgt[:, 1:]


def nmt_model(pt, state, dropout):
    """(am)'s model on the default place with ``state``'s weights and no
    attention dropout (the paper has none; the reference's clones would
    otherwise take ``dropout`` there and route to the dense path)."""
    from tools import seq2seq
    e = NMT
    model = seq2seq.nmt_transformer(pt, e["V"], e["d"], e["nh"], e["L"],
                                    e["F"], dropout, NMT_MAX_LEN)
    if state is not None:
        model.set_state_dict(state)
    for layer in model.sublayers():
        if isinstance(layer, pt.nn.MultiHeadAttention):
            layer.dropout = 0.0
    return model


def nmt_optimizer(pt, model):
    """Adam(beta2 0.98, eps 1e-9) on NoamDecay(512, 4000), the paper's,
    resumed at the end of the warm-up (its peak rate, 7.0e-4)."""
    sched = pt.optimizer.lr.NoamDecay(NMT["d"], NMT_WARMUP_STEPS,
                                      last_epoch=NMT_WARMUP_STEPS - 1)
    return sched, pt.optimizer.Adam(learning_rate=sched, beta1=0.9,
                                    beta2=0.98, epsilon=1e-9,
                                    parameters=model.parameters())


def nmt_loss(pt, model, batch):
    from tools import seq2seq
    src, tgt_in, tgt_out = batch
    return seq2seq.label_smoothed_ce(pt, model(src, tgt_in), tgt_out,
                                     NMT["V"])


def nmt_train(torch, pt, flash_attn, norms, state, amp, args):
    """(am) training: :func:`timed_loop` over one 4,096 + 4,096-token
    batch, fp32 or under ``auto_cast`` bf16; 12 flash forwards, 12 dq and
    12 dk/dv a step (encoder self- and cross-attention; the decoder's
    self-attention is dense under ``tgt_mask``), no LayerNorm kernel (the
    training forward records)."""
    B, Ns, Nt = NMT_BATCH
    model = nmt_model(pt, state, NMT_DROPOUT).train()
    sched, opt = nmt_optimizer(pt, model)
    batch = tuple(pt.to_tensor(a) for a in nmt_batch(NMT["V"], B, Ns, Nt,
                                                     SEED + 60))
    L = NMT["L"]

    def step(t):
        if amp:
            with pt.amp.auto_cast(dtype="bfloat16"):
                loss = nmt_loss(pt, model, batch)
        else:
            loss = nmt_loss(pt, model, batch)
        loss.backward()
        opt.step()
        sched.step()
        opt.clear_grad()
        return float(loss)
    for _ in range(NMT_WARMUP - 1):    # timed_loop runs the last one
        step(0)
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": 2 * L,
            "flash_attention_bwd_dkv": 2 * L, "flash_attention_bwd_fused": 0,
            "flash_attention_nokey": 0, "layer_norm": 0, "rms_norm": 0}
    res = timed_loop(torch, step, NMT_STEPS, eager_counters(flash_attn, norms),
                     want, "(am)", B, Nt)
    res["lr"] = sched.last_lr
    if args.profile_train:
        res["profile"] = profile_steps(
            torch, lambda: step(0), args.profile_train, "train_step_nmt",
            args.train_trace.replace(".json", f"_nmt_{int(amp)}.json"))
    del model, opt
    torch.cuda.empty_cache()
    return res


def nmt_decode(pt, model, src, beam, max_steps, trace=None):
    """Beam search over (am)'s model: the encoder once, then the
    flat-state Transformer cell (``tools/seq2seq.py``)."""
    from tools import seq2seq
    with pt.no_grad():
        memory = model.encode(src)
    cell = seq2seq.TransformerCell(pt, model.transformer.decoder,
                                   model.embed, model.project)
    return seq2seq.beam_decode(pt, cell, cell.initial(memory), beam,
                               max_steps, NMT_START, NMT_END, trace)


def nmt_beam(torch, pt, flash_attn, norms, model, dtype, args):
    """(am) beam decode of 8 sentences, timed after a 2-step warm-up
    decode, with the launch counts zeroed just before and read just
    after: the encoder's 6 flash forwards and 12 LayerNorms once, then
    12 and 18 a decode step."""
    n, beam, max_steps = NMT_BEAM
    src, _, _ = nmt_batch(NMT["V"], n, NMT_BATCH[1], 1, SEED + 61)
    src = pt.to_tensor(src)
    nmt_decode(pt, model, src, beam, 2)
    counters = eager_counters(flash_attn, norms)
    torch.cuda.synchronize()
    zero_counts(counters)
    t0 = time.perf_counter()
    out, parents, lengths, lp, steps = nmt_decode(pt, model, src, beam,
                                                  max_steps)
    lp = lp.numpy()
    wall = time.perf_counter() - t0
    got = read_counts(counters)
    L = NMT["L"]
    want = {"flash_attention_fwd": L + 2 * L * steps,
            "layer_norm": 2 * L + 3 * L * steps,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    bad = {k: (got[k], w) for k, w in want.items() if got[k] != w}
    if bad:
        raise SystemExit(f"(am) {dtype} decode: launches (got, want) {bad}")
    if not (np.isfinite(lp).all() and list(out.shape) == [n, steps, beam]):
        raise SystemExit(f"(am) {dtype} decode: shape {out.shape}, "
                         f"finite {bool(np.isfinite(lp).all())}")
    res = {"dtype": dtype, "steps": steps, "wall_s": wall,
           "ms_per_step": 1e3 * wall / steps, "sentences_per_s": n / wall,
           "launches": {k: got[k] for k in want},
           "lengths_mean": float(lengths.numpy().mean()),
           "best_log_prob_mean": float(lp[:, 0].mean())}
    if args.profile:
        # one span: the encoder and ``args.profile`` decode steps
        res["profile"] = profile_steps(
            torch, lambda: nmt_decode(pt, model, src, beam, args.profile), 1,
            "nmt_decode", args.trace.replace(".json", f"_nmt_{dtype}.json"))
    return res


def to_bf16(pt, model):
    """(am)'s bf16 model: weights and the position table in bf16; the
    float32 caches ``gen_cache`` makes promote the decoder after its first
    concat, as the reference's."""
    model.to(dtype="bfloat16")
    model.pos = model.pos.astype("bfloat16")
    return model


def nmt_bf16_parity(pt, state):
    """(am)'s bf16 decode, card against CPU on the same bf16 weights, 2
    sentences for 16 steps, both traced: step by step while the beams
    agree, the logits within ``NMT_BF16_LOGIT_TOL`` of the CPU's
    max|logit|, and a first difference only where the CPU's score margin
    is within the rounding's reach (``seq2seq.traced_parity``).  The
    gate must reject the wrong-scale mutant of the card's logits."""
    from tools import seq2seq
    from paddle_tpu_torch.framework import core
    _, n, steps = NMT_PARITY
    src = nmt_batch(NMT["V"], n, NMT_BATCH[1], 1, SEED + 62)[0]
    runs, prev = {}, core._state.expected_place
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            model = to_bf16(pt, nmt_model(pt, state, 0.0).eval())
            trace = []
            beams = nmt_decode(pt, model, pt.to_tensor(src), NMT_BEAM[1],
                               steps, trace)
            runs[place] = (trace, beams[1].numpy())
            del model
    finally:
        core._state.expected_place = prev
    (tg, pg), (tc, pc) = runs["gpu"], runs["cpu"]
    out = seq2seq.traced_parity(tg, tc, pg, pc, NMT_BEAM[1], NMT_END)
    mutant = [(lp, fin, z * WRONG_SCALE, k) for lp, fin, z, k in tg]
    out["mutant_logit_err"] = seq2seq.traced_parity(
        mutant, tc, pg, pc, NMT_BEAM[1], NMT_END)["logit_err"]
    out["tol"] = NMT_BF16_LOGIT_TOL
    if not (out["logit_err"] <= NMT_BF16_LOGIT_TOL < out["mutant_logit_err"]
            and out["divergence_ok"]):
        raise SystemExit(f"(am) bf16 decode card against CPU: "
                         f"{json.dumps(out)}")
    return out


def nmt_parity(pt, state):
    """(am) card against CPU in fp32 at full width, dropout 0: one
    training step's loss (1e-5) and every gradient (1e-4 of the largest
    |gradient|), then 2 sentences decoded 16 steps, tokens and parents
    exact."""
    B, n, steps = NMT_PARITY
    batch = nmt_batch(NMT["V"], B, NMT_BATCH[1], NMT_BATCH[2], SEED + 62)

    def run(place):
        model = nmt_model(pt, state, 0.0).train()
        loss = nmt_loss(pt, model, tuple(pt.to_tensor(a) for a in batch))
        model.eval()
        trace = [] if place == "cpu" else None
        beams = nmt_decode(pt, model, pt.to_tensor(batch[0][:n]),
                           NMT_BEAM[1], steps, trace)
        return loss, model, beams, trace
    return seq2seq_parity(pt, run, NMT_BEAM[1], "(am)")


def seq2seq_parity(pt, run, beam, label):
    """``run(place)`` -> (loss, model, beam outputs, trace) on the card
    and on the CPU (``tools/seq2seq.py``): the loss within 1e-5, every
    gradient within 1e-4 of the largest |gradient|, tokens, parents and
    lengths exact."""
    from tools import seq2seq
    res = seq2seq.card_against_cpu(pt, run)
    out = {**seq2seq.loss_grad_errors(res),
           **seq2seq.beam_parity(res, beam, NMT_END)}
    if not (out["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and out["grad_err_over_max"] <= TRAIN_GRAD_TOL
            and out["tokens_equal"] and out["parents_equal"]
            and out["lengths_equal"]):
        raise SystemExit(f"{label} card against CPU: {json.dumps(out)}")
    return out


def rnn_batch(B, T, seed):
    """(an)'s batch from a numpy seed: source ids [B, T] with lengths in
    [T / 5, T], target ids [B, T + 1] (start token first) with lengths in
    [T / 5, T]."""
    e = RNN_NMT
    rng = np.random.default_rng(seed)
    src = rng.integers(3, e["src_V"], (B, T))
    src_len = rng.integers(T // 5, T + 1, B)
    tgt = rng.integers(3, e["tgt_V"], (B, T + 1))
    tgt[:, 0] = NMT_START
    tgt_len = rng.integers(T // 5, T + 1, B)
    return src, src_len, tgt[:, :-1], tgt[:, 1:], tgt_len


def rnn_model(pt, state, dropout):
    from tools import seq2seq
    e = RNN_NMT
    model = seq2seq.rnn_seq2seq(pt, e["src_V"], e["tgt_V"], e["H"], e["L"],
                                dropout)
    if state is not None:
        model.set_state_dict(state)
    return model


def rnn_loss(pt, model, batch):
    from tools import seq2seq
    src, src_len, tgt_in, tgt_out, tgt_len = batch
    return seq2seq.masked_ce(pt, model(src, src_len, tgt_in), tgt_out,
                             tgt_len)


def rnn_decode(pt, model, batch, beam, steps, trace=None):
    from tools import seq2seq
    with pt.no_grad():
        init = model.encode(batch[0], batch[1])
    return seq2seq.beam_decode(pt, seq2seq.RNNCell(model), init, beam, steps,
                               NMT_START, NMT_END, trace)


def rnn_path(torch, pt, flash_attn, norms, state, args):
    """(an): 5 timed teacher-forced steps (Adam 1e-3 with
    ClipGradByGlobalNorm(5.0), the example's) and one beam decode of the
    batch; no kernel of the table runs on this path."""
    e = RNN_NMT
    model = rnn_model(pt, state, e["dropout"]).train()
    opt = pt.optimizer.Adam(learning_rate=1e-3,
                            grad_clip=pt.nn.ClipGradByGlobalNorm(5.0),
                            parameters=model.parameters())
    batch = tuple(pt.to_tensor(a) for a in rnn_batch(e["B"], e["T"],
                                                     SEED + 63))

    def step(t):
        loss = rnn_loss(pt, model, batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)
    counters = eager_counters(flash_attn, norms)
    res = timed_loop(torch, step, RNN_STEPS, counters,
                     dict.fromkeys(counters, 0), "(an)", e["B"], e["T"])
    res["steps_per_s"] = 1e3 / res["step_ms"]
    if args.profile_train:
        res["profile"] = profile_steps(
            torch, lambda: step(0), args.profile_train, "train_step_rnn",
            args.train_trace.replace(".json", "_rnn.json"))
    # two recurrences of T steps a training step (encoder, decoder)
    res["ms_per_time_step"] = res["step_ms"] / (2 * e["T"])
    model.eval()
    rnn_decode(pt, model, batch, e["beam"], 2)
    torch.cuda.synchronize()
    zero_counts(counters)
    t0 = time.perf_counter()
    out, _, lengths, lp, steps = rnn_decode(pt, model, batch, e["beam"],
                                            e["T"])
    lp = lp.numpy()
    wall = time.perf_counter() - t0
    if any(read_counts(counters).values()) or not np.isfinite(lp).all():
        raise SystemExit(f"(an) decode: launches {read_counts(counters)}, "
                         f"finite {bool(np.isfinite(lp).all())}")
    res.update(decode_steps=steps, decode_s=wall,
               decode_ms_per_step=1e3 * wall / steps,
               decode_sentences_per_s=e["B"] / wall,
               decode_lengths_mean=float(lengths.numpy().mean()))
    del model, opt
    torch.cuda.empty_cache()
    return res


def rnn_parity(pt, state):
    """(an) card against CPU in fp32, dropout 0, at full width on 16
    pairs: one step's loss and gradients as (am), then 2 sentences
    decoded 16 steps with beam 10, tokens and parents exact."""
    B, n, steps = RNN_PARITY
    batch = rnn_batch(B, RNN_NMT["T"], SEED + 64)

    def run(place):
        model = rnn_model(pt, state, 0.0).train()
        t = tuple(pt.to_tensor(a) for a in batch)
        loss = rnn_loss(pt, model, t)
        model.eval()
        trace = [] if place == "cpu" else None
        beams = rnn_decode(pt, model, tuple(x[:n] for x in t),
                           RNN_NMT["beam"], steps, trace)
        return loss, model, beams, trace
    return seq2seq_parity(pt, run, RNN_NMT["beam"], "(an)")


def nn_sweep_phase(pt):
    """Phase (ao): ``tools/op_sweep.py``'s ``NN_CASES`` and
    ``NN_LAYER_CASES`` on the card against the CPU."""
    from tools import op_sweep as S
    res, failed = {}, []
    for label, cases in (("functionals", S.NN_CASES),
                         ("layers", S.NN_LAYER_CASES)):
        checked, bad, worst = S.card_sweep(pt, cases)
        w = max(worst, key=worst.get) if worst else None
        res[label] = {"cases": len(cases), "checked": len(checked),
                      "ops": len({c.split(":")[0] for c in checked}),
                      "worst": w, "worst_err": worst.get(w, 0.0)}
        failed += [(f"{label}: {n}", e) for n, e in bad]
    res["failed"] = failed
    return res


def seq2seq_phases(torch, flash_attn, norms, card, launches, args):
    """Phases (am), (an), (ao), logged; (am)'s launches go into
    ``launches``.  With ``--profile-train`` (am)'s and (an)'s training
    steps are traced, with ``--profile`` a decode of that many steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    prev = core._state.expected_place
    e, r = NMT, RNN_NMT
    try:
        pt.set_device("gpu")
        t0 = time.perf_counter()
        pt.seed(SEED + 65)
        state = numpy_state(nmt_model(pt, None, 0.0), SEED + 66)
        train = {dt: nmt_train(torch, pt, flash_attn, norms, state,
                               dt == "bfloat16", args)
                 for dt in ("float32", "bfloat16")}
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv", "layer_norm"):
            launches[f"{k}_transformer_train"] = sum(
                t["launches"][k] for t in train.values())
        B, Ns, Nt = NMT_BATCH
        log(f"(am) Transformer base (Vaswani et al. 2017, Table 3: "
            f"d_model {e['d']}, {e['nh']} heads, {e['L']} + {e['L']} layers, "
            f"F {e['F']}, post-LN, relu, dropout {NMT_DROPOUT}, no attention "
            f"dropout; shared {e['V']}-token vocabulary, tied output), "
            f"{B} pairs of {Ns} + {Nt} tokens, label_smooth 0.1 soft-label "
            f"cross_entropy, Adam(0.9, 0.98, 1e-9) on NoamDecay(512, 4000) "
            f"from its peak, on {card}:")
        for dt, t in train.items():
            log(f"    {dt}{' (auto_cast)' if dt == 'bfloat16' else ''}: "
                f"step {t['step_ms']:.2f} ms ({[round(x, 2) for x in t['step_ms_each']]}), "
                f"{t['tokens_per_s']:.0f} target tokens/s "
                f"({2 * t['tokens_per_s']:.0f} both sides); "
                f"max_memory_allocated {t['max_memory_allocated_gib']:.3f} "
                f"GiB; losses {[round(x, 4) for x in t['losses']]}; lr "
                f"{t['lr']:.3e}; launches {t['launches']} over "
                f"{t['steps']} steps  [{card}]")
            if "profile" in t:
                log(f"    {dt} training step profile on {card}: "
                    f"{json.dumps(t['profile'])}")
        model = nmt_model(pt, state, 0.0).eval()
        beams = [nmt_beam(torch, pt, flash_attn, norms, model, "float32",
                          args)]
        beams.append(nmt_beam(torch, pt, flash_attn, norms,
                              to_bf16(pt, model), "bfloat16", args))
        del model
        torch.cuda.empty_cache()
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv", "layer_norm"):
            launches[f"{k}_beam"] = sum(b["launches"][k] for b in beams)
        n, beam, max_steps = NMT_BEAM
        for b in beams:
            log(f"    beam decode {b['dtype']}: {n} sentences, beam {beam}, "
                f"max_step_num {max_steps}: {b['steps']} steps in "
                f"{b['wall_s']:.3f} s, {b['ms_per_step']:.2f} ms a decode "
                f"step, {b['sentences_per_s']:.2f} sentences/s; launches "
                f"{b['launches']}; mean length {b['lengths_mean']:.2f}, "
                f"mean best log-prob {b['best_log_prob_mean']:.4f}  "
                f"[{card}]")
            if "profile" in b:
                log(f"    {b['dtype']} decode profile (the encoder and "
                    f"{args.profile} steps, one span) on {card}: "
                    f"{json.dumps(b['profile'])}")
        par = nmt_parity(pt, state)
        log(f"    card against CPU (fp32, full width, dropout 0, "
            f"{NMT_PARITY[0]} pairs): loss rel err "
            f"{par['loss_rel_err']:.2e} (tol {TRAIN_LOSS_RTOL:.0e}), "
            f"gradients {par['grad_err_over_max']:.2e} of max (tol "
            f"{TRAIN_GRAD_TOL:.0e}); beam {NMT_PARITY[1]} sentences x "
            f"{NMT_PARITY[2]} steps: tokens equal {par['tokens_equal']}, "
            f"parents equal {par['parents_equal']}, lengths equal "
            f"{par['lengths_equal']}, final log-prob diff "
            f"{par['log_prob_err']:.2e}")
        bp = nmt_bf16_parity(pt, state)
        log(f"    bf16 decode card against CPU (the same bf16 weights, "
            f"{NMT_PARITY[1]} sentences x {NMT_PARITY[2]} steps, traced): "
            f"{bp['steps_compared']} steps compared, logits "
            f"{bp['logit_err']:.2e} of max|logit| (tol {bp['tol']:.0e}; "
            f"wrong-scale mutant {bp['mutant_logit_err']:.2e}), log-probs "
            f"{bp['log_prob_err']:.2e}; beams first differ at step "
            f"{bp['diverged_at']}"
            + (f" (CPU score margin {bp['margin_there']:.3e} against the "
               f"rounding's reach {bp['score_bound_there']:.3e})"
               if bp["diverged_at"] is not None else "")
            + f"; phase {time.perf_counter() - t0:.1f} s")
        del state
        gc.collect()
        torch.cuda.empty_cache()

        pt.set_device("gpu")
        t0 = time.perf_counter()
        pt.seed(SEED + 67)
        state = numpy_state(rnn_model(pt, None, 0.0), SEED + 68)
        an = rnn_path(torch, pt, flash_attn, norms, state, args)
        log(f"(an) RNN seq2seq at Paddle's IWSLT'15 en-vi widths (vocab "
            f"{r['src_V']} / {r['tgt_V']}, hidden and embedding {r['H']}, "
            f"{r['L']}-layer LSTM encoder, dropout {r['dropout']}, LSTMCell "
            f"decoder + Linear), batch {r['B']}, padded to {r['T']} "
            f"(sequence_length), Adam 1e-3, clip 5.0, on {card}: step "
            f"{an['step_ms']:.2f} ms ({an['steps_per_s']:.2f} steps/s, "
            f"{an['ms_per_time_step']:.3f} ms a time step); losses "
            f"{[round(x, 4) for x in an['losses']]}; max_memory_allocated "
            f"{an['max_memory_allocated_gib']:.3f} GiB; beam {r['beam']} "
            f"decode of the batch: {an['decode_steps']} steps, "
            f"{an['decode_ms_per_step']:.2f} ms a step, "
            f"{an['decode_sentences_per_s']:.1f} sentences/s  [{card}]")
        if "profile" in an:
            log(f"    (an) training step profile on {card}: "
                f"{json.dumps(an['profile'])}")
        par = rnn_parity(pt, state)
        log(f"    card against CPU (fp32, dropout 0, {RNN_PARITY[0]} pairs):"
            f" loss rel err {par['loss_rel_err']:.2e}, gradients "
            f"{par['grad_err_over_max']:.2e} of max; beam "
            f"{RNN_PARITY[1]} x {RNN_PARITY[2]} steps: tokens equal "
            f"{par['tokens_equal']}, parents equal {par['parents_equal']}, "
            f"lengths equal {par['lengths_equal']}; phase "
            f"{time.perf_counter() - t0:.1f} s")
        del state
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ao = nn_sweep_phase(pt)
        for label in ("functionals", "layers"):
            x = ao[label]
            log(f"(ao) nn {label}: {x['checked']} of {x['cases']} cases "
                f"({x['ops']} ops) on the card equal the CPU's; the largest "
                f"difference over max|ref| {x['worst_err']:.3e} "
                f"({x['worst']}); phase {time.perf_counter() - t0:.1f} s  "
                f"[{card}]")
        if ao["failed"]:
            for name, err in ao["failed"]:
                log(f"    FAILED {name}: {err}")
            raise SystemExit(f"(ao): {len(ao['failed'])} cases failed on "
                             f"the card")
    finally:
        core._state.expected_place = prev


# (ap), (aq), (ar): the rest of vision/ -------------------------------------

# (ap): PaddleCV's object_detection example (mobilenet_ssd.py, train.py):
# MobileNet-SSD300 on Pascal VOC, 21 classes, batch 64, nothing cut; raw
# images at VOC's typical 375 x 500, resized to 300 x 300
SSD = dict(size=300, classes=21, batch=64, steps=8, lr=1e-3, l2=5e-5,
           max_gt=8, raw=(375, 500), nms_threshold=0.45,
           extras=((256, 512), (128, 256), (128, 256), (64, 128)),
           min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
           max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
           aspect_ratios=[[2.0]] + [[2.0, 3.0]] * 5)
SSD_PRIORS = 1917             # 19^2 x 3 + (10^2 + 5^2 + 3^2 + 2^2 + 1) x 6
SSD_PARITY = 2                # card vs CPU: images, fp32, full width
SSD_LOSS_TOL = 1e-5           # relative
SSD_GRAD_TOL = 1e-4           # x the largest |gradient| on the CPU
SSD_NEAR_TIE = 1e-4           # where the rows part: the CPU's margin
# (aq): ImageNet-width classification through the user's input path
IMAGENET = dict(images=1024, classes=8, raw=256, size=224, batch=128,
                workers=4, lr=0.05, momentum=0.9, wd=4e-5, num_classes=1000)
IMAGENET_MEAN = [123.675, 116.28, 103.53]     # pixel units, HWC
IMAGENET_STD = [58.395, 57.12, 57.375]
VGG_BATCH, VGG_ITERS = 64, 5  # (aq): VGG16 eval forwards a dtype
LOGIT_TOL = 1e-4              # (aq): x max|logit| on the CPU
# (ar): YOLOv3-608 (Redmon & Farhadi 2018): the three heads' grids,
# strides and anchor masks, the nine COCO anchors, 80 classes
YOLO = dict(batch=8, gt=50, classes=80, size=608, ignore=0.7,
            anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116,
                     90, 156, 198, 373, 326],
            heads=((19, 32, [6, 7, 8]), (38, 16, [3, 4, 5]),
                   (76, 8, [0, 1, 2])))
# (ar): Faster R-CNN's RPN at an 800 x 1088 image, stride 16, 5 sizes x 3
# ratios, the op's defaults pre 6000 / post 1000
RPN = dict(batch=2, image=(800, 1088), stride=16,
           sizes=[32, 64, 128, 256, 512], ratios=[0.5, 1.0, 2.0])
# (ar): ResNet-50 res5's 3 x 3 convolution (512 -> 512) at that image
DEFORM = dict(batch=2, c=512, hw=(25, 34))
# (ar): RetinaNet's P3-P7 anchors (9 a cell) at a 512 x 512 image
RETINA_ANCHORS = [9 * (512 // s) ** 2 for s in (8, 16, 32, 64, 128)]
FAMILY_TOL = 1e-5             # (ar): x max|ref| on the CPU


def sync_ms(torch, fn, iters=1):
    """Wall ms of ``fn()`` on the card, synchronised (mean of ``iters``);
    returns (ms, the last result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters, out


def ssd_batch(pt, n, seed):
    """``n`` raw uint8 VOC-sized images through ``transforms.Resize`` and
    ``Normalize`` (mean 127.5, std 127.5) to [n, 3, 300, 300] float32,
    and 1-8 gt boxes an image (normalised xyxy, labels 1-20), padded to
    ``max_gt`` with zero rows."""
    from paddle_tpu_torch.vision import transforms as T
    S = SSD
    rng = np.random.RandomState(seed)
    tf = T.Compose([T.Resize((S["size"], S["size"])),
                    T.Normalize(127.5, 127.5, data_format="HWC"),
                    T.Transpose()])
    raw = rng.randint(0, 256, (n,) + S["raw"] + (3,)).astype(np.uint8)
    img = np.stack([tf(a) for a in raw]).astype(np.float32)
    box = np.zeros((n, S["max_gt"], 4), np.float32)
    lbl = np.zeros((n, S["max_gt"]), np.int64)
    for i in range(n):
        k = rng.randint(1, S["max_gt"] + 1)
        xy = rng.uniform(0.0, 0.7, (k, 2))
        wh = rng.uniform(0.08, 0.3, (k, 2))
        box[i, :k] = np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1)
        lbl[i, :k] = rng.randint(1, S["classes"], k)
    return {"image": img, "gt_box": box, "gt_label": lbl}


def ssd_program(pt, parity=False):
    """MobileNet-SSD300 as PaddleCV builds it: the MobileNetV1 x1.0
    backbone (its 11th and 13th blocks, 19 x 19 x 512 and 10 x 10 x 1024,
    are the first two maps), four extra blocks (1 x 1 conv_bn, then
    3 x 3 stride 2 conv_bn), ``fluid.layers.multi_box_head`` over the six
    maps (1,917 priors) and ``fluid.layers.ssd_loss`` at its defaults;
    RMSProp (lr 1e-3, L2 decay 5e-5) ``minimize``, or with ``parity``
    ``append_backward`` instead.  The inference program (a test clone
    taken before the loss) ends in ``fluid.layers.detection_output`` on
    the softmaxed scores, nms_threshold 0.45.  Returns a dict."""
    from paddle_tpu_torch import fluid, static
    from paddle_tpu_torch.vision import models
    L, S = fluid.layers, SSD
    pt.enable_static()
    try:
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            img = static.data("image", [None, 3, S["size"], S["size"]],
                              "float32")
            gt_box = static.data("gt_box", [None, S["max_gt"], 4], "float32")
            gt_label = static.data("gt_label", [None, S["max_gt"]], "int64")
            net = models.MobileNetV1(scale=1.0, num_classes=0,
                                     with_pool=False)
            x = net.conv1(img)
            maps = []
            for i, block in enumerate(net.blocks):
                x = block(x)
                if i in (10, 12):
                    maps.append(x)
            for c1, c2 in S["extras"]:
                x = static.nn.batch_norm(static.nn.conv2d(
                    x, c1, 1, bias_attr=False), act="relu")
                x = static.nn.batch_norm(static.nn.conv2d(
                    x, c2, 3, stride=2, padding=1, bias_attr=False),
                    act="relu")
                maps.append(x)
            locs, confs, box, var = L.multi_box_head(
                inputs=maps, image=img, num_classes=S["classes"],
                base_size=S["size"], min_sizes=S["min_sizes"],
                max_sizes=S["max_sizes"],
                aspect_ratios=S["aspect_ratios"], flip=True, offset=0.5)
            scores = pt.nn.functional.softmax(confs, axis=-1)
            infer = main.clone(for_test=True)
        with static.program_guard(infer, static.Program()):
            det = L.detection_output(locs, scores, box, var,
                                     nms_threshold=S["nms_threshold"])
        with static.program_guard(main, startup):
            loss = L.ssd_loss(locs, confs, gt_box, gt_label, box, var)
            if parity:
                grads = [g for _, g in static.append_backward(loss)]
            else:
                grads = []
                pt.optimizer.RMSProp(
                    learning_rate=S["lr"],
                    weight_decay=pt.regularizer.L2Decay(S["l2"])).minimize(
                        loss)
    finally:
        pt.disable_static()
    if tuple(box.shape) != (SSD_PRIORS, 4) or locs.shape[1] != SSD_PRIORS:
        raise SystemExit(f"(ap): {box.shape[0]} priors, not {SSD_PRIORS}")
    return {"main": main, "startup": startup, "infer": infer, "loss": loss,
            "det": det, "locs": locs, "scores": scores, "box": box,
            "var": var, "grads": grads, "maps": [list(m.shape[1:])
                                                 for m in maps]}


def run_static(pt, prog, feed, fetch):
    pt.enable_static()
    try:
        return pt.static.Executor().run(prog, feed=feed, fetch_list=fetch)
    finally:
        pt.disable_static()


def nms_rows(pt, locs, scores, box, var):
    """``detection_output``'s arithmetic with the kept indices:
    ``box_coder`` decode, then ``multiclass_nms`` (the defaults of
    ``detection_output``: nms_top_k 400, keep_top_k 200, score_threshold
    0.01, background 0) on the scores [B, C, N]."""
    from paddle_tpu_torch.vision import detection as D
    dec = D.box_coder(box, var, locs, code_type="decode_center_size")
    return D.multiclass_nms(dec, pt.transpose(scores, [0, 2, 1]),
                            score_threshold=0.01, nms_top_k=400,
                            keep_top_k=200,
                            nms_threshold=SSD["nms_threshold"],
                            return_index=True)


def nms_margin(dec, scores):
    """The CPU's smallest margin in a detection's NMS (float64): between
    adjacent candidate scores of a class, between a candidate's score and
    the score threshold, and between a candidate pair's IoU and the NMS
    threshold, over the 400 best candidates of each foreground class."""
    best = math.inf
    for b in range(dec.shape[0]):
        bx = dec[b].astype(np.float64)
        for c in range(1, scores.shape[1]):
            s = scores[b, c].astype(np.float64)
            idx = np.argsort(-s, kind="stable")[:400]
            idx = idx[s[idx] > 0.01 - 1e-3]
            if not len(idx):
                continue
            ss = s[idx]
            best = min(best, float(np.abs(ss - 0.01).min()))
            if len(idx) > 1:
                best = min(best, float(np.abs(np.diff(ss)).min()))
            q = bx[idx]
            x1 = np.maximum(q[:, None, 0], q[None, :, 0])
            y1 = np.maximum(q[:, None, 1], q[None, :, 1])
            x2 = np.minimum(q[:, None, 2], q[None, :, 2])
            y2 = np.minimum(q[:, None, 3], q[None, :, 3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            area = (q[:, 2] - q[:, 0]) * (q[:, 3] - q[:, 1])
            iou = inter / np.maximum(area[:, None] + area[None] - inter,
                                     1e-10)
            iu = np.triu_indices(len(idx), 1)
            if len(iu[0]):
                best = min(best, float(np.abs(iou[iu]
                                              - SSD["nms_threshold"]).min()))
    return best


def ssd_path(torch, pt, args):
    """Phase (ap): MobileNet-SSD300 static training (one warm-up step,
    8 timed, the last fetching the loss) and inference at batch 64."""
    S = SSD
    pt.seed(SEED + 70)
    t0 = time.perf_counter()
    p = ssd_program(pt)
    build_s = time.perf_counter() - t0
    feed = ssd_batch(pt, S["batch"], SEED + 71)
    dfeed = {k: pt.to_tensor(v) for k, v in feed.items()}
    run_static(pt, p["startup"], None, [])
    lv0, = run_static(pt, p["main"], dfeed, [p["loss"]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(S["steps"] - 1):
        run_static(pt, p["main"], dfeed, [])
    lv, = run_static(pt, p["main"], dfeed, [p["loss"]])
    final = float(np.asarray(lv))
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first = float(np.asarray(lv0))
    if not (np.isfinite(first) and np.isfinite(final) and final < first):
        raise SystemExit(f"(ap): loss {first} -> {final}: not finite and "
                         "falling")
    prof = profile_steps(
        torch, lambda: run_static(pt, p["main"], dfeed, []), 1, "ssd_step",
        os.path.join(os.path.dirname(os.path.abspath(args.train_trace)),
                     "ssd_trace.json"))
    # inference: warm, then timed; the NMS alone on the same decode
    ifeed = {"image": dfeed["image"]}
    run_static(pt, p["infer"], ifeed, [p["det"]])
    infer_ms, (locs, scores, box, var, det) = sync_ms(
        torch, lambda: run_static(pt, p["infer"], ifeed, [
            p["locs"], p["scores"], p["box"], p["var"], p["det"]]), 3)
    T = pt.to_tensor
    nms_rows(pt, T(locs), T(scores), T(box), T(var))
    nms_ms, _ = sync_ms(torch, lambda: nms_rows(
        pt, T(locs), T(scores), T(box), T(var)), 3)
    det = np.asarray(det)
    if det.shape != (S["batch"], 200, 6) or not np.isfinite(det).all():
        raise SystemExit(f"(ap): detections {det.shape}, finite "
                         f"{np.isfinite(det).all()}")
    kept = (det[..., 0] >= 0).sum(1)
    return {"step_ms": 1e3 * dt / S["steps"],
            "imgs_per_s": S["batch"] * S["steps"] / dt,
            "loss_first": first, "loss_final": final, "build_s": build_s,
            "ops": len(p["main"].ops), "params": len(p["main"].params),
            "maps": p["maps"], "peak_gib": peak,
            "launches_per_step": prof["kernel_launches_per_step"],
            "device_idle_share": prof["device_idle_share"],
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "top_kernels": prof["device_ms_per_step_by_kernel"][:5],
            "infer_ms": infer_ms, "nms_ms": nms_ms,
            "nms_share": nms_ms / infer_ms,
            "kept_mean": float(kept.mean()), "kept_min": int(kept.min()),
            "kept_max": int(kept.max())}


def to_float64(pt, tensors):
    """Cast a model's or program's parameters and buffers to float64 in
    place (after the build, as (ab) does)."""
    import torch
    for t in tensors:
        if t.value.is_floating_point():
            t.value = t.value.detach().to(torch.float64)
            if isinstance(t, pt.tensor.Parameter):
                t._mark()


def float64_tensor(pt, a):
    """``a`` as a float64 Tensor on the default place (``to_tensor``
    takes float64 arrays to the default float dtype)."""
    import torch
    from paddle_tpu_torch.framework import core
    return pt.Tensor(torch.from_numpy(np.asarray(a, np.float64)).to(
        core.get_place().device))


def step_errors(g, c):
    """(loss relative error, the largest gradient difference over the
    largest |gradient|) of a card run ``g`` against a CPU run ``c``, each
    (loss, [gradients])."""
    scale = max(float(np.abs(a).max()) for a in c[1])
    return (abs(g[0] - c[0]) / abs(c[0]),
            max(float(np.abs(a - b).max()) for a, b in zip(g[1], c[1]))
            / scale)


def ssd_parity(torch, pt):
    """Phase (ap)'s check: the SSD program without its optimizer
    (``append_backward``) on 2 images at full width, on the card and on
    the CPU from the same weights: the loss within 1e-5 (relative) and
    every parameter's gradient within 1e-4 of the largest |gradient|,
    asserted in float64 (parameters, buffers and the image cast after the
    build; ``ssd_loss`` keeps float64) and reported in fp32, where the
    step is ill-conditioned (the port's own fp32 gradients are 5.4e-3 of
    max from its float64 ones on the CPU, ``tools/vision_conditioning.py``); the NMS rows (labels, kept
    indices) of the CPU's fp32 outputs on both devices equal, and of each
    device's own outputs equal or parted only where the CPU's margin is
    under 1e-4."""
    feed = ssd_batch(pt, SSD_PARITY, SEED + 72)
    runs, init = {}, None
    for dev in ("gpu", "cpu"):
        pt.set_device(dev)
        pt.seed(SEED + 73)
        p = ssd_program(pt, parity=True)
        params = p["main"].all_parameters()
        if init is None:
            init = [np.asarray(v.numpy()).copy() for v in params]
        else:
            for v, a in zip(params, init):
                v.set_value(a)
        run_static(pt, p["startup"], None, [])
        fetch = [p["loss"], p["locs"], p["scores"], p["box"],
                 p["var"]] + p["grads"]
        f32 = [np.asarray(o) for o in run_static(
            pt, p["main"], {k: pt.to_tensor(v) for k, v in feed.items()},
            fetch)]
        to_float64(pt, params + list(p["main"].captured.values()))
        f64 = run_static(pt, p["main"], dict(
            {k: pt.to_tensor(v) for k, v in feed.items()},
            image=float64_tensor(pt, feed["image"])),
            [p["loss"]] + p["grads"])
        if not np.asarray(f64[0]).dtype == np.float64:
            raise SystemExit("(ap): the float64 step did not run in float64")
        runs[dev] = {"f32": f32, "f64": (float(f64[0]), [
            np.asarray(o) for o in f64[1:]])}
    pt.set_device("gpu")
    og, oc = runs["gpu"]["f32"], runs["cpu"]["f32"]
    l64, g64 = step_errors(runs["gpu"]["f64"], runs["cpu"]["f64"])
    l32, g32 = step_errors((float(og[0]), og[5:]), (float(oc[0]), oc[5:]))
    res = {"loss_card": float(og[0]), "loss_cpu": float(oc[0]),
           "loss_rel_err": l32, "grad_err_over_max": g32,
           "loss_rel_err_f64": l64, "grad_err_over_max_f64": g64,
           "grads": len(oc) - 5}
    T = pt.to_tensor
    rows = {}
    for tag, src in (("cpu_inputs", oc), ("own", og)):
        got = {}
        for dev, o in (("gpu", src), ("cpu", oc)):
            pt.set_device(dev)
            r, i = nms_rows(pt, *[T(a) for a in o[1:5]])
            got[dev] = (np.asarray(r.numpy()), np.asarray(i.numpy()))
        pt.set_device("gpu")
        (rg, ig), (rc, ic) = got["gpu"], got["cpu"]
        rows[tag] = {"labels_equal": bool(np.array_equal(rg[..., 0],
                                                         rc[..., 0])),
                     "index_equal": bool(np.array_equal(ig, ic)),
                     "kept": int((ic >= 0).sum()),
                     "row_err": float(np.abs(rg - rc).max())}
    res["nms"] = rows
    own = rows["own"]
    if not (own["labels_equal"] and own["index_equal"]):
        from paddle_tpu_torch.vision import detection as D
        pt.set_device("cpu")
        dec = D.box_coder(T(oc[3]), T(oc[4]), T(oc[1]),
                          code_type="decode_center_size").numpy()
        pt.set_device("gpu")
        own["cpu_margin"] = nms_margin(np.asarray(dec),
                                       oc[2].transpose(0, 2, 1))
    ok = (l64 <= SSD_LOSS_TOL and g64 <= SSD_GRAD_TOL
          and rows["cpu_inputs"]["labels_equal"]
          and rows["cpu_inputs"]["index_equal"]
          and ((own["labels_equal"] and own["index_equal"])
               or own["cpu_margin"] <= SSD_NEAR_TIE))
    if not ok:
        raise SystemExit(f"(ap): the SSD on the card differs from the "
                         f"CPU's: {res}")
    return res


def imagenet_folder(root, n, classes, raw, seed):
    """``n`` synthetic raw x raw x 3 uint8 ``.npy`` images in ``classes``
    class folders under ``root``, from a numpy seed."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        d = os.path.join(root, f"class{i % classes:02d}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{i:05d}.npy"),
                rng.randint(0, 256, (raw, raw, 3)).astype(np.uint8))


class TimedLoader:
    """A loader that adds the host's wait for each batch to ``wait``."""

    def __init__(self, loader):
        self.loader, self.wait = loader, 0.0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            finally:
                self.wait += time.perf_counter() - t0
            yield b


def imagenet_path(torch, pt, root):
    """Phase (aq): MobileNetV2 x1.0 fit through the user's input path:
    ``DatasetFolder`` -> RandomResizedCrop(224), RandomHorizontalFlip,
    Normalize (ImageNet mean and std in pixel units, HWC), Transpose ->
    ``io.DataLoader`` (batch 128, 4 workers, the native ring, 2 batches
    ahead on the card) -> ``Model.fit`` with Momentum 0.9: two epochs of
    8 steps, the second timed; then the batch's normalisation two ways,
    and VGG16's eval forward in fp32 and bf16."""
    from paddle_tpu_torch import runtime
    from paddle_tpu_torch.vision import datasets, models
    from paddle_tpu_torch.vision import transforms as T
    c = IMAGENET
    tf = T.Compose([T.RandomResizedCrop(c["size"]), T.RandomHorizontalFlip(),
                    T.Normalize(IMAGENET_MEAN, IMAGENET_STD,
                                data_format="HWC"), T.Transpose()])
    ds = datasets.DatasetFolder(root, transform=tf)
    loader = TimedLoader(pt.io.DataLoader(
        ds, batch_size=c["batch"], shuffle=True, num_workers=c["workers"],
        use_native_ring=True, prefetch_to_device=2))
    pt.seed(SEED + 80)
    net = models.MobileNetV2(num_classes=c["num_classes"])
    model = pt.Model(net, inputs=[pt.static.InputSpec(
        [None, 3, c["size"], c["size"]], "float32")],
        labels=[pt.static.InputSpec([None], "int64")])
    model.prepare(pt.optimizer.Momentum(
        learning_rate=c["lr"], momentum=c["momentum"],
        weight_decay=c["wd"], parameters=net.parameters()),
        pt.nn.CrossEntropyLoss())
    rec = {"losses": []}

    class Timer(pt.callbacks.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            if epoch == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                loader.wait = 0.0
                rec["t0"] = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            rec["losses"].append(float(np.asarray(logs["loss"]).ravel()[0]))

        def on_epoch_end(self, epoch, logs=None):
            if epoch == 1:
                torch.cuda.synchronize()
                rec["wall"] = time.perf_counter() - rec["t0"]
                rec["wait"] = loader.wait
                rec["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30

    model.fit(loader, epochs=2, verbose=0, callbacks=[Timer()])
    steps = len(loader)
    losses = rec["losses"]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"(aq): MobileNetV2's losses {losses}")
    out = {"steps": steps, "step_ms": 1e3 * rec["wall"] / steps,
           "imgs_per_s": c["images"] / rec["wall"],
           "loader_wait_share": rec["wait"] / rec["wall"],
           "peak_gib": rec["peak"], "loss_first": losses[0],
           "loss_last": losses[-1]}
    # one batch's normalisation: per image, and one native call
    rng = np.random.RandomState(SEED + 81)
    raw = [T.RandomResizedCrop(c["size"])(np.load(ds.samples[i][0]))
           for i in rng.randint(0, len(ds), c["batch"])]
    norm = T.Compose([T.Normalize(IMAGENET_MEAN, IMAGENET_STD,
                                  data_format="HWC"), T.Transpose()])
    t0 = time.perf_counter()
    a = np.stack([norm(x) for x in raw])
    per_image_ms = 1e3 * (time.perf_counter() - t0)
    runtime.preprocess_images(raw, IMAGENET_MEAN, IMAGENET_STD, 1.0)
    t0 = time.perf_counter()
    b = runtime.preprocess_images(raw, IMAGENET_MEAN, IMAGENET_STD, 1.0)
    native_ms = 1e3 * (time.perf_counter() - t0)
    diff = float(np.abs(a - b).max())
    if a.shape != b.shape or diff > 1e-5 * float(np.abs(a).max()):
        raise SystemExit(f"(aq): preprocess_images differs from Normalize + "
                         f"Transpose by {diff}")
    out.update(per_image_ms=per_image_ms, native_ms=native_ms,
               preprocess_max_diff=diff, preprocess_max=float(
                   np.abs(a).max()))
    del model, net
    torch.cuda.empty_cache()
    # VGG16 (configuration D), eval forward in fp32 and under bf16
    pt.seed(SEED + 82)
    vgg = models.vgg16()
    vgg.eval()
    x = pt.to_tensor(np.random.RandomState(SEED + 83).randn(
        VGG_BATCH, 3, c["size"], c["size"]).astype(np.float32))
    for dt in ("float32", "bfloat16"):
        ctx = (pt.amp.auto_cast(dtype="bfloat16") if dt == "bfloat16"
               else contextlib.nullcontext())
        with pt.no_grad(), ctx:
            vgg(x)
            ms, y = sync_ms(torch, lambda: vgg(x), VGG_ITERS)
        if not torch.isfinite(y.value).all():
            raise SystemExit(f"(aq): VGG16's {dt} logits are not finite")
        out[f"vgg16_{dt}_imgs_per_s"] = VGG_BATCH / ms * 1e3
        out[f"vgg16_{dt}_ms"] = ms
    return out


def imagenet_parity(torch, pt):
    """Phase (aq)'s check, 2 images at 224, card against CPU from the
    same weights: MobileNetV2's and VGG16's fp32 eval logits within 1e-4
    of max|logit|; one MobileNetV2 training step (batch statistics,
    dropout 0): the loss within 1e-5 (relative) and every gradient within
    1e-4 of the largest |gradient|, asserted in float64 and reported in
    fp32 (ill-conditioned there: the port's own fp32 gradients are
    6.5e-3 of max from its float64 ones on the CPU,
    ``tools/vision_conditioning.py``)."""
    from paddle_tpu_torch.vision import models
    rng = np.random.RandomState(SEED + 84)
    x = rng.randn(2, 3, 224, 224).astype(np.float32)
    y = np.array([3, 917], np.int64)
    res = {}
    for name, make in (("mobilenet_v2", models.MobileNetV2),
                       ("vgg16", models.vgg16)):
        pt.set_device("gpu")
        pt.seed(SEED + 85)
        state = {k: np.asarray(v.numpy()).copy()
                 for k, v in make().state_dict().items()}
        outs = {}
        for dev in ("gpu", "cpu"):
            pt.set_device(dev)
            net = make()
            net.set_state_dict(state)
            net.eval()
            with pt.no_grad():
                item = {"logits": np.asarray(net(pt.to_tensor(x)).numpy())}
            if name == "mobilenet_v2":
                net.train()
                for layer in net.sublayers():
                    if isinstance(layer, pt.nn.Dropout):
                        layer.p = 0.0
                for dt in ("f32", "f64"):
                    if dt == "f64":
                        net.set_state_dict(state)
                        to_float64(pt, list(net.state_dict().values()))
                    xt = (float64_tensor(pt, x) if dt == "f64"
                          else pt.to_tensor(x))
                    loss = pt.nn.functional.cross_entropy(
                        net(xt), pt.to_tensor(y)).mean()
                    loss.backward()
                    item[dt] = (float(loss), [np.asarray(p.grad.numpy())
                                              for p in net.parameters()])
                    for prm in net.parameters():
                        prm.clear_grad()
            outs[dev] = item
            del net
        pt.set_device("gpu")
        g, c_ = outs["gpu"], outs["cpu"]
        r = {"logit_err_over_max": float(np.abs(g["logits"]
                                                - c_["logits"]).max())
             / float(np.abs(c_["logits"]).max())}
        ok = r["logit_err_over_max"] <= LOGIT_TOL
        if "f32" in c_:
            l32, g32 = step_errors(g["f32"], c_["f32"])
            l64, g64 = step_errors(g["f64"], c_["f64"])
            r.update(loss_card=g["f32"][0], loss_cpu=c_["f32"][0],
                     loss_rel_err=l32, grad_err_over_max=g32,
                     loss_rel_err_f64=l64, grad_err_over_max_f64=g64)
            ok = ok and l64 <= SSD_LOSS_TOL and g64 <= SSD_GRAD_TOL
        res[name] = r
        if not ok:
            raise SystemExit(f"(aq): {name} on the card differs from the "
                             f"CPU's: {r}")
    torch.cuda.empty_cache()
    return res


def family_cases():
    """(ar)'s cases: (label, function name, module, numpy arrays, keyword
    arguments, indices of the arrays to differentiate).  Shapes of named
    models; the rest at the reference's defaults."""
    rng = np.random.RandomState(SEED + 90)

    def boxes(*shape, scale=1.0, lo=0.02, hi=0.4):
        xy = rng.uniform(0, 0.6, shape + (2,))
        wh = rng.uniform(lo, hi, shape + (2,))
        return (np.concatenate([xy, xy + wh], -1) * scale).astype(np.float32)

    f32 = np.float32
    Y = YOLO
    cases = []
    for g, stride, mask in Y["heads"]:
        x = (rng.randn(Y["batch"], 3 * (5 + Y["classes"]), g, g)
             * 0.5).astype(f32)
        size = np.full((Y["batch"], 2), Y["size"], np.int32)
        cases.append((f"yolo_box {g}x{g}", "yolo_box", "ops", [x, size],
                      dict(anchors=[a for m in mask for a in
                                    Y["anchors"][2 * m:2 * m + 2]],
                           class_num=Y["classes"], conf_thresh=0.005,
                           downsample_ratio=stride), ()))
        gt = np.concatenate([rng.uniform(0.05, 0.95, (Y["batch"], Y["gt"],
                                                      2)),
                             rng.uniform(0.01, 0.4, (Y["batch"], Y["gt"],
                                                     2))], -1).astype(f32)
        gt[:, 40:] = 0.0
        lbl = rng.randint(0, Y["classes"], (Y["batch"], Y["gt"])).astype(
            np.int32)
        cases.append((f"yolo_loss {g}x{g}", "yolo_loss", "ops",
                      [x, gt, lbl], dict(anchors=Y["anchors"],
                                         anchor_mask=mask,
                                         class_num=Y["classes"],
                                         ignore_thresh=Y["ignore"],
                                         downsample_ratio=stride), (0,)))
    D = DEFORM
    H, W = D["hw"]
    x = rng.randn(D["batch"], D["c"], H, W).astype(f32)
    w = (rng.randn(D["c"], D["c"], 3, 3) * 0.02).astype(f32)
    off = (rng.randn(D["batch"], 18, H, W) * 2.0).astype(f32)
    mask = rng.uniform(0, 1, (D["batch"], 9, H, W)).astype(f32)
    b = rng.randn(D["c"]).astype(f32)
    cases.append(("deform_conv2d v1 res5", "deform_conv2d", "ops",
                  [x, off, w, b], dict(padding=1), (0, 1, 2)))
    cases.append(("deform_conv2d v2 res5", "deform_conv2d_v2", "ops",
                  [x, off, w, b, mask], dict(padding=1), (0, 1, 2, 4)))
    R = RPN
    h, w_ = (s // R["stride"] for s in R["image"])
    A = len(R["sizes"]) * len(R["ratios"])
    cases.append(("generate_proposals RPN", "generate_proposals", "det",
                  [rng.uniform(0, 1, (R["batch"], A, h, w_)).astype(f32),
                   (rng.randn(R["batch"], 4 * A, h, w_) * 0.3).astype(f32),
                   np.array([[800, 1088, 1.0], [760, 1088, 1.25]], f32),
                   "anchors", "variances"],
                  dict(pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.7, min_size=0.0, return_rois_num=True),
                  ()))
    N, C = 1917, 21
    dec = boxes(8, N)
    sc = rng.uniform(0, 1, (8, C, N)).astype(f32) ** 4
    cases += [
        ("multiclass_nms VOC", "multiclass_nms", "det", [dec, sc],
         dict(score_threshold=0.01, nms_top_k=400, keep_top_k=200,
              nms_threshold=0.45, return_index=True), ()),
        ("multiclass_nms eta", "multiclass_nms", "det", [dec[:2], sc[:2]],
         dict(score_threshold=0.05, nms_eta=0.9, nms_threshold=0.8), ()),
        ("matrix_nms SOLOv2", "matrix_nms", "det",
         [boxes(2, 500), rng.uniform(0, 1, (2, 81, 500)).astype(f32) ** 3],
         dict(score_threshold=0.1, post_threshold=0.05, nms_top_k=400,
              keep_top_k=100, use_gaussian=True), ()),
        ("locality_aware_nms", "locality_aware_nms", "det",
         [boxes(2, 400, scale=512.0), rng.uniform(0, 1, (2, 1, 400))
          .astype(f32)],
         dict(score_threshold=0.2, nms_top_k=200, keep_top_k=100), ()),
        ("ssd_loss VOC", "ssd_loss", "det",
         [(rng.randn(8, N, 4) * 0.3).astype(f32),
          rng.randn(8, N, C).astype(f32), boxes(8, 8, lo=0.1, hi=0.4),
          rng.randint(1, C, (8, 8)).astype(np.int64), boxes(N)], {},
         (0, 1)),
        ("prior_box SSD 19x19", "prior_box", "det",
         [np.zeros((1, 512, 19, 19), f32), np.zeros((1, 3, 300, 300), f32)],
         dict(min_sizes=[60.0], max_sizes=[], aspect_ratios=[2.0],
              flip=True), ()),
        ("density_prior_box", "density_prior_box", "det",
         [np.zeros((1, 256, 64, 64), f32), np.zeros((1, 3, 1024, 1024),
                                                     f32)],
         dict(densities=[4, 2, 1], fixed_sizes=[32.0, 64.0, 128.0],
              fixed_ratios=[1.0], flatten_to_2d=True), ()),
        ("anchor_generator RPN", "anchor_generator", "det",
         [np.zeros((1, 1024, 50, 68), f32)],
         dict(anchor_sizes=RPN["sizes"], aspect_ratios=RPN["ratios"],
              stride=[16.0, 16.0]), ()),
        ("collect_fpn_proposals FPN", "collect_fpn_proposals", "det",
         [[boxes(n, scale=1000.0) for n in (2000, 2000, 2000, 2000)],
          [rng.uniform(0, 1, (n,)).astype(f32) for n in (2000,) * 4],
          [np.int32(n) for n in (2000, 1800, 900, 300)]],
         dict(min_level=2, max_level=5, post_nms_top_n=2000), ()),
        ("retinanet_detection_output P3-P7", "retinanet_detection_output",
         "det", [[(rng.randn(1, m, 4) * 0.2).astype(f32) for m in
                  RETINA_ANCHORS],
                 [(rng.uniform(0, 1, (1, m, 80)) ** 6).astype(f32)
                  for m in RETINA_ANCHORS],
                 [boxes(m, scale=512.0) for m in RETINA_ANCHORS],
                 np.array([[512, 512, 1.0]], f32)], {}, ()),
        ("iou_similarity", "iou_similarity", "det", [boxes(64), boxes(N)],
         {}, ()),
        ("box_coder encode", "box_coder", "det",
         [boxes(N), np.tile(f32([0.1, 0.1, 0.2, 0.2]), (N, 1)),
          boxes(32)], dict(code_type="encode_center_size"), ()),
        ("box_coder decode", "box_coder", "det",
         [boxes(N), np.tile(f32([0.1, 0.1, 0.2, 0.2]), (N, 1)),
          (rng.randn(8, N, 4) * 0.5).astype(f32)],
         dict(code_type="decode_center_size"), ()),
        ("box_clip", "box_clip", "det",
         [boxes(2, 1000, scale=1200.0) - 50.0,
          np.array([[800, 1088, 1.0], [760, 1088, 1.25]], f32)], {}, ()),
        ("polygon_box_transform", "polygon_box_transform", "det",
         [rng.randn(2, 8, 128, 128).astype(f32)], {}, ()),
        ("bipartite_match", "bipartite_match", "det",
         [rng.uniform(0, 1, (20, N)).astype(f32)],
         dict(match_type="per_prediction", dist_threshold=0.5), ()),
        ("target_assign", "target_assign", "det",
         [rng.randn(20, 4).astype(f32),
          rng.randint(-1, 20, (N,)).astype(np.int32)], {}, ()),
        ("rpn_target_assign", "rpn_target_assign", "det",
         [None, None, boxes(20000, scale=1000.0), None,
          boxes(2, 20, scale=1000.0, lo=0.05, hi=0.3), None,
          np.array([[800, 1088, 1.0], [760, 1088, 1.25]], f32)], {}, ()),
        ("retinanet_target_assign", "retinanet_target_assign", "det",
         [None, None, boxes(20000, scale=1000.0), None,
          boxes(2, 20, scale=1000.0, lo=0.05, hi=0.3),
          rng.randint(1, 81, (2, 20)).astype(np.int32),
          np.zeros((2, 20), np.int32), None], dict(num_classes=80), ()),
        ("distribute_fpn_proposals", "distribute_fpn_proposals", "det",
         [boxes(1000, scale=1000.0, lo=0.01, hi=0.5)],
         dict(min_level=2, max_level=5, refer_level=4, refer_scale=224),
         ()),
        ("generate_proposal_labels", "generate_proposal_labels", "det",
         [boxes(2, 1000, scale=1000.0),
          rng.randint(1, 81, (2, 20)).astype(np.int32),
          np.zeros((2, 20), np.int32),
          boxes(2, 20, scale=1000.0, lo=0.05, hi=0.3),
          np.array([[800, 1088, 1.0]] * 2, f32)],
         dict(batch_size_per_im=512, class_nums=81), ()),
        ("roi_perspective_transform", "roi_perspective_transform", "det",
         [rng.randn(2, 32, 64, 64).astype(f32),
          np.array([[4, 4, 50, 8, 52, 30, 6, 26], [10, 20, 60, 18, 58, 40,
                                                   12, 44]] * 8, f32)],
         dict(transformed_height=8, transformed_width=32), (0,)),
    ]
    return cases


def _family_call(pt, name, module, arrays, kw, grads):
    """One case on the default place: (outputs, gradients) as numpy."""
    from paddle_tpu_torch.vision import detection as D, ops as O
    R = RPN
    if name == "generate_proposals":
        h, w = (s // R["stride"] for s in R["image"])
        an, var = D.anchor_generator(pt.zeros([1, 1, h, w]), R["sizes"],
                                     R["ratios"], stride=[16.0, 16.0])
        arrays = arrays[:3] + [an.numpy(), var.numpy()]
    ts = [None if a is None else [pt.to_tensor(v) for v in a]
          if isinstance(a, list) else pt.to_tensor(
              a, stop_gradient=i not in grads) for i, a in enumerate(arrays)]
    fn = getattr(O if module == "ops" else D, name.replace("_v2", ""))
    if name == "deform_conv2d_v2":
        out = fn(*ts[:4], mask=ts[4], **kw)
    elif name == "collect_fpn_proposals":
        out = fn(ts[0], ts[1], rois_num_per_level=ts[2], **kw)
    else:
        out = fn(*ts, **kw)
    flat = list(out) if isinstance(out, (tuple, list)) else [out]
    flat = [v for o in flat for v in (o if isinstance(o, list) else [o])
            if v is not None]
    gs = []
    if grads:
        g = np.asarray(np.random.RandomState(7).randn(*flat[0].shape),
                       np.float32)
        (flat[0] * pt.to_tensor(g)).sum().backward()
        gs = [np.asarray(ts[i].grad.numpy()) for i in grads]
    return [np.asarray(o.numpy()) for o in flat], gs


def family_phase(torch, pt):
    """Phase (ar): each case of :func:`family_cases` on the card and on
    the CPU from the same inputs: floating outputs and gradients within
    1e-5 of the CPU's max|value|, integer outputs (indices, labels,
    counts) equal; each function's ms on the card (one call after a
    warm one, synchronised).  Returns the table; cases that raise are
    listed, and there must be none."""
    res = {"cases": [], "raised": [], "failed": []}
    for label, name, module, arrays, kw, grads in family_cases():
        try:
            pt.set_device("cpu")
            want, wg = _family_call(pt, name, module, arrays, kw, grads)
            pt.set_device("gpu")
            _family_call(pt, name, module, arrays, kw, grads)
            ms, (got, gg) = sync_ms(torch, lambda: _family_call(
                pt, name, module, arrays, kw, grads))
        except Exception as e:         # noqa: BLE001 - listed, then fatal
            pt.set_device("gpu")
            res["raised"].append((label, f"{type(e).__name__}: {e}"))
            continue
        worst = 0.0
        exact = True
        for a, b in zip(got + gg, want + wg):
            if a.shape != b.shape:
                exact = False
                worst = math.inf
            elif b.dtype.kind == "f":
                worst = max(worst, float(np.abs(a - b).max()) / max(
                    float(np.abs(b).max()), 1e-30))
            else:
                exact = exact and bool(np.array_equal(a, b))
        res["cases"].append({"case": label, "ms": ms, "err_over_max": worst,
                             "integers_equal": exact,
                             "outputs": len(want), "grads": len(wg)})
        if worst > FAMILY_TOL or not exact:
            res["failed"].append(label)
    return res


def vision_family_phases(torch, card, args):
    """Phases (ap), (aq), (ar), logged."""
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    prev = core._state.expected_place
    S, c = SSD, IMAGENET
    try:
        pt.set_device("gpu")
        t0 = time.perf_counter()
        ap = ssd_path(torch, pt, args)
        log(f"(ap) MobileNet-SSD300 (PaddleCV object_detection: "
            f"MobileNetV1 x1.0, 4 extra blocks, multi_box_head over maps "
            f"{ap['maps']}, {SSD_PRIORS} priors, {S['classes']} classes) "
            f"static training, RMSProp {S['lr']} with L2 {S['l2']}, batch "
            f"{S['batch']} at {S['size']}x{S['size']} (transforms.Resize + "
            f"Normalize from {S['raw'][0]}x{S['raw'][1]}), on {card}:")
        log(f"    step {ap['step_ms']} ms, imgs/s {ap['imgs_per_s']} "
            f"({S['steps']} steps, the last fetched); loss "
            f"{ap['loss_first']} -> {ap['loss_final']}; kernel launches a "
            f"step {ap['launches_per_step']} (profiler), device busy "
            f"{ap['device_busy_ms_per_step']} ms a step, idle share "
            f"{ap['device_idle_share']}; max_memory_allocated "
            f"{ap['peak_gib']} GiB; program {ap['ops']} ops, "
            f"{ap['params']} parameters, built in {ap['build_s']:.1f} s  "
            f"[{card}]")
        log(f"    top kernels a step: {json.dumps(ap['top_kernels'])}  "
            f"[{card}]")
        log(f"    inference (detection_output, nms 0.45, top 400 / keep "
            f"200, score 0.01) {ap['infer_ms']} ms a batch of "
            f"{S['batch']}; the NMS alone (box decode + multiclass_nms on "
            f"the same outputs) {ap['nms_ms']} ms, share "
            f"{ap['nms_share']}; kept boxes an image {ap['kept_mean']} "
            f"(min {ap['kept_min']}, max {ap['kept_max']})  [{card}]")
        torch.cuda.empty_cache()
        par = ssd_parity(torch, pt)
        n = par["nms"]
        log(f"    card against CPU, {SSD_PARITY} images at full width: "
            f"float64 (asserted) loss relative {par['loss_rel_err_f64']:.3e}"
            f" (tol {SSD_LOSS_TOL:.0e}), {par['grads']} gradients at worst "
            f"{par['grad_err_over_max_f64']:.3e} of the largest (tol "
            f"{SSD_GRAD_TOL:.0e}); fp32 (reported) loss {par['loss_card']} "
            f"/ {par['loss_cpu']} (relative {par['loss_rel_err']:.3e}), "
            f"gradients {par['grad_err_over_max']:.3e} of the largest; "
            f"NMS rows on the CPU's fp32 outputs: labels "
            f"equal {n['cpu_inputs']['labels_equal']}, kept indices equal "
            f"{n['cpu_inputs']['index_equal']} ({n['cpu_inputs']['kept']} "
            f"kept); on each device's own outputs: labels equal "
            f"{n['own']['labels_equal']}, indices equal "
            f"{n['own']['index_equal']}"
            + (f", CPU margin {n['own']['cpu_margin']:.3e}"
               if "cpu_margin" in n["own"] else "")
            + f"; phase {time.perf_counter() - t0:.1f} s  [{card}]")
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        root = tempfile.mkdtemp(prefix="imagenet_")
        try:
            imagenet_folder(root, c["images"], c["classes"], c["raw"],
                            SEED + 86)
            write_s = time.perf_counter() - t0
            aq = imagenet_path(torch, pt, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        log(f"(aq) MobileNetV2 x1.0 (Sandler et al. 2018, Table 2; "
            f"{c['num_classes']} classes) through DatasetFolder "
            f"({c['images']} synthetic {c['raw']}x{c['raw']}x3 uint8 .npy, "
            f"written in {write_s:.1f} s) -> RandomResizedCrop({c['size']}) "
            f"+ RandomHorizontalFlip + Normalize + Transpose -> "
            f"io.DataLoader (batch {c['batch']}, {c['workers']} workers) -> "
            f"Model.fit, Momentum {c['momentum']}, on {card}:")
        log(f"    imgs/s {aq['imgs_per_s']}, step {aq['step_ms']} ms "
            f"({aq['steps']} timed steps, the second epoch); the host waits "
            f"on the loader {aq['loader_wait_share']} of the wall; "
            f"max_memory_allocated {aq['peak_gib']} GiB; loss "
            f"{aq['loss_first']} -> {aq['loss_last']}  [{card}]")
        log(f"    a batch's normalisation: per-image Normalize + Transpose "
            f"{aq['per_image_ms']} ms, one runtime.preprocess_images call "
            f"{aq['native_ms']} ms, outputs equal within "
            f"{aq['preprocess_max_diff']:.3e} (max |value| "
            f"{aq['preprocess_max']:.3f}), host  [{card}]")
        log(f"    VGG16 (configuration D) eval forward [{VGG_BATCH}, 3, "
            f"{c['size']}, {c['size']}]: imgs/s fp32 "
            f"{aq['vgg16_float32_imgs_per_s']}, bf16 auto_cast "
            f"{aq['vgg16_bfloat16_imgs_per_s']}  [{card}]")
        qp = imagenet_parity(torch, pt)
        m = qp["mobilenet_v2"]
        log(f"    card against CPU, 2 images at 224: fp32 logits, "
            f"MobileNetV2 {m['logit_err_over_max']:.3e} of max, VGG16 "
            f"{qp['vgg16']['logit_err_over_max']:.3e} (tol "
            f"{LOGIT_TOL:.0e}); one MobileNetV2 training step in float64 "
            f"(asserted): loss relative {m['loss_rel_err_f64']:.3e}, "
            f"gradients {m['grad_err_over_max_f64']:.3e} of the largest; "
            f"in fp32 (reported): loss {m['loss_card']} / {m['loss_cpu']} "
            f"(relative {m['loss_rel_err']:.3e}), gradients "
            f"{m['grad_err_over_max']:.3e}; phase "
            f"{time.perf_counter() - t0:.1f} s  [{card}]")
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ar = family_phase(torch, pt)
        worst = max(ar["cases"], key=lambda r: r["err_over_max"])
        log(f"(ar) vision.ops and vision.detection card against CPU: "
            f"{len(ar['cases'])} cases checked, the largest difference "
            f"{worst['err_over_max']:.3e} of max ({worst['case']}), "
            f"integers equal in all but {len(ar['failed'])}; raised: "
            f"{ar['raised'] or 'none'}; phase "
            f"{time.perf_counter() - t0:.1f} s  [{card}]")
        for r in ar["cases"]:
            log(f"    {r['case']}: {r['ms']:.3f} ms on the card, "
                f"{r['err_over_max']:.3e} of max, integers equal "
                f"{r['integers_equal']} ({r['outputs']} outputs, "
                f"{r['grads']} gradients)  [{card}]")
        if ar["raised"] or ar["failed"]:
            raise SystemExit(f"(ar): raised {ar['raised']}, failed "
                             f"{ar['failed']}")
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
    "row_matmul": (
        "paddle_tpu_torch/ops/cuda/csrc/row_matmul.cu",
        "none: added for the reference's commit-bytes contract "
        "(paddle_tpu/models/gpt.py:1103 _paged_verify_block)",
        "[8, 1024] x [1024, 4096] (fc1)"),
    "ln_row_matmul": (
        "paddle_tpu_torch/ops/cuda/csrc/row_matmul.cu",
        "paddle_tpu/ops/pallas/norms.py:47 (on the paged decode and the fp "
        "verify, as the qkv and fc1 products' prologue)",
        "[8, 1024] x [1024, 4096] (fc1)"),
}


# (aj), (ak), (al): inference export and the Predictor, the reader path,
# the optimizer extras and the checkpoint -----------------------------------

EXPORT_BATCHES = (8, 5, 8)    # (aj): the fresh process's Predictor batches
EXPORT_ROUNDS = 5             # (aj): timed rounds, alternated
READER_STEPS = 3              # (ak): ResNet50 steps fed by the py_reader
# (ak): Paddle's CTR-DNN example: 26 sparse slots into one 1,000,001 x 10
# table, 13 dense features, fc 400-400-400, batch 512
CTR = dict(sparse=26, dense=13, rows=1000001, emb=10, fc=(400, 400, 400),
           batch=512, batches=8)
CTR_LOSS_TOL = 1e-5           # (ak): card against CPU, x max|loss|
EXTRA_STEPS = 4               # (al): LookAhead / average steps
CKPT_TOL = 1e-6               # (al): resumed against uninterrupted, x max

# the fresh process of (aj): imports paddle_tpu_torch and no model code,
# serves each artifact through create_predictor at EXPORT_BATCHES
_SERVE = r"""
import collections, hashlib, json, sys, time
import numpy as np, torch
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.inference import export
from paddle_tpu_torch.ops.cuda import flash_attn, norms

def counts():
    return (norms.launches, flash_attn.fwd_launches, norms.rms_launches)

res = {}
for prefix in sys.argv[2:]:
    t0 = time.perf_counter()
    cfg = Config(prefix)
    cfg.enable_use_gpu()
    pred = create_predictor(cfg)
    nodes = collections.Counter(
        str(n.target) for n in pred._model._module.graph.nodes
        if n.op == "call_function")
    c_before = export.serving_stats()["standalone_compiles"]
    load_s = time.perf_counter() - t0
    runs = []
    for b in json.loads(sys.argv[1]):
        ids = np.load(f"{prefix}.ids{b}.npy")
        c0 = counts()
        t0 = time.perf_counter()
        h = pred.get_input_handle("ids")
        h.copy_from_cpu(ids)
        pred.run()
        outs = [pred.get_output_handle(n).copy_to_cpu()
                for n in pred.get_output_names()]
        ms = 1e3 * (time.perf_counter() - t0)
        c1 = counts()
        runs.append({"batch": b, "ms": ms,
                     "launches": [a - z for a, z in zip(c1, c0)],
                     "shapes": [list(o.shape) for o in outs],
                     "finite": bool(all(np.isfinite(o).all() for o in outs)),
                     "sha256": [hashlib.sha256(o.tobytes()).hexdigest()
                                for o in outs]})
    res[prefix] = {"load_s": load_s, "nodes": dict(nodes), "runs": runs,
                   "meta": pred._model.meta,
                   "standalone_compiles": export.serving_stats()[
                       "standalone_compiles"] - c_before}
print("SERVED " + json.dumps(res))
"""


def _digest(arrays):
    import hashlib
    return [hashlib.sha256(a.tobytes()).hexdigest() for a in arrays]


def _host(v):
    v = v.detach()
    return (v.float() if v.dtype.is_floating_point else v).cpu().numpy()


def _rel_err(got, want):
    return max_err(got, want) / max(float(want.float().abs().max()), 1e-30)


def _encoder_ok(dt, h_err, l_err):
    """(o)'s tolerances in fp32 (final norm 1e-4 of max, logits 1e-3),
    (ag)'s in bf16 (2^-6 of max)."""
    if dt == "float32":
        return h_err <= RMS_PARITY_TOL and l_err <= PARITY_LOGIT_TOL
    return max(h_err, l_err) <= BF16_STEPS_TOL


def export_path(torch, pt, flash_attn, norms, out_dir):
    """(aj): (n)'s encoder at full width exported per dtype with a dynamic
    batch, served from a fresh process at EXPORT_BATCHES, held against
    the eager forward; the Predictor, ``to_static`` and eager timed
    alternated; ``from_layer`` and a ``jit.save`` pair; ResNet50's eval
    program through ``static.save_inference_model``."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.inference.export import StandaloneModel
    e, L = ENCODER, ENCODER["L"]
    os.makedirs(out_dir, exist_ok=True)
    pt.set_device("gpu")
    model = make_encoder(pt, **e)
    model.set_state_dict(numpy_state(model, SEED + 15))
    rng = np.random.default_rng(SEED + 80)
    ids_np = {b: rng.integers(0, e["V"], (b, e["N"])).astype(np.int64)
              for b in set(EXPORT_BATCHES)}
    spec = [pt.static.InputSpec([None, e["N"]], "int64")]
    res, prefixes = {"dtypes": {}, "times": {}}, []
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["times"][name] = round(now - mark[0], 1)
        mark[0] = now
    for dt in ("float32", "bfloat16"):
        model.to(dtype=dt)
        prefix = os.path.join(out_dir, f"encoder_{dt}")
        t0 = time.perf_counter()
        meta = inference.save_inference_model(
            prefix, model, spec, input_names=["ids"],
            output_names=["hidden", "logits"])
        export_s = time.perf_counter() - t0
        if not meta["dynamic_batch"] or meta["inputs"][0]["shape"] != [
                -1, e["N"]]:
            raise SystemExit(f"(aj) {dt} manifest {meta}")
        for b, a in ids_np.items():
            np.save(f"{prefix}.ids{b}.npy", a)
        with pt.no_grad():
            eager = {b: [o.value for o in model(pt.to_tensor(a))]
                     for b, a in ids_np.items()}
        res["dtypes"][dt] = {"export_s": export_s, "meta": meta,
                             "pt2_mib": os.path.getsize(prefix + ".pt2")
                             / 2 ** 20, "eager": eager}
        prefixes.append(prefix)
        lap(f"export_{dt}")
    # the fresh process
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _SERVE,
                        json.dumps(list(EXPORT_BATCHES)), *prefixes],
                       capture_output=True, text=True, env=env, timeout=600)
    serve_s = time.perf_counter() - t0
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("SERVED ")]
    if r.returncode != 0 or not line:
        raise SystemExit(f"(aj) the serving process failed "
                         f"(rc {r.returncode}): {r.stderr[-3000:]}")
    served = json.loads(line[0][len("SERVED "):])
    lap("fresh_process")
    want_nodes = {"paddle_tpu.layer_norm.default": 2 * L,
                  "paddle_tpu.flash_fwd.default": L,
                  "paddle_tpu.rms_norm.default": 1}
    per = [2 * L, L, 1]
    launches = {"layer_norm": 0, "flash_attention_fwd": 0, "rms_norm": 0}
    for dt, prefix in zip(("float32", "bfloat16"), prefixes):
        s, d = served[prefix], res["dtypes"][dt]
        nodes = {k: s["nodes"].get(k, 0) for k in want_nodes}
        stray = [k for k in s["nodes"] if not k.startswith("paddle_tpu.")
                 and any(w in k for w in ("layer_norm", "attention",
                                          "softmax", "rsqrt"))]
        if nodes != want_nodes or stray:
            raise SystemExit(f"(aj) {dt} graph nodes {nodes}, plain ops "
                             f"{stray}")
        # batch 8 captures (its warm-up runs eagerly), batch 5 pads to the
        # 8-bucket and the probe replays it twice, batch 8 replays once
        want_runs = [per, [2 * n for n in per], per]
        got_runs = [x["launches"] for x in s["runs"]]
        if got_runs != want_runs or s["standalone_compiles"] != 1:
            raise SystemExit(f"(aj) {dt} launches {got_runs} (want "
                             f"{want_runs}), standalone_compiles "
                             f"{s['standalone_compiles']}")
        for k, n in zip(launches, map(sum, zip(*got_runs))):
            launches[k] += n
        if not all(x["finite"] for x in s["runs"]) or \
                s["runs"][0]["sha256"] != s["runs"][2]["sha256"]:
            raise SystemExit(f"(aj) {dt}: a non-finite output, or batch 8's "
                             "replay differs from its first run")
        # the same artifact in this process: the same bits as the fresh
        # one's, and the eager forward's within (o)'s / (ag)'s tolerances
        sm = StandaloneModel(prefix)
        errs, bit = [], True
        for x in s["runs"][:2]:
            b = x["batch"]
            outs = sm(ids_np[b])
            if _digest([_host(o) for o in outs]) != x["sha256"]:
                raise SystemExit(f"(aj) {dt} batch {b}: this process's "
                                 "outputs differ from the fresh process's")
            bit = bit and all(torch.equal(o, w) for o, w in
                              zip(outs, d["eager"][b]))
            errs.append([_rel_err(o, w) for o, w in zip(outs, d["eager"][b])])
        h_err = max(x[0] for x in errs)
        l_err = max(x[1] for x in errs)
        if not (bit or _encoder_ok(dt, h_err, l_err)):
            raise SystemExit(f"(aj) {dt}: the Predictor's outputs against "
                             f"eager: final norm {h_err:.3e}, logits "
                             f"{l_err:.3e} of max")
        d.update(served=s, bit_equal=bit, h_err=h_err, l_err=l_err,
                 sm=sm)
        lap(f"load_and_compare_{dt}")
    res["serve_s"] = serve_s
    res["launches"] = launches
    # timing, alternated: the Predictor's graph, to_static's, eager
    sfn = pt.jit.to_static(model)
    for dt in ("float32", "bfloat16"):
        model.to(dtype=dt)
        d = res["dtypes"][dt]
        ids = pt.to_tensor(ids_np[8])
        with pt.no_grad():
            sfn(ids)                         # capture
            t = {"predictor": [], "to_static": [], "eager": []}
            for _ in range(EXPORT_ROUNDS):
                for k, fn in (("predictor", lambda: d["sm"](ids.value)),
                              ("to_static", lambda: sfn(ids)),
                              ("eager", lambda: model(ids))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    t[k].append(time.perf_counter() - t0)
        B, N = ids_np[8].shape
        d["timing"] = {k: {"batch_ms": 1e3 * float(np.mean(v)),
                           "tokens_per_s": B * N / float(np.mean(v)),
                           "ms_each": [round(1e3 * x, 3) for x in v]}
                       for k, v in t.items()}
        del d["sm"], d["eager"]
    del sfn
    lap("timing")
    # from_layer and a jit.save pair (bf16): the eager forward's outputs
    cfg = inference.Config()
    cfg.enable_use_gpu()
    a = ids_np[8]
    with pt.no_grad():
        want = [_host(o.value) for o in model(pt.to_tensor(a))]
    got = inference.Predictor.from_layer(model, cfg).run([a])
    lap("from_layer")
    path = os.path.join(out_dir, "jit_pair")
    pt.jit.save(model, path, input_spec=spec)
    pair = inference.Config(path)
    pair.enable_use_gpu()
    got_pair = inference.Predictor(pair).run([a])
    lap("jit_pair")
    res["from_layer_bit_equal"] = all(np.array_equal(g, w)
                                      for g, w in zip(got, want))
    res["pair_bit_equal"] = all(np.array_equal(g, w)
                                for g, w in zip(got_pair, want))
    if not (res["from_layer_bit_equal"] and res["pair_bit_equal"]):
        raise SystemExit("(aj) from_layer or the jit.save pair differ from "
                         "the eager forward")
    del model, got, got_pair, want
    gc.collect()
    torch.cuda.empty_cache()
    res["resnet"] = resnet_inference_export(torch, pt, out_dir)
    lap("resnet")
    return res


def resnet_inference_export(torch, pt, out_dir):
    """(aj)'s static part: (aa)'s ResNet50 program's eval clone frozen by
    ``static.save_inference_model`` (logits from the image, the loss and
    its label pruned away), loaded and run by the Executor, against the
    clone's own fetch on the same batch."""
    from paddle_tpu_torch import static
    c = RESNET
    pt.seed(SEED)
    main, startup, net, loss, v = resnet_program(
        pt, 50, c["size"], c["classes"], True)
    test, img, logits = main.clone(for_test=True), v["image"], v["logits"]
    rng = np.random.RandomState(5)
    x = rng.randn(32, 3, c["size"], c["size"]).astype(np.float32)
    y = rng.randint(0, c["classes"], (32, 1)).astype(np.int64)
    exe = static.Executor()
    prefix = os.path.join(out_dir, "resnet50_eval")
    pt.enable_static()
    try:
        want, = exe.run(test, feed={"image": x, "label": y},
                        fetch_list=[logits])
        t0 = time.perf_counter()
        meta = static.save_inference_model(prefix, [img], [logits], exe,
                                           program=test)
        export_s = time.perf_counter() - t0
    finally:
        pt.disable_static()
    prog, feeds, fetches = static.load_inference_model(prefix, exe)
    got, = exe.run(prog, feed={"image": x}, fetch_list=fetches)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    if feeds != ["image"] or got.shape != want.shape or \
            not np.isfinite(got).all() or err > BF16_STEPS_TOL:
        raise SystemExit(f"(aj) ResNet50 eval artifact: feeds {feeds}, "
                         f"{got.shape} against {want.shape}, error {err:.3e}")
    return {"export_s": export_s, "dynamic_batch": meta["dynamic_batch"],
            "bit_equal": bool(np.array_equal(got, want)), "err": err,
            "batch": x.shape[0]}


def reader_resnet(torch, pt, fluid):
    """(ak), first part: (aa)'s ResNet50 train program fed by a
    ``py_reader`` over its data variables with ``double_buffer``, the
    classic loop for READER_STEPS steps, ``EOFException``, ``reset()``;
    beside ``exe.run(feed=...)`` over the same batches in a program built
    from the same seed.  cuDNN is deterministic in this phase."""
    from paddle_tpu_torch import static
    c = RESNET
    rng = np.random.RandomState(SEED + 81)
    batches = [(rng.randn(c["batch"], 3, c["size"], c["size"]).astype(
        np.float32), rng.randint(0, c["classes"], (c["batch"], 1)).astype(
            np.int64)) for _ in range(READER_STEPS)]
    losses, stats = {}, {}
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for how in ("reader", "feed"):
            pt.seed(SEED)
            main, startup, net, loss, v = resnet_program(
                pt, 50, c["size"], c["classes"], True)
            exe = static.Executor()
            out = []
            pt.enable_static()
            try:
                if how == "feed":
                    for x, y in batches:
                        out.append(float(exe.run(main, feed={
                            "image": x, "label": y}, fetch_list=[loss])[0]))
                else:
                    with static.program_guard(main, startup):
                        rd = fluid.layers.create_py_reader_by_data(
                            capacity=2, feed_list=[v["image"], v["label"]],
                            use_double_buffer=False)
                    rd = fluid.layers.double_buffer(rd)
                    rd.decorate_batch_generator(lambda: iter(batches))
                    rd.start()
                    ring = rd._pass.ring
                    t0 = time.perf_counter()
                    try:
                        while True:
                            out.append(float(exe.run(
                                main, fetch_list=[loss])[0]))
                    except fluid.core.EOFException:
                        rd.reset()
                    stats = {"ring": ring is not None,
                             "s": time.perf_counter() - t0}
            finally:
                pt.disable_static()
            losses[how] = out
            del main, startup, net, exe, v
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev_det
    a, b = np.asarray(losses["reader"]), np.asarray(losses["feed"])
    err = float(np.abs(a - b).max() / np.abs(b).max())
    if len(a) != READER_STEPS or not stats["ring"] or \
            not np.isfinite(a).all() or err > 1e-4:
        raise SystemExit(f"(ak) ResNet50 via py_reader: losses {a} against "
                         f"{b} (ring {stats['ring']})")
    return {"losses": a.tolist(), "feed_losses": b.tolist(), "err": err,
            "bit_equal": bool(np.array_equal(a, b)), **stats}


def ctr_files(tmp, fleet, n):
    """n samples of the CTR-DNN's MultiSlot protocol (13 dense floats, 26
    sparse ids, a click) from a ``MultiSlotDataGenerator``, two files."""
    rng = np.random.RandomState(SEED + 82)
    dense = rng.rand(n, CTR["dense"]).round(4)
    sparse = rng.randint(0, CTR["rows"], (n, CTR["sparse"]))
    click = rng.randint(0, 2, n)

    class Gen(fleet.MultiSlotDataGenerator):
        def generate_sample(self, line):
            lo, hi = line

            def it():
                for i in range(lo, hi):
                    yield ([("dense", [float(v) for v in dense[i]])]
                           + [(f"C{j}", [int(sparse[i, j])])
                              for j in range(CTR["sparse"])]
                           + [("click", [int(click[i])])])
            return it
    files = []
    for k, part in enumerate(((0, n // 2), (n // 2, n))):
        path = os.path.join(tmp, f"part-{k}")
        with open(path, "w") as f, contextlib.redirect_stdout(f):
            g = Gen()
            g.set_batch(CTR["batch"])
            g._run_samples([g.generate_sample(part)])
        files.append(path)
    return files


def ctr_program(pt, place):
    """Paddle's CTR-DNN on the port's static API: the 26 sparse slots
    through one shared ``Embedding`` (summed over each slot's ids), the
    dense slot, fc 400-400-400 relu, a 2-way softmax, cross entropy, Adam
    1e-4; built from one seed on ``place``."""
    from paddle_tpu_torch import static
    pt.set_device(place)
    pt.seed(SEED + 83)
    pt.enable_static()
    try:
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            # the QueueDataset pads each slot to a power of two, the 13
            # dense values to 16: the model reads the 13
            dense = static.data("dense", [None, 16], "float32")
            sparse = [static.data(f"C{j}", [None, 1], "int64")
                      for j in range(CTR["sparse"])]
            click = static.data("click", [None, 1], "int64")
            emb = pt.nn.Embedding(CTR["rows"], CTR["emb"], sparse=True)
            h = pt.concat([pt.sum(emb(s), axis=1) for s in sparse]
                          + [dense[:, :CTR["dense"]]], axis=1)
            for width in CTR["fc"]:
                h = static.nn.fc(h, width, activation="relu")
            predict = static.nn.fc(h, 2, activation="softmax")
            loss = pt.mean(pt.nn.functional.cross_entropy(
                predict, click, use_softmax=False))
            pt.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    finally:
        pt.disable_static()
    return main, [dense] + sparse + [click], loss


def reader_ctr(torch, pt, distributed, tmp):
    """(ak), second part: ``train_from_dataset`` of the CTR-DNN over a
    ``QueueDataset`` of MultiSlot files, on the card and on the CPU (the
    losses it prints, every step), then ``infer_from_dataset`` on the
    card, which must leave every parameter's bits."""
    from paddle_tpu_torch import static
    n = CTR["batch"] * CTR["batches"]
    files = ctr_files(tmp, distributed.fleet, n)
    out = {}
    for place in ("gpu", "cpu"):
        main, slots, loss = ctr_program(pt, place)
        ds = distributed.QueueDataset()
        ds.init(batch_size=CTR["batch"], use_var=slots)
        ds.set_filelist(files)
        wait = [0.0]
        batches = ds.iter_batches

        def timed():
            it = batches()
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                finally:
                    wait[0] += time.perf_counter() - t0
                yield b
        ds.iter_batches = timed
        exe = static.Executor()
        buf = io.StringIO()
        pt.enable_static()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                exe.train_from_dataset(main, ds, fetch_list=[loss],
                                       fetch_info=["loss"], print_period=1)
            wall = time.perf_counter() - t0
            losses = [float(ln.split("[")[1].rstrip("]"))
                      for ln in buf.getvalue().splitlines()
                      if ln.startswith("step ")]
            res = {"losses": losses, "steps_per_s": len(losses) / wall,
                   "reader_wait_share": wait[0] / wall}
            if place == "gpu":
                before = [p.value.detach().clone()
                          for p in main.all_parameters()]
                with contextlib.redirect_stdout(io.StringIO()):
                    exe.infer_from_dataset(main, ds, fetch_list=[loss],
                                           print_period=100)
                res["infer_kept_params"] = all(
                    torch.equal(b, p.value) for b, p in
                    zip(before, main.all_parameters()))
                res["params"] = sum(p.size for p in main.all_parameters())
                res["on_card"] = all(p.value.is_cuda
                                     for p in main.all_parameters())
        finally:
            pt.disable_static()
            pt.set_device("gpu")
        out[place] = res
        del main, slots, loss, ds, exe
        gc.collect()
    g, c = np.asarray(out["gpu"]["losses"]), np.asarray(out["cpu"]["losses"])
    err = float(np.abs(g - c).max() / np.abs(c).max())
    if (len(g) != CTR["batches"] or len(c) != len(g) or err > CTR_LOSS_TOL
            or not out["gpu"]["infer_kept_params"]
            or not out["gpu"]["on_card"]):
        raise SystemExit(f"(ak) CTR-DNN: card losses {g}, CPU {c} "
                         f"(err {err:.3e}); infer kept the parameters "
                         f"{out['gpu'].get('infer_kept_params')}")
    out["err"] = err
    return out


def ernie_fine_tune(pt, bert, cfg, batch, lr=1e-4, epsilon=1e-6, opt=None,
                    wrap=None):
    """(ae)'s classifier step at a constant lr: AdamW (weight decay 0.01,
    ``ClipGradByGlobalNorm(1.0)``) or ``opt(net)``, ``wrap``ped; returns
    (net, optimizer, step(t, y) -> loss)."""
    pt.seed(SEED + 84)
    net = multilabel_classifier(pt, bert, cfg)
    o = (opt or (lambda n: pt.optimizer.AdamW(
        learning_rate=lr, weight_decay=0.01, epsilon=epsilon,
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
        parameters=trained_params(n))))(net)
    o = wrap(o) if wrap is not None else o
    crit = pt.nn.BCEWithLogitsLoss()

    def step(t, y):
        loss = crit(net(t), y)
        loss.backward()
        o.step()
        o.clear_grad()
        return loss
    return net, o, step


def extras_path(torch, pt, bert, flash_attn, norms, fused_ffn, out_dir):
    """(al): the optimizer extras and the checkpoint on (ae)'s
    ERNIE-3.0-Base fine-tune, fp32 where they are compared, and
    ``incubate.fused_feedforward`` at (l)'s shape."""
    from paddle_tpu_torch.incubate import optimizer as inc
    from paddle_tpu_torch.optimizer import GradientMergeOptimizer
    from paddle_tpu_torch.utils import checkpoint as ckpt
    base = bert.ernie_3_base()
    L, B, N = base.num_layers, ERNIE_BATCH, base.max_seq_len
    cfg32 = dataclasses.replace(base, dtype="float32")
    tokens, labels = multilabel_batch(base.vocab_size, B, N, SEED + 85)
    t, y = pt.to_tensor(tokens), pt.to_tensor(labels)
    counters = eager_counters(flash_attn, norms)
    res = {}
    # GradientMerge(AdamW, k=2): two micro-steps of B/2 against one of B
    t0 = time.perf_counter()
    net, opt, step = ernie_fine_tune(pt, bert, cfg32, None)
    init = [p.value.detach().clone() for p in trained_params(net)]
    step(t, y)
    one = [p.value.detach().clone() for p in trained_params(net)]
    with torch.no_grad():
        for p, v in zip(trained_params(net), init):
            p.value.copy_(v)
    gm = GradientMergeOptimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01, epsilon=1e-6,
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
        parameters=trained_params(net)), k_steps=2)
    crit = pt.nn.BCEWithLogitsLoss()
    zero_counts(counters)
    for half in (slice(0, B // 2), slice(B // 2, B)):
        crit(net(t[half]), y[half]).backward()
        gm.step()
    res["gm_launches"] = read_counts(counters)
    scale = max(float(v.abs().max()) for v in one)
    res["gm_err"] = max(max_err(p.value.detach(), v) for p, v in
                        zip(trained_params(net), one)) / scale
    if res["gm_err"] > FP32_TOL or gm._acc:
        raise SystemExit(f"(al) gradient merge against one step of B: "
                         f"{res['gm_err']:.3e} of max|param|")
    check_counts("(al) gradient merge", res["gm_launches"],
                 {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                  "flash_attention_bwd_dkv": L}, 2)
    res["gm_s"] = time.perf_counter() - t0
    del net, opt, step, gm, init, one
    gc.collect()
    torch.cuda.empty_cache()
    # LookAhead(k=2) over EXTRA_STEPS steps against its update by hand,
    # ModelAverage and ExponentialMovingAverage beside it
    t0 = time.perf_counter()
    fast = []

    def with_fast(o):
        la = inc.LookAhead(o, alpha=0.5, k=2)
        inner = la.inner_optimizer.step

        def record():
            inner()
            fast.append([p.value.detach().clone() for p in la._parameters])
        la.inner_optimizer.step = record
        return la
    net, la, step = ernie_fine_tune(pt, bert, cfg32, None, wrap=with_fast)
    ma = inc.ModelAverage(0.15, parameters=trained_params(net),
                          min_average_window=2, max_average_window=3)
    ema = inc.ExponentialMovingAverage(0.9,
                                       parameters=trained_params(net))
    slow = [p.value.detach().clone() for p in la._parameters]
    exact = True
    for k in range(EXTRA_STEPS):
        step(t, y)
        ma.step()
        ema.update()
        if (k + 1) % 2 == 0:
            slow = [s + 0.5 * (f - s) for s, f in zip(slow, fast[-1])]
            exact = exact and all(torch.equal(p.value, s) for p, s in
                                  zip(la._parameters, slow))
    if not exact:
        raise SystemExit("(al) LookAhead's weights differ from slow + 0.5 "
                         "(fast - slow) by hand")
    trained = [p.value.detach().clone() for p in trained_params(net)]
    restored = {}
    for name, avg in (("ModelAverage", ma), ("EMA", ema)):
        with avg.apply():
            moved = any(not torch.equal(p.value, v) for p, v in
                        zip(trained_params(net), trained))
        restored[name] = moved and all(
            torch.equal(p.value, v) for p, v in
            zip(trained_params(net), trained))
    if not all(restored.values()):
        raise SystemExit(f"(al) apply / restore: {restored}")
    res.update(lookahead_exact=exact, restored=restored,
               la_s=time.perf_counter() - t0)
    del net, la, step, ma, ema, trained, slow, fast
    gc.collect()
    torch.cuda.empty_cache()
    # CheckpointManager(async_save=True): save at step 2, step 3 launched
    # before wait(); a fresh model restored at step 2 runs 3-4
    t0 = time.perf_counter()
    root = os.path.join(out_dir, "ckpt")
    shutil.rmtree(root, ignore_errors=True)

    def sched_opt(n):
        sched = pt.optimizer.lr.LinearWarmup(1e-4, 10, 1e-5, 1e-4)
        return pt.optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                                  epsilon=1e-6, parameters=trained_params(n))
    net, opt, step = ernie_fine_tune(pt, bert, cfg32, None, opt=sched_opt)
    mgr = ckpt.CheckpointManager(root, keep=2, async_save=True)
    ckpt.reset_checkpoint_stats()
    for k in range(1, 5):
        step(t, y)
        opt._lr.step()
        if k == 2:
            ts = time.perf_counter()
            mgr.save(2, model=net, optimizer=opt, scheduler=opt._lr)
            res["save_call_ms"] = 1e3 * (time.perf_counter() - ts)
            saved = [p.value.detach().clone() for p in trained_params(net)]
        if k == 3:
            mgr.wait()
    want = [p.value.detach().clone() for p in trained_params(net)]
    del net, opt, step
    gc.collect()
    net2, opt2, step2 = ernie_fine_tune(pt, bert, cfg32, None, opt=sched_opt)
    if mgr.restore(model=net2, optimizer=opt2, scheduler=opt2._lr) != 2:
        raise SystemExit("(al) restore did not return step 2")
    at2 = all(torch.equal(p.value, v) for p, v in
              zip(trained_params(net2), saved))
    for _ in (3, 4):
        step2(t, y)
        opt2._lr.step()
    scale = max(float(v.abs().max()) for v in want)
    res["ckpt_err"] = max(max_err(p.value.detach(), v) for p, v in
                          zip(trained_params(net2), want)) / scale
    res["ckpt_bit_equal"] = all(torch.equal(p.value, v) for p, v in
                                zip(trained_params(net2), want))
    res["ckpt_stats"] = ckpt.checkpoint_stats()
    res["ckpt_mib"] = sum(os.path.getsize(os.path.join(root, "step_2", f))
                          for f in os.listdir(os.path.join(root, "step_2"))
                          ) / 2 ** 20
    if not at2 or res["ckpt_err"] > CKPT_TOL or \
            res["ckpt_stats"]["async_saves"] != 1:
        raise SystemExit(f"(al) checkpoint: restored step 2 equal {at2}; "
                         f"resumed against uninterrupted "
                         f"{res['ckpt_err']:.3e} of max; "
                         f"{res['ckpt_stats']}")
    res["ckpt_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    del net2, opt2, step2, want, saved
    gc.collect()
    torch.cuda.empty_cache()
    # incubate.fused_feedforward at (l)'s shape, one FFN launch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 86)
    M, H, F = 12288, 2048, 8192

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=gen)
                * scale).to(torch.bfloat16)
    args = (rnd(M, H), rnd(H, F, scale=H ** -0.5), rnd(F, scale=0.1),
            rnd(F, H, scale=F ** -0.5), rnd(H, scale=0.1))
    n0 = fused_ffn.launches
    with pt.no_grad():
        got = pt.incubate.fused_feedforward(*[pt.Tensor(a) for a in args])
    res["ffn_launches"] = fused_ffn.launches - n0
    with fp32_reduction(torch):
        ref = fused_ffn._ref_fused_ffn(*args)
    ratio, _ = gate([(got.value, ref, ref)], BF16_ATOL, BF16_RTOL)
    res.update(ffn_err=max_err(got.value, ref), ffn_gate=ratio)
    if res["ffn_launches"] != 1 or ratio > 1.0:
        raise SystemExit(f"(al) fused_feedforward: {res['ffn_launches']} "
                         f"launches, gate {ratio:.3f}")
    return res


def deploy_phases(torch, flash_attn, norms, fused_ffn, card, launches):
    """Phases (aj), (ak), (al), logged; their launches go into
    ``launches``."""
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed, fluid
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.models import bert
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "paddle_tpu_torch", "_build", "deploy")
    prev = core._state.expected_place
    try:
        t0 = time.perf_counter()
        aj = export_path(torch, pt, flash_attn, norms, out_dir)
        for k, n in aj["launches"].items():
            launches[f"{k}_predictor"] = n
        e = ENCODER
        log(f"(aj) inference.save_inference_model of (n)'s encoder (V="
            f"{e['V']}, H={e['H']}, L={e['L']}, nh={e['nh']}, F={e['F']}), "
            f"InputSpec([None, {e['N']}], int64), served by "
            f"create_predictor in a fresh process at batches "
            f"{list(EXPORT_BATCHES)}, on {card}:")
        for dt, d in aj["dtypes"].items():
            s = d["served"]
            log(f"    {dt}: export {d['export_s']:.1f} s, {d['pt2_mib']:.1f} "
                f"MiB .pt2, dynamic_batch {d['meta']['dynamic_batch']}; "
                f"graph nodes LayerNorm / flash forward / RMSNorm "
                f"{[s['nodes'].get(f'paddle_tpu.{k}.default') for k in ('layer_norm', 'flash_fwd', 'rms_norm')]}"
                f"; fresh process: load {s['load_s']:.1f} s, runs (batch, ms "
                f"with host copies, launches) "
                f"{[(x['batch'], round(x['ms'], 1), x['launches']) for x in s['runs']]}"
                f", standalone_compiles {s['standalone_compiles']}; against "
                f"eager: bit-equal {d['bit_equal']}, final norm "
                f"{d['h_err']:.3e}, logits {d['l_err']:.3e} of max  [{card}]")
            tm = d["timing"]
            log(f"    {dt} [8, {e['N']}], {EXPORT_ROUNDS} rounds alternated: "
                + "; ".join(f"{k} {v['batch_ms']:.3f} ms a batch, "
                            f"{v['tokens_per_s']:.0f} tokens/s {v['ms_each']}"
                            for k, v in tm.items()) + f"  [{card}]")
        r = aj["resnet"]
        log(f"    Predictor.from_layer bit-equal {aj['from_layer_bit_equal']}"
            f", jit.save pair bit-equal {aj['pair_bit_equal']} (bf16); "
            f"ResNet50 eval clone through static.save_inference_model "
            f"(export {r['export_s']:.1f} s, dynamic_batch "
            f"{r['dynamic_batch']}) and exe.run of load_inference_model at "
            f"batch {r['batch']}: bit-equal {r['bit_equal']}, "
            f"{r['err']:.3e} of max; the fresh process "
            f"{aj['serve_s']:.1f} s; seconds by step {aj['times']}; phase "
            f"{time.perf_counter() - t0:.1f} s")
        shutil.rmtree(out_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pt.set_device("gpu")
        rr = reader_resnet(torch, pt, fluid)
        with tempfile.TemporaryDirectory() as tmp:
            ctr = reader_ctr(torch, pt, distributed, tmp)
        g = ctr["gpu"]
        log(f"(ak) (aa)'s ResNet50 program fed by py_reader + double_buffer "
            f"(the native ring {rr['ring']}), {READER_STEPS} steps, "
            f"EOFException, reset(): losses {rr['losses']} against "
            f"exe.run(feed=...) {rr['feed_losses']} (bit-equal "
            f"{rr['bit_equal']}, {rr['err']:.3e} of max; cuDNN "
            f"deterministic); CTR-DNN ({CTR['sparse']} sparse slots into one "
            f"{CTR['rows']} x {CTR['emb']} table, {CTR['dense']} dense, fc "
            f"{list(CTR['fc'])}, batch {CTR['batch']}, {g['params']} "
            f"parameters) by train_from_dataset over a QueueDataset of "
            f"MultiSlot files: {g['steps_per_s']:.2f} steps/s, reader wait "
            f"{g['reader_wait_share']:.3f} of the wall (CPU "
            f"{ctr['cpu']['steps_per_s']:.2f} steps/s); losses card against "
            f"CPU {ctr['err']:.3e} of max (tol {CTR_LOSS_TOL:.0e}); "
            f"infer_from_dataset kept every parameter "
            f"{g['infer_kept_params']}; phase {time.perf_counter() - t0:.1f}"
            f" s  [{card}]")
        t0 = time.perf_counter()
        al = extras_path(torch, pt, bert, flash_attn, norms, fused_ffn,
                         out_dir)
        launches["fused_ffn_incubate"] = al["ffn_launches"]
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            launches[f"{k}_gradient_merge"] = al["gm_launches"][k]
        log(f"(al) (ae)'s ERNIE-3.0-Base classifier ([{ERNIE_BATCH}, 512], "
            f"fp32): GradientMergeOptimizer(AdamW, k_steps=2) "
            f"over two halves against one AdamW step of the batch "
            f"{al['gm_err']:.3e} of max|param| (tol {FP32_TOL:.0e}), "
            f"launches {al['gm_launches']} ({al['gm_s']:.1f} s); "
            f"LookAhead(k=2) over {EXTRA_STEPS} steps equal to slow + 0.5 "
            f"(fast - slow) by hand {al['lookahead_exact']}, ModelAverage "
            f"and EMA apply / restore bitwise {al['restored']} "
            f"({al['la_s']:.1f} s); CheckpointManager(async_save=True) at "
            f"step 2 (save call {al['save_call_ms']:.1f} ms, "
            f"{al['ckpt_mib']:.1f} MiB), step 3 before wait(), a fresh "
            f"model restored and run to step 4: {al['ckpt_err']:.3e} of max "
            f"(bit-equal {al['ckpt_bit_equal']}), {al['ckpt_stats']} "
            f"({al['ckpt_s']:.1f} s); incubate.fused_feedforward at "
            f"[12288, 2048] x [2048, 8192] bf16: {al['ffn_launches']} "
            f"launch, max_abs_err {al['ffn_err']:.3e} (gate "
            f"{al['ffn_gate']:.3f}); phase {time.perf_counter() - t0:.1f} s"
            f"  [{card}]")
    finally:
        core._state.expected_place = prev
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()


# (as), (at), (au), (av): the WordPiece tokenizer, QAT / PTQ at
# ERNIE-3.0-Base width, their parity, the BiGRU-CRF tagger ----------------

# (as): ERNIE 3.0's vocabulary size; 8,192 documents of 100-400 words
TEXT = dict(vocab=40000, pieces=10000, cjk=2000, docs=8192, words=(100, 400))
# (at): (n)'s encoder at ERNIE-3.0-Base width with a 2-label head;
# PaddleNLP text classification's max_seq_length 128, batch 32, lr 5e-5
QAT_FT = dict(V=40000, H=768, L=12, nh=12, F=3072, N=128, B=32, lr=5e-5,
              steps=10, eval_batches=8, dropout=0.1)
QAT_PARITY = (4, 128)         # (au): B, N at 2 layers, fp32
QAT_PARITY_TOL = 1e-5         # (au): losses (relative), params (x leaf max),
                              # scales, int8 logits (x max|ref|)
# (au): a flip whose CPU quotient lies this many quantisation steps from
# the rounding boundary or less is a tie, and at most TIE_SHARE of the
# rounded values may be ties.  On an H100 (tools/qat_tie_margin.py) the
# card's and the CPU's quotients part by at most 1.2e-3 of a step (the
# trained weights), the farthest flip lies 2.1e-4 from its boundary and
# 2.6e-6 of the values flip; planted faults read: the card rounding
# r + 1e-3, 1.3e-3 of the values flipped; its flash forward's output
# times 1 + 2^-20, a flip 6.2e-3 from its boundary
TIE_MARGIN = 3e-3
TIE_SHARE = 2e-5
PREDICTOR_TOL = 1e-5          # (at): the artifact's logits, x max|ref|
# (av): PaddleNLP examples/lexical_analysis BiGruCrf (20,940 words, emb
# and hidden 128, 2 bidirectional GRU layers, 57 tags + BOS/EOS), batch
# 300, max_seq_len 64
TAGGER = dict(V=20940, E=128, H=128, layers=2, tags=59, B=300, lens=(8, 64),
              batches=5)
TAGGER_SCORE_RTOL = 1e-5      # (av): Viterbi scores, card against CPU


def wordpiece_vocab(size, n_pieces, n_cjk, seed):
    """A WordPiece vocabulary of ``size`` entries from a numpy seed, laid
    out as BERT's: special tokens, ASCII punctuation, CJK characters,
    whole words (single letters first, then by rank: the most frequent
    first) and ``##`` continuation pieces.  Returns (entries, words,
    pieces, cjk)."""
    rng = np.random.default_rng(seed)
    special = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    punct = [chr(c) for c in range(33, 127) if not chr(c).isalnum()]
    cjk = [chr(0x4E00 + i) for i in range(n_cjk)]
    letters = list("etaoinshrdlcumwfgypbvkjxqz")
    accents = list("éèàüöçñ")
    p = 1.0 / np.arange(1, 27) ** 0.7
    p /= p.sum()

    def draw(lo, hi):
        s = "".join(rng.choice(letters, int(rng.integers(lo, hi + 1)), p=p))
        if rng.random() < 0.03:
            i = int(rng.integers(0, len(s) + 1))
            s = s[:i] + accents[int(rng.integers(len(accents)))] + s[i:]
        return s
    singles = sorted(letters) + accents
    words = dict.fromkeys(singles)
    pieces = dict.fromkeys(singles)
    n_words = size - len(special) - len(punct) - n_cjk - n_pieces
    while len(pieces) < n_pieces:
        pieces[draw(1, 4)] = None
    while len(words) < n_words:
        words[draw(2, 10)] = None
    words, pieces = list(words), list(pieces)
    entries = special + punct + cjk + words + ["##" + x for x in pieces]
    assert len(entries) == len(set(entries)) == size
    return entries, words, pieces, cjk


def text_corpus(words, pieces, cjk, docs, lo, hi, seed):
    """``docs`` documents of ``lo``-``hi`` words drawn from ``words`` with
    Zipf frequencies (rank r with weight 1 / r^1.05): 10% capitalised, 1%
    upper case, 5% a word glued to a continuation piece (greedy
    longest-match splits it), 2% a CJK character, 0.5% an upper-case
    accented letter (not lowered: [UNK]); 8% of words followed by ASCII
    punctuation, 0.5% separated by a control or other whitespace
    character, 0.2% holding a control character."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(lo, hi + 1, docs)
    n = int(counts.sum())
    wp = 1.0 / np.arange(1, len(words) + 1) ** 1.05
    wp /= wp.sum()
    w = rng.choice(len(words), n, p=wp)
    kind = rng.random(n)
    sep = rng.random(n)
    extra = rng.integers(0, 1 << 30, n)
    punct = list(",.!?;:'\"()")
    spaces = ["\t", "\n", "\x1c", "\x1d", "\x1e", "\x1f", "\x0b", "\x0c",
              "\r\n"]
    out, k = [], 0
    for c in counts:
        parts = []
        for i in range(k, k + int(c)):
            t, r, e = words[w[i]], kind[i], int(extra[i])
            if r < 0.02:
                t = cjk[e % len(cjk)]
            elif r < 0.07:
                t = t + pieces[e % len(pieces)]
            elif r < 0.17:
                t = t.capitalize()
            elif r < 0.18:
                t = t.upper()
            elif r < 0.185:
                t = "É" + t
            elif r < 0.187:
                t = t + "\x01" + t
            q = sep[i]
            if q < 0.08:
                t += punct[e % len(punct)]
            parts.append(t)
            parts.append(spaces[e % len(spaces)] if 0.08 <= q < 0.085
                         else " ")
        out.append("".join(parts))
        k += int(c)
    return out


def tokenizer_path(torch, pt, tmp):
    """Phase (as): the native and the Python WordPiece paths over the
    whole corpus, timed on the host; ids equal.  Returns the measurements
    and the native ids as one int64 stream."""
    from paddle_tpu_torch.text import FullTokenizer
    t = TEXT
    t0 = time.perf_counter()
    vocab, words, pieces, cjk = wordpiece_vocab(t["vocab"], t["pieces"],
                                                t["cjk"], SEED + 90)
    docs = text_corpus(words, pieces, cjk, t["docs"], *t["words"],
                       SEED + 91)
    path = os.path.join(tmp, "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    gen_s = time.perf_counter() - t0
    native = FullTokenizer(path)            # the default: the native path
    python = FullTokenizer(path, use_native=False)
    if native._native is None or python._native is not None:
        raise SystemExit("(as): the tokenizers took the wrong paths")
    t0 = time.perf_counter()
    nat = [native.encode(d) for d in docs]
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = [python.encode(d) for d in docs]
    py_s = time.perf_counter() - t0
    n_ids = sum(len(x) for x in nat)
    equal = sum(a == b for a, b in zip(nat, py))
    if equal != len(docs):
        bad = next(i for i, (a, b) in enumerate(zip(nat, py)) if a != b)
        raise SystemExit(f"(as): native ids differ from the Python path's "
                         f"in {len(docs) - equal} documents, first {bad}")
    stream = np.fromiter((i for x in nat for i in x), np.int64, n_ids)
    unk = native.vocab["[UNK]"]
    return {"docs": len(docs),
            "mib": sum(len(d.encode("utf-8")) for d in docs) / 2 ** 20,
            "ids": n_ids, "unk_share": float((stream == unk).mean()),
            "pieces_share": float((stream >= t["vocab"] - t["pieces"]).mean()),
            "native_s": nat_s, "python_s": py_s,
            "native_tokens_per_s": n_ids / nat_s,
            "python_tokens_per_s": n_ids / py_s, "speedup": py_s / nat_s,
            "docs_equal": equal, "setup_s": gen_s}, stream


def packed_batches(stream, B, N, n, start=0):
    """``n`` batches of ``B`` rows of ``N`` consecutive ids from the
    stream (no padding), from row ``start * B`` on; each row's label is 1
    where its first id is a multiple of 8 (about one row in eight: an
    imbalanced task, whose prior a model learns in a few steps from
    random weights; a balanced rule gives those steps nothing to learn)."""
    rows = stream[:len(stream) // N * N].reshape(-1, N)
    if len(rows) < (start + n) * B:
        raise SystemExit(f"the corpus gives {len(rows)} rows of {N}, "
                         f"{(start + n) * B} needed")
    out = []
    for i in range(start, start + n):
        ids = np.ascontiguousarray(rows[i * B:(i + 1) * B])
        out.append((ids, (ids[:, :1] % 8 == 0).astype(np.int64)))
    return out


def qat_model(pt, L, weights, dropout):
    """(n)'s encoder at ``QAT_FT``'s widths with ``L`` layers and a 2-label
    head on the first position, ``weights`` loaded (numpy weights from
    ``numpy_state`` when None), in ``train()``.  Returns the model and
    its weights."""
    e = QAT_FT
    model = make_encoder(pt, e["V"], e["H"], L, e["nh"], e["F"], e["N"],
                         dropout=dropout,
                         attn_dropout=0.0 if dropout else None, classes=2)
    if weights is None:
        weights = numpy_state(model, SEED + 93)
    model.set_state_dict(weights)
    return model.train(), weights


def qat_loop(pt, model, batch, amp, warmup, epsilon=1e-8, start_lr=0.0):
    """AdamW (weight decay 0.01) over every parameter on ``LinearWarmup``
    from ``start_lr`` to ``QAT_FT``'s lr over ``warmup`` steps (PaddleNLP
    fine-tunes with a warm-up: AdamW's first, sign-like steps on random
    weights throw the loss up); returns ``step()``:
    ``CrossEntropyLoss()(model(ids), labels)`` under ``auto_cast`` bf16
    when ``amp``, ``backward``, ``step``, ``clear_grad``, the scheduler's
    step, ``float(loss)``."""
    lr = QAT_FT["lr"]
    sched = pt.optimizer.lr.LinearWarmup(lr, warmup, start_lr, lr)
    opt = pt.optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                             epsilon=epsilon, parameters=model.parameters())
    ce = pt.nn.CrossEntropyLoss()
    ids, y = (pt.to_tensor(a) for a in batch)

    def step():
        with pt.amp.auto_cast(enable=amp, dtype="bfloat16"):
            loss = ce(model(ids), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return float(loss)
    return step


def train_loss(pt, model, batch):
    """``model``'s loss on ``batch`` in ``eval()`` (no dropout) under
    ``no_grad`` and bf16 ``auto_cast``, as a float; the model goes back to
    ``train()``."""
    ids, y = (pt.to_tensor(a) for a in batch)
    model.eval()
    with pt.no_grad(), pt.amp.auto_cast(dtype="bfloat16"):
        loss = float(pt.nn.CrossEntropyLoss()(model(ids), y))
    model.train()
    return loss


def wrapped_layers(model, cls):
    return [l for l in model.sublayers() if isinstance(l, cls)]


def alternated(torch, calls, rounds, counters):
    """Each of ``calls`` (name -> fn) once a round, in turn, ``rounds``
    rounds: host ms of each call (synchronised before and after), its
    result, and its launches (every count zeroed just before the call and
    read just after), summed by name."""
    ms = {k: [] for k in calls}
    outs = {k: [] for k in calls}
    launched = {k: dict.fromkeys(counters, 0) for k in calls}
    for _ in range(rounds):
        for k, fn in calls.items():
            torch.cuda.synchronize()
            zero_counts(counters)
            t0 = time.perf_counter()
            outs[k].append(fn())
            torch.cuda.synchronize()
            ms[k].append(1e3 * (time.perf_counter() - t0))
            for c, v in read_counts(counters).items():
                launched[k][c] += v
    return ms, outs, launched


def logits_of(pt, model, batches):
    """The model's eval logits for each batch under ``no_grad``, as a
    list of device tensors."""
    model.eval()
    with pt.no_grad():
        return [model(pt.to_tensor(ids)).value for ids, _ in batches]


def qat_path(torch, pt, flash_attn, norms, stream, tmp):
    """Phase (at): QAT fine-tune, int8 eval and PTQ served through the
    Predictor, at ``QAT_FT``'s widths and depth."""
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.inference import Config, create_predictor
    e = QAT_FT
    L, B, N = e["L"], e["B"], e["N"]
    t0 = time.perf_counter()
    train = packed_batches(stream, B, N, 1)[0]
    evals = packed_batches(stream, B, N, e["eval_batches"], start=1)
    calib = packed_batches(stream, B, N, e["eval_batches"],
                           start=1 + e["eval_batches"])
    pt.seed(SEED + 92)
    qat, weights = qat_model(pt, L, None, e["dropout"])
    flt, _ = qat_model(pt, L, weights, e["dropout"])
    keys = list(qat.state_dict())
    quant = Q.QAT(Q.QuantConfig())
    quant.quantize(qat)
    n_wrapped = len(wrapped_layers(qat, Q._QATWrapper))
    if n_wrapped != 6 * L + 1:
        raise SystemExit(f"(at): QAT wrapped {n_wrapped} Linears, "
                         f"want {6 * L + 1}")
    # the first steps of a 3-epoch fine-tune over (as)'s corpus with the
    # BERT recipe's 10% warm-up
    warmup = max(1, round(0.1 * 3 * (len(stream) // N // B)))
    steps = {k: qat_loop(pt, m, train, True, warmup=warmup)
             for k, m in (("qat", qat), ("float", flt))}
    before = {k: train_loss(pt, m, train) for k, m in (("qat", qat),
                                                       ("float", flt))}
    setup_s = time.perf_counter() - t0
    counters = eager_counters(flash_attn, norms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = {k: fn() for k, fn in steps.items()}
    warm_s = time.perf_counter() - t0
    ms, losses, launched = alternated(torch, steps, e["steps"], counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_fused": 0,
            "flash_attention_nokey": 0, "layer_norm": 0, "rms_norm": 0}
    after = {k: train_loss(pt, m, train) for k, m in (("qat", qat),
                                                      ("float", flt))}
    for k in steps:
        check_counts(f"(at) {k} step", launched[k], want, e["steps"])
        ls = [first[k]] + losses[k]
        if not all(math.isfinite(x) for x in ls + [after[k]]) \
                or not after[k] < before[k]:
            raise SystemExit(f"(at) {k}: the loss did not fall: "
                             f"{before[k]} -> {after[k]}; steps {ls}")
    res = {"wrapped": n_wrapped, "setup_s": setup_s, "warmup_s": warm_s,
           "step_ms": float(np.mean(ms["qat"])),
           "float_step_ms": float(np.mean(ms["float"])),
           "step_ms_each": ms["qat"], "losses": [first["qat"]] + losses["qat"],
           "float_losses": [first["float"]] + losses["float"],
           "max_memory_allocated_gib": peak,
           "launches": launched["qat"], "float_launches": launched["float"],
           "keys_after_step": list(qat.state_dict()), "warmup": warmup,
           "loss_before": before["qat"], "loss_after": after["qat"],
           "float_loss_before": before["float"],
           "float_loss_after": after["float"]}
    res["tokens_per_s"] = B * N / (res["step_ms"] / 1e3)
    res["ratio"] = res["step_ms"] / res["float_step_ms"]
    res["keys_reordered"] = sum(
        a != b for a, b in zip(keys, [k.replace("inner.", "") for k in
                                      res.pop("keys_after_step")]))
    # the fake-quantised eval forward, then convert and the int8 forward
    fq = logits_of(pt, qat, evals)
    t0 = time.perf_counter()
    quant.convert(qat)
    convert_s = time.perf_counter() - t0
    n_q = len(wrapped_layers(qat, Q.QuantedLinear))
    if n_q != 6 * L + 1:
        raise SystemExit(f"(at): convert made {n_q} QuantedLinears")
    qat.eval()
    flt.eval()
    it = {"int8": iter(evals), "float": iter(evals)}

    def forward(model, k):
        ids, _ = next(it[k])
        with pt.no_grad():
            return model(pt.to_tensor(ids)).value
    ms, outs, launched = alternated(
        torch, {"int8": lambda: forward(qat, "int8"),
                "float": lambda: forward(flt, "float")},
        e["eval_batches"], counters)
    want = {"layer_norm": 2 * L, "flash_attention_fwd": L, "rms_norm": 1,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    for k in outs:
        check_counts(f"(at) {k} eval", launched[k], want, e["eval_batches"])
    pred = {k: torch.cat(v).argmax(-1) for k, v in outs.items()}
    pred_fq = torch.cat(fq).argmax(-1)
    if not all(torch.isfinite(torch.cat(v)).all() for v in outs.values()):
        raise SystemExit("(at): non-finite eval logits")
    res.update(convert_s=convert_s, int8_ms=float(np.mean(ms["int8"])),
               float_eval_ms=float(np.mean(ms["float"])),
               int8_ms_each=ms["int8"], int8_launches=launched["int8"],
               int8_agree_fq=float((pred["int8"] == pred_fq).float().mean()),
               int8_agree_float=float(
                   (pred["int8"] == pred["float"]).float().mean()),
               labels_share=float(np.mean([b[1].mean() for b in evals])))
    res["int8_ratio"] = res["int8_ms"] / res["float_eval_ms"]
    del qat, flt, steps
    torch.cuda.empty_cache()
    # PTQ of a fresh float copy, exported and served
    t0 = time.perf_counter()
    ptq_net, _ = qat_model(pt, L, weights, 0.0)
    ptq = Q.PostTrainingQuantization(ptq_net, Q.QuantConfig())
    ptq.quantize([pt.to_tensor(ids) for ids, _ in calib])
    ptq_net.eval()
    calib_s = time.perf_counter() - t0
    prefix = os.path.join(tmp, "ernie_int8")
    t0 = time.perf_counter()
    meta = ptq.save_quantized_model(prefix, input_spec=[((B, N), "int64")])
    export_s = time.perf_counter() - t0
    with pt.no_grad():
        want_logits = ptq_net(pt.to_tensor(evals[0][0])).value.cpu().numpy()
    t0 = time.perf_counter()
    cfg = Config(prefix)
    cfg.enable_use_gpu()
    pred = create_predictor(cfg)
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(evals[0][0])
    pred.run()              # the batch bucket's graph is captured here
    load_s = time.perf_counter() - t0
    zero_counts(counters)
    t0 = time.perf_counter()
    h.copy_from_cpu(evals[0][0])
    pred.run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    serve_ms = 1e3 * (time.perf_counter() - t0)
    served = read_counts(counters)
    err = float(np.abs(got - want_logits).max()
                / max(float(np.abs(want_logits).max()), 1e-30))
    if got.shape != want_logits.shape or not err <= PREDICTOR_TOL:
        raise SystemExit(f"(at): the Predictor's logits {got.shape} are "
                         f"{err:.3e} of max from the in-process int8 "
                         f"forward's (tol {PREDICTOR_TOL:.0e})")
    check_counts("(at) Predictor", served,
                 {"layer_norm": 2 * L, "flash_attention_fwd": L,
                  "rms_norm": 1}, 1)
    res.update(ptq_calib_s=calib_s, export_s=export_s, predictor_load_s=load_s,
               predictor_ms=serve_ms, predictor_err=err,
               predictor_launches=served, artifact_format=meta["format"],
               artifact_mib=os.path.getsize(prefix + ".pt2") / 2 ** 20)
    del ptq_net, ptq, pred
    torch.cuda.empty_cache()
    return res


class RoundingTape:
    """The rounding decisions of (au), taken on the card and given to the
    CPU.  A fake-quantised tensor's integers jump where ``x / scale``
    crosses a half step, so fp32 differences of 1e-7 between the card's
    kernels and the CPU's plain versions move whole quantisation steps,
    and every later value with them (on the CPU alone, a 1e-7 change of
    the embeddings moves the first QAT loss by 7e-4).  In ``record`` mode
    each rounding's quotients, integers and straight-through mask are
    kept in call order; in ``replay`` mode the CPU takes the card's where
    they differ from its own and its quotient lies within ``margin``
    steps of the boundary between the two (or of the clip edge) -- a tie
    -- and counts every other difference as a far flip.  ``gap`` holds,
    for each ``stage``, the largest distance between the card's and the
    CPU's quotients, in steps, and the shape of that rounding's input."""

    def __init__(self, margin):
        self.margin = margin
        self.mode = "record"
        self.stage = None
        self.r, self.q, self.mask = [], [], []
        self.i = self.ties = self.far = 0
        self.worst = self.far_nearest = self.far_farthest = 0.0
        self.gap = {}

    def take(self, r, q, inside, qmax):
        """The integers and mask (None where the caller wants none) to
        use for quotient ``r``."""
        if self.mode == "record":
            self.r.append(r.float().cpu())
            self.q.append(q.char().cpu())
            self.mask.append(None if inside is None else inside.cpu())
            return q, inside
        rc, qc, ic = self.r[self.i], self.q[self.i].to(q.dtype), \
            self.mask[self.i]
        self.i += 1
        gap = float((r.float() - rc).abs().max()) if r.numel() else 0.0
        if gap >= self.gap.get(self.stage, (-1.0,))[0]:
            self.gap[self.stage] = (gap, tuple(r.shape))
        checks = [(qc != q, (r - (q + qc) / 2).abs())]
        if inside is not None:
            checks.append((ic != inside, (r.abs() - qmax).abs()))
        for moved, d in checks:
            d = d[moved]
            near = d <= self.margin
            if bool(near.any()):
                self.worst = max(self.worst, float(d[near].max()))
            if not bool(near.all()):
                far = float(d[~near].min())
                self.far_nearest = (far if not self.far else
                                    min(self.far_nearest, far))
                self.far_farthest = max(self.far_farthest,
                                        float(d[~near].max()))
            self.ties += int(near.sum())
            self.far += int((~near).sum())
        return qc, ic


@contextlib.contextmanager
def taped_rounding(Q, tape):
    """``quantization``'s one rounding, ``_round_clip``, passed through
    ``tape``: the module's fake quantisation, int8 product and weight
    conversion run as shipped and round through it."""
    plain = Q._round_clip

    def taped(r, qmax, mask=False):
        q, inside = plain(r, qmax, mask=True)
        q, inside = tape.take(r, q, inside if mask else None, qmax)
        return (q, inside) if mask else q
    Q._round_clip = taped
    try:
        yield
    finally:
        Q._round_clip = plain


def qat_parity(torch, pt, flash_attn, stream, margin=TIE_MARGIN,
               share=TIE_SHARE):
    """Phase (au)'s readings: (at) at 2 layers in fp32, [4, 128], the same
    numpy weights on the card (kernels) and on the CPU (plain versions):
    three QAT steps, ``QAT.convert`` and the converted int8 logits, and
    PTQ's scales and int8 weights, the CPU taking the card's rounding at
    ties within ``margin`` steps (:class:`RoundingTape`).  ``res["ok"]``
    says whether every gate held; ``res["failed"]`` names those that did
    not."""
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.framework import core
    B, N = QAT_PARITY
    L = 2
    batches = packed_batches(stream, B, N, 3, start=0)
    weights, out = None, {}
    tape = RoundingTape(margin)
    prev = core._state.expected_place
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            tape.mode = "record" if place == "gpu" else "replay"
            pt.seed(SEED + 94)
            net, weights = qat_model(pt, L, weights, 0.0)
            quant = Q.QAT()
            quant.quantize(net)
            before = (flash_attn.fwd_launches, flash_attn.dq_launches,
                      flash_attn.dkv_launches)
            with taped_rounding(Q, tape):
                # Adam's eps 1e-6, as (q), (s), (af): see ernie_parity
                tape.stage = "QAT steps"
                step = qat_loop(pt, net, batches[0], False, warmup=1,
                                epsilon=1e-6, start_lr=QAT_FT["lr"])
                losses = [step() for _ in range(3)]
                launched = tuple(a - b for a, b in zip(
                    (flash_attn.fwd_launches, flash_attn.dq_launches,
                     flash_attn.dkv_launches), before))
                params = {k: p.numpy() for k, p in net.state_dict().items()}
                scales = [float(w._obs.scale) for w in
                          wrapped_layers(net, Q._QATWrapper)]
                tape.stage = "convert"
                quant.convert(net)
                tape.stage = "int8 eval"
                logits = np.concatenate([l.cpu().numpy() for l in logits_of(
                    pt, net, batches[1:2])])
                tape.stage = "PTQ"
                ptq_net, _ = qat_model(pt, L, weights, 0.0)
                Q.PostTrainingQuantization(ptq_net).quantize(
                    [pt.to_tensor(ids) for ids, _ in batches[1:]])
            ptq = [(q.w_int8.cpu().numpy(), q.w_scale.cpu().numpy(),
                    float(q.a_scale)) for q in wrapped_layers(ptq_net,
                                                              Q.QuantedLinear)]
            out[place] = (losses, params, scales, logits, ptq, launched)
            del net, ptq_net, step
    finally:
        core._state.expected_place = prev
    (lg, pg, sg, og, qg, launched), (lc, pc, sc, oc, qc, _) = (out["gpu"],
                                                               out["cpu"])
    param_rel = {k: float(np.abs(pg[k] - p).max()
                          / max(float(np.abs(p).max()), 1e-30))
                 for k, p in pc.items()}
    res = {"loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(lg, lc)],
           "param_rel_err_max": max(param_rel.values()),
           "param_rel_err_worst": max(param_rel, key=param_rel.get),
           "scale_rel_err_max": max(abs(a - b) / b for a, b in zip(sg, sc)),
           "int8_logit_err": float(np.abs(og - oc).max()
                                   / max(float(np.abs(oc).max()), 1e-30)),
           "roundings": tape.i, "rounded": sum(q.numel() for q in tape.q),
           "ties": tape.ties, "far_flips": tape.far,
           "tie_worst": tape.worst, "far_nearest": tape.far_nearest,
           "far_farthest": tape.far_farthest, "gap": tape.gap,
           "ptq_w_int8_equal": all(np.array_equal(a[0], b[0])
                                   for a, b in zip(qg, qc)),
           "ptq_w_scale_err": max(float(np.abs(a[1] - b[1]).max()
                                        / np.abs(b[1]).max())
                                  for a, b in zip(qg, qc)),
           "ptq_a_scale_err": max(abs(a[2] - b[2]) / b[2]
                                  for a, b in zip(qg, qc)),
           "flash_launches": launched,
           "flash_launches_expected": (3 * L, 3 * L, 3 * L)}
    gates = {
        "losses": max(res["loss_rel_err"]) <= QAT_PARITY_TOL,
        "params": res["param_rel_err_max"] <= QAT_PARITY_TOL,
        "observer scales": res["scale_rel_err_max"] <= QAT_PARITY_TOL,
        "int8 logits": res["int8_logit_err"] <= QAT_PARITY_TOL,
        "far flips": res["far_flips"] == 0,
        "rounding count": tape.i == len(tape.q),
        "tie share": res["ties"] <= share * res["rounded"],
        "PTQ int8 weights": res["ptq_w_int8_equal"],
        "PTQ weight scales": res["ptq_w_scale_err"] <= QAT_PARITY_TOL,
        "PTQ activation scales": res["ptq_a_scale_err"] <= QAT_PARITY_TOL,
        "flash launches": launched == res["flash_launches_expected"]}
    res["failed"] = [k for k, ok in gates.items() if not ok]
    res["ok"] = not res["failed"]
    return res


def tagger_model(pt):
    """PaddleNLP's lexical-analysis ``BiGruCrf`` on the 2.x API: word
    embedding, a 2-layer bidirectional GRU over the lengths, a Linear to
    the tags and ``text.ViterbiDecoder`` over the transitions (BOS/EOS
    included); its forward gives (emissions, scores, paths)."""
    t = TAGGER

    class BiGruCrf(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.word_embedding = pt.nn.Embedding(t["V"], t["E"])
            self.gru = pt.nn.GRU(t["E"], t["H"], num_layers=t["layers"],
                                 direction="bidirect")
            self.fc = pt.nn.Linear(2 * t["H"], t["tags"])
            self.transitions = self.create_parameter([t["tags"], t["tags"]])
            self.viterbi_decoder = pt.text.ViterbiDecoder(
                self.transitions, include_bos_eos_tag=True)

        def forward(self, ids, lengths):
            h, _ = self.gru(self.word_embedding(ids), sequence_length=lengths)
            emission = self.fc(h)
            scores, path = self.viterbi_decoder(emission, lengths)
            return emission, scores, path
    return BiGruCrf().eval()


def tagger_batch(seed):
    """[B, 64] word ids (0 past each length) and lengths drawn in 8-64."""
    t = TAGGER
    rng = np.random.default_rng(seed)
    lens = rng.integers(t["lens"][0], t["lens"][1] + 1, t["B"])
    ids = rng.integers(1, t["V"], (t["B"], t["lens"][1]))
    ids[np.arange(t["lens"][1])[None, :] >= lens[:, None]] = 0
    return ids, lens


def tagger_weights(model, seed):
    """Every weight U(-1/sqrt(H), 1/sqrt(H)) as Paddle's GRU draws them,
    the embedding N(0, 1) and the transitions U(-1, 1), from numpy."""
    rng = np.random.default_rng(seed)
    k = 1 / math.sqrt(TAGGER["H"])
    out = {}
    for n, p in model.state_dict().items():
        if n.startswith("word_embedding"):
            w = rng.standard_normal(p.shape)
        elif n == "transitions":
            w = rng.uniform(-1, 1, p.shape)
        else:
            w = rng.uniform(-k, k, p.shape)
        out[n] = w.astype(np.float32)
    return out


def tagger_path(torch, pt):
    """Phase (av): the tagger's eval batches on the card, timed, with the
    Viterbi alone on the same emissions; then card against CPU from the
    same weights, and a batch of integer emissions (ties)."""
    from paddle_tpu_torch.framework import core
    t = TAGGER
    weights, res = None, {}
    prev = core._state.expected_place
    ids, lens = tagger_batch(SEED + 96)
    got = {}
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            model = tagger_model(pt)
            weights = weights or tagger_weights(model, SEED + 97)
            model.set_state_dict(weights)
            x, ln = pt.to_tensor(ids), pt.to_tensor(lens)
            with pt.no_grad():
                em, sc, pa = model(x, ln)
                got[place] = (em.numpy(), sc.numpy(), pa.numpy())
                if place != "gpu":
                    continue
                batch_ms, vit_ms = [], []
                for _ in range(t["batches"]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    em, sc, pa = model(x, ln)
                    pa.numpy()
                    batch_ms.append(1e3 * (time.perf_counter() - t0))
                    t0 = time.perf_counter()
                    model.viterbi_decoder(em, ln)[1].numpy()
                    vit_ms.append(1e3 * (time.perf_counter() - t0))
            res.update(batch_ms=float(np.mean(batch_ms)),
                       batch_ms_each=batch_ms,
                       viterbi_ms=float(np.mean(vit_ms)))
            del model
    finally:
        core._state.expected_place = prev
    (eg, sg, pg), (ec, scc, pc) = got["gpu"], got["cpu"]
    res.update(sentences_per_s=t["B"] / (res["batch_ms"] / 1e3),
               viterbi_share=res["viterbi_ms"] / res["batch_ms"],
               emission_err=float(np.abs(eg - ec).max() / np.abs(ec).max()),
               score_rel_err=float(np.abs(sg - scc).max()
                                   / np.abs(scc).max()),
               paths_equal=bool(np.array_equal(pg, pc)),
               path_dtype=str(pg.dtype), tokens=int(lens.sum()))
    past = np.arange(t["lens"][1])[None, :] >= lens[:, None]
    res["padding_zero"] = bool((pg[past] == 0).all() and (pc[past] == 0).all())
    # integer emissions and transitions: tie sets on every step
    rng = np.random.default_rng(SEED + 98)
    em = rng.integers(-3, 4, eg.shape).astype(np.float32)
    tr = rng.integers(-2, 3, (t["tags"], t["tags"])).astype(np.float32)
    ties = {}
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            s, p = pt.text.viterbi_decode(pt.to_tensor(em), pt.to_tensor(tr),
                                          pt.to_tensor(lens), True)
            ties[place] = (s.numpy(), p.numpy())
    finally:
        core._state.expected_place = prev
    res.update(ties_paths_equal=bool(np.array_equal(ties["gpu"][1],
                                                    ties["cpu"][1])),
               ties_scores_equal=bool(np.array_equal(ties["gpu"][0],
                                                     ties["cpu"][0])))
    if not (res["paths_equal"] and res["padding_zero"]
            and res["path_dtype"] == "int32"
            and res["score_rel_err"] <= TAGGER_SCORE_RTOL
            and res["ties_paths_equal"] and res["ties_scores_equal"]):
        raise SystemExit(f"(av) the tagger on the card disagrees with the "
                         f"CPU: {json.dumps(res)}")
    return res


def text_phases(torch, flash_attn, norms, card, launches):
    """Phases (as), (at), (au), (av), logged; (at)'s launches go into
    ``launches``."""
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    prev = core._state.expected_place
    e = QAT_FT
    try:
        pt.set_device("gpu")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ts, stream = tokenizer_path(torch, pt, tmp)
            log(f"(as) WordPiece over a synthetic corpus ({TEXT['vocab']} "
                f"entries, {ts['docs']} documents, {ts['mib']:.2f} MiB, "
                f"{ts['ids']} ids, [UNK] share {ts['unk_share']:.4f}, "
                f"'##' share {ts['pieces_share']:.4f}) on the host of "
                f"{card}: native {ts['native_tokens_per_s']:.0f} tokens/s "
                f"({ts['native_s']:.3f} s), Python "
                f"{ts['python_tokens_per_s']:.0f} tokens/s "
                f"({ts['python_s']:.3f} s), {ts['speedup']:.1f}x; ids equal "
                f"in {ts['docs_equal']} of {ts['docs']} documents; set-up "
                f"{ts['setup_s']:.1f} s; phase "
                f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            at = qat_path(torch, pt, flash_attn, norms, stream, tmp)
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            launches[f"{k}_qat"] = at["launches"][k]
        for k in ("layer_norm", "flash_attention_fwd", "rms_norm"):
            launches[f"{k}_int8_eval"] = at["int8_launches"][k]
        log(f"(at) QAT fine-tune at ERNIE-3.0-Base width ((n)'s encoder, "
            f"V={e['V']}, L={e['L']}, a Linear({e['H']}, 2) head on the "
            f"first position; {at['wrapped']} Linears fake-quantised; "
            f"[{e['B']}, {e['N']}] of (as)'s ids, AdamW on LinearWarmup to "
            f"{e['lr']} over {at['warmup']} steps, dropout "
            f"{e['dropout']}, bf16 auto_cast over fp32 params) on {card}: "
            f"step {at['step_ms']:.2f} ms, tokens/s {at['tokens_per_s']:.0f}"
            f", {at['ratio']:.3f}x the unwrapped model's step "
            f"({at['float_step_ms']:.2f} ms, alternated); the batch's loss "
            f"without dropout {at['loss_before']:.4f} -> "
            f"{at['loss_after']:.4f} (unwrapped {at['float_loss_before']:.4f}"
            f" -> {at['float_loss_after']:.4f}); step losses "
            f"{[round(x, 4) for x in at['losses']]}; max_memory_allocated "
            f"{at['max_memory_allocated_gib']:.3f} GiB (both models); "
            f"launches over {e['steps']} steps {at['launches']}  [{card}]")
        log(f"    step ms {[round(x, 2) for x in at['step_ms_each']]}; "
            f"unwrapped losses {[round(x, 4) for x in at['float_losses']]}; "
            f"state_dict keys moved by the weight swap "
            f"{at['keys_reordered']} (the reference's order); warm-up "
            f"{at['warmup_s']:.1f} s, set-up {at['setup_s']:.1f} s")
        log(f"    int8 eval (QAT.convert in {at['convert_s']:.2f} s): "
            f"{at['int8_ms']:.2f} ms a batch against the unwrapped float "
            f"model's {at['float_eval_ms']:.2f} ({at['int8_ratio']:.3f}x, "
            f"alternated, {e['eval_batches']} batches); launches "
            f"{at['int8_launches']}; predictions agree with the "
            f"fake-quantised forward's on {at['int8_agree_fq']:.4f}, with "
            f"the float model's on {at['int8_agree_float']:.4f} (label 1 "
            f"share {at['labels_share']:.3f})  [{card}]")
        log(f"    PTQ: calibrated on {e['eval_batches']} batches and "
            f"converted in {at['ptq_calib_s']:.1f} s; "
            f"save_quantized_model ({at['artifact_format']}, "
            f"{at['artifact_mib']:.1f} MiB) in {at['export_s']:.1f} s; "
            f"create_predictor and the first run {at['predictor_load_s']:.1f}"
            f" s; a served batch {at['predictor_ms']:.2f} ms, launches "
            f"{at['predictor_launches']}; logits {at['predictor_err']:.3e} "
            f"of max from the in-process int8 forward's (tol "
            f"{PREDICTOR_TOL:.0e}); phase {time.perf_counter() - t0:.1f} s"
            f"  [{card}]")
        t0 = time.perf_counter()
        au = qat_parity(torch, pt, flash_attn, stream)
        if not au["ok"]:
            raise SystemExit(f"(au) QAT / PTQ on the card disagrees with "
                             f"the CPU ({', '.join(au['failed'])}): "
                             f"{json.dumps(au)}")
        gaps = ", ".join(f"{k} {g:.2e} at {list(sh)}"
                         for k, (g, sh) in au["gap"].items())
        log(f"(au) QAT / PTQ in fp32, card against CPU, {QAT_PARITY}, 2 "
            f"layers: loss rel errs {[f'{x:.2e}' for x in au['loss_rel_err']]}"
            f" (tol {QAT_PARITY_TOL:.0e}); max param err / max|param| "
            f"{au['param_rel_err_max']:.2e} ({au['param_rel_err_worst']}); "
            f"observer scales {au['scale_rel_err_max']:.2e}; int8 logits "
            f"{au['int8_logit_err']:.3e} of max; the CPU took the card's "
            f"rounding at {au['ties']} ties of {au['rounded']} values in "
            f"{au['roundings']} roundings (the farthest "
            f"{au['tie_worst']:.2e} steps from its boundary; margin "
            f"{TIE_MARGIN}), far flips {au['far_flips']}; the largest "
            f"card-CPU quotient gap, in steps, by stage ({gaps}); PTQ "
            f"int8 weights equal {au['ptq_w_int8_equal']}, weight "
            f"scales "
            f"{au['ptq_w_scale_err']:.2e}, activation scales "
            f"{au['ptq_a_scale_err']:.2e}; flash fwd / dq / dk-dv "
            f"{au['flash_launches']}; phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        av = tagger_path(torch, pt)
        t = TAGGER
        log(f"(av) BiGRU-CRF tagger (Embedding({t['V']}, {t['E']}), GRU "
            f"{t['layers']} layers bidirect {t['H']}, Linear({2 * t['H']}, "
            f"{t['tags']}), ViterbiDecoder with BOS/EOS), batch {t['B']}, "
            f"lengths {t['lens'][0]}-{t['lens'][1]} ({av['tokens']} tokens),"
            f" eval fp32, on {card}: {av['batch_ms']:.2f} ms a batch, "
            f"{av['sentences_per_s']:.0f} sentences/s, the Viterbi "
            f"{av['viterbi_ms']:.2f} ms ({av['viterbi_share']:.3f} of the "
            f"batch); card against CPU: paths equal {av['paths_equal']} "
            f"({av['path_dtype']}, padding 0 {av['padding_zero']}), scores "
            f"{av['score_rel_err']:.2e} (tol {TAGGER_SCORE_RTOL:.0e}), "
            f"emissions {av['emission_err']:.2e} of max; integer emissions "
            f"(ties): paths equal {av['ties_paths_equal']}, scores equal "
            f"{av['ties_scores_equal']}; phase "
            f"{time.perf_counter() - t0:.1f} s  [{card}]")
    finally:
        core._state.expected_place = prev
    torch.cuda.empty_cache()
    return ts, at, au, av


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
            **{t: main[t] for t in ("atol", "rtol", "gate",
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
        for path in ("ernie", "eager_ernie", "eager_encoder", "multilabel",
                     "to_static", "predictor", "gradient_merge", "incubate",
                     "hapi",
                     "hapi_eval", "chunked", "chunked_quant", "spec",
                     "spec_quant", "spec_quant_m40", "slot", "slot_quant",
                     "transformer_train", "beam", "qat", "int8_eval"):
            if f"{k['name']}_{path}" in launches:
                k[f"launches_{path}"] = launches[f"{k['name']}_{path}"]
    # row_matmul.launches counts the launches with the LayerNorm prologue
    # too; the row_matmul line counts those without it
    rm = next(k for k in kernels if k["name"] == "row_matmul")
    rm["launches"] -= launches["ln_row_matmul"]
    for path in ("chunked", "spec"):
        if f"launches_{path}" in rm:
            rm[f"launches_{path}"] -= launches.get(f"ln_row_matmul_{path}", 0)
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
