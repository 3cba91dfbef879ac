"""Sequence-to-sequence models over the nn API of either package
(``mod``: ``paddle_tpu`` or ``paddle_tpu_torch``), shared by
``chip_smoke.py``'s phases (am) and (an), ``tests/test_torch_cuda.py``
and ``tests/test_torch_seq2seq.py``.  It imports numpy only; the package
comes in as an argument.

* :func:`nmt_transformer`: the Transformer of Vaswani et al. 2017 (an
  ``nn.Transformer``, post-LN, relu) with one embedding table shared by
  source, target and the output projection, embeddings scaled by
  sqrt(d_model) plus sinusoidal positions, dropout on their sum.
* :class:`TransformerCell`: a decoder as a ``BeamSearchDecoder`` cell.
  Its state is one flat tuple, each layer's incremental k and v then its
  static k and v, which ``BeamSearchDecoder.step`` gathers one level
  deep.  The initial state holds the static k and v alone (``initialize``
  tiles it by beam, and the reference's tiling cannot take the empty
  incremental caches); the first step adds the empty caches, and the
  step's position is the incremental cache's length.
* :func:`rnn_seq2seq` and :class:`RNNCell`: the fluid-era NMT line
  (``examples/seq2seq_reverse.py``): an ``nn.LSTM`` encoder over
  ``sequence_length`` whose last layer's final state seeds an
  ``LSTMCell`` decoder, then a ``Linear`` to the target vocabulary.
* :func:`beam_decode` and the card-against-CPU comparison of a model's
  training step and beams (:func:`card_against_cpu`,
  :func:`loss_grad_errors`, :func:`beam_parity`, :func:`traced_parity`),
  which ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` both use.
"""
import numpy as np


def sinusoid(n, d):
    """[n, d] float32 positional encodings: sin on even, cos on odd
    columns, wavelengths 2 pi 10000^(2i / d)."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    rate = 1.0 / 10000 ** (np.arange(0, d, 2, dtype=np.float64) / d)
    out = np.zeros((n, d))
    out[:, 0::2] = np.sin(pos * rate)
    out[:, 1::2] = np.cos(pos * rate)
    return out.astype(np.float32)


def nmt_transformer(mod, vocab, d_model, nhead, layers, ffn, dropout,
                    max_len):
    nn = mod.nn

    class NMT(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(vocab, d_model)
            self.transformer = nn.Transformer(d_model, nhead, layers, layers,
                                              ffn, dropout)
            self.dropout = nn.Dropout(dropout)
            # a constant, not state: neither a parameter nor a buffer
            self.pos = mod.to_tensor(sinusoid(max_len, d_model))

        def embed(self, ids, start=0):
            n = ids.shape[1]
            return self.dropout(self.embedding(ids) * d_model ** 0.5
                                + self.pos[start:start + n])

        def project(self, h):
            return mod.matmul(h, self.embedding.weight, transpose_y=True)

        def encode(self, src):
            return self.transformer.encoder(self.embed(src))

        def forward(self, src, tgt_in):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt_in.shape[1])
            out = self.transformer.decoder(self.embed(tgt_in),
                                           self.encode(src), mask)
            return self.project(out)
    return NMT()


class TransformerCell:
    """``decoder`` (an ``nn.TransformerDecoder``) as a beam-search cell;
    ``embed(ids [N, 1], position)`` and ``project(h [N, d])`` map tokens
    in and logits out."""

    def __init__(self, mod, decoder, embed, project):
        self.mod, self.decoder = mod, decoder
        self.embed, self.project = embed, project

    def initial(self, memory):
        flat = []
        for _, static in self.decoder.gen_cache(memory):
            flat += [static.k, static.v]
        return tuple(flat)

    def __call__(self, tok, states):
        mha = self.mod.nn.MultiHeadAttention
        layers = self.decoder.layers
        first = len(states) == 2 * len(layers)
        x = self.embed(self.mod.unsqueeze(tok, [1]),
                       0 if first else states[0].shape[1])
        if first:
            states = sum((tuple(lay.self_attn.gen_cache(x))
                          + tuple(states[2 * i:2 * i + 2])
                          for i, lay in enumerate(layers)), ())
        cache = [(mha.Cache(*states[4 * i:4 * i + 2]),
                  mha.StaticCache(*states[4 * i + 2:4 * i + 4]))
                 for i in range(len(layers))]
        out, new = self.decoder(x, None, None, None, cache)
        flat = []
        for incr, static in new:
            flat += [incr.k, incr.v, static.k, static.v]
        return self.project(out[:, 0]), tuple(flat)


def rnn_seq2seq(mod, src_vocab, tgt_vocab, hidden, layers, dropout):
    nn = mod.nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(src_vocab, hidden)
            self.tgt_emb = nn.Embedding(tgt_vocab, hidden)
            self.encoder = nn.LSTM(hidden, hidden, layers, dropout=dropout)
            self.decoder = nn.RNN(nn.LSTMCell(hidden, hidden))
            self.proj = nn.Linear(hidden, tgt_vocab)

        def encode(self, src, src_len):
            _, (h, c) = self.encoder(self.src_emb(src), None, src_len)
            return h[-1], c[-1]

        def forward(self, src, src_len, tgt_in):
            out, _ = self.decoder(self.tgt_emb(tgt_in),
                                  self.encode(src, src_len))
            return self.proj(out)
    return Seq2Seq()


class RNNCell:
    """:func:`rnn_seq2seq`'s decoder step as a beam-search cell over
    token ids; the state is the LSTM's (h, c)."""

    def __init__(self, model):
        self.model = model

    def __call__(self, tok, states):
        m = self.model
        out, new = m.decoder.cell(m.tgt_emb(tok), states)
        return m.proj(out), new


def masked_ce(mod, logits, labels, lengths):
    """The mean over the valid target positions of the token cross
    entropy ([B, T, V] logits, [B, T] labels, lengths [B])."""
    F = mod.nn.functional
    B, T = labels.shape
    ce = mod.reshape(F.cross_entropy(logits, labels, reduction="none"),
                     [B, T])
    mask = F.sequence_mask(lengths, T, dtype="float32")
    return (ce * mask).sum() / mask.sum()


def label_smoothed_ce(mod, logits, labels, vocab, epsilon=0.1):
    """The soft-label cross entropy against ``label_smooth``'s
    distribution (``epsilon`` spread over the vocabulary), meaned."""
    F = mod.nn.functional
    soft = F.label_smooth(F.one_hot(labels, vocab), epsilon=epsilon)
    return F.cross_entropy(logits, soft, soft_label=True)


def beam_decode(mod, cell, init, beam, max_steps, start=1, end=2,
                trace=None):
    """``dynamic_decode`` of ``BeamSearchDecoder(cell)`` from ``init``
    under ``no_grad``.  Returns (tokens [B, T, beam], parents [T, B,
    beam], lengths, final log-probs, steps).  With a ``trace`` list, each
    step appends the log-probs and finished flags before it, its logits
    and its chosen tokens, as float32 / bool / int numpy arrays."""
    class Traced(mod.nn.BeamSearchDecoder):
        def step(self, time, inputs, states, **kwargs):
            out = super().step(time, inputs, states, **kwargs)
            trace.append((states[1].astype("float32").numpy(),
                          states[2].numpy(), logits[-1], out[0].numpy()))
            return out
    logits = []

    def traced_cell(tok, states):
        out, new = cell(tok, states)
        logits.append(out.astype("float32").numpy())
        return out, new
    with mod.no_grad():
        dec = (mod.nn.BeamSearchDecoder(cell, start, end, beam)
               if trace is None else Traced(traced_cell, start, end, beam))
        out, states, lengths = mod.nn.dynamic_decode(
            dec, inits=init, max_step_num=max_steps, return_length=True)
        parents = mod.stack(dec._parents, 0)
    return out, parents, lengths, states[1], int(out.shape[1])


def _host(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else x


def card_against_cpu(mod, run):
    """``run(place)`` -> (loss, model, beams, trace) with ``place`` ("gpu",
    then "cpu") set as the device; ``loss.backward()`` follows each run.
    Returns {place: (loss, {name: gradient}, beams, trace)} on the host
    (numpy); the device setting is restored."""
    core = mod.framework.core
    res, prev = {}, core._state.expected_place
    try:
        for place in ("gpu", "cpu"):
            mod.set_device(place)
            loss, model, beams, trace = run(place)
            loss.backward()
            grads = {k: p.grad.astype("float32").numpy()
                     for k, p in model.named_parameters()}
            res[place] = (float(loss), grads,
                          tuple(_host(b) for b in beams), trace)
            del model
    finally:
        core._state.expected_place = prev
    return res


def loss_grad_errors(res):
    """The card's loss against the CPU's (relative) and its largest
    gradient difference over the CPU's largest |gradient| (some are zero
    up to rounding, as a key projection's bias)."""
    (lg, gg, _, _), (lc, gc, _, _) = res["gpu"], res["cpu"]
    scale = max(float(np.abs(g).max()) for g in gc.values())
    return {"loss": lc, "loss_rel_err": abs(lg - lc) / abs(lc),
            "grad_err_over_max": max(float(np.abs(gg[k] - g).max())
                                     for k, g in gc.items()) / scale}


def beam_margins(trace, beam, end=2):
    """Each traced step's margin: the smallest gap between adjacent
    candidate scores among a row's ``beam + 1`` best, over the batch
    (float64, from a :func:`beam_decode` trace).  Scores that move by
    less than half of it keep every beam's slot: the order within the
    beam fixes the slots, the gap below it which candidates stay."""
    out = []
    for lp, fin, logits, _ in trace:
        B = lp.shape[0]
        z = logits.astype(np.float64).reshape(B, beam, -1)
        step = z - z.max(-1, keepdims=True)
        step -= np.log(np.exp(step).sum(-1, keepdims=True))
        mask = np.full(z.shape[-1], -1e9)
        mask[end] = 0.0
        cand = np.where(fin[..., None], lp[..., None] + mask,
                        step + lp[..., None]).reshape(B, -1)
        top = -np.sort(-cand, axis=-1)[:, :beam + 1]
        out.append(float((top[:, :-1] - top[:, 1:]).min()))
    return out


def beam_parity(res, beam, end=2):
    """The card's beams against the CPU's: tokens, parents and lengths
    equal, the final log-prob difference, and on a difference the first
    differing step with the CPU's score margin there (when the CPU run
    was traced)."""
    (og, pg, ng, sg, _), (oc, pc, nc, sc, _) = res["gpu"][2], res["cpu"][2]
    out = {"tokens_equal": bool(np.array_equal(og, oc)),
           "parents_equal": bool(np.array_equal(pg, pc)),
           "lengths_equal": bool(np.array_equal(ng, nc)),
           "log_prob_err": float(np.abs(sg - sc).max())}
    trace = res["cpu"][3]
    if (trace and og.shape == oc.shape
            and not (out["tokens_equal"] and out["parents_equal"])):
        diff = (og != oc).any(axis=(0, 2)) | (pg != pc).any(axis=(1, 2))
        t = int(np.argmax(diff))
        out["first_differing_step"] = t
        out["score_margin_there"] = beam_margins(trace, beam, end)[t]
    return out


def traced_parity(card, cpu, parents_card, parents_cpu, beam, end=2):
    """Two traced beam runs (:func:`beam_decode`), card and CPU, step by
    step while they agree: each step's logits difference over the CPU's
    max|logit| (``logit_err``, the largest over the steps compared), and
    the log-probs' difference going into it.  The runs agree at a step
    while its chosen tokens and parents are equal.  Where they first
    differ, the CPU's score margin there against the bound on how far the
    card's scores can sit from the CPU's (the log-prob difference plus
    twice the logits', each candidate's score moving by up to that):
    ``divergence_ok`` holds when the margin is within twice the bound,
    two candidates that near swapping places by rounding alone."""
    out = {"steps": len(cpu), "steps_compared": 0, "logit_err": 0.0,
           "log_prob_err": 0.0, "diverged_at": None, "divergence_ok": True}
    margins = beam_margins(cpu, beam, end)
    for t, ((lg, _, zg, kg), (lc, _, zc, kc)) in enumerate(zip(card, cpu)):
        dz = float(np.abs(zg - zc).max())
        dlp = float(np.abs(lg - lc).max())
        out["steps_compared"] = t + 1
        out["logit_err"] = max(out["logit_err"],
                               dz / float(np.abs(zc).max()))
        out["log_prob_err"] = max(out["log_prob_err"], dlp)
        if not (np.array_equal(kg, kc)
                and np.array_equal(_host(parents_card[t]),
                                   _host(parents_cpu[t]))):
            bound = dlp + 2 * dz
            out.update(diverged_at=t, margin_there=margins[t],
                       score_bound_there=bound,
                       divergence_ok=margins[t] <= 2 * bound)
            break
    return out
