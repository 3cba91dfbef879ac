"""Decoding helpers: ``BeamSearchDecoder`` and ``dynamic_decode``
(counterpart of ``paddle_tpu/nn/decode.py``).

An eager loop whose stopping test reads the finished flags on the host
each step, as the reference's does.  :meth:`BeamSearchDecoder.step`
keeps the reference's contract:

- the cell's states are one tensor or a flat tuple of tensors, each
  gathered by beam one level deep (a Transformer cell hands over each
  layer's incremental and static k and v as one flat tuple);
- a finished beam extends only with ``end_token`` at no cost, every
  other token at -1e9;
- the ``beam_size`` best of a row's ``beam_size x V`` scores are chosen
  in a stable order, ties lowest index first, as ``jax.lax.top_k``
  orders them (``torch.topk`` promises no order among equals, and the
  scores of a finished beam's candidates tie);
- tokens and parents are int32, the parents kept per step in
  ``_parents`` for ``gather_tree`` in :meth:`finalize`.

``dynamic_decode`` keeps each slot's length in int64 numpy, re-ordered
by the beams' ancestry every step, and returns the outputs batch-major
unless ``output_time_major``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import creation
from ..tensor import manipulation as manip
from ..tensor.tensor import Tensor
from . import functional as F


class Decoder:
    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam_size, ...], each row repeated
        ``beam_size`` times in place."""
        shape = list(x.shape)
        tiled = manip.tile(manip.unsqueeze(x, [1]),
                           [1, beam_size] + [1] * (len(shape) - 1))
        return manip.reshape(tiled, [-1] + shape[1:])

    def _merge_batch_beams(self, x):
        return manip.reshape(x, [-1] + list(x.shape[2:]))

    def initialize(self, initial_cell_states):
        states = initial_cell_states
        sample = states[0] if isinstance(states, (tuple, list)) else states
        batch = sample.shape[0]
        self.batch_size = batch
        self._parents = []
        start = creation.full([batch, self.beam_size], self.start_token,
                              "int64")
        log_probs = creation.full([batch, self.beam_size], -1e9, "float32")
        log_probs.value[:, 0] = 0.0
        finished = creation.zeros([batch, self.beam_size], "bool")

        def tile(s):
            return self.tile_beam_merge_with_batch(s, self.beam_size)
        if isinstance(states, (tuple, list)):
            states = tuple(tile(s) for s in states)
        else:
            states = tile(states)
        return start, (states, log_probs, finished), finished

    def _gather(self, s, beam_idx):
        """Rows of ``s`` [B * beam, ...] re-ordered by ``beam_idx``
        [B, beam]: slot j of row b takes beam ``beam_idx[b, j]``."""
        sv = s.value if isinstance(s, Tensor) else s
        sv = sv.reshape(self.batch_size, self.beam_size, *sv.shape[1:])
        rows = torch.arange(self.batch_size, device=sv.device)[:, None]
        g = sv[rows, beam_idx]
        return Tensor(g.reshape(-1, *sv.shape[2:]))

    def step(self, time, inputs, states, **kwargs):
        cell_states, log_probs, finished = states
        inp = inputs
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        inp = self._merge_batch_beams(inp)
        cell_out, next_cell_states = self.cell(inp, cell_states)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        V = cell_out.shape[-1]
        logits = manip.reshape(cell_out, [-1, self.beam_size, V])
        step_lp = F.log_softmax(logits, axis=-1)
        with torch.no_grad():
            lp = log_probs.value
            lv = step_lp.value + lp[..., None]
            fin = finished.value
            mask = torch.full((V,), -1e9, dtype=torch.float32,
                              device=lv.device)
            mask[self.end_token] = 0.0
            lv = torch.where(fin[..., None], lp[..., None] + mask, lv)
            flat = lv.reshape(self.batch_size, -1)
            # stable: equal scores keep their index order (jax.lax.top_k)
            top_lp, top_idx = torch.sort(flat, dim=1, descending=True,
                                         stable=True)
            top_lp = top_lp[:, :self.beam_size]
            top_idx = top_idx[:, :self.beam_size]
            beam_idx = top_idx // V
            token_idx = top_idx % V
            new_finished = (torch.gather(fin, 1, beam_idx)
                            | (token_idx == self.end_token))
            if isinstance(next_cell_states, (tuple, list)):
                next_cell_states = tuple(self._gather(s, beam_idx)
                                         for s in next_cell_states)
            else:
                next_cell_states = self._gather(next_cell_states, beam_idx)
        outputs = Tensor(token_idx.to(torch.int32))
        self._parents.append(Tensor(beam_idx.to(torch.int32)))
        next_states = (next_cell_states, Tensor(top_lp),
                       Tensor(new_finished))
        return outputs, next_states, outputs, Tensor(new_finished)

    def finalize(self, outputs, final_states, sequence_lengths):
        """``outputs`` time-major [T, B, beam]; each slot's full path is
        traced back through the recorded parents (``gather_tree``)."""
        if not self._parents:
            return outputs, final_states
        parents = manip.stack(self._parents, axis=0)      # [T, B, beam]
        return F.gather_tree(outputs, parents), final_states

    @property
    def tracks_own_finished(self):
        return True


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, Tensor):
        return fn(*trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return first


def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step ``decoder`` until every slot has finished or ``max_step_num``
    steps.  A slot's length counts the step that first emits its end
    token; a decoder that does not track its own finished flags has them
    made sticky.  Returns (outputs, final states[, lengths])."""
    inputs, states, finished = decoder.initialize(inits)
    outputs_list = []
    fin_np = np.asarray(finished.numpy()).astype(bool)
    lengths_np = np.zeros(fin_np.shape, np.int64)
    for t in range(int(max_step_num)):
        out, states, next_inputs, finished = decoder.step(t, inputs, states,
                                                          **kwargs)
        outputs_list.append(out)
        if decoder.tracks_own_finished and getattr(decoder, "_parents",
                                                   None):
            # slot j now continues old slot parents[j]: its length and
            # finished flag follow it
            par = np.asarray(decoder._parents[-1].numpy()).astype(np.int64)
            lengths_np = np.take_along_axis(lengths_np, par, axis=-1)
            fin_np = np.take_along_axis(fin_np, par, axis=-1)
        lengths_np = lengths_np + (~fin_np).astype(np.int64)
        new_fin = np.asarray(finished.numpy()).astype(bool)
        fin_np = (new_fin if decoder.tracks_own_finished
                  else (fin_np | new_fin))
        inputs = next_inputs
        if bool(np.all(fin_np)):
            break
    outputs = _tree_map(lambda *xs: manip.stack(list(xs), axis=0),
                        *outputs_list)
    outputs, final_states = decoder.finalize(outputs, states, None)
    if not output_time_major:
        outputs = _tree_map(lambda x: manip.transpose(
            x, [1, 0] + list(range(2, len(x.shape)))), outputs)
    if return_length:
        return outputs, final_states, Tensor(lengths_np)
    return outputs, final_states
