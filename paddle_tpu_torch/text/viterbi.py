"""Viterbi decode (counterpart of ``paddle_tpu/text/viterbi.py``; ref:
paddle.text.viterbi_decode / ViterbiDecoder, the phi viterbi_decode
kernel's semantics): a forward loop over the steps and a backtrack loop,
in plain torch on the emissions' device.

Contract: ``lengths`` bounds each row's decode (a row's alpha freezes past
its length, padding steps neither score nor appear in the path, and the
path slots past the length are 0); ``include_bos_eos_tag=True`` treats
transitions row N-2 as BOS->tag and column N-1 as tag->EOS, added to the
first and last real step.  The path is int32.  Every argmax takes the
first maximal index, as ``jnp.argmax`` does, by a reduction that says so
on any device: the least index whose value equals the max.
"""
from __future__ import annotations

import torch

from ..ops.dispatch import call


def _first_argmax(v, dim):
    """(max, the first index of the max) along ``dim``."""
    best = v.amax(dim)
    n = v.shape[dim]
    shape = [1] * v.dim()
    shape[dim] = n
    idx = torch.arange(n, device=v.device).view(shape)
    first = torch.where(v == best.unsqueeze(dim), idx, n).amin(dim)
    return best, first


def _viterbi(emissions, trans, lens, include_bos_eos_tag):
    # emissions: [B, T, N], trans: [N, N], lens: [B]
    B, T, N = emissions.shape
    lens = torch.as_tensor(lens, device=emissions.device).to(torch.int32)
    alpha = emissions[:, 0]
    if include_bos_eos_tag:
        alpha = alpha + trans[N - 2][None, :]
    backptrs = []
    for t in range(1, T):
        total = alpha[:, :, None] + trans[None, :, :]
        best, idx = _first_argmax(total, 1)
        # frozen past each row's length: alpha stays the state at len-1
        alpha = torch.where((t < lens)[:, None], best + emissions[:, t],
                            alpha)
        backptrs.append(idx)
    final = alpha
    if include_bos_eos_tag:
        final = final + trans[:, N - 1][None, :]
    score, tag = _first_argmax(final, -1)          # tag at position len-1
    path = [None] * T
    for t in range(T - 1, 0, -1):
        prev = backptrs[t - 1].gather(1, tag[:, None])[:, 0]
        executed = t <= lens - 1                   # step t ran for the row
        path[t] = torch.where(executed, tag, 0)    # path slot t (0-padded)
        tag = torch.where(executed, prev, tag)
    path[0] = tag
    return score, torch.stack(path, 1).to(torch.int32)


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """(scores [B], paths [B, T] int32) of the best tag sequences.
    potentials: [B, T, N] emissions; transition_params: [N, N]; lengths:
    [B] (None: every row T long)."""
    B, T = potentials.shape[0], potentials.shape[1]
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32)

    def _vit(emissions, trans, lens):
        return _viterbi(emissions, trans, lens, include_bos_eos_tag)
    return call(_vit, potentials, transition_params, lengths,
                _name="viterbi_decode")


class ViterbiDecoder:
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
