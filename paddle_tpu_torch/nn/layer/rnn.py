"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``): the
cells, ``RNN`` / ``BiRNN`` and ``SimpleRNN``, ``LSTM``, ``GRU``.

A layer's whole scan over time is one ``dispatch.call`` (``rnn_scan``),
as the reference's is one ``lax.scan`` op, so the tape and a static
``Program`` see one op.  Inside it the input projection of every step is
one product, then the recurrence runs step by step.

``sequence_length`` follows the reference, not PyTorch's packed
sequences or cuDNN's RNN: a row's states freeze once its length is
consumed (the final states are those after step ``length - 1``), while
its outputs past the length stay the raw per-step cell product; a reverse
scan flips the mask, so padding runs first, on the frozen initial state.
The gate orders are the reference's: LSTM i, f, g, o; GRU r, z, n with
``r * (h W_hn + b_hn)``.
"""
from __future__ import annotations

import math

import torch

from ...ops.dispatch import call
from ...tensor import manipulation as manip
from ..initializer import Uniform
from .container import LayerList
from .layers import Layer


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        from ...tensor.creation import full
        B = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        if isinstance(shape, (list, tuple)) and isinstance(shape[0],
                                                           (list, tuple)):
            return tuple(full([B] + list(s), init_value) for s in shape)
        return full([B] + list(shape), init_value)

    def _weights(self, gates, input_size, hidden_size, attrs):
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        wi, wh, bi, bh = attrs
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], wi, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], wh, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], bi, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], bh, is_bias=True, default_initializer=init)
        self.input_size = input_size
        self.hidden_size = hidden_size


def _act(name):
    return torch.tanh if name == "tanh" else torch.relu


def _simple_step(act, xw, h, wh, bh):
    return act(xw + h @ wh.T + bh)


def _lstm_step(xw, h, c, wh, bh):
    i, f, g, o = (xw + h @ wh.T + bh).chunk(4, -1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c2), c2


def _gru_step(xw, h, wh, bh):
    xr, xz, xn = xw.chunk(3, -1)
    hr, hz, hn = (h @ wh.T + bh).chunk(3, -1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self._weights(1, input_size, hidden_size, (
            weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr))
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = _act(self.activation)
        h = call(lambda x, h, wi, wh, bi, bh: _simple_step(
            act, x @ wi.T + bi, h, wh, bh), inputs, states, self.weight_ih,
            self.weight_hh, self.bias_ih, self.bias_hh,
            _name="simple_rnn_cell")
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._weights(4, input_size, hidden_size, (
            weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr))

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        h_new, c_new = call(lambda x, h, c, wi, wh, bi, bh: _lstm_step(
            x @ wi.T + bi, h, c, wh, bh), inputs, h, c, self.weight_ih,
            self.weight_hh, self.bias_ih, self.bias_hh, _name="lstm_cell")
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._weights(3, input_size, hidden_size, (
            weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr))

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = call(lambda x, h, wi, wh, bi, bh: _gru_step(
            x @ wi.T + bi, h, wh, bh), inputs, states, self.weight_ih,
            self.weight_hh, self.bias_ih, self.bias_hh, _name="gru_cell")
        return h, h


def _scan_cell(cell, inputs, initial_states, time_major, reverse=False,
               sequence_length=None):
    """The cell over time as one dispatched op: (outputs, final states)."""
    is_lstm = isinstance(cell, LSTMCell)
    is_gru = isinstance(cell, GRUCell)
    act = None if is_lstm or is_gru else _act(cell.activation)

    def _run(x, states, lens, wi, wh, bi, bh):
        if not time_major:
            x = x.transpose(0, 1)                   # [T, B, I]
        if reverse:
            x = x.flip(0)
        T = x.shape[0]
        if lens is None:
            mask = torch.ones((T, x.shape[1]), dtype=torch.bool,
                              device=x.device)
        else:
            mask = (torch.arange(T, device=x.device)[:, None]
                    < lens.to(x.device)[None, :])
            if reverse:
                mask = mask.flip(0)
        xw = x @ wi.T + bi                          # every step's x W_i
        carry = tuple(states) if is_lstm else (states,)
        ys = []
        for t in range(T):
            m = mask[t][:, None]
            if is_lstm:
                h2, c2 = _lstm_step(xw[t], carry[0], carry[1], wh, bh)
                new = (h2, c2)
            elif is_gru:
                h2 = _gru_step(xw[t], carry[0], wh, bh)
                new = (h2,)
            else:
                h2 = _simple_step(act, xw[t], carry[0], wh, bh)
                new = (h2,)
            ys.append(h2)
            carry = tuple(torch.where(m, n, o) for n, o in zip(new, carry))
        ys = torch.stack(ys, 0)
        if reverse:
            ys = ys.flip(0)
        if not time_major:
            ys = ys.transpose(0, 1)
        return (ys,) + carry

    outs = call(_run, inputs, initial_states, sequence_length,
                cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh,
                _name="rnn_scan")
    return outs[0], (outs[1:] if len(outs) > 2 else outs[1])


class RNN(Layer):
    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        return _scan_cell(self.cell, inputs, initial_states, self.time_major,
                          self.is_reverse, sequence_length)


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        if initial_states is None:
            bdim = 1 if self.time_major else 0
            s_fw = self.cell_fw.get_initial_states(inputs, batch_dim_idx=bdim)
            s_bw = self.cell_bw.get_initial_states(inputs, batch_dim_idx=bdim)
        else:
            s_fw, s_bw = initial_states
        y_fw, f_fw = _scan_cell(self.cell_fw, inputs, s_fw, self.time_major,
                                sequence_length=sequence_length)
        y_bw, f_bw = _scan_cell(self.cell_bw, inputs, s_bw, self.time_major,
                                reverse=True, sequence_length=sequence_length)
        return manip.concat([y_fw, y_bw], axis=-1), (f_fw, f_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidirect else 1
        self.direction = direction
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)

        def make_cell(isz):
            if mode == "LSTM":
                return LSTMCell(isz, hidden_size, *attrs)
            if mode == "GRU":
                return GRUCell(isz, hidden_size, *attrs)
            return SimpleRNNCell(isz, hidden_size, activation, *attrs)

        layers = []
        for i in range(num_layers):
            isz = input_size if i == 0 else hidden_size * self.num_directions
            if bidirect:
                layers.append(BiRNN(make_cell(isz), make_cell(isz),
                                    time_major))
            else:
                layers.append(RNN(make_cell(isz),
                                  is_reverse=(direction == "backward"),
                                  time_major=time_major))
        self.layer_list = LayerList(layers)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """Initial states [num_layers * num_directions, B, H] (an (h, c)
        pair for LSTM); returns (outputs, final states of that shape)."""
        from .. import functional as F
        out = inputs
        finals = []
        for i, rnn in enumerate(self.layer_list):
            init = (None if initial_states is None
                    else self._layer_state(initial_states, i))
            out, fin = rnn(out, init, sequence_length)
            finals.append(fin)
            if self.dropout > 0 and i < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        return out, self._stack_finals(finals)

    def _layer_state(self, states, i):
        d = self.num_directions
        if self.mode == "LSTM":
            h, c = states
            if d == 1:
                return (h[i], c[i])
            return ((h[2 * i], c[2 * i]), (h[2 * i + 1], c[2 * i + 1]))
        return states[i] if d == 1 else (states[2 * i], states[2 * i + 1])

    def _stack_finals(self, finals):
        if self.num_directions == 2:
            finals = [f for pair in finals for f in pair]
        if self.mode == "LSTM":
            return (manip.stack([f[0] for f in finals], 0),
                    manip.stack([f[1] for f in finals], 0))
        return manip.stack(finals, 0)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)
