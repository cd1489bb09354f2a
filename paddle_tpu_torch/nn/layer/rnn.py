"""Recurrent layers — port of ``paddle_tpu/nn/layer/rnn.py``: ``SimpleRNN``,
``LSTM`` and ``GRU`` (stacked, one or both directions), their cells and
the ``RNN`` wrapper.

The JAX package runs a ``lax.scan`` of ``_cell_step`` (:20-45) over time;
its gate orders (LSTM i, f, g, o; GRU r, z, n with the reset gate inside
the candidate's recurrent term, ``n = tanh(W_in x + b_in + r (W_hn h +
b_hn))``) and its two biases are exactly the formulas of torch's fused RNN
ops, so the port runs one call of ``torch._VF.lstm`` / ``gru`` /
``rnn_tanh`` / ``rnn_relu`` for the whole stack (cuDNN on the card): a
loop over time would launch kernels a step and a layer and leave the card
waiting on the host. The reverse direction runs over the whole sequence
reversed, as in the JAX package. Parameters carry the JAX package's names
(``weight_ih_l{k}[_reverse]``, ``weight_hh_...``, ``bias_ih_...``,
``bias_hh_...``: torch's too), shapes ``[gates * hidden, in]`` and
initializer ``Uniform(-1 / sqrt(hidden), 1 / sqrt(hidden))``.

Two arguments the JAX package ignores are Paddle's here. ``dropout``
between stacked layers: in training, on every layer's output but the
last (torch's fused op does it, its masks from torch's own generator of
the device). ``sequence_length`` [batch]: the stack runs as one call of
the fused op's packed form over the rows sorted by length (the initial
states permuted to match, the final ones back), so outputs past a row's
length are zero, its final states are those of its last valid step, and
its reverse direction starts there; the lengths are read on the host, as
torch's packing needs. ``RNN`` takes it too: past a row's length the
state is frozen and the output zero. The cells take their
``weight_*_attr`` / ``bias_*_attr`` (which the JAX cells drop).
"""

from __future__ import annotations

import torch
from torch.nn.utils.rnn import pack_padded_sequence

from ...core.op_registry import apply_fn
from ...core.tensor import unwrap
from ...device import resolve_device
from .. import initializer as I
from .layers import Layer, check_attr

_GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


def _promoted(x, weights):
    """x's and the weights' common dtype (JAX's promotion of ``x @
    w.T``)."""
    dt = x.dtype
    for w in weights:
        dt = torch.promote_types(dt, w.dtype)
    return dt


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        if activation not in ("tanh", "relu"):
            raise ValueError(f"unknown activation {activation!r}")
        what = type(self).__name__
        attrs = [check_attr(a, what) for a in (weight_ih_attr,
                                               weight_hh_attr, bias_ih_attr,
                                               bias_hh_attr)]
        if (attrs[2] is False) != (attrs[3] is False):
            raise ValueError(f"{what}: bias_ih_attr and bias_hh_attr are "
                             "both False or neither")
        self.mode, self.input_size, self.hidden_size = (mode, input_size,
                                                        hidden_size)
        self.num_layers, self.time_major = num_layers, time_major
        self.dropout, self.activation = dropout, activation
        self.bidirect = direction != "forward"
        self._has_bias = attrs[2] is not False
        dev = resolve_device(device)
        num_dirs = 2 if self.bidirect else 1
        gh = _GATES[mode] * hidden_size
        k = hidden_size ** -0.5
        self._flat_names = []
        for layer in range(num_layers):
            for d in range(num_dirs):
                in_sz = input_size if layer == 0 else hidden_size * num_dirs
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                for name, shape, attr, is_bias in (
                        ("weight_ih", [gh, in_sz], attrs[0], False),
                        ("weight_hh", [gh, hidden_size], attrs[1], False),
                        ("bias_ih", [gh], attrs[2], True),
                        ("bias_hh", [gh], attrs[3], True)):
                    if attr is False:
                        continue
                    self.add_parameter(name + sfx, self.create_parameter(
                        shape, attr=attr, is_bias=is_bias,
                        default_initializer=I.Uniform(-k, k), device=dev,
                        generator=generator))
                    self._flat_names.append(name + sfx)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``(outputs, final_states)``: outputs [batch, time, dirs x
        hidden] ([time, batch, ...] when ``time_major``), states [layers x
        dirs, batch, hidden] (LSTM: the pair (h, c)); initial states
        default to zeros; ``sequence_length`` [batch] (see the module
        docstring)."""
        lengths = None if sequence_length is None else torch.as_tensor(
            unwrap(sequence_length)).to("cpu", torch.int64)
        mode, lstm = self.mode, self.mode == "LSTM"
        states = (list(initial_states) if lstm else [initial_states]) \
            if initial_states is not None else []
        nl, bi = self.num_layers, self.bidirect
        drop = float(self.dropout) if self.training else 0.0
        # cuDNN runs a backward only after a training-mode call: take it
        # whenever autograd records (the dropout above follows the mode)
        train = self.training or torch.is_grad_enabled()
        has_bias, batch_first = self._has_bias, not self.time_major
        op = {"LSTM": torch._VF.lstm, "GRU": torch._VF.gru}.get(
            mode, torch._VF.rnn_tanh if self.activation == "tanh"
            else torch._VF.rnn_relu)
        nw = len(self._flat_names)

        def fn(x, *rest):
            weights, hx = list(rest[:nw]), list(rest[nw:])
            dt = _promoted(x, weights)
            x, weights = x.to(dt), [w.to(dt) for w in weights]
            if not hx:
                zeros = x.new_zeros(nl * (2 if bi else 1),
                                    x.shape[0 if batch_first else 1],
                                    self.hidden_size)
                hx = [zeros, zeros] if lstm else [zeros]
            hx = [h.to(dt) for h in hx]
            if lengths is None:
                return op(x, tuple(hx) if lstm else hx[0], weights,
                          has_bias, nl, drop, train, bi, batch_first)
            packed = pack_padded_sequence(x, lengths, batch_first,
                                          enforce_sorted=False)
            order, back = packed.sorted_indices, packed.unsorted_indices
            hx = [h.index_select(1, order) for h in hx]
            res = op(packed.data, packed.batch_sizes,
                     tuple(hx) if lstm else hx[0], weights, has_bias, nl,
                     drop, train, bi)
            # pad_packed_sequence without its lengths (a copy to the host)
            out = torch._VF._pad_packed_sequence(
                res[0], packed.batch_sizes, batch_first, 0.0,
                x.shape[1 if batch_first else 0])[0]
            return ((out.index_select(0 if batch_first else 1, back),)
                    + tuple(h.index_select(1, back) for h in res[1:]))

        res = apply_fn("rnn_" + mode.lower(), fn, inputs,
                       *[self._parameters[n] for n in self._flat_names],
                       *states)
        if lstm:
            return res[0], (res[1], res[2])
        return res[0], res[1]

    def extra_repr(self):
        return (f"{self.input_size}, {self.hidden_size}, "
                f"num_layers={self.num_layers}, "
                f"direction={'bidirect' if self.bidirect else 'forward'}")


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr, device=device, generator=generator)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, "tanh",
                         weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr, device=device, generator=generator)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, "tanh",
                         weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr, device=device, generator=generator)


class _CellBase(Layer):
    """A cell's ``weight_ih`` [gates x hidden, in], ``weight_hh`` [gates x
    hidden, hidden], ``bias_ih`` and ``bias_hh``, Uniform(+-1 /
    sqrt(hidden))."""

    def __init__(self, gates, input_size, hidden_size, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                 generator):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        dev = resolve_device(device)
        k = hidden_size ** -0.5
        what = type(self).__name__
        for name, shape, attr, is_bias in (
                ("weight_ih", [gates * hidden_size, input_size],
                 weight_ih_attr, False),
                ("weight_hh", [gates * hidden_size, hidden_size],
                 weight_hh_attr, False),
                ("bias_ih", [gates * hidden_size], bias_ih_attr, True),
                ("bias_hh", [gates * hidden_size], bias_hh_attr, True)):
            attr = check_attr(attr, what)
            setattr(self, name, None if attr is False else
                    self.create_parameter(
                        shape, attr=attr, is_bias=is_bias,
                        default_initializer=I.Uniform(-k, k), device=dev,
                        generator=generator))

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """[batch, hidden] of ``init_value``, in fp32 (the JAX package's)
        on the cell's device."""
        b = batch_ref.shape[batch_dim_idx]
        return torch.full((b, self.hidden_size), float(init_value),
                          device=self.weight_ih.device)

    def _step(self, name, op, inputs, *states):
        weights = [self.weight_ih, self.weight_hh, self.bias_ih,
                   self.bias_hh]

        def fn(x, *rest):
            rest = list(rest)
            hx = rest[:len(states)]
            it = iter(rest[len(states):])   # the weights that are there
            w = [next(it) if t is not None else None for t in weights]
            dt = _promoted(x, [t for t in w if t is not None])
            hx = [h.to(dt) for h in hx]
            w = [None if t is None else t.to(dt) for t in w]
            return op(x.to(dt), hx[0] if len(hx) == 1 else tuple(hx), *w)

        return apply_fn(name, fn, inputs, *states,
                        *[t for t in weights if t is not None])


class SimpleRNNCell(_CellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        if activation not in ("tanh", "relu"):
            raise ValueError(f"unknown activation {activation!r}")
        super().__init__(1, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         generator)
        self.activation = activation

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        op = (torch._VF.rnn_tanh_cell if self.activation == "tanh"
              else torch._VF.rnn_relu_cell)
        h = self._step("rnn_cell", op, inputs, h)
        return h, h


class LSTMCell(_CellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__(4, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         generator)

    def forward(self, inputs, states=None):
        if states is None:
            h = c = self.get_initial_states(inputs)
        else:
            h, c = states
        h2, c2 = self._step("lstm_cell", torch._VF.lstm_cell, inputs, h, c)
        return h2, (h2, c2)


class GRUCell(_CellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__(3, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         generator)

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        h = self._step("gru_cell", torch._VF.gru_cell, inputs, h)
        return h, h


def nest_map(fn, *nests):
    """``fn`` over matching nests (tuples, lists) of tensors."""
    if isinstance(nests[0], (tuple, list)):
        return type(nests[0])(nest_map(fn, *parts)
                              for parts in zip(*nests))
    return fn(*nests)


class RNN(Layer):
    """A cell run over time, one step at a time (the JAX package's Python
    loop, :258-281); ``is_reverse`` runs it from the last step back. With
    ``sequence_length`` a row's state past its length stays as it was
    (``where(t < length, new, old)``; so the reverse direction starts at
    its last valid step) and its output there is zero."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse, self.time_major = is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        xt = inputs if self.time_major else torch.transpose(inputs, 0, 1)
        steps = range(xt.shape[0])
        if self.is_reverse:
            steps = reversed(steps)
        lengths = None if sequence_length is None else torch.as_tensor(
            unwrap(sequence_length)).to(xt.device)
        outs, state = {}, initial_states
        for t in steps:
            out, new = self.cell(xt[t], state)
            if lengths is not None:
                live = (t < lengths)[:, None]
                old = state if state is not None \
                    else nest_map(torch.zeros_like, new)
                new = nest_map(lambda n, o: torch.where(live, n, o), new, old)
                out = torch.where(live, out, 0.0)
            outs[t], state = out, new
        out = torch.stack([outs[t] for t in range(xt.shape[0])], 0)
        return (out if self.time_major else torch.transpose(out, 0, 1)), \
            state
