"""Unfused recurrent cells (the port of `mxnet_tpu.gluon.rnn.rnn_cell`).

The reference's cell classes and `unroll` protocol, stepping through the
port's ops (`FullyConnected`, `split`, the activations) one time step at a
time; the fused whole-sequence route is `rnn_layer.py`'s `RNN` op.

Fixed here, not copied from the reference: `unroll(valid_length=...)`
masks the outputs over the whole sequence and picks each sequence's last
state, and its outputs come out in the layout and form `merge_outputs`
asks for, as upstream MXNet's `_format_sequence` gives them. The
reference masks each step as a sequence of one (so nothing is masked),
hands `SequenceMask` an NDArray by keyword, which its op cannot read, and
re-merges a merged tensor along the batch.
"""
from __future__ import annotations

import inspect

from ... import ndarray as nd
from ..block import Block, HybridBlock
from ..utils import _indent

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _context_of(inputs):
    first = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
    return getattr(first, "context", None)


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    """The given states, or zeros on the inputs' context."""
    if begin_state is None:
        kw = {}
        ctx = _context_of(inputs)
        if ctx is not None:
            kw["ctx"] = ctx
        begin_state = cell.begin_state(batch_size=batch_size,
                                       func=nd.zeros, **kw)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """The inputs as a list of per-step tensors (merge False), one tensor
    with the time axis of `layout` (merge True) or as they are (None):
    (inputs, time axis, batch size, length)."""
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, nd.NDArray) or not isinstance(inputs,
                                                        (list, tuple)):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            assert length is None or length == inputs.shape[in_axis]
            inputs = list(nd.split_v2(
                inputs, inputs.shape[in_axis], axis=in_axis,
                squeeze_axis=True)) if isinstance(inputs, nd.NDArray) else \
                [inputs.slice_axis(in_axis, i, i + 1).reshape(
                    _squeeze_shape(inputs, in_axis))
                 for i in range(inputs.shape[in_axis])]
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = nd.concat(*[i.expand_dims(axis) for i in inputs],
                               dim=axis)
    if isinstance(inputs, (list, tuple)):
        length = len(inputs)
    else:
        length = inputs.shape[in_axis] if merge is not True else length
    return inputs, axis, batch_size, length


def _squeeze_shape(x, axis):
    shape = list(x.shape)
    shape.pop(axis)
    return tuple(shape)


def _mask_sequence_variable_length(F, data, length, valid_length, time_axis,
                                   merge):
    """The steps of each sequence at or past its valid length zeroed: one
    tensor with `merge`, else a list of per-step tensors."""
    assert valid_length is not None
    if isinstance(data, (list, tuple)):
        data = F.stack(*data, axis=time_axis)
    outputs = F.SequenceMask(data, sequence_length=valid_length,
                             use_sequence_length=True, axis=time_axis)
    if not merge:
        outputs = list(nd.split_v2(outputs, length, axis=time_axis,
                                   squeeze_axis=True))
    return outputs


def _func_takes_name(func):
    try:
        return "name" in inspect.signature(func).parameters
    except (ValueError, TypeError):
        return False


class RecurrentCell(Block):
    """Abstract cell: `state_info`, `begin_state`, one step through
    `__call__(inputs, states)` and `unroll` over a sequence."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset before re-use (new sequence)."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, made by `func` (default `nd.zeros`) from
        each state's shape; ``ctx=``/``dtype=`` reach it."""
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base cell " \
            "cannot be called directly. Call the modifier cell instead."
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            if _func_takes_name(func):
                state = func(name="%sbegin_state_%d" % (
                    self._prefix, self._init_counter), **info)
            else:
                state = func(info["shape"], **{
                    k: v for k, v in info.items() if k in ("ctx", "dtype")})
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell for `length` steps: (outputs, final states).
        With `valid_length` (N,), each sequence's outputs past its length
        are zero and its states are those of its last valid step."""
        self.reset()
        F = nd
        inputs, axis, batch_size, length = _format_sequence(
            length, inputs, layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.invoke("SequenceLast",
                                nd.stack(*ele_list, axis=0),
                                valid_length,
                                use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(F, outputs, length,
                                                     valid_length, axis, True)
        outputs, _, _, _ = _format_sequence(length, outputs, layout,
                                            merge_outputs)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            if activation in ("tanh", "relu", "sigmoid"):
                return getattr(inputs, activation)()
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell whose step is `hybrid_forward(F, inputs, states, **params)`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman cell: h' = act(x W_i^T + b_i + h W_h^T + b_h)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def _shape_from_input(self, x, *args):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]

    def __repr__(self):
        shape = self.i2h_weight.shape
        return "{name}({inp} -> {out}, {act})".format(
            name=self.__class__.__name__,
            inp=shape[1] if shape[1] else None, out=shape[0],
            act=self._activation)


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gate order [i, f, g, o]; states [h, c]."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def _shape_from_input(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.split(gates, num_outputs=4, axis=-1)
        in_gate = self._get_activation(F, slice_gates[0],
                                       self._recurrent_activation)
        forget_gate = self._get_activation(F, slice_gates[1],
                                           self._recurrent_activation)
        in_transform = self._get_activation(F, slice_gates[2],
                                            self._activation)
        out_gate = self._get_activation(F, slice_gates[3],
                                        self._recurrent_activation)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]

    def __repr__(self):
        shape = self.i2h_weight.shape
        return "{name}({inp} -> {out})".format(
            name=self.__class__.__name__,
            inp=shape[1] if shape[1] else None, out=shape[0] // 4)


class GRUCell(HybridRecurrentCell):
    """GRU cell, gate order [r, z, n]: n = tanh(x_n + r * (h W_n^T +
    b_n))."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def _shape_from_input(self, x, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.split(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h = F.split(h2h, num_outputs=3, axis=-1)
        reset_gate = (i2h_r + h2h_r).sigmoid()
        update_gate = (i2h_z + h2h_z).sigmoid()
        next_h_tmp = (i2h + reset_gate * h2h).tanh()
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]

    def __repr__(self):
        shape = self.i2h_weight.shape
        return "{name}({inp} -> {out})".format(
            name=self.__class__.__name__,
            inp=shape[1] if shape[1] else None, out=shape[0] // 3)


def _sequential_step(cell, inputs, states):
    cell._counter += 1
    next_states = []
    p = 0
    for child in cell._children.values():
        n = len(child.state_info())
        state = states[p:p + n]
        p += n
        inputs, state = child(inputs, state)
        next_states.append(state)
    return inputs, sum(next_states, [])


def _sequential_unroll(cell, length, inputs, begin_state, layout,
                       merge_outputs, valid_length):
    """Each child unrolls the whole sequence and feeds the next."""
    cell.reset()
    num_cells = len(cell._children)
    _, _, batch_size, _ = _format_sequence(length, inputs, layout, None)
    begin_state = _get_begin_state(cell, nd, begin_state, inputs,
                                   batch_size)
    p = 0
    next_states = []
    for i, child in enumerate(cell._children.values()):
        n = len(child.state_info())
        states = begin_state[p:p + n]
        p += n
        inputs, states = child.unroll(
            length, inputs=inputs, begin_state=states, layout=layout,
            merge_outputs=None if i < num_cells - 1 else merge_outputs,
            valid_length=valid_length)
        next_states.extend(states)
    return inputs, next_states


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def __repr__(self):
        return "{name}(\n{modstr}\n)".format(
            name=self.__class__.__name__,
            modstr="\n".join("({i}): {m}".format(i=i, m=_indent(repr(m), 2))
                             for i, m in self._children.items()))

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        assert all(not isinstance(cell, BidirectionalCell)
                   for cell in self._children.values())
        return _sequential_step(self, inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        return _sequential_unroll(self, length, inputs, begin_state, layout,
                                  merge_outputs, valid_length)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridSequentialRNNCell(HybridRecurrentCell):
    """`SequentialRNNCell` whose children are hybrid cells."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        return _sequential_step(self, inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        return _sequential_unroll(self, length, inputs, begin_state, layout,
                                  merge_outputs, valid_length)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on the inputs at each step (no state)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float)), "rate must be a number"
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, _, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if isinstance(inputs, nd.NDArray):
            return self.hybrid_forward(nd, inputs, begin_state or [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell; the parameters are the base
    cell's."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified " \
            "twice" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError

    def __repr__(self):
        return "{name}({base_cell})".format(name=self.__class__.__name__,
                                            base_cell=self.base_cell)


class ZoneoutCell(ModifierCell):
    """Zoneout: each output and state keeps its previous value where a
    dropout mask of ones is zero (an identity outside training)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath " \
            "instead."
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        super().__init__(base_cell)
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self._zoneout_outputs,
                                     self._zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return nd.invoke("Dropout", nd.ones_like(like), p=p)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = nd.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0. else next_output
        new_states = [F.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Output = base(x) + x."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def _alias(self):
        return "residual"

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        if isinstance(outputs, list):
            inputs_l, _, _, _ = _format_sequence(length, inputs, layout,
                                                 False)
            outputs = [o + i for o, i in zip(outputs, inputs_l)]
        else:
            inputs_m, _, _, _ = _format_sequence(length, inputs, layout,
                                                 True)
            outputs = outputs + inputs_m
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """A left-to-right and a right-to-left cell over the sequence, their
    outputs concatenated per step; unrolled only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def __repr__(self):
        return "{name}(forward={l_cell}, backward={r_cell})".format(
            name=self.__class__.__name__,
            l_cell=self._children["l_cell"],
            r_cell=self._children["r_cell"])

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        axis = layout.find("T")
        inputs, _, batch_size, length = _format_sequence(length, inputs,
                                                         layout, False)
        reversed_inputs = list(reversed(inputs))
        begin_state = _get_begin_state(self, nd, begin_state, inputs,
                                       batch_size)
        states = begin_state
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs, begin_state=states[n_l:],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        reversed_r_outputs = list(reversed(r_outputs))
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed_r_outputs)]
        if merge_outputs:
            outputs = nd.concat(*[o.expand_dims(axis) for o in outputs],
                                dim=axis)
        return outputs, l_states + r_states
