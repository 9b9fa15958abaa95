"""`mx.rnn`: the symbolic RNN cell API (the port of `mxnet_tpu.rnn`).

The cells compose `mx.sym` graphs for `Module` and `BucketingModule`:
`BaseRNNCell`, `RNNCell`, `LSTMCell`, `GRUCell`, `FusedRNNCell` (one
`RNN` op over the sequence; `unfuse` gives the equivalent stack and
`pack_weights`/`unpack_weights` convert its flat vector), the stacking
and modifier cells, `BucketSentenceIter` and `encode_sentences`, and the
checkpoint helpers that pack fused weights before writing. Each unrolled
graph is one program per bucket on the executor's whole-graph route. The
Gluon cells (`gluon.rnn`) are the imperative twins.
"""
from __future__ import annotations

import numpy as _np

from . import symbol as sym
from .base import MXNetError

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ResidualCell", "BucketSentenceIter"]


class BaseRNNCell:
    """A symbolic cell: `state_info`, `begin_state` (one variable per
    state), a step through `__call__` and `unroll`."""

    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._own_params = params is None
        self._modified = False
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [s["shape"] for s in self.state_info]

    def begin_state(self, func=None, init_sym=None, **kwargs):
        """Symbols for the initial states."""
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        states = []
        for i, info in enumerate(self.state_info):
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            states.append(sym.Variable(name, **kwargs))
        return states

    def reset(self):
        self._counter = -1
        self._init_counter = -1

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        """Unroll into a symbol graph: (outputs, final states)."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [sym.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, sym.Symbol):
            inputs = list(sym.split(inputs, num_outputs=length, axis=axis,
                                    squeeze_axis=True))
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(inputs[i], states)
            outputs.append(out)
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, states

    def _get_param(self, name):
        return sym.Variable(self._prefix + name)


class RNNCell(BaseRNNCell):
    """Elman cell (tanh or relu)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self._get_param("i2h_weight")
        self._iB = self._get_param("i2h_bias")
        self._hW = self._get_param("h2h_weight")
        self._hB = self._get_param("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=self._num_hidden,
                                 name=name + "i2h")
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=self._num_hidden,
                                 name=name + "h2h")
        out = sym.Activation(i2h + h2h, act_type=self._activation,
                             name=name + "out")
        return out, [out]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order [i, f, g, o], `forget_bias` added to the
    forget gate's pre-activation."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias
        self._iW = self._get_param("i2h_weight")
        self._iB = self._get_param("i2h_bias")
        self._hW = self._get_param("h2h_weight")
        self._hB = self._get_param("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=4 * self._num_hidden,
                                 name=name + "i2h")
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=4 * self._num_hidden,
                                 name=name + "h2h")
        gates = i2h + h2h
        slices = list(sym.split(gates, num_outputs=4, axis=1))
        in_gate = sym.Activation(slices[0], act_type="sigmoid")
        forget_gate = sym.Activation(slices[1] + self._forget_bias,
                                     act_type="sigmoid")
        in_trans = sym.Activation(slices[2], act_type="tanh")
        out_gate = sym.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order [r, z, n]."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._iW = self._get_param("i2h_weight")
        self._iB = self._get_param("i2h_bias")
        self._hW = self._get_param("h2h_weight")
        self._hB = self._get_param("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=3 * self._num_hidden)
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=3 * self._num_hidden)
        i_r, i_z, i_n = list(sym.split(i2h, num_outputs=3, axis=1))
        h_r, h_z, h_n = list(sym.split(h2h, num_outputs=3, axis=1))
        reset = sym.Activation(i_r + h_r, act_type="sigmoid")
        update = sym.Activation(i_z + h_z, act_type="sigmoid")
        newmem = sym.Activation(i_n + reset * h_n, act_type="tanh")
        next_h = update * states[0] + (1 - update) * newmem
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """The whole sequence through one `RNN` op over a flat parameter
    vector named ``<prefix>parameters``."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix=None, params=None):
        prefix = prefix or ("%s_" % mode)
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._param = sym.Variable(self._prefix + "parameters")

    @property
    def state_info(self):
        b = 2 if self._bidirectional else 1
        info = [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append(dict(info[0]))
        return info

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        if inputs is None:
            inputs = sym.Variable("%sdata" % input_prefix)
        if isinstance(inputs, (list, tuple)):
            inputs = sym.stack(*inputs, axis=1)
        if layout == "NTC":  # RNN op takes TNC
            inputs = sym.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        args = [inputs, self._param] + list(begin_state)
        out = sym.RNN(*args, state_size=self._num_hidden,
                      num_layers=self._num_layers, mode=self._mode,
                      bidirectional=self._bidirectional, p=self._dropout,
                      state_outputs=False)[0]
        if layout == "NTC":
            out = sym.swapaxes(out, dim1=0, dim2=1)
        return out, begin_state

    def unfuse(self):
        """The equivalent stack of unfused cells."""
        stack = SequentialRNNCell()
        cls = {"rnn_tanh": RNNCell, "rnn_relu": RNNCell, "lstm": LSTMCell,
               "gru": GRUCell}[self._mode]
        kw = {}
        if cls is LSTMCell:
            # the packed fused bias already carries the forget bias
            # (initializer.FusedRNN bakes it in); a runtime add here
            # would double-count it against unpacked weights
            kw["forget_bias"] = 0.0
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    cls(self._num_hidden,
                        prefix="%sl%d_" % (self._prefix, i), **kw),
                    cls(self._num_hidden,
                        prefix="%sl%d_r_" % (self._prefix, i), **kw),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(cls(self._num_hidden,
                              prefix="%sl%d_" % (self._prefix, i), **kw))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(
                    self._dropout, prefix="%s_dropout%d_"
                    % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Cells stacked; a step runs them in order."""

    def __init__(self, params=None):
        super().__init__("", params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(st)
        return inputs, next_states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Layer-wise unroll: each child unrolls the whole sequence and
        feeds the next, so children that cannot be stepped
        (BidirectionalCell) work."""
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        states = []
        pos = 0
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            last = i == len(self._cells) - 1
            inputs, st = cell.unroll(
                length, inputs, begin_state[pos:pos + n],
                input_prefix=input_prefix, layout=layout,
                merge_outputs=None if last else False)
            pos += n
            states.extend(st)
        if merge_outputs and isinstance(inputs, list):
            inputs = sym.stack(*inputs, axis=layout.find("T"))
        return inputs, states


class BidirectionalCell(BaseRNNCell):
    """A left-to-right and a right-to-left cell, their outputs
    concatenated per step; unrolled only."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params)
        self._l, self._r = l_cell, r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    def begin_state(self, **kwargs):
        return self._l.begin_state(**kwargs) + self._r.begin_state(**kwargs)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [sym.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, sym.Symbol):
            inputs = list(sym.split(inputs, num_outputs=length, axis=axis,
                                    squeeze_axis=True))
        if begin_state is None:
            begin_state = self.begin_state()
        nl = len(self._l.state_info)
        lo, ls = self._l.unroll(length, inputs, begin_state[:nl], layout="TNC")
        ro, rs = self._r.unroll(length, list(reversed(inputs)),
                                begin_state[nl:], layout="TNC")
        outs = [sym.concat(l, r, dim=1)
                for l, r in zip(lo, reversed(ro))]
        if merge_outputs:
            outs = sym.stack(*outs, axis=axis)
        return outs, ls + rs


class DropoutCell(BaseRNNCell):
    """Dropout on the inputs at each step (no state)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = sym.Dropout(inputs, p=self._dropout)
        return inputs, states


class ResidualCell(BaseRNNCell):
    """Output = base(x) + x."""

    def __init__(self, base_cell):
        super().__init__("", None)
        self._base = base_cell

    @property
    def state_info(self):
        return self._base.state_info

    def begin_state(self, **kwargs):
        return self._base.begin_state(**kwargs)

    def __call__(self, inputs, states):
        out, states = self._base(inputs, states)
        return out + inputs, states


class BucketSentenceIter:
    """Bucketed sequence batches for BucketingModule: each sentence padded
    with `invalid_label` to the smallest bucket that holds it (longer ones
    are dropped), the label the sentence shifted left by one; batches in
    an order shuffled by numpy's global generator at each `reset`. The
    batches are made on the current context."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        from .io import DataBatch, DataDesc
        if buckets is None:
            lens = _np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size]
        buckets.sort()
        self._DataBatch, self._DataDesc = DataBatch, DataDesc
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for s in sentences:
            buck = _np.searchsorted(buckets, len(s))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = _np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(s)] = s
            self.data[buck].append(buff)
        self.data = [_np.asarray(x, dtype=dtype) for x in self.data]
        self.batch_size = batch_size
        self.buckets = buckets
        self.invalid_label = invalid_label
        self.data_name, self.label_name = data_name, label_name
        self.dtype = dtype
        self.layout = layout
        self.default_bucket_key = max(buckets)
        self.reset()

    @property
    def provide_data(self):
        return [self._DataDesc(self.data_name,
                               (self.batch_size, self.default_bucket_key),
                               self.dtype)]

    @property
    def provide_label(self):
        return [self._DataDesc(self.label_name,
                               (self.batch_size, self.default_bucket_key),
                               self.dtype)]

    def reset(self):
        self._idx = [(b, i) for b, d in enumerate(self.data)
                     for i in range(0, len(d) - self.batch_size + 1,
                                    self.batch_size)]
        _np.random.shuffle(self._idx)
        self._cur = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._cur >= len(self._idx):
            raise StopIteration
        b, start = self._idx[self._cur]
        self._cur += 1
        d = self.data[b][start:start + self.batch_size]
        label = _np.full_like(d, self.invalid_label)
        label[:, :-1] = d[:, 1:]
        return self._make_batch(d, label, self.buckets[b])

    next = __next__

    def _make_batch(self, d, label, bucket_key):
        from .ndarray import array
        batch = self._DataBatch(
            data=[array(d)], label=[array(label)], pad=0,
            provide_data=[self._DataDesc(self.data_name, d.shape,
                                         self.dtype)],
            provide_label=[self._DataDesc(self.label_name, label.shape,
                                          self.dtype)])
        batch.bucket_key = bucket_key
        return batch


class RNNParams:
    """Parameter variables shared between cells, by name."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class ModifierCell(BaseRNNCell):
    """Base for cells that wrap another cell."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def reset(self):
        super().reset()
        self.base_cell.reset()

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """Zoneout on the symbolic cells (Krueger et al.): keep the previous
    output or state where a dropout mask of ones is zero."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout; unfuse() first"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return sym.Dropout(sym.ones_like(like), p=p)
        prev_output = self._prev_output if self._prev_output is not None \
            else sym.zeros_like(next_output)
        if self.zoneout_outputs > 0.0:
            output = sym.where(mask(self.zoneout_outputs, next_output),
                               next_output, prev_output)
        else:
            output = next_output
        if self.zoneout_states > 0.0:
            states = [sym.where(mask(self.zoneout_states, ns), ns, s)
                      for ns, s in zip(next_states, states)]
        else:
            states = next_states
        self._prev_output = output
        return output, states


def _fused_layout(cell, total):
    """Per-layer slicing offsets of the packed vector (input size solved
    by the shared ops.rnn_ops inversion)."""
    from .ops.rnn_ops import _gates, rnn_solve_input_size
    ng = _gates(cell._mode)
    h = cell._num_hidden
    ndir = 2 if cell._bidirectional else 1
    L = cell._num_layers
    in_sz = rnn_solve_input_size(cell._mode, total, h, L,
                                 cell._bidirectional)
    return ng, h, ndir, L, in_sz


def _fused_chunks(cell, total):
    """Yield (name, offset, shape) over the packed layout (weights then
    biases; names match unfuse()'s per-layer cells so fused and unfused
    checkpoints interchange)."""
    ng, h, ndir, L, in_sz = _fused_layout(cell, total)
    off = 0
    for layer in range(L):
        for d in range(ndir):
            cur_in = in_sz if layer == 0 else h * ndir
            tag = "%sl%d%s_" % (cell._prefix, layer, "_r" if d else "")
            yield tag + "i2h_weight", off, (ng * h, cur_in)
            off += ng * h * cur_in
            yield tag + "h2h_weight", off, (ng * h, h)
            off += ng * h * h
    for layer in range(L):
        for d in range(ndir):
            tag = "%sl%d%s_" % (cell._prefix, layer, "_r" if d else "")
            yield tag + "i2h_bias", off, (ng * h,)
            off += ng * h
            yield tag + "h2h_bias", off, (ng * h,)
            off += ng * h


def _fused_unpack(cell, args):
    from . import ndarray as nd
    args = dict(args)
    key = cell._prefix + "parameters"
    packed = args.pop(key).asnumpy().reshape(-1)
    for name, off, shape in _fused_chunks(cell, packed.size):
        n = 1
        for s in shape:
            n *= s
        args[name] = nd.array(packed[off:off + n].reshape(shape))
    return args


def _fused_pack(cell, args):
    import numpy as _np
    from . import ndarray as nd
    args = dict(args)
    key0 = cell._prefix + "l0_i2h_weight"
    if key0 not in args:
        return args  # already packed (or not this cell's params)
    from .ops.rnn_ops import rnn_param_size
    in_sz = args[key0].shape[1]
    total = rnn_param_size(cell._mode, in_sz, cell._num_hidden,
                           cell._num_layers, cell._bidirectional)
    flat = _np.zeros((total,), dtype=args[key0].dtype)
    for name, off, shape in _fused_chunks(cell, total):
        n = 1
        for s in shape:
            n *= s
        flat[off:off + n] = args.pop(name).asnumpy().reshape(-1)
    args[cell._prefix + "parameters"] = nd.array(flat)
    return args


FusedRNNCell.unpack_weights = _fused_unpack
FusedRNNCell.pack_weights = _fused_pack
BaseRNNCell.unpack_weights = lambda self, args: dict(args)
BaseRNNCell.pack_weights = lambda self, args: dict(args)
SequentialRNNCell.unpack_weights = lambda self, args: _chain(
    self._cells, "unpack_weights", args)
SequentialRNNCell.pack_weights = lambda self, args: _chain(
    self._cells, "pack_weights", args)
BidirectionalCell.unpack_weights = lambda self, args: _chain(
    (self._l, self._r), "unpack_weights", args)
BidirectionalCell.pack_weights = lambda self, args: _chain(
    (self._l, self._r), "pack_weights", args)
ResidualCell.unpack_weights = lambda self, args: \
    self._base.unpack_weights(args)
ResidualCell.pack_weights = lambda self, args: \
    self._base.pack_weights(args)


def _chain(cells, meth, args):
    for c in cells:
        args = getattr(c, meth)(args)
    return args


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Pack the fused cells' weights, then write the checkpoint pair
    (``prefix-symbol.json``, ``prefix-%04d.params``)."""
    from .model import save_checkpoint
    if isinstance(cells, BaseRNNCell):
        cells = [cells]
    for cell in cells:
        arg_params = cell.pack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint pair and unpack the fused cells' weights."""
    from .model import load_checkpoint
    sym_, arg, aux = load_checkpoint(prefix, epoch)
    if isinstance(cells, BaseRNNCell):
        cells = [cells]
    for cell in cells:
        arg = cell.unpack_weights(arg)
    return sym_, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback that writes `save_rnn_checkpoint` every
    `period` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, s=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, s, arg, aux)
    return _callback


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Map token sequences to integer ids, growing the vocab as needed."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token:
                        word = unknown_token
                    else:
                        raise ValueError("Unknown token %s" % word)
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


__all__ += ["RNNParams", "ModifierCell", "ZoneoutCell",
            "save_rnn_checkpoint", "load_rnn_checkpoint",
            "do_rnn_checkpoint", "encode_sentences"]
