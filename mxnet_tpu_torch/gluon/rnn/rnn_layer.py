"""Fused recurrent layers `RNN`, `LSTM` and `GRU` over the `RNN` op (the
port of `mxnet_tpu.gluon.rnn.rnn_layer`).

Parameter names (``l0_i2h_weight``, ``r0_h2h_bias``, ...) and the TNC /
NTC layouts are the reference's, so `.params` files cross between the
two packages; each forward concatenates the per-layer weights into the
op's flat vector (all weights, then all biases).
"""
from __future__ import annotations

from ... import ndarray as nd
from ...ops.rnn_ops import _gates
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """The shared layer: `num_layers` (bidirectional) layers of one mode,
    the input size deferred to the first input when 0."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = _gates(mode)

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=i2h_bias_initializer)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(
            shape[1] if shape[1] else None, shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _shape_from_input(self, x, *args):
        ni = x.shape[2]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, "{}{}_i2h_weight".format(j, i)).shape = \
                    (ng * nh, ni)
            ni = nh * self._dir

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (or `func`'s) of `state_info`'s shapes; ``ctx=``
        and ``dtype=`` reach `func`."""
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(info.pop("shape", ()), **{
                k: v for k, v in info.items() if k in ("ctx", "dtype")}))
        return states

    def hybrid_forward(self, F, inputs, states=None, **kwargs):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, 0, 1)
        batch_size = inputs.shape[1]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context,
                                      dtype=inputs.dtype)
        if isinstance(states, nd.NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(state.shape)))
        outputs, new_states = self._forward_kernel(F, inputs, states,
                                                   **kwargs)
        if self._layout == "NTC":
            outputs = nd.invoke("swapaxes", outputs, dim1=0, dim2=1)
        return outputs if skip_states else (outputs, new_states)

    def _flat_params(self, kwargs):
        order = []
        for kind in ("weight", "bias"):
            for i in range(self._num_layers):
                for j in ["l", "r"][:self._dir]:
                    order.append(kwargs["{}{}_i2h_{}".format(j, i, kind)])
                    order.append(kwargs["{}{}_h2h_{}".format(j, i, kind)])
        return nd.concat(*[w.reshape((-1,)) for w in order], dim=0)

    def _forward_kernel(self, F, inputs, states, **kwargs):
        params = self._flat_params(kwargs)
        lstm = self._mode == "lstm"
        outputs, state_n, cell_n = F.RNN(
            inputs, params, states[0], states[1] if lstm else None,
            state_size=self._hidden_size, num_layers=self._num_layers,
            mode=self._mode, bidirectional=self._dir == 2, p=self._dropout,
            state_outputs=True)
        return outputs, ([state_n, cell_n] if lstm else [state_n])


class RNN(_RNNLayer):
    """Elman RNN layer (relu or tanh)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """LSTM layer; states [h, c]."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", projection_size,
                         **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """GRU layer."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
