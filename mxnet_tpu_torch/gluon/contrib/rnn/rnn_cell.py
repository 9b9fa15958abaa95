"""`VariationalDropoutCell` and `LSTMPCell` (the port of
`mxnet_tpu.gluon.contrib.rnn.rnn_cell`)."""
from __future__ import annotations

from .... import ndarray as nd
from ...rnn.rnn_cell import HybridRecurrentCell, ModifierCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Dropout on the inputs, states and outputs with masks drawn once per
    sequence and reused at every step (Gal and Ghahramani)."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        super().__init__(base_cell)
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    @staticmethod
    def _mask(p, like):
        return nd.invoke("Dropout", nd.ones_like(like), p=p)

    def hybrid_forward(self, F, inputs, states):
        if self._drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask(self._drop_inputs, inputs)
            inputs = inputs * self._input_mask
        if self._drop_states:
            if self._state_masks is None:
                self._state_masks = [self._mask(self._drop_states, s)
                                     for s in states]
            states = [s * m for s, m in zip(states, self._state_masks)]
        out, next_states = self.base_cell(inputs, states)
        if self._drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask(self._drop_outputs, out)
            out = out * self._output_mask
        return out, next_states


class LSTMPCell(HybridRecurrentCell):
    """LSTM whose output and recurrent state are projected from
    `hidden_size` down to `projection_size` (Sak et al.); states [r, c]."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def _shape_from_input(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gi, gf, gg, go = F.split(i2h + h2h, num_outputs=4, axis=-1)
        next_c = F.sigmoid(gf) * states[1] + F.sigmoid(gi) * gg.tanh()
        hidden = F.sigmoid(go) * next_c.tanh()
        next_r = F.FullyConnected(hidden, h2r_weight, None, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
