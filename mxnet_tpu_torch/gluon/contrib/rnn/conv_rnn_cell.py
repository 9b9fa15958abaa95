"""Convolutional recurrent cells (the port of
`mxnet_tpu.gluon.contrib.rnn.conv_rnn_cell`):
Conv{1D,2D,3D}{RNN,LSTM,GRU}Cell.

The state is a feature map: the input-to-hidden and hidden-to-hidden
transforms are convolutions (ConvLSTM, Shi et al. 2015), and the
hidden-to-hidden kernel must be odd so that its 'same' padding keeps the
state's shape from step to step. The 1-, 2- and 3-D cells run on the
port's `Convolution` of that many spatial dims.
"""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(val, n, name):
    if isinstance(val, int):
        return (val,) * n
    val = tuple(val)
    if len(val) != n:
        raise ValueError("%s must be a scalar or a %d-tuple, got %r"
                         % (name, n, val))
    return val


class _BaseConvRNNCell(HybridRecurrentCell):
    """Shared conv-cell machinery: parameter shapes, state-shape
    arithmetic, and the i2h/h2h convolutions."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer,
                 dims, conv_layout, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)
        self._conv_layout = conv_layout
        self._activation = activation
        self._dims = dims
        self._channels_last = conv_layout.endswith("C")

        self._i2h_kernel = _tup(i2h_kernel, dims, "i2h_kernel")
        self._h2h_kernel = _tup(h2h_kernel, dims, "h2h_kernel")
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError(
                "h2h_kernel must be odd so the recurrent conv preserves the "
                "state shape; got %r" % (self._h2h_kernel,))
        self._i2h_pad = _tup(i2h_pad, dims, "i2h_pad")
        self._i2h_dilate = _tup(i2h_dilate, dims, "i2h_dilate")
        self._h2h_dilate = _tup(h2h_dilate, dims, "h2h_dilate")
        # 'same' padding for the recurrent conv
        self._h2h_pad = tuple(d * (k - 1) // 2 for k, d in
                              zip(self._h2h_kernel, self._h2h_dilate))

        if self._channels_last:
            in_c = self._input_shape[-1]
            spatial_in = self._input_shape[:-1]
        else:
            in_c = self._input_shape[0]
            spatial_in = self._input_shape[1:]
        if len(spatial_in) != dims:
            raise ValueError("input_shape %r does not match %dD layout %s"
                             % (self._input_shape, dims, conv_layout))
        # i2h output spatial size fixes the state's spatial size
        self._state_spatial = tuple(
            s + 2 * p - d * (k - 1) for s, p, d, k in
            zip(spatial_in, self._i2h_pad, self._i2h_dilate,
                self._i2h_kernel))
        if any(s <= 0 for s in self._state_spatial):
            raise ValueError("i2h conv collapses the spatial dims: %r"
                             % (self._state_spatial,))

        ng = self._num_gates
        out_c = ng * hidden_channels
        if self._channels_last:
            i2h_w = (out_c,) + self._i2h_kernel + (in_c,)
            h2h_w = (out_c,) + self._h2h_kernel + (hidden_channels,)
        else:
            i2h_w = (out_c, in_c) + self._i2h_kernel
            h2h_w = (out_c, hidden_channels) + self._h2h_kernel
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=i2h_w, init=i2h_weight_initializer,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=h2h_w, init=h2h_weight_initializer,
            allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(out_c,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(out_c,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    @property
    def _num_gates(self):
        raise NotImplementedError

    def state_info(self, batch_size=0):
        if self._channels_last:
            shape = (batch_size,) + self._state_spatial + \
                (self._hidden_channels,)
        else:
            shape = (batch_size, self._hidden_channels) + self._state_spatial
        return [{"shape": shape, "__layout__": self._conv_layout}] * \
            self._num_states

    def _act(self, F, x):
        if self._activation == "leaky":
            return F.LeakyReLU(x, act_type="leaky", slope=0.25)
        return self._get_activation(F, x, self._activation)

    def _convs(self, F, inputs, state, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        ng = self._num_gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate,
                            num_filter=ng * self._hidden_channels,
                            layout=self._conv_layout)
        h2h = F.Convolution(state, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate,
                            num_filter=ng * self._hidden_channels,
                            layout=self._conv_layout)
        return i2h, h2h

    def _split_gates(self, F, x):
        axis = len(self._conv_layout) - 1 if self._channels_last else 1
        return F.split(x, num_outputs=self._num_gates, axis=axis)

    def __repr__(self):
        return "%s(%r -> %d hidden channels, i2h %r / h2h %r)" % (
            self.__class__.__name__, self._input_shape,
            self._hidden_channels, self._i2h_kernel, self._h2h_kernel)


class _ConvRNNCell(_BaseConvRNNCell):
    _num_states = 1

    @property
    def _num_gates(self):
        return 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        output = self._act(F, i2h + h2h)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    """Gate order [i, f, g, o] like LSTMCell; c and h are feature maps."""
    _num_states = 2

    @property
    def _num_gates(self):
        return 4

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        gates = i2h + h2h
        gi, gf, gg, go = self._split_gates(F, gates)
        in_gate = F.sigmoid(gi)
        forget_gate = F.sigmoid(gf)
        in_transform = self._act(F, gg)
        out_gate = F.sigmoid(go)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._act(F, next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    """Gate order [r, z, n] like GRUCell: the reset gate scales the
    recurrent candidate BEFORE it enters the nonlinearity."""
    _num_states = 1

    @property
    def _num_gates(self):
        return 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_n = self._split_gates(F, i2h)
        h2h_r, h2h_z, h2h_n = self._split_gates(F, h2h)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        cand = self._act(F, i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]


def _make(cls_base, dims, layout, doc_alias):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout=layout, activation="leaky", prefix=None,
                 params=None):
        cls_base.__init__(
            self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
            i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
            h2h_weight_initializer, i2h_bias_initializer,
            h2h_bias_initializer, dims, conv_layout, activation,
            prefix=prefix, params=params)
    name = "Conv%dD%sCell" % (dims, doc_alias)
    return type(name, (cls_base,), {
        "__init__": __init__,
        "__doc__": "%dD convolutional %s cell." % (dims, doc_alias)})


Conv1DRNNCell = _make(_ConvRNNCell, 1, "NCW", "RNN")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "NCHW", "RNN")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "NCDHW", "RNN")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "NCW", "LSTM")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "NCHW", "LSTM")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "NCDHW", "LSTM")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "NCW", "GRU")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "NCHW", "GRU")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "NCDHW", "GRU")
