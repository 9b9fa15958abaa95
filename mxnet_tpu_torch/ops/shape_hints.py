"""Parameter-shape inference hints (the port of `mxnet_tpu.ops.shape_hints`).

The input-filling half of the reference's FInferShape attributes: given the
known input shapes of an op (None = unknown) and its hyper-parameters, fill
the parameter shapes. Symbolic `infer_shape` and `simple_bind` use them.

The output shapes come from running each op's plain version on `meta`
tensors. Two ops cannot run there, because their output's size depends on
their input's values: `boolean_mask` and `where_index`. As in the
reference, a symbolic graph that holds them cannot infer its shapes.
"""
from __future__ import annotations

from . import registry as _reg


def _prod(xs):
    p = 1
    for x in xs:
        p *= x
    return p


def _hint(*names):
    def deco(fn):
        for name in names:
            _reg.get(name).shape_hint = fn
        return fn
    return deco


@_hint("FullyConnected")
def _fc_hint(shapes, kw):
    data = shapes[0]
    if data is None:
        return shapes
    num_hidden = kw.get("num_hidden")
    in_units = _prod(data[1:]) if kw.get("flatten", True) else data[-1]
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (num_hidden, in_units)
    if len(out) > 2 and out[2] is None:
        out[2] = (num_hidden,)
    return out


@_hint("Convolution")
def _conv_hint(shapes, kw):
    data = shapes[0]
    if data is None:
        return shapes
    num_filter = kw.get("num_filter")
    num_group = kw.get("num_group", 1)
    kernel = tuple(kw.get("kernel"))
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        if kw.get("layout") in ("NHWC", "NWC", "NDHWC"):
            out[1] = (num_filter,) + kernel + (data[-1] // num_group,)
        else:
            out[1] = (num_filter, data[1] // num_group) + kernel
    if len(out) > 2 and out[2] is None:
        out[2] = (num_filter,)
    return out


@_hint("Deconvolution")
def _deconv_hint(shapes, kw):
    """weight (C_in, num_filter / num_group, *kernel), bias (num_filter,)."""
    data = shapes[0]
    if data is None:
        return shapes
    num_filter = kw.get("num_filter")
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (data[1], num_filter // kw.get("num_group", 1)) \
            + tuple(kw.get("kernel"))
    if len(out) > 2 and out[2] is None:
        out[2] = (num_filter,)
    return out


def _channel_hint(axis_key="axis", default_axis=1):
    def hint(shapes, kw):
        data = shapes[0]
        if data is None:
            return shapes
        axis = kw.get(axis_key, default_axis)
        c = data[axis % len(data)]
        return [shapes[0]] + [(c,) if s is None else s for s in shapes[1:]]
    return hint


_reg.get("BatchNorm").shape_hint = _channel_hint("axis", 1)
_reg.get("LayerNorm").shape_hint = _channel_hint("axis", -1)
_reg.get("InstanceNorm").shape_hint = _channel_hint("axis", 1)
_reg.get("GroupNorm").shape_hint = _channel_hint("axis", 1)
_reg.get("RMSNorm").shape_hint = _channel_hint("axis", -1)


@_hint("Embedding")
def _embedding_hint(shapes, kw):
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (kw.get("input_dim"), kw.get("output_dim"))
    return out


@_hint("SoftmaxOutput")
def _softmax_output_hint(shapes, kw):
    data = shapes[0]
    if data is None:
        return shapes
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        if kw.get("multi_output"):
            out[1] = (data[0],) + tuple(data[2:])
        else:
            out[1] = tuple(data[:-1])
    return out


@_hint("LinearRegressionOutput", "MAERegressionOutput",
       "LogisticRegressionOutput")
def _linreg_hint(shapes, kw):
    data = shapes[0]
    if data is None:
        return shapes
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = data
    return out


@_hint("LeakyReLU")
def _leaky_hint(shapes, kw):
    data = shapes[0]
    if data is None or kw.get("act_type") != "prelu":
        return shapes
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (data[1],)
    return out


@_hint("RNN")
def _rnn_hint(shapes, kw):
    """The flat parameter vector's length and the begin states' shapes
    (layers * directions, N, state_size) from the TNC data shape."""
    data = shapes[0]
    if data is None:
        return shapes
    from .rnn_ops import rnn_param_size
    h = kw.get("state_size")
    L = kw.get("num_layers", 1)
    ndir = 2 if kw.get("bidirectional") else 1
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (rnn_param_size(kw.get("mode", "lstm"), data[2], h, L,
                                 kw.get("bidirectional", False)),)
    for i in (2, 3):
        if len(out) > i and out[i] is None:
            out[i] = (L * ndir, data[1], h)
    return out
