"""Convolution and pooling layers (the port of
`mxnet_tpu.gluon.nn.conv_layers`): Conv1D/2D/3D, their transposes
(channels first only, weight (in, out / groups, *kernel), on the
`Deconvolution` op), max, average and global pools in 1, 2 and 3
dimensions, and ReflectionPad2D. Convolutions and pools take the
channels-first (NCW/NCHW/NCDHW) or channels-last (NWC/NHWC/NDHWC) layout.

A transposed convolution here is upstream MXNet's: the reference's
correlates with the kernel unflipped, so a reference `Conv*DTranspose`
weight means this block's weight flipped on its spatial axes
(`models.convert.gluon_params_from_jax` flips it on the way over)."""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _to_tuple(x, n):
    if isinstance(x, int):
        return (x,) * n
    if len(x) != n:
        raise ValueError("expected %d values, got %s" % (n, x))
    return tuple(x)


class _Conv(HybridBlock):
    """Base conv: weight (O, I/groups, *k) channels-first, (O, *k,
    I/groups) channels-last, as the reference; a transposed one
    (`op_name` "Deconvolution") holds (I, O/groups, *k)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            from ...ops.nn import layout_info
            _, self._channels_last = layout_info(
                layout, len(kernel_size), type(self).__name__)
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj
            self._op_name = op_name
            if op_name == "Deconvolution" and self._channels_last:
                raise ValueError("Deconvolution supports channels-first "
                                 "layouts only")
            wshape = self._weight_shape(in_channels)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _weight_shape(self, in_channels):
        k = self._kwargs["kernel"]
        groups = self._kwargs["num_group"]
        if self._op_name == "Deconvolution":
            return (in_channels, self._channels // groups) + k
        if self._channels_last:
            return (self._channels,) + k + (in_channels // groups,)
        return (self._channels, in_channels // groups) + k

    def _shape_from_input(self, x, *args):
        in_channels = x.shape[-1 if self._channels_last else 1]
        self.weight.shape = self._weight_shape(in_channels)
        self._in_channels = in_channels

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, **self._kwargs)
        else:
            act = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 2),
                         _to_tuple(strides, 2), _to_tuple(padding, 2),
                         _to_tuple(dilation, 2), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 1),
                         _to_tuple(strides, 1), _to_tuple(padding, 1),
                         _to_tuple(dilation, 1), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 3),
                         _to_tuple(strides, 3), _to_tuple(padding, 3),
                         _to_tuple(dilation, 3), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    """Transposed convolution on the `Deconvolution` op; `output_padding`
    goes to the op as `adj`."""

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, in_channels,
                 activation, use_bias, weight_initializer, bias_initializer,
                 **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)
        self.outpad = output_padding
        self.out_pad = output_padding


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 1),
                         _to_tuple(strides, 1), _to_tuple(padding, 1),
                         _to_tuple(output_padding, 1), _to_tuple(dilation, 1),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 2),
                         _to_tuple(strides, 2), _to_tuple(padding, 2),
                         _to_tuple(output_padding, 2), _to_tuple(dilation, 2),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 3),
                         _to_tuple(strides, 3), _to_tuple(padding, 3),
                         _to_tuple(output_padding, 3), _to_tuple(dilation, 3),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    """Base pool. `count_include_pad` reaches the op only when given (the
    average pools give True by default, as the reference)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        from ...ops.nn import layout_info
        layout_info(layout, len(pool_size), type(self).__name__)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "layout": layout,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "{name}(size={kernel}, stride={stride}, padding={pad}, " \
            "ceil_mode={ceil_mode})".format(
                name=self.__class__.__name__,
                ceil_mode=self._kwargs["pooling_convention"] == "full",
                **self._kwargs)


def _pool_args(n, pool_size, strides, padding):
    return (_to_tuple(pool_size, n),
            strides if strides is None else _to_tuple(strides, n),
            _to_tuple(padding, n))


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(*_pool_args(1, pool_size, strides, padding),
                         ceil_mode, False, "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(*_pool_args(2, pool_size, strides, padding),
                         ceil_mode, False, "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(*_pool_args(3, pool_size, strides, padding),
                         ceil_mode, False, "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(*_pool_args(1, pool_size, strides, padding),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_pool_args(2, pool_size, strides, padding),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_pool_args(3, pool_size, strides, padding),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class _GlobalPooling(_Pooling):
    def __init__(self, n, pool_type, layout, **kwargs):
        super().__init__((1,) * n, None, (0,) * n, True, True, pool_type,
                         layout, **kwargs)


class GlobalMaxPool1D(_GlobalPooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "max", layout, **kwargs)


class GlobalMaxPool2D(_GlobalPooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "max", layout, **kwargs)


class GlobalMaxPool3D(_GlobalPooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "max", layout, **kwargs)


class GlobalAvgPool1D(_GlobalPooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "avg", layout, **kwargs)


class GlobalAvgPool2D(_GlobalPooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "avg", layout, **kwargs)


class GlobalAvgPool3D(_GlobalPooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "avg", layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the last two axes of an NCHW input: an int
    pads each side by it, else the `pad` op's 8-tuple."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
