"""Convolution and pooling layers (the port of the part of
`mxnet_tpu.gluon.nn.conv_layers` that the ResNets use): Conv2D, MaxPool2D,
GlobalAvgPool2D, in the channels-first (NCHW) or channels-last (NHWC)
layout."""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _to_tuple(x, n):
    if isinstance(x, int):
        return (x,) * n
    if len(x) != n:
        raise ValueError("expected %d values, got %s" % (n, x))
    return tuple(x)


class _Conv(HybridBlock):
    """Base conv: weight (O, I/groups, *k) channels-first, (O, *k,
    I/groups) channels-last, as the reference."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
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
            if self._channels_last:
                wshape = (channels,) + kernel_size + (in_channels // groups,)
            else:
                wshape = (channels, in_channels // groups) + kernel_size
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

    def _shape_from_input(self, x, *args):
        in_channels = x.shape[-1 if self._channels_last else 1]
        k = self._kwargs["kernel"]
        groups = self._kwargs["num_group"]
        if self._channels_last:
            self.weight.shape = (self._channels,) + k + \
                (in_channels // groups,)
        else:
            self.weight.shape = (self._channels, in_channels // groups) + k
        self._in_channels = in_channels

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            act = F.Convolution(x, weight, **self._kwargs)
        else:
            act = F.Convolution(x, weight, bias, **self._kwargs)
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


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, **kwargs):
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

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_to_tuple(pool_size, 2),
                         strides if strides is None else _to_tuple(strides, 2),
                         _to_tuple(padding, 2), ceil_mode, False, "max",
                         layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", layout,
                         **kwargs)
