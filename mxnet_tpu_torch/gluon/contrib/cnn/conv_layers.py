"""Fused conv3x3 + BatchNorm + ReLU blocks (the port of
`mxnet_tpu.gluon.contrib.cnn`'s FusedConvBNReLU and FusedConvBNReLUTrain).

Both run `_contrib_conv_bn_relu` in inference: on a GPU context the
hand-written kernel of ``csrc/conv_bn_relu.cu`` (conv, folded BN, ReLU and
residual in one pass), on a CPU context its plain version. In training,
FusedConvBNReLUTrain runs `_contrib_conv_bn_relu_train` (the batch
statistics kernel forward, the BN + ReLU backward kernel) and moves its
running statistics. Layout NHWC, stride 1, SAME padding: every interior
ResNet bottleneck conv.
"""
from __future__ import annotations

import torch

from ....base import dtype_name
from ...block import HybridBlock

__all__ = ["FusedConvBNReLU", "FusedConvBNReLUTrain"]


class FusedConvBNReLU(HybridBlock):
    """Inference-only fused conv3x3 + folded BN + ReLU (+ residual), from a
    weight (3,3,Cin,Cout) HWIO and the folded scale and shift (Cout,).
    Build it from a trained (Conv2D, BatchNorm) pair with `from_layers`.
    Call as `block(x)` or `block(x, residual)`."""

    def __init__(self, weight, scale, shift, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.weight = self.params.get("weight", shape=weight.shape,
                                          grad_req="null")
            self.scale = self.params.get("scale", shape=scale.shape,
                                         grad_req="null")
            self.shift = self.params.get("shift", shape=shift.shape,
                                         grad_req="null")
        for p, v in ((self.weight, weight), (self.scale, scale),
                     (self.shift, shift)):
            p.initialize(ctx=v.context)
            p.set_data(v)

    @classmethod
    def from_layers(cls, conv, bn, eps=None, **kwargs):
        """Fold a Conv2D (NHWC, 3x3, stride 1, pad 1, no bias) and a trained
        BatchNorm into one fused block. Any other conv raises: folding it
        would give wrong numbers, not an error."""
        from ....ndarray import NDArray
        from ....ops.fused_conv import fold_bn_params
        kw = conv._kwargs
        if kw.get("layout") != "NHWC":
            raise ValueError("FusedConvBNReLU.from_layers: layout must be "
                             "NHWC, got %r" % kw.get("layout"))
        if tuple(kw.get("kernel", ())) != (3, 3) or \
                tuple(kw.get("stride", (1, 1))) != (1, 1) or \
                tuple(kw.get("pad", (0, 0))) != (1, 1):
            raise ValueError(
                "FusedConvBNReLU.from_layers needs a 3x3/stride-1/pad-1 "
                "conv, got kernel=%s stride=%s pad=%s"
                % (kw.get("kernel"), kw.get("stride"), kw.get("pad")))
        if tuple(kw.get("dilate", (1, 1))) != (1, 1) or \
                kw.get("num_group", 1) != 1:
            raise ValueError(
                "FusedConvBNReLU.from_layers: dilated/grouped convs are not "
                "folded (dilate=%s num_group=%s)"
                % (kw.get("dilate"), kw.get("num_group")))
        if not kw.get("no_bias", False):
            raise ValueError("FusedConvBNReLU.from_layers: conv bias is not "
                             "folded; build the conv with use_bias=False")
        w = conv.weight.data()
        # Conv2D NHWC keeps weights (Cout, kh, kw, Cin): to HWIO
        w_hwio = w.data_torch.permute(1, 2, 3, 0).contiguous()
        scale, shift = fold_bn_params(
            bn.gamma.data().data_torch, bn.beta.data().data_torch,
            bn.running_mean.data().data_torch,
            bn.running_var.data().data_torch,
            eps=eps if eps is not None else bn._kwargs.get("eps", 1e-3))
        return cls(NDArray(w_hwio, w.context), NDArray(scale, w.context),
                   NDArray(shift, w.context), **kwargs)

    def hybrid_forward(self, F, x, residual=None, weight=None, scale=None,
                       shift=None):
        args = [x, weight, scale, shift]
        if residual is not None:
            args.append(residual)
        return F.contrib.conv_bn_relu(*args)


class FusedConvBNReLUTrain(HybridBlock):
    """Fused conv3x3 + BatchNorm + ReLU (+ residual), NHWC, stride 1, SAME,
    with the parameters of a Conv2D (no bias) -> BatchNorm -> relu chain:
    weight (3,3,Cin,Cout) HWIO, gamma, beta, running_mean, running_var.

    Inference folds the running statistics and runs `_contrib_conv_bn_relu`
    (the kernel on a card). Training runs `_contrib_conv_bn_relu_train`
    with the batch's statistics and moves the running statistics to ``m *
    old + (1 - m) * batch`` (`record_aux_update`). Call as `block(x)` or
    `block(x, residual)`.
    """

    def __init__(self, channels, in_channels, momentum=0.9, epsilon=1e-3,
                 weight_initializer="xavier", **kwargs):
        super().__init__(**kwargs)
        self._momentum = momentum
        self._epsilon = epsilon
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(3, 3, in_channels, channels),
                init=weight_initializer, allow_deferred_init=False)
            self.gamma = self.params.get("gamma", shape=(channels,),
                                         init="ones")
            self.beta = self.params.get("beta", shape=(channels,),
                                        init="zeros")
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(channels,),
                init="zeros", differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(channels,),
                init="ones", differentiable=False)

    def cast(self, dtype):
        # BN parameters and statistics stay fp32 (the reference's AMP keeps
        # BatchNorm fp32): a half-precision cast moves the conv weight only
        if dtype_name(dtype) in ("float16", "bfloat16"):
            self.weight.cast(dtype)
            return
        super().cast(dtype)

    def hybrid_forward(self, F, x, residual=None, weight=None, gamma=None,
                       beta=None, running_mean=None, running_var=None):
        from .... import autograd
        from ....ndarray import NDArray
        from ....ops.fused_conv import fold_bn_params
        from ...nn.basic_layers import update_running_stats
        args = [x, weight]
        if not autograd.is_training():
            with torch.no_grad():
                scale, shift = fold_bn_params(
                    gamma.data_torch, beta.data_torch,
                    running_mean.data_torch, running_var.data_torch,
                    eps=self._epsilon)
            args += [NDArray(scale, x.context), NDArray(shift, x.context)]
            if residual is not None:
                args.append(residual)
            return F.contrib.conv_bn_relu(*args)
        args += [gamma, beta]
        if residual is not None:
            args.append(residual)
        out, mean, var = F.contrib.conv_bn_relu_train(*args,
                                                      eps=self._epsilon)
        update_running_stats(running_mean, running_var, mean, var,
                             self._momentum)
        return out
