"""Neural-net ops of the ResNet and BERT paths (the port of the part of
`mxnet_tpu.ops.nn` that Gluon's ResNet and BERT layers and the losses
call): FullyConnected, Convolution, Pooling, BatchNorm (inference and
training), LayerNorm, Activation, LeakyReLU, softmax, log_softmax,
Dropout, the interleaved self-attention products and ctc_loss (the
reference's ``optax.ctc_loss`` there, ``F.ctc_loss`` here); and the
training-output heads of symbolic graphs: SoftmaxOutput (alias Softmax),
LinearRegressionOutput, LogisticRegressionOutput, MAERegressionOutput and
MakeLoss, whose hand-written gradients live in `torch.autograd.Function`s
(the reference's custom VJPs).

They are XLA ops in the reference, outside any Pallas kernel, so they stay
`torch.nn.functional` calls here. A float32 convolution on the card runs
with cuDNN's TF32 switch off (`cudnn_fp32`): cuDNN would otherwise round
fp32 operands to TF32, about three decimal digits, where the reference
keeps fp32. The switch is scoped to the port's own convolutions, forward
and backward (`_FP32Conv2d` runs its backward inside the scope too), and
the caller's setting of ``torch.backends.cudnn.allow_tf32`` is restored
after each.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import alias, register


def _pair(v, n):
    if v is None:
        return (0,) * n
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v if len(v) == n else v * n


def layout_info(layout, nd, op="Convolution"):
    """Validate an MXNet layout string for nd spatial dims. Returns
    (layout, channels_last)."""
    spatial = "DHW"[3 - nd:]
    if layout is None:
        layout = "NC" + spatial
    if layout == "NC" + spatial:
        return layout, False
    if layout == "N" + spatial + "C":
        return layout, True
    raise ValueError("%s: unsupported layout %r for %dD (expected %r or %r)"
                     % (op, layout, nd, "NC" + spatial,
                        "N" + spatial + "C"))


def _to_nchw(x, last):
    return x.permute(0, 3, 1, 2) if last else x


def _from_nchw(x, last):
    return x.permute(0, 2, 3, 1).contiguous() if last else x


@register("FullyConnected")
def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True):
    """y = x W^T + b; weight is (num_hidden, in_units) like the
    reference."""
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    b = None if no_bias else bias
    # mixed dtypes promote as in the reference (bf16 x fp32 -> fp32)
    dt = torch.promote_types(x.dtype, weight.dtype)
    if b is not None:
        dt = torch.promote_types(dt, b.dtype)
    return F.linear(x.to(dt), weight.to(dt), None if b is None else b.to(dt))


@contextlib.contextmanager
def cudnn_fp32():
    """cuDNN's TF32 switch off for the convolutions run inside; the
    caller's setting restored on exit."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _FP32Conv2d(torch.autograd.Function):
    """F.conv2d with its forward and its backward inside `cudnn_fp32`:
    autograd's own convolution backward would read the global switch when
    the backward runs, not when the forward ran. The backward is the one
    autograd runs for F.conv2d (`aten.convolution_backward` on the same
    tensors), so gradients and their memory layout are unchanged."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups, b is not None)
        with cudnn_fp32():
            return F.conv2d(x, w, b, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, has_bias = ctx.conf
        need = ctx.needs_input_grad
        with cudnn_fp32():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]] if has_bias else None, stride, padding,
                dilation, False, [0] * len(stride), groups,
                [need[0], need[1], has_bias and need[2]])
        return dx, dw, db, None, None, None, None


@register("Convolution")
def _convolution(data, weight, bias=None, kernel=None, stride=None,
                 dilate=None, pad=None, num_filter=None, num_group=1,
                 no_bias=False, layout=None, cudnn_tune=None, cudnn_off=None,
                 workspace=None):
    """2-D convolution in NCHW (weight OIHW) or NHWC (weight OHWI, the
    reference's channels-last weight layout)."""
    nd = data.dim() - 2
    if nd != 2:
        raise NotImplementedError("Convolution: only 2-D convolutions are "
                                  "ported so far, got %d-D" % nd)
    _, last = layout_info(layout, nd)
    w = weight.permute(0, 3, 1, 2) if last else weight
    out = _FP32Conv2d.apply(_to_nchw(data, last), w,
                            None if no_bias else bias,
                            _pair(stride if stride else 1, nd),
                            _pair(pad if pad else 0, nd),
                            _pair(dilate if dilate else 1, nd), num_group)
    return _from_nchw(out, last)


@register("Pooling")
def _pooling(data, kernel=None, pool_type="max", global_pool=False,
             stride=None, pad=None, pooling_convention="valid",
             count_include_pad=True, cudnn_off=None, layout=None):
    """max / avg pooling, global or windowed ("valid" or "full" output
    size), in NCHW or NHWC."""
    nd = data.dim() - 2
    _, last = layout_info(layout, nd, "Pooling")
    axes = tuple(range(1, 1 + nd)) if last else tuple(range(2, data.dim()))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=axes, keepdim=True)
        raise ValueError("unknown pool_type " + pool_type)
    if nd != 2:
        raise NotImplementedError("Pooling: only 2-D windows are ported so "
                                  "far, got %d-D" % nd)
    kernel = _pair(kernel, nd)
    stride = _pair(stride if stride else 1, nd)
    pad = _pair(pad if pad else 0, nd)
    x = _to_nchw(data, last)
    # explicit (low, high) padding per spatial dim; "full" (ceil mode) pads
    # the high side far enough to cover the last window, as the reference
    spans = []
    for i in range(nd):
        size = x.shape[2 + i]
        hi = pad[i]
        if pooling_convention == "full":
            out = -(-(size + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            hi = max(pad[i], (out - 1) * stride[i] + kernel[i] - size
                     - pad[i])
        spans.append((pad[i], hi))
    flat = [p for lo_hi in reversed(spans) for p in lo_hi]
    if pool_type == "max":
        x = F.pad(x, flat, value=float("-inf"))
        out = F.max_pool2d(x, kernel, stride)
    elif pool_type == "avg":
        out = F.avg_pool2d(F.pad(x, flat), kernel, stride)
        if not count_include_pad:
            ones = F.pad(torch.ones_like(x[:1, :1]), flat)
            out = out / F.avg_pool2d(ones, kernel, stride)
    else:
        raise ValueError("unknown pool_type " + pool_type)
    return _from_nchw(out, last)


alias("Pooling", "pooling")


@register("BatchNorm")
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=None):
    """Normalization math in fp32, output in the input dtype; with
    `use_global_stats` the moving statistics, else the batch's, with the
    reference's two-pass variance ``mean((x - mean)^2)`` (the moving-average
    update is the caller's). `output_mean_var` also returns the statistics
    used."""
    ax = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    x32 = data.float()
    if use_global_stats:
        mean, var = moving_mean, moving_var
    else:
        mean = x32.mean(dim=red)
        centered = x32 - mean.reshape(shape)
        var = (centered * centered).mean(dim=red)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(var.float() + eps)
    out = ((x32 - mean.reshape(shape).float()) * inv.reshape(shape)
           * g.reshape(shape).float()
           + beta.reshape(shape).float()).to(data.dtype)
    if output_mean_var:
        return out, mean, var
    return out


@register("LayerNorm")
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalized in fp32 and cast to the input dtype, THEN scaled and
    shifted in that dtype, as the reference does
    (`torch.nn.functional.layer_norm` would apply gamma and beta before the
    cast, which rounds bf16 differently)."""
    x32 = data.float()
    mean = x32.mean(dim=axis, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=axis, keepdim=True)
    out = (centered * torch.rsqrt(var + eps)).to(data.dtype)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = out * gamma.reshape(shape) + beta.reshape(shape)
    if output_mean_var:
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


def _gelu_erf(x):
    return F.gelu(x, approximate="none")


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign, "gelu": _gelu_erf}


@register("Activation")
def _activation(data, act_type="relu"):
    if act_type not in _ACTIVATIONS:
        raise ValueError("unknown act_type " + act_type)
    return _ACTIVATIONS[act_type](data)


@register("LeakyReLU")
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    """leaky and gelu (exact, erf); the other act_types come with later
    slices."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "gelu":
        return _gelu_erf(data)
    raise NotImplementedError("LeakyReLU: act_type %r is not ported"
                              % act_type)


@register("softmax")
def _softmax(data, axis=-1, temperature=None, length=None, use_length=False,
             dtype=None):
    """softmax computed in fp32, returned in `dtype` (default the
    input's)."""
    if use_length:
        raise NotImplementedError("softmax(use_length=True) is not ported")
    x = data
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    out = torch.softmax(x.float(), dim=axis)
    return out.to(torch_dtype(dtype) if dtype else data.dtype)


@register("Dropout", random=True)
def _dropout(data, p=0.5, mode="training", axes=None, cudnn_off=None,
             _training=None):
    """Each element kept with probability 1 - p and scaled by 1 / (1 - p)
    while training (or always, mode="always"); the identity otherwise.
    `axes` share one draw along those axes. The draw comes from the
    context's generator (`mx.random`), so it follows `mx.random.seed` but
    not the reference's JAX stream."""
    from .. import autograd
    from ..context import context_of
    from ..random import generator
    training = _training if _training is not None else autograd.is_training()
    if (not training and mode != "always") or p <= 0.0:
        return data
    shape = list(data.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = 1.0 - p
    u = torch.rand(shape, generator=generator(context_of(data.device)),
                   device=data.device)
    return data * (u < keep).to(data.dtype) / keep


def _split_interleaved(qkv, heads, which):
    """(seq, batch, heads*3*hd), interleaved per head -> (batch*heads, seq,
    hd) of q (0), k (1) or v (2)."""
    s, b, e = qkv.shape
    hd = e // (heads * 3)
    t = qkv.reshape(s, b, heads, 3, hd)[:, :, :, which, :]
    return t.permute(1, 2, 0, 3).reshape(b * heads, s, hd)


@register("_contrib_interleaved_matmul_selfatt_qk")
def _interleaved_matmul_selfatt_qk(queries_keys_values, heads=None):
    """scores[b*h, q, k] = (q / sqrt(hd)) . k, q scaled in its own dtype
    before the product, as the reference does."""
    q = _split_interleaved(queries_keys_values, heads, 0)
    k = _split_interleaved(queries_keys_values, heads, 1)
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    return torch.bmm(q * scale.to(q.device), k.transpose(1, 2))


@register("_contrib_interleaved_matmul_selfatt_valatt")
def _interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                       heads=None):
    """(attention @ v) regrouped to (seq, batch, heads*hd)."""
    s, b, e = queries_keys_values.shape
    hd = e // (heads * 3)
    v = _split_interleaved(queries_keys_values, heads, 2)
    dt = torch.promote_types(attention.dtype, v.dtype)
    out = torch.bmm(attention.to(dt), v.to(dt))
    return out.reshape(b, heads, s, hd).permute(2, 0, 1, 3).reshape(
        s, b, heads * hd)


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None, dtype=None):
    """log_softmax in fp32, returned in `dtype` (default the input's)."""
    x = data if not temperature or temperature == 1.0 else data / temperature
    out = torch.log_softmax(x.float(), dim=axis)
    return out.to(torch_dtype(dtype) if dtype else data.dtype)


@register("ctc_loss", arity=None)
def _ctc_loss(data, label, data_lengths=None, label_lengths=None):
    """CTC negative log-likelihood per sequence of TNC logits `data`
    against NT labels, the blank the last class: a label below 0 is
    padding (its row's length is its count of labels >= 0) unless
    `label_lengths` is given; `data_lengths` cuts each row's frames."""
    T, N, C = data.shape
    logp = torch.log_softmax(data.float(), dim=-1)
    lab = label.long()
    if data_lengths is None:
        in_len = torch.full((N,), T, dtype=torch.long, device=data.device)
    else:
        in_len = data_lengths.long()
    if label_lengths is None:
        tgt_len = (lab >= 0).sum(dim=1)
    else:
        tgt_len = label_lengths.long()
    out = F.ctc_loss(logp, lab.clamp(min=0), in_len, tgt_len, blank=C - 1,
                     reduction="none")
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# training-output heads (reference: softmax_output.cc, regression_output.cc,
# make_loss.cc): the backward is the hand-coded loss gradient, not the
# derivative of the forward, and the incoming cotangent is ignored (except
# by MakeLoss, which scales it)
# ---------------------------------------------------------------------------
def _onehot_along(label, depth, axis, like):
    """onehot(label) with the classes along `axis` of `like`; a label
    outside [0, depth) gives a row of zeros, as ``jax.nn.one_hot``."""
    lab = label.long().unsqueeze(axis)
    shape = [1] * like.dim()
    shape[axis] = depth
    classes = torch.arange(depth, device=like.device).reshape(shape)
    return (lab == classes).to(like.dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    """softmax forward; backward (softmax - onehot(label)) * grad_scale,
    masked by `use_ignore` and divided by the batch ("batch") or the count
    of kept labels ("valid", with `use_ignore`)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, normalization, smooth_alpha):
        axis = 1 if multi_output else data.dim() - 1
        out = torch.softmax(data.float(), dim=axis).to(data.dtype)
        ctx.save_for_backward(out, label)
        ctx.cfg = (axis, grad_scale, ignore_label, use_ignore,
                   normalization, smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        axis, grad_scale, ignore_label, use_ignore, normalization,             smooth_alpha = ctx.cfg
        depth = out.shape[axis]
        oh = _onehot_along(label, depth, axis, out)
        if smooth_alpha:
            oh = oh * (1 - smooth_alpha) + smooth_alpha / depth
        grad = (out - oh) * grad_scale
        keep = None
        if use_ignore:
            keep = (label != ignore_label).to(out.dtype).unsqueeze(axis)
            grad = grad * keep
        if normalization == "batch":
            grad = grad / out.shape[0]
        elif normalization == "valid" and keep is not None:
            grad = grad / torch.clamp(keep.sum(), min=1.0)
        return grad, None, None, None, None, None, None, None


@register("SoftmaxOutput")
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """softmax over the last axis (axis 1 with `multi_output`); its
    gradient is the fused cross-entropy one (`_SoftmaxOutputFn`)."""
    return _SoftmaxOutputFn.apply(data, label, float(grad_scale),
                                  float(ignore_label), bool(multi_output),
                                  bool(use_ignore), str(normalization),
                                  float(smooth_alpha))


alias("SoftmaxOutput", "Softmax")


class _RegressionOutputFn(torch.autograd.Function):
    """forward `kind`'s map of data; backward residual(out, label) *
    grad_scale / (elements per example)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.cfg = (kind, grad_scale, tuple(data.shape), data.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        kind, grad_scale, shape, dtype = ctx.cfg
        num_output = 1
        for s in shape[1:]:
            num_output *= s
        lab = label.reshape(shape).to(out.dtype)
        res = torch.sign(out - lab) if kind == "mae" else out - lab
        grad = res * (grad_scale / num_output)
        return grad.to(dtype), None, None, None


def _regression_output(kind):
    def fn(data, label, grad_scale=1.0):
        return _RegressionOutputFn.apply(data, label, kind, float(grad_scale))
    return fn


register("LinearRegressionOutput")(_regression_output("linear"))
register("MAERegressionOutput")(_regression_output("mae"))
register("LogisticRegressionOutput")(_regression_output("logistic"))


class _MakeLossFn(torch.autograd.Function):
    """Identity forward; the cotangent times grad_scale, divided by the
    batch ("batch") or by the count of |data| > valid_thresh ("valid")."""

    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        valid = None
        if normalization == "valid":
            valid = torch.clamp((data.float().abs() > valid_thresh)
                                .float().sum(), min=1.0)
        ctx.cfg = (grad_scale, normalization, valid)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        gs, normalization, valid = ctx.cfg
        if normalization == "batch":
            gs = gs / g.shape[0]
        grad = g * gs
        if valid is not None:
            grad = grad / valid.to(g.dtype)
        return grad, None, None, None


@register("MakeLoss")
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    if float(grad_scale) == 1.0 and normalization == "null":
        return data
    return _MakeLossFn.apply(data, float(grad_scale), float(valid_thresh),
                             str(normalization))
