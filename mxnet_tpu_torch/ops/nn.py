"""Neural-net ops (the port of `mxnet_tpu.ops.nn`): FullyConnected,
Convolution (1-, 2- and 3-D) and Deconvolution, Pooling (1-, 2- and 3-D;
max, avg, sum, lp), BatchNorm (inference and training; alias
BatchNorm_v1), LayerNorm, InstanceNorm, GroupNorm, L2Normalization,
RMSNorm, Activation, LeakyReLU (every act_type, rrelu as upstream),
hard_sigmoid, softmax (with lengths), softmin, SoftmaxActivation,
softmax_cross_entropy, log_softmax, UpSampling, BilinearSampler,
GridGenerator, ROIPooling, Correlation, dot_scaled, crop,
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
and backward (`_FP32Conv` runs its backward inside the scope too), and
the caller's setting of ``torch.backends.cudnn.allow_tf32`` is restored
after each.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from ..random import generator_of
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
    """Channels-last (N, *spatial, C) -> channels-first."""
    if not last:
        return x
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _from_nchw(x, last):
    if not last:
        return x
    return x.permute(0, *range(2, x.dim()), 1).contiguous()


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


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


class _FP32Conv(torch.autograd.Function):
    """A 1-, 2- or 3-D convolution, or its transpose, with its forward and
    its backward inside `cudnn_fp32`: autograd's own convolution backward
    would read the global switch when the backward runs, not when the
    forward ran. The forward is F.conv*d / F.conv_transpose*d and the
    backward the one autograd runs for them (`aten.convolution_backward`
    on the same tensors), so values, gradients and their memory layout
    are unchanged."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups,
                transposed=False, output_padding=None):
        output_padding = output_padding or [0] * len(stride)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups, b is not None,
                    transposed, output_padding)
        nd = x.dim() - 2
        with cudnn_fp32():
            if transposed:
                return getattr(F, "conv_transpose%dd" % nd)(
                    x, w, b, stride, padding, output_padding, groups,
                    dilation)
            return getattr(F, "conv%dd" % nd)(x, w, b, stride, padding,
                                              dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, has_bias, transposed, \
            output_padding = ctx.conf
        need = ctx.needs_input_grad
        with cudnn_fp32():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[1] * groups if transposed else w.shape[0]]
                if has_bias else None, stride, padding, dilation,
                transposed, output_padding, groups,
                [need[0], need[1], has_bias and need[2]])
        return dx, dw, db, None, None, None, None, None, None


@register("Convolution")
def _convolution(data, weight, bias=None, kernel=None, stride=None,
                 dilate=None, pad=None, num_filter=None, num_group=1,
                 no_bias=False, layout=None, cudnn_tune=None, cudnn_off=None,
                 workspace=None):
    """1-, 2- or 3-D convolution, channels first (NCW/NCHW/NCDHW, weight
    OI+spatial) or channels last (weight O+spatial+I, the reference's
    channels-last weight layout)."""
    nd = data.dim() - 2
    _, last = layout_info(layout, nd)
    out = _FP32Conv.apply(_to_nchw(data, last), _to_nchw(weight, last),
                          None if no_bias else bias,
                          _pair(stride if stride else 1, nd),
                          _pair(pad if pad else 0, nd),
                          _pair(dilate if dilate else 1, nd), num_group)
    return _from_nchw(out, last)


@register("Deconvolution")
def _deconvolution(data, weight, bias=None, kernel=None, stride=None,
                   dilate=None, pad=None, adj=None, num_filter=None,
                   num_group=1, no_bias=True, target_shape=None, layout=None,
                   cudnn_tune=None, cudnn_off=None, workspace=None):
    """The transposed convolution (the gradient of `Convolution` with
    respect to its data), channels first, weight (C_in, C_out / group,
    *kernel), as upstream MXNet: out = (in - 1) stride - 2 pad +
    dilate (kernel - 1) + adj + 1. The reference correlates the dilated
    input with the kernel unflipped, which is this op on the kernel
    flipped in space (the tests hold the port to that). `target_shape` is
    accepted and not read, as in the reference."""
    nd = len(kernel) if kernel is not None else data.dim() - 2
    _, last = layout_info(layout, nd, "Deconvolution")
    if last:
        raise NotImplementedError(
            "Deconvolution: channels-last layouts not implemented")
    return _FP32Conv.apply(data, weight, None if no_bias else bias,
                           _pair(stride if stride else 1, nd),
                           _pair(pad if pad else 0, nd),
                           _pair(dilate if dilate else 1, nd), num_group,
                           True, list(_pair(adj if adj else 0, nd)))


@register("Pooling")
def _pooling(data, kernel=None, pool_type="max", global_pool=False,
             stride=None, pad=None, pooling_convention="valid",
             count_include_pad=True, cudnn_off=None, layout=None, p_value=2):
    """max / avg / sum / lp pooling over 1, 2 or 3 spatial dims, windowed
    ("valid" or "full" output size) or global (max, else the mean, as the
    reference), channels first or last."""
    nd = data.dim() - 2
    _, last = layout_info(layout, nd, "Pooling")
    axes = tuple(range(1, 1 + nd)) if last else tuple(range(2, data.dim()))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError("unknown pool_type " + pool_type)
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
    area = math.prod(kernel)
    if pool_type == "max":
        out = _MAX_POOL[nd](F.pad(x, flat, value=float("-inf")), kernel,
                            stride)
    elif pool_type == "lp":
        out = (_AVG_POOL[nd](F.pad(x.abs() ** p_value, flat), kernel, stride)
               * area) ** (1.0 / p_value)
    else:
        out = _AVG_POOL[nd](F.pad(x, flat), kernel, stride)
        if pool_type == "sum":
            out = out * area
        elif not count_include_pad:
            ones = F.pad(torch.ones_like(x[:1, :1]), flat)
            out = out / _AVG_POOL[nd](ones, kernel, stride)
    return _from_nchw(out, last)


alias("Pooling", "pooling")


def _stats_group():
    from ..parallel.collectives import batch_stats_group
    return batch_stats_group()


@register("BatchNorm")
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=None):
    """Normalization math in fp32, output in the input dtype; with
    `use_global_stats` the moving statistics, else the batch's, with the
    reference's two-pass variance ``mean((x - mean)^2)`` (the moving-average
    update is the caller's). Inside a data-parallel `FusedTrainStep` over
    several ranks the batch is the global one: both passes' per-channel
    sums and the row count are all-reduced (`parallel.collectives
    .batch_stats_scope`), with the cotangents all-reduced back.
    `output_mean_var` also returns the statistics used."""
    ax = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    x32 = data.float()
    group = None if use_global_stats else _stats_group()
    if use_global_stats:
        mean, var = moving_mean, moving_var
    elif group is not None:
        # the global batch's statistics: the sums (and rows) all-reduced,
        # differentiably, then the same two passes
        from ..parallel.collectives import all_reduce_sum
        sums = x32.sum(dim=red)
        tot = all_reduce_sum(torch.cat(
            [sums, sums.new_full((1,), x32.numel() // x32.shape[ax])]),
            group)
        count = tot[-1]
        mean = tot[:-1] / count
        centered = x32 - mean.reshape(shape)
        var = all_reduce_sum((centered * centered).sum(dim=red),
                             group) / count
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
                "softsign": F.softsign, "gelu": _gelu_erf,
                "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
                "silu": F.silu, "swish": F.silu}


@register("Activation")
def _activation(data, act_type="relu"):
    if act_type not in _ACTIVATIONS:
        raise ValueError("unknown act_type " + act_type)
    return _ACTIVATIONS[act_type](data)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU")
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    """leaky (slope x below 0), prelu (the learned per-channel gamma), elu
    (slope (e^x - 1)), selu, gelu (exact, erf) and rrelu: a slope drawn
    from U(lower_bound, upper_bound) for each element while training (from
    the context's generator), their mean otherwise, as upstream MXNet (the
    reference raises for rrelu)."""
    neg = data >= 0
    if act_type == "leaky":
        return torch.where(neg, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(neg, data, g * data)
    if act_type == "elu":
        return torch.where(neg, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(neg, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return _gelu_erf(data)
    if act_type == "rrelu":
        from .. import autograd
        if not autograd.is_training():
            return torch.where(neg, data,
                               (lower_bound + upper_bound) / 2.0 * data)
        u = torch.rand(data.shape, generator=generator_of(data.device),
                       device=data.device)
        a = (lower_bound + (upper_bound - lower_bound) * u).to(data.dtype)
        return torch.where(neg, data, a * data)
    raise ValueError("unknown act_type " + act_type)


@register("softmax")
def _softmax(data, axis=-1, temperature=None, length=None, use_length=False,
             dtype=None):
    """softmax computed in fp32, returned in `dtype` (default the
    input's); with `use_length`, the steps at or past each row's `length`
    along `axis` are left out (they read 0)."""
    x = data
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if use_length and length is not None:
        steps = torch.arange(x.shape[axis], device=x.device)
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        mask = steps.reshape(shape) < length.reshape(
            tuple(length.shape) + (1,) * (x.dim() - length.dim()))
        x = torch.where(mask, x, torch.full((), float("-inf"),
                                            dtype=x.dtype, device=x.device))
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
    training = _training if _training is not None else autograd.is_training()
    if (not training and mode != "always") or p <= 0.0:
        return data
    shape = list(data.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = 1.0 - p
    u = torch.rand(shape, generator=generator_of(data.device),
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


alias("BatchNorm", "BatchNorm_v1")


# ---------------------------------------------------------------------------
# the other norms, activations and softmax forms
# ---------------------------------------------------------------------------
def _var(x, dims):
    return x.var(dim=dims, unbiased=False, keepdim=True)


@register("InstanceNorm")
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Each (example, channel) normalized over its spatial dims, in the
    input's dtype."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    out = (data - mean) * torch.rsqrt(_var(data, red) + eps)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("GroupNorm")
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Each example's channel groups normalized over the group and the
    spatial dims; gamma and beta per channel."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + tuple(data.shape[2:]))
    red = tuple(range(2, x.dim()))
    x = (x - x.mean(dim=red, keepdim=True)) * torch.rsqrt(_var(x, red) + eps)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return x.reshape(data.shape) * gamma.reshape(shape) + beta.reshape(shape)


@register("L2Normalization")
def _l2_normalization(data, eps=1e-10, mode="instance"):
    """x / sqrt(sum(x^2) + eps) over each example ("instance"), the
    channels ("channel") or the spatial dims ("spatial")."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    return data / torch.sqrt(data.square().sum(dim=red, keepdim=True) + eps)


@register("RMSNorm")
def _rms_norm(data, gamma, axis=-1, eps=1e-6):
    """x / rms(x) in fp32, cast to the input dtype, then times gamma."""
    x32 = data.float()
    ms = x32.square().mean(dim=axis, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(data.dtype) * gamma


@register("hard_sigmoid")
def _hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("softmin")
def _softmin(data, axis=-1):
    return torch.softmax(-data, dim=axis)


@register("SoftmaxActivation")
def _softmax_activation(data, mode="instance"):
    """softmax over the channels (axis 1, "channel") or over each
    flattened example ("instance")."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """sum over the rows of logsumexp(row) - row[label]."""
    picked = torch.gather(data, -1, label.long()[..., None])[..., 0]
    return (torch.logsumexp(data, dim=-1) - picked).sum()


# ---------------------------------------------------------------------------
# upsampling, sampling grids, ROI pooling, correlation
# ---------------------------------------------------------------------------
@register("UpSampling", arity=None)
def _upsampling(data, *rest, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=None):
    """NCHW upsampled by `scale`: each pixel repeated ("nearest") or
    bilinear with half-pixel centers; as in the reference, only the first
    input is read."""
    if sample_type == "nearest":
        return data.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3)
    n, c, h, w = data.shape
    return F.interpolate(data, size=(h * scale, w * scale), mode="bilinear",
                         align_corners=False)


@register("BilinearSampler")
def _bilinear_sampler(data, grid, cudnn_off=None):
    """NCHW data sampled at grid (N, 2, Ho, Wo) of (x, y) in [-1, 1]; a tap
    outside the image reads 0."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    batch = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def tap(yy, xx):
        yv = yy.to(torch.long).clamp(0, h - 1)
        xv = xx.to(torch.long).clamp(0, w - 1)
        ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        return data[batch, :, yv, xv] * ok[..., None]      # (n, ho, wo, c)

    out = (tap(y0, x0) * (wy0 * wx0)[..., None] +
           tap(y0, x1) * (wy0 * wx1)[..., None] +
           tap(y1, x0) * (wy1 * wx0)[..., None] +
           tap(y1, x1) * (wy1 * wx1)[..., None])
    return out.permute(0, 3, 1, 2)


@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=None):
    """The affine sampling grid (N, 2, H, W) of the (N, 6) transforms over
    a [-1, 1] target of `target_shape`."""
    h, w = target_shape
    dev = data.device
    ys = torch.linspace(-1, 1, h, device=dev, dtype=data.dtype)
    xs = torch.linspace(-1, 1, w, device=dev, dtype=data.dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])      # (3, h*w)
    out = torch.einsum("nij,jk->nik", data.reshape(-1, 2, 3), base)
    return out.reshape(-1, 2, h, w)


@register("ROIPooling")
def _roi_pooling(data, rois, pooled_size=None, spatial_scale=1.0):
    """Max over each cell of each roi (R, 5) = [batch, x1, y1, x2, y2],
    coordinates rounded half to even; an empty cell reads 0."""
    from .tensor import div_once as div
    ph, pw = pooled_size
    _, c, h, w = data.shape
    dev = data.device
    r = rois.to(torch.float32)
    bidx = r[:, 0].long()
    x1, y1, x2, y2 = (torch.round(r[:, i] * spatial_scale).long()
                      for i in range(1, 5))
    rh = torch.clamp(y2 - y1 + 1, min=1).to(torch.float32)
    rw = torch.clamp(x2 - x1 + 1, min=1).to(torch.float32)
    img = data[bidx]                                       # (R, C, H, W)
    ys = torch.arange(h, device=dev)[None]
    xs = torch.arange(w, device=dev)[None]
    cells = []
    for py in range(ph):
        hs = (torch.floor(div(py * rh, ph)).long() + y1)[:, None]
        he = (torch.ceil(div((py + 1) * rh, ph)).long() + y1)[:, None]
        row = []
        for px in range(pw):
            ws_ = (torch.floor(div(px * rw, pw)).long() + x1)[:, None]
            we = (torch.ceil(div((px + 1) * rw, pw)).long() + x1)[:, None]
            m = ((ys >= hs) & (ys < he))[:, :, None] & \
                ((xs >= ws_) & (xs < we))[:, None, :]
            v = torch.where(m[:, None], img, torch.full(
                (), float("-inf"), dtype=img.dtype, device=dev)).amax(
                dim=(2, 3))
            row.append(torch.where(torch.isfinite(v), v,
                                   torch.zeros_like(v)))
        cells.append(torch.stack(row, dim=-1))
    return torch.stack(cells, dim=-2)                  # (R, C, ph, pw)


@register("Correlation")
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation: for each displacement on the stride2 grid
    within +-max_displacement, the kernel-window sum over the channels of
    data1 times (or minus, absolute) the shifted data2, over k^2 C."""
    n, c, h, w = data1.shape
    k = int(kernel_size)
    md, s1, s2 = int(max_displacement), int(stride1), int(stride2)
    pad = int(pad_size)
    border = md + (k - 1) // 2
    ph, pw = h + 2 * pad, w + 2 * pad
    out_h = int(math.ceil((ph - 2 * border) / float(s1)))
    out_w = int(math.ceil((pw - 2 * border) / float(s1)))
    sublen = float(k * k * c)
    p1 = F.pad(data1.float(), (pad, pad, pad, pad))
    p2 = F.pad(data2.float(), (pad, pad, pad, pad))

    def box_sum(x):
        if k > 1:
            x = x.unfold(2, k, 1).unfold(3, k, 1).sum(dim=(-1, -2))
        return x.sum(dim=1)

    a = p1[:, :, md:ph - md, md:pw - md]
    maps = []
    for dy in range(-(md // s2), md // s2 + 1):
        for dx in range(-(md // s2), md // s2 + 1):
            oy, ox = dy * s2, dx * s2
            b = p2[:, :, md + oy:ph - md + oy, md + ox:pw - md + ox]
            prod = a * b if is_multiply else torch.abs(a - b)
            maps.append(box_sum(prod) / sublen)
    out = torch.stack(maps, dim=1)[:, :, ::s1, ::s1]
    return out[:, :, :out_h, :out_w].to(data1.dtype)


@register("dot_scaled")
def _dot_scaled(a, b, scale=1.0):
    return scale * torch.matmul(a, b)


@register("crop", arity=None)
def _crop(data, *shape_like, offset=None, h_w=None, num_args=1,
          center_crop=False):
    """NCHW cropped to the H, W of a second input (or `h_w`), at the
    center, at `offset` or at the top left."""
    if shape_like:
        th, tw = shape_like[0].shape[2:4]
    else:
        th, tw = h_w
    h, w = data.shape[2:4]
    if center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    elif offset is not None:
        oy, ox = offset
    else:
        oy = ox = 0
    return data[:, :, oy:oy + th, ox:ox + tw]


alias("crop", "Crop")


@register("_contrib_div_sqrt_dim")
def _div_sqrt_dim(data):
    """x / sqrt(last dim), the root taken in fp32 and cast to x's
    dtype."""
    d = torch.sqrt(torch.tensor(float(data.shape[-1]), dtype=torch.float32))
    return data / d.to(device=data.device, dtype=data.dtype)
