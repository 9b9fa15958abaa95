"""INT8 quantization ops (the port of `mxnet_tpu.ops.quantization_ops`):
`_contrib_quantize_v2`, `_contrib_dequantize`, `_contrib_requantize`,
`_contrib_quantized_fully_connected` and `_contrib_quantized_conv`.

Symmetric int8, as the reference: a real value v maps to round(v * 127 /
t), t the larger magnitude of the (min, max) range. The quantized product
and convolution take int8 operands and give the int32 accumulator and the
range it represents. They are exact: the integer products are summed in
float64, which holds every sum of int8 products below 2^53 without
rounding (the card's matmul and convolution have no int32 accumulation
outside `torch._int_mm`'s shapes), and are then cast to int32.
"""
from __future__ import annotations

import torch

from .registry import register
from .tensor import div_once as _div

__all__ = []

INT8_MAX = 127.0
_F32 = torch.float32


def _scalar(v, device):
    return torch.as_tensor(v, dtype=_F32, device=device)


def _thresh(lo, hi, device):
    """The symmetric threshold of a (min, max) range."""
    return torch.maximum(torch.abs(_scalar(lo, device)),
                         torch.abs(_scalar(hi, device)))


def _to_int8(real, t):
    scale = _div(INT8_MAX, torch.clamp(t, min=1e-30))
    return torch.clamp(torch.round(real * scale), -INT8_MAX,
                       INT8_MAX).to(torch.int8)


@register("_contrib_quantize_v2", arity=1, differentiable=False,
          num_outputs=3)
def _quantize_v2(data, min_calib_range=None, max_calib_range=None,
                 out_type="int8"):
    """float -> (int8, -t, t), t from the calibrated range or, without
    one, the data's largest magnitude."""
    if out_type not in ("int8", "auto"):
        raise NotImplementedError("quantize_v2: only int8 out_type")
    if min_calib_range is not None and max_calib_range is not None:
        t = _thresh(min_calib_range, max_calib_range, data.device)
    else:
        t = torch.abs(data).max().to(_F32)
    return _to_int8(data.to(_F32), t), -t, t


@register("_contrib_dequantize", arity=3, differentiable=False)
def _dequantize(data, min_range, max_range, out_type="float32"):
    """int8 (or an int32 accumulator, whose unit is t / 127^2) -> float32."""
    t = _thresh(min_range, max_range, data.device)
    denom = INT8_MAX if data.dtype == torch.int8 else INT8_MAX * INT8_MAX
    return data.to(_F32) * _div(t, denom)


@register("_contrib_requantize", arity=3, differentiable=False,
          num_outputs=3)
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None):
    """An int32 accumulator of range t_in -> (int8, -t, t), t calibrated
    or the accumulator's largest real magnitude."""
    t_in = _thresh(min_range, max_range, data.device)
    real = data.to(_F32) * _div(t_in, INT8_MAX * INT8_MAX)
    if min_calib_range is not None and max_calib_range is not None:
        t_out = _thresh(min_calib_range, max_calib_range, data.device)
    else:
        t_out = torch.abs(real).max()
    return _to_int8(real, t_out), -t_out, t_out


def int8_dot_acc(x, w):
    """x (..., K) int8 times w (N, K) int8 transposed: the exact int32
    accumulator (float64 sums of the integer products)."""
    return torch.matmul(x.to(torch.float64),
                        w.to(torch.float64).t()).to(torch.int32)


def int8_conv_acc(x, w, stride, pad, dilate, groups):
    """The NC(D)HW convolution of int8 `x` by int8 `w` (O, I/groups, ...):
    the exact int32 accumulator (float64 sums of the integer products)."""
    from .nn import _FP32Conv
    return _FP32Conv.apply(x.to(torch.float64), w.to(torch.float64), None,
                           tuple(stride), tuple(pad), tuple(dilate),
                           groups).to(torch.int32)


def _bias32(bias, t_b, t_d, t_w):
    """The int8 bias in the accumulator's unit."""
    acc_scale = _div(INT8_MAX * INT8_MAX, torch.clamp(t_d * t_w, min=1e-30))
    return torch.round(bias.to(_F32) * _div(t_b, INT8_MAX)
                       * acc_scale).to(torch.int32)


@register("_contrib_quantized_fully_connected", arity=9,
          differentiable=False, num_outputs=3)
def _quantized_fully_connected(data, weight, bias, min_data, max_data,
                               min_weight, max_weight, min_bias, max_bias,
                               num_hidden=None, no_bias=False, flatten=True):
    """int8 x int8^T -> int32 (+ the rescaled bias), with the range the
    accumulator represents (t_data t_weight)."""
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    dev = data.device
    out = int8_dot_acc(x, weight)
    t_d = _thresh(min_data, max_data, dev)
    t_w = _thresh(min_weight, max_weight, dev)
    if bias is not None and not no_bias:
        out = out + _bias32(bias, _thresh(min_bias, max_bias, dev), t_d, t_w)
    t_out = t_d * t_w
    return out, -t_out, t_out


@register("_contrib_quantized_conv", arity=9, differentiable=False,
          num_outputs=3)
def _quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                    max_weight, min_bias, max_bias, kernel=None, stride=None,
                    dilate=None, pad=None, num_filter=None, num_group=1,
                    no_bias=False, layout=None):
    """int8 NC(D)HW convolution -> int32 (+ the rescaled bias), with its
    range."""
    if layout not in (None, "NCW", "NCHW", "NCDHW"):
        raise NotImplementedError(
            "_contrib_quantized_conv: only channels-first layouts (got %r)"
            % layout)
    from .nn import _pair
    nd = len(kernel) if kernel is not None else data.dim() - 2
    dev = data.device
    out = int8_conv_acc(data, weight, _pair(stride if stride else 1, nd),
                        _pair(pad if pad else 0, nd),
                        _pair(dilate if dilate else 1, nd), num_group)
    t_d = _thresh(min_data, max_data, dev)
    t_w = _thresh(min_weight, max_weight, dev)
    if bias is not None and not no_bias:
        out = out + _bias32(bias, _thresh(min_bias, max_bias, dev), t_d,
                            t_w).reshape((1, -1) + (1,) * nd)
    t_out = t_d * t_w
    return out, -t_out, t_out
