"""Fused conv3x3 + folded-BN + ReLU (+ residual): the inference half of
`mxnet_tpu.ops.fused_conv`.

Layout NHWC (x), HWIO (w), stride 1, SAME padding: the shape of every
interior ResNet bottleneck conv. BN is the folded (inference) form,
``scale = gamma / sqrt(var + eps)``, ``shift = beta - mean * scale``
(`fold_bn_params`). The op `_contrib_conv_bn_relu` runs its plain PyTorch
version (`_ref_conv_bn_relu`) on a CPU context; on a GPU context its
`cuda_impl` launches the hand-written kernel of ``csrc/conv_bn_relu.cu``
(`conv_bn_relu`), which takes every shape, so no shape falls back to the
composite. A CUDA tensor that the kernel cannot take raises.

The training form (`_contrib_conv_bn_relu_train`, with the batch-statistics
and backward kernels) comes with the Gluon training slice; it is not
registered here.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import count_launch
from ._build import library
from .registry import get, register

__all__ = ["fold_bn_params", "conv_bn_relu"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn_params(gamma, beta, moving_mean, moving_var, eps=1e-3):
    """BN(inference) == y * scale + shift with these folded tensors."""
    scale = gamma / torch.sqrt(moving_var + eps)
    return scale, beta - moving_mean * scale


def _conv3x3_same(x, w):
    """The one conv this module fuses, in fp32: x (N,H,W,C) NHWC, w
    (3,3,C,Cout) HWIO, stride 1, SAME; returns (N,H,W,Cout) fp32. TF32 is
    switched off for it (cuDNN would otherwise round fp32 operands)."""
    torch.backends.cudnn.allow_tf32 = False
    out = F.conv2d(x.permute(0, 3, 1, 2).float(),
                   w.permute(3, 2, 0, 1).float(), padding=1)
    return out.permute(0, 2, 3, 1)


def _ref_conv_bn_relu(x, w, scale, shift, residual=None):
    """The kernel's plain version: fp32 conv, then ``acc * scale + shift``
    (+ residual) and ReLU in fp32, rounded once to x's dtype."""
    out = _conv3x3_same(x, w) * scale.float() + shift.float()
    if residual is not None:
        out = out + residual.float()
    return torch.relu(out).to(x.dtype).contiguous()


def _check(x, w, scale, shift, residual):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError("conv_bn_relu: x must be (N,H,W,C) and w (3,3,C,"
                         "Cout), got %s %s" % (tuple(x.shape),
                                               tuple(w.shape)))
    N, H, W, C = x.shape
    Cout = w.shape[3]
    if w.shape[2] != C:
        raise ValueError("conv_bn_relu: w has %d input channels, x has %d"
                         % (w.shape[2], C))
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError("conv_bn_relu: the kernel takes float32 or bfloat16 "
                         "x and w of one dtype, got %s %s" % (x.dtype,
                                                              w.dtype))
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (Cout,) or t.dtype != torch.float32:
            raise ValueError("conv_bn_relu: %s must be float32 (%d,), got %s "
                             "%s" % (name, Cout, t.dtype, tuple(t.shape)))
    if residual is not None and (residual.dtype != x.dtype or tuple(
            residual.shape) != (N, H, W, Cout)):
        raise ValueError("conv_bn_relu: residual must be %s (%d,%d,%d,%d), "
                         "got %s %s" % (x.dtype, N, H, W, Cout,
                                        residual.dtype,
                                        tuple(residual.shape)))
    tensors = [x, w, scale, shift] + ([residual] if residual is not None
                                      else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("conv_bn_relu: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv_bn_relu: the kernel takes contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("conv_bn_relu: the kernel reads 16-byte aligned "
                         "inputs")
    if N * H * W >= 2 ** 31 or Cout >= 65535 * 64:
        raise ValueError("conv_bn_relu: N*H*W must be < 2**31 and Cout < "
                         "%d" % (65535 * 64))


def _kernel_fn():
    lib = library("conv_bn_relu")
    fn = lib.mx_conv_bn_relu
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, w, scale, shift, residual, out, N, H, W, C, Cout, dtype, stream
        fn.argtypes = [p] * 6 + [i] * 6 + [p]
        fn.restype = i
        lib.mx_cuda_error_string.argtypes = [i]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def conv_bn_relu(x, w, scale, shift, residual=None):
    """relu(conv3x3_same(x, w) * scale + shift (+ residual)) in x's dtype.

    x (N,H,W,C) NHWC; w (3,3,C,Cout) HWIO; scale, shift (Cout,) fp32;
    residual (N,H,W,Cout) in x's dtype or None. CUDA tensors go through the
    hand-written kernel, CPU tensors through its plain version; any other
    device raises.
    """
    if x.device.type == "cpu":
        return _ref_conv_bn_relu(x, w, scale, shift, residual)
    if x.device.type != "cuda":
        raise ValueError("conv_bn_relu: no kernel for device %s" % x.device)
    _check(x, w, scale, shift, residual)
    N, H, W, C = x.shape
    Cout = w.shape[3]
    out = torch.empty((N, H, W, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib, fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), N, H, W, C, Cout, _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError("conv_bn_relu: launch failed: %s"
                           % lib.mx_cuda_error_string(err).decode())
    count_launch("conv_bn_relu")
    return out


@register("_contrib_conv_bn_relu", arity=None, differentiable=False)
def _conv_bn_relu(x, w, scale, shift, *residual):
    """x (N,H,W,C) NHWC; w (3,3,Cin,Cout) HWIO; scale/shift (Cout,);
    optional residual (N,H,W,Cout). Stride 1, SAME pad, folded-BN + ReLU
    epilogue."""
    return _ref_conv_bn_relu(x, w, scale, shift,
                             residual[0] if residual else None)


@get("_contrib_conv_bn_relu").cuda_impl
def _conv_bn_relu_cuda(x, w, scale, shift, *residual):
    return conv_bn_relu(x, w, scale.float().contiguous(),
                        shift.float().contiguous(),
                        residual[0] if residual else None)
