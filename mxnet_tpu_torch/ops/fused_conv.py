"""Fused conv3x3 + BatchNorm + ReLU (+ residual) (the port of
`mxnet_tpu.ops.fused_conv`): the inference op with folded BN, and the
training op with batch statistics and its backward.

Layout NHWC (x), HWIO (w), stride 1, SAME padding: the shape of every
interior ResNet bottleneck conv. BN is the folded (inference) form,
``scale = gamma / sqrt(var + eps)``, ``shift = beta - mean * scale``
(`fold_bn_params`). The op `_contrib_conv_bn_relu` runs its plain PyTorch
version (`_ref_conv_bn_relu`) on a CPU context; on a GPU context its
`cuda_impl` launches the hand-written kernel of ``csrc/conv_bn_relu.cu``
(`conv_bn_relu`), which takes every shape, so no shape falls back to the
composite. A CUDA tensor that the kernel cannot take raises. The kernel
has variants, chosen by `conv_tile` from the shape before the launch (never
after a failure): a pipelined wgmma implicit GEMM for bf16 with C and Cout
multiples of 64 (every ResNet-50 bottleneck 3x3 conv), the general
mma.sync kernel for other bf16 shapes, and an fp32 FMA kernel. Each launch
counts under its kernel's name and records its variant and tile
(`ops.variant_counts`).

The training op `_contrib_conv_bn_relu_train(x, w, gamma, beta,
*residual, eps)` returns (out, batch mean, batch var) through a
`torch.autograd.Function`. Its forward is `conv_bn_stats` (the kernel of
``csrc/conv_bn_relu.cu``'s training variant: the conv output and its
per-channel sum and sum of squares from the fp32 accumulator), then the
reference's one-pass statistics (``mean = s/M``, ``var = max(sq/M -
mean^2, 0)``) and the normalize + ReLU pass in plain PyTorch, as they were
plain XLA in the reference. Its backward is `cbr_train_bwd` (the kernel of
``csrc/cbr_train_bwd.cu``: dgamma, dbeta, the fp32 dconv and dres), then dx
and dw from dconv through PyTorch's convolution backward in full fp32 (the
reference leaves them to XLA's transposed convs, outside any Pallas
kernel). The mean and var outputs carry no gradient (stop-grad, as the
reference's running-statistics semantics).

Inside a data-parallel `gluon.FusedTrainStep` over several ranks
(`parallel.collectives.batch_stats_group`), the statistics are those of
the global batch, as in the reference's one GSPMD program: the forward
all-reduces the per-channel sum, sum of squares and row count before the
mean and variance, and the backward's sums of g and g * xhat are
all-reduced before dconv. #6's persistent variant computes those sums and
dconv in one cooperative launch with no point where the sums could leave
the card, so that backward takes the split route in two calls
(`cbr_train_bwd_global`: the sums, the all-reduce, then dconv), one count
of ``cbr_train_bwd`` with the variant's label and ``+global``. The
gradients of gamma and beta stay this rank's (the step sums them with
every other gradient).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import barrier_words, count_launch
from ._build import bind
from .nn import cudnn_fp32
from .registry import get, register

__all__ = ["fold_bn_params", "conv_bn_relu", "conv_bn_stats",
           "cbr_train_bwd", "conv_tile", "ConvTile", "cbr_bwd_plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"mma": 0, "fma": 0, "wgmma": 1}    # the C entries' variant codes
H100_SMS = 132


class ConvTile(collections.namedtuple("ConvTile", "variant bm bn")):
    """The kernel variant ("wgmma", "mma" or "fma") and its tile: bm output
    pixels by bn output channels per block."""

    @property
    def label(self):
        return "%s_%dx%d" % self


def conv_tile(N, H, W, C, Cout, dtype, sms=H100_SMS):
    """The variant and tile `conv_bn_relu` and `conv_bn_stats` launch for
    x (N,H,W,C) and w (3,3,C,Cout) of `dtype` on a card with `sms`
    multiprocessors. bf16 with C and Cout multiples of 64 takes the wgmma
    kernel: 128 channels a block where Cout allows, else 64; 128 pixels a
    block, or 64 where 128 would give fewer blocks than `sms` (under one
    wave). Other bf16 shapes take the general mma.sync kernel and fp32 the
    FMA kernel, both at 64 x 64."""
    if dtype == torch.bfloat16 and C % 64 == 0 and Cout % 64 == 0 \
            and Cout > 0:
        bn = 128 if Cout % 128 == 0 else 64
        bm = 128 if -(-N * H * W // 128) * (Cout // bn) >= sms else 64
        return ConvTile("wgmma", bm, bn)
    return ConvTile("mma" if dtype == torch.bfloat16 else "fma", 64, 64)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_tile(x, Cout):
    N, H, W, C = x.shape
    return conv_tile(N, H, W, C, Cout, x.dtype, _sm_count(x.device.index))


def fold_bn_params(gamma, beta, moving_mean, moving_var, eps=1e-3):
    """BN(inference) == y * scale + shift with these folded tensors."""
    scale = gamma / torch.sqrt(moving_var + eps)
    return scale, beta - moving_mean * scale


def _conv3x3_same(x, w):
    """The one conv this module fuses, in fp32: x (N,H,W,C) NHWC, w
    (3,3,C,Cout) HWIO, stride 1, SAME; returns (N,H,W,Cout) fp32. TF32 is
    switched off for it (cuDNN would otherwise round fp32 operands), and
    the caller's switch restored after."""
    with cudnn_fp32():
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


_P, _I = ctypes.c_void_p, ctypes.c_int


def _kernel_fn():
    # x, w, scale, shift, residual, out, N, H, W, C, Cout, dtype, variant,
    # bm, bn, stream
    return bind("conv_bn_relu", "mx_conv_bn_relu", [_P] * 6 + [_I] * 9
                 + [_P])


def _raise_on(err, lib, name):
    if err:
        raise RuntimeError("%s: launch failed: %s"
                           % (name, lib.mx_cuda_error_string(err).decode()))


def conv_bn_relu(x, w, scale, shift, residual=None):
    """relu(conv3x3_same(x, w) * scale + shift (+ residual)) in x's dtype.

    x (N,H,W,C) NHWC; w (3,3,C,Cout) HWIO; scale, shift (Cout,) fp32;
    residual (N,H,W,Cout) in x's dtype or None. CUDA tensors go through the
    hand-written kernel (the variant `conv_tile` picks), CPU tensors
    through its plain version; any other device raises.
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
    tile = _device_tile(x, Cout)
    lib, fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), N, H, W, C, Cout, _DTYPES[x.dtype],
                 _VARIANTS[tile.variant], tile.bm, tile.bn, stream)
    _raise_on(err, lib, "conv_bn_relu")
    count_launch("conv_bn_relu", tile.label)
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


# ---------------------------------------------------------------------------
# training form: conv + batch statistics (kernel #5), BN + ReLU backward
# (kernel #6), and the op's autograd Function
# ---------------------------------------------------------------------------
def _ref_conv_bn_stats(x, w):
    """The plain version of `conv_bn_stats`: the fp32 conv, rounded once to
    x's dtype, and the per-channel sum and sum of squares of the fp32
    conv."""
    acc = _conv3x3_same(x, w)
    return (acc.to(x.dtype).contiguous(), acc.sum(dim=(0, 1, 2)),
            (acc * acc).sum(dim=(0, 1, 2)))


def _check_common(name, tensors):
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("%s: inputs on different devices" % name)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("%s: the kernel takes contiguous inputs" % name)


def conv_bn_stats(x, w):
    """(conv3x3_same(x, w) in x's dtype, per-channel sum, per-channel sum
    of squares), the sums fp32 and taken from the fp32 accumulator over
    the N*H*W rows. x (N,H,W,C) NHWC, w (3,3,C,Cout) HWIO, one dtype
    (float32 or bfloat16). CUDA tensors go through the hand-written kernel
    (the variant `conv_tile` picks), CPU tensors through its plain version;
    any other device raises."""
    if x.device.type == "cpu":
        return _ref_conv_bn_stats(x, w)
    if x.device.type != "cuda":
        raise ValueError("conv_bn_stats: no kernel for device %s" % x.device)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError("conv_bn_stats: x must be (N,H,W,C) and w (3,3,C,"
                         "Cout), got %s %s" % (tuple(x.shape),
                                               tuple(w.shape)))
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError("conv_bn_stats: the kernel takes float32 or "
                         "bfloat16 x and w of one dtype, got %s %s"
                         % (x.dtype, w.dtype))
    _check_common("conv_bn_stats", [x, w])
    if any(t.data_ptr() % 16 for t in (x, w)):
        raise ValueError("conv_bn_stats: the kernel reads 16-byte aligned "
                         "inputs")
    N, H, W, C = x.shape
    Cout = w.shape[3]
    M = N * H * W
    if M >= 2 ** 31 or Cout >= 65535 * 64:
        raise ValueError("conv_bn_stats: N*H*W must be < 2**31 and Cout < "
                         "%d" % (65535 * 64))
    out = torch.empty((N, H, W, Cout), dtype=x.dtype, device=x.device)
    sums = torch.zeros((2, Cout), dtype=torch.float32, device=x.device)
    if M == 0 or Cout == 0:
        return out, sums[0], sums[1]
    tile = _device_tile(x, Cout)
    partial = torch.empty(stats_scratch_shape(M, Cout, tile),
                          dtype=torch.float32, device=x.device)
    # x, w, out, partial, sums, N, H, W, C, Cout, dtype, variant, bm, bn,
    # stream
    lib, fn = bind("conv_bn_stats", "mx_conv_bn_stats",
                    [_P] * 5 + [_I] * 9 + [_P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 partial.data_ptr(), sums.data_ptr(), N, H, W, C, Cout,
                 _DTYPES[x.dtype], _VARIANTS[tile.variant], tile.bm,
                 tile.bn, stream)
    _raise_on(err, lib, "conv_bn_stats")
    count_launch("conv_bn_stats", tile.label)
    return out, sums[0], sums[1]


def stats_scratch_shape(M, Cout, tile):
    """The fp32 partial-sum scratch of `conv_bn_stats` over M rows: one
    (sum, sum of squares) row pair per tile of `tile.bm` rows. The C entry
    takes the same bm and walks the same tiles."""
    return (-(-M // tile.bm), 2, Cout)


def _normalize_relu(conv_out, mean, invstd, gamma, beta, residual):
    """xhat and the pre-ReLU value y in fp32, op by op as the reference's
    `_normalize_relu`."""
    xhat = (conv_out.float() - mean) * invstd
    y = xhat * gamma.float() + beta.float()
    if residual is not None:
        y = y + residual.float()
    return xhat, y


def _ref_cbr_train_bwd(conv_out, dy, mean, invstd, gamma, beta,
                       residual=None):
    """The plain version of `cbr_train_bwd`: the arithmetic of the
    reference's `_xla_cbr_bwd`."""
    g_out = dy.float()
    xhat, y = _normalize_relu(conv_out, mean, invstd, gamma, beta, residual)
    g = torch.where(y > 0, g_out, torch.zeros_like(g_out))
    axes = (0, 1, 2)
    dbeta = g.sum(dim=axes)
    dgamma = (g * xhat).sum(dim=axes)
    dxhat = g * gamma.float()
    mean_dxhat = dxhat.mean(dim=axes)
    mean_dxhat_xhat = (dxhat * xhat).mean(dim=axes)
    dconv = invstd * (dxhat - mean_dxhat - xhat * mean_dxhat_xhat)
    dres = g.to(residual.dtype) if residual is not None else None
    return dconv, dgamma, dbeta, dres


def cbr_bwd_plan(Cout, aligned=True):
    """The variant `cbr_train_bwd` launches for Cout channels:
    "persistent" (one cooperative launch that holds part of conv/dy on chip
    between its two phases) for Cout a multiple of 8 up to 4096 with
    16-byte `aligned` rows; else "split_v8" (three launches, 8 channels a
    thread) for the other multiples of 8, "split_v1" (one channel a
    thread) for the rest."""
    if Cout % 8 == 0 and aligned:
        return "persistent" if Cout <= 4096 else "split_v8"
    return "split_v1"


_BWD_VARIANTS = {"split_v1": 0, "split_v8": 1, "persistent": 2}


def _bwd_grid(variant, M, Cout, dev):
    """(the C entry's `grid`, the partial-sum scratch's rows) of variant
    `variant`: persistent, a block on every multiprocessor and a
    partial-sum row pair each; split, chunks of 8 rows a thread (256
    threads over min(Cout / vec, 256) channel groups) and a row pair a
    chunk."""
    if variant == "persistent":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return sms, sms
    vec = 8 if variant == "split_v8" else 1
    chunk = 8 * (256 // min(Cout // vec, 256))
    return chunk, -(-M // chunk)


def _launch_bwd_entry(dev, args_of):
    """Call mx_cbr_train_bwd with args_of(stream) on dev's current stream
    (the last argument); raise on a launch error."""
    # conv, dy, mean, invstd, gamma, beta, residual, partial, sums, dconv,
    # dres, bar, M, Cout, dtype, res_dtype, variant, grid, stream
    lib, fn = bind("cbr_train_bwd", "mx_cbr_train_bwd",
                   [_P] * 12 + [_I] * 6 + [_P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args_of(stream), stream)
    _raise_on(err, lib, "cbr_train_bwd")


def _launch_cbr_bwd(variant, conv_out, dy, mean, invstd, gamma, beta,
                    residual):
    """cbr_train_bwd's outputs through kernel variant `variant` (checked
    inputs on a CUDA device)."""
    dev = conv_out.device
    Cout = conv_out.shape[3]
    M = conv_out.numel() // max(Cout, 1)
    dconv = torch.empty(conv_out.shape, dtype=torch.float32, device=dev)
    sums = torch.empty((2, Cout), dtype=torch.float32, device=dev)
    dres = None if residual is None else torch.empty_like(residual)
    if M == 0 or Cout == 0:
        sums.zero_()
        return dconv, sums[1], sums[0], dres
    grid, rows = _bwd_grid(variant, M, Cout, dev)
    partial = torch.empty((rows, 2, Cout), dtype=torch.float32, device=dev)
    _launch_bwd_entry(dev, lambda stream: (
        conv_out.data_ptr(), dy.data_ptr(), mean.data_ptr(),
        invstd.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if residual is None else residual.data_ptr(),
        partial.data_ptr(), sums.data_ptr(), dconv.data_ptr(),
        None if dres is None else dres.data_ptr(),
        barrier_words(dev, stream).data_ptr(), M, Cout,
        _DTYPES[conv_out.dtype],
        _DTYPES[residual.dtype] if residual is not None else 0,
        _BWD_VARIANTS[variant], grid))
    count_launch("cbr_train_bwd", variant)
    return dconv, sums[1], sums[0], dres


def cbr_train_bwd(conv_out, dy, mean, invstd, gamma, beta, residual=None):
    """BatchNorm + ReLU (+ residual) backward: (dconv fp32, dgamma fp32,
    dbeta fp32, dres in the residual's dtype or None) from the saved conv
    output, the output's gradient dy (both (N,H,W,Cout), one dtype, float32
    or bfloat16), mean, invstd, gamma and beta (Cout,) fp32 and the
    residual. CUDA tensors go through the hand-written kernel (the variant
    `cbr_bwd_plan` picks; one count, with the variant), CPU tensors through
    its plain version; any other device raises."""
    if conv_out.device.type == "cpu":
        return _ref_cbr_train_bwd(conv_out, dy, mean, invstd, gamma, beta,
                                  residual)
    if conv_out.device.type != "cuda":
        raise ValueError("cbr_train_bwd: no kernel for device %s"
                         % conv_out.device)
    if conv_out.dim() != 4 or dy.shape != conv_out.shape:
        raise ValueError("cbr_train_bwd: conv_out and dy must be (N,H,W,"
                         "Cout) alike, got %s %s" % (tuple(conv_out.shape),
                                                     tuple(dy.shape)))
    if conv_out.dtype not in _DTYPES or dy.dtype != conv_out.dtype:
        raise ValueError("cbr_train_bwd: the kernel takes float32 or "
                         "bfloat16 conv_out and dy of one dtype, got %s %s"
                         % (conv_out.dtype, dy.dtype))
    Cout = conv_out.shape[3]
    for name, t in (("mean", mean), ("invstd", invstd), ("gamma", gamma),
                    ("beta", beta)):
        if tuple(t.shape) != (Cout,) or t.dtype != torch.float32:
            raise ValueError("cbr_train_bwd: %s must be float32 (%d,), got "
                             "%s %s" % (name, Cout, t.dtype, tuple(t.shape)))
    tensors = [conv_out, dy, mean, invstd, gamma, beta]
    if residual is not None:
        if residual.shape != conv_out.shape or residual.dtype not in _DTYPES:
            raise ValueError("cbr_train_bwd: residual must be float32 or "
                             "bfloat16 of shape %s, got %s %s"
                             % (tuple(conv_out.shape), residual.dtype,
                                tuple(residual.shape)))
        tensors.append(residual)
    _check_common("cbr_train_bwd", tensors)
    if conv_out.numel() // max(Cout, 1) >= 2 ** 31:
        raise ValueError("cbr_train_bwd: N*H*W must be < 2**31")
    rows = [conv_out, dy] + ([residual] if residual is not None else [])
    variant = cbr_bwd_plan(Cout, all(t.data_ptr() % 16 == 0 for t in rows))
    return _launch_cbr_bwd(variant, conv_out, dy, mean, invstd, gamma, beta,
                           residual)


def cbr_train_bwd_global(conv_out, dy, mean, invstd, gamma, beta, residual,
                         reduce, count):
    """`cbr_train_bwd` with batch statistics over several ranks: (dconv
    fp32, dgamma and dbeta of these rows fp32, dres). The sums of g and of
    g * xhat over these rows go through `reduce` (a (2, Cout) fp32 tensor,
    dbeta's sums then dgamma's, to the sums over every rank), and dconv's
    means divide those by `count`, the rows of every rank. CUDA tensors
    take the kernel's split variant in two calls with `reduce` between
    them (see the module docstring); CPU tensors its plain version; any
    other device raises."""
    if conv_out.device.type == "cpu":
        g_out = dy.float()
        xhat, y = _normalize_relu(conv_out, mean, invstd, gamma, beta,
                                  residual)
        g = torch.where(y > 0, g_out, torch.zeros_like(g_out))
        axes = (0, 1, 2)
        dbeta, dgamma = g.sum(dim=axes), (g * xhat).sum(dim=axes)
        tot = reduce(torch.stack([dbeta, dgamma]))
        gam = gamma.float()
        k1, k2 = gam * (tot[0] / count), gam * (tot[1] / count)
        dconv = invstd * (g * gam - k1 - xhat * k2)
        dres = g.to(residual.dtype) if residual is not None else None
        return dconv, dgamma, dbeta, dres
    if conv_out.device.type != "cuda":
        raise ValueError("cbr_train_bwd_global: no kernel for device %s"
                         % conv_out.device)
    dev = conv_out.device
    Cout = conv_out.shape[3]
    M = conv_out.numel() // max(Cout, 1)
    rows = [conv_out, dy] + ([residual] if residual is not None else [])
    variant = "split_v8" if Cout % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in rows) else "split_v1"
    dconv = torch.empty(conv_out.shape, dtype=torch.float32, device=dev)
    sums = torch.zeros((2, Cout), dtype=torch.float32, device=dev)
    dres = None if residual is None else torch.empty_like(residual)
    grid, nrows = _bwd_grid(variant, M, Cout, dev)
    partial = torch.empty((max(nrows, 1), 2, Cout), dtype=torch.float32,
                          device=dev)
    # conv, dy, mean, invstd, gamma, beta, residual, partial, sums, dconv,
    # dres, M, Cout, dtype, res_dtype, variant, grid, stage, mdiv, stream
    lib, fn = bind("cbr_train_bwd", "mx_cbr_train_bwd_staged",
                   [_P] * 11 + [_I] * 7 + [ctypes.c_float, _P])

    def stage(k, sums_in):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(conv_out.data_ptr(), dy.data_ptr(), mean.data_ptr(),
                     invstd.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     None if residual is None else residual.data_ptr(),
                     partial.data_ptr(), sums_in.data_ptr(),
                     dconv.data_ptr(),
                     None if dres is None else dres.data_ptr(), M, Cout,
                     _DTYPES[conv_out.dtype],
                     _DTYPES[residual.dtype] if residual is not None else 0,
                     _BWD_VARIANTS[variant], grid, k, float(count), stream)
        _raise_on(err, lib, "cbr_train_bwd")

    if M:
        stage(1, sums)
    tot = reduce(sums).contiguous()
    if M:
        stage(2, tot)
    count_launch("cbr_train_bwd", variant + "+global")
    return dconv, sums[1], sums[0], dres


def _conv3x3_backward(x, w, dconv):
    """dx, dw of the fp32 conv3x3 (SAME) from the fp32 dconv (N,H,W,Cout),
    in full fp32: TF32 stays off for these convs too."""
    x32 = x.permute(0, 3, 1, 2).float()
    w32 = w.permute(3, 2, 0, 1).float()
    g = dconv.permute(0, 3, 1, 2)
    with cudnn_fp32():
        dx = torch.nn.grad.conv2d_input(x32.shape, w32, g, padding=1)
        dw = torch.nn.grad.conv2d_weight(x32, w32.shape, g, padding=1)
    return (dx.permute(0, 2, 3, 1).to(x.dtype).contiguous(),
            dw.permute(2, 3, 1, 0).to(w.dtype).contiguous())


class _ConvBNReLUTrain(torch.autograd.Function):
    """(out, batch mean, batch var) of relu(BN_batch(conv3x3(x, w)) (+
    residual)); gradients for x, w, gamma, beta and the residual."""

    @staticmethod
    def forward(ctx, eps, x, w, gamma, beta, residual):
        from ..parallel.collectives import all_reduce, batch_stats_group
        x, w = x.contiguous(), w.contiguous()
        conv_out, s, sq = conv_bn_stats(x, w)
        M = x.shape[0] * x.shape[1] * x.shape[2]
        ctx.group = batch_stats_group()
        if ctx.group is not None:
            # the global batch's sums (and rows) before the statistics
            tot = all_reduce(torch.cat([s, sq, s.new_full((1,), M)]),
                             ctx.group)
            C = s.shape[0]
            s, sq, M = tot[:C], tot[C:2 * C], tot[2 * C]
        ctx.count = M
        mean = s / M
        var = torch.clamp_min(sq / M - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        _, y = _normalize_relu(conv_out, mean, invstd, gamma, beta, residual)
        out = torch.relu(y).to(x.dtype)
        ctx.save_for_backward(x, w, conv_out, mean, invstd, gamma, beta,
                              residual)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, dmean, dvar):
        # the mean/var cotangents are dropped: running-stat updates are
        # stop-grad (reference BatchNorm semantics)
        x, w, conv_out, mean, invstd, gamma, beta, residual = \
            ctx.saved_tensors
        res = residual.contiguous() if residual is not None else None
        args = (conv_out, dout.to(conv_out.dtype).contiguous(), mean, invstd,
                gamma.float().contiguous(), beta.float().contiguous(), res)
        if ctx.group is None:
            dconv, dgamma, dbeta, dres = cbr_train_bwd(*args)
        else:
            from ..parallel.collectives import all_reduce
            dconv, dgamma, dbeta, dres = cbr_train_bwd_global(
                *args, lambda t: all_reduce(t, ctx.group), ctx.count)
        dx, dw = _conv3x3_backward(x, w, dconv)
        return (None, dx, dw, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                dres)


@register("_contrib_conv_bn_relu_train", arity=None, num_outputs=3)
def _conv_bn_relu_train(x, w, gamma, beta, *residual, eps=1e-3):
    """Training-form fused conv3x3 + BatchNorm + ReLU (+ residual): x
    (N,H,W,C) NHWC, w (3,3,Cin,Cout) HWIO, gamma/beta (Cout,), optional
    residual (N,H,W,Cout). Returns (out, batch_mean, batch_var); the caller
    updates the running statistics from mean/var as BatchNorm does. The
    kernels run for CUDA tensors (their wrappers pick by device)."""
    return _ConvBNReLUTrain.apply(eps, x, w, gamma, beta,
                                  residual[0] if residual else None)
