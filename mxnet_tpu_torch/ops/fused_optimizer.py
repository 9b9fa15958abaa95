"""One-pass SGD(-momentum) and Adam updates (the port of the SGD/Adam half
of `mxnet_tpu.ops.fused_optimizer`).

`flat_sgd` and `flat_adam` wrap the hand-written kernels of
``csrc/fused_optimizer.cu``: one launch reads every element of the weight,
its gradient and its state once, runs the update in fp32 and writes every
output once. They update their tensors IN PLACE (the weight, the state and
the fp32 master) and return them, which saves an allocation per parameter
per step; the reference's functions return new arrays. CUDA tensors go
through the kernel, CPU tensors through the plain version
(`_ref_flat_sgd`, `_ref_flat_adam`: the reference's `_fused_flat_xla`
arithmetic as separate fp32 torch ops, rounded once to each output's
dtype), whose results are then copied in. On the card each torch op rounds
once and the kernel uses round-to-nearest intrinsics in the same order, so
the two agree bit for bit at fp32.

`flat_update_fn(kind, momentum_on, clip_on, mp_on)` has the call signature
of the reference's (flat vectors, per-element lr/wd), for the ZeRO slice;
the per-parameter optimizer ops (`ops.optimizer_ops`) call the same
wrappers with scalar lr/wd. Unlike the reference, no dtype gate sends a
bf16 weight elsewhere: fp32 and bf16 weights, gradients and states all
launch the kernel, and the arithmetic is fp32 with one rounding per output.
"""
from __future__ import annotations

import ctypes

import torch

from . import count_launch
from ._build import bind

__all__ = ["flat_sgd", "flat_adam", "flat_update_fn"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MOMENTUM, _CLIP, _MP, _VEC = 1, 2, 4, 8


def _ref_flat_sgd(w, g, mom, master, lr, wd, momentum, rescale, clip,
                  momentum_on, clip_on, mp_on):
    """SGD(-momentum) as separate fp32 ops: (new w, new mom, new master).
    lr and wd are floats or fp32 tensors of w's shape."""
    w32 = master if mp_on else w.float()
    g32 = g.float() * rescale
    if clip_on:
        g32 = torch.clamp(g32, -clip, clip)
    g32 = g32 + wd * w32
    if momentum_on:
        m = mom.float() * momentum - lr * g32
        new_mom = m.to(mom.dtype)
        w32n = w32 + m
    else:
        new_mom = mom
        w32n = w32 - lr * g32
    return w32n.to(w.dtype), new_mom, (w32n if mp_on else master)


def _ref_flat_adam(w, g, mean, var, master, lr, wd, beta1, omb1, beta2, omb2,
                   eps, rescale, clip, clip_on, mp_on):
    """Adam (bias correction folded into lr by the caller) as separate fp32
    ops: (new w, new mean, new var, new master)."""
    w32 = master if mp_on else w.float()
    g32 = g.float() * rescale
    if clip_on:
        g32 = torch.clamp(g32, -clip, clip)
    g32 = g32 + wd * w32
    m = beta1 * mean.float() + omb1 * g32
    v = beta2 * var.float() + omb2 * g32 * g32
    w32n = w32 - lr * m / (torch.sqrt(v) + eps)
    return (w32n.to(w.dtype), m.to(mean.dtype), v.to(var.dtype),
            w32n if mp_on else master)


def _scalar_or_vec(kernel, name, v, n, dev):
    """(float, None) for a scalar lr/wd, (0.0, tensor) for a per-element
    fp32 vector of n elements."""
    if torch.is_tensor(v) and v.dim() > 0:
        if v.numel() != n or v.dtype != torch.float32 or v.device != dev \
                or not v.is_contiguous():
            raise ValueError("%s: a per-element %s must be a contiguous "
                             "float32 tensor of %d elements on %s, got %s %s"
                             % (kernel, name, n, dev, v.dtype,
                                tuple(v.shape)))
        return 0.0, v
    return float(v), None


def _check(name, w, g, states, master, mp_on):
    n = w.numel()
    for label, t in [("weight", w), ("grad", g)] + states:
        if t.dtype not in _DTYPES:
            raise ValueError("%s: the kernel takes float32 or bfloat16 "
                             "tensors, got %s %s" % (name, label, t.dtype))
        if t.numel() != n or t.device != w.device or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous tensor of %d "
                             "elements on %s" % (name, label, n, w.device))
    if mp_on and (master is None or master.dtype != torch.float32
                  or master.numel() != n or master.device != w.device
                  or not master.is_contiguous()):
        raise ValueError("%s: the master copy must be a contiguous float32 "
                         "tensor of %d elements" % (name, n))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(kernel, symbol, argtypes, args, dev):
    lib, fn = bind(kernel, symbol, argtypes)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("%s: launch failed: %s"
                           % (kernel, lib.mx_cuda_error_string(err).decode()))
    count_launch(kernel)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def flat_sgd(w, g, mom, master, lr, wd, momentum, rescale, clip,
             momentum_on, clip_on, mp_on):
    """SGD(-momentum) over every element of w, in place; returns (w, mom,
    master). mom has w's element count (any of fp32/bf16; ignored without
    momentum); master is fp32 (mp_on); lr and wd are floats or fp32
    per-element tensors."""
    if w.device.type == "cpu":
        new = _ref_flat_sgd(w, g, mom, master, lr, wd, momentum, rescale,
                            clip, momentum_on, clip_on, mp_on)
        with torch.no_grad():
            for dst, src, on in ((w, new[0], True),
                                 (mom, new[1], momentum_on),
                                 (master, new[2], mp_on)):
                if on and dst is not src:
                    dst.copy_(src)
        return w, mom, master
    if w.device.type != "cuda":
        raise ValueError("flat_sgd: no kernel for device %s" % w.device)
    _check("flat_sgd", w, g, [("momentum", mom)] if momentum_on else [],
           master, mp_on)
    n = w.numel()
    if n == 0:
        return w, mom, master
    lr_s, lr_v = _scalar_or_vec("flat_sgd", "lr", lr, n, w.device)
    wd_s, wd_v = _scalar_or_vec("flat_sgd", "wd", wd, n, w.device)
    if (lr_v is None) != (wd_v is None):
        raise ValueError("flat_sgd: lr and wd must both be scalars or both "
                         "per-element vectors")
    flags = (_MOMENTUM * bool(momentum_on) | _CLIP * bool(clip_on)
             | _MP * bool(mp_on) | _VEC * (lr_v is not None))
    state_dtype = _DTYPES[mom.dtype] if momentum_on else 0
    # w, g, mom, master, lr_vec, wd_vec, n, lr, wd, momentum, rescale,
    # clip, w_dtype, g_dtype, state_dtype, flags, stream
    _launch("flat_sgd", "mx_flat_sgd",
            [_P] * 6 + [ctypes.c_longlong] + [_F] * 5 + [_I] * 4 + [_P],
            [w.data_ptr(), g.data_ptr(),
             _ptr(mom) if momentum_on else None,
             _ptr(master) if mp_on else None, _ptr(lr_v), _ptr(wd_v), n,
             lr_s, wd_s, float(momentum), float(rescale),
             float(clip) if clip_on else 0.0, _DTYPES[w.dtype],
             _DTYPES[g.dtype], state_dtype, flags], w.device)
    return w, mom, master


def flat_adam(w, g, mean, var, master, lr, wd, beta1, omb1, beta2, omb2,
              eps, rescale, clip, clip_on, mp_on):
    """Adam over every element of w, in place (bias correction folded into
    lr by the caller; omb1 = 1 - beta1 and omb2 = 1 - beta2 computed in
    Python double); returns (w, mean, var, master). mean and var share one
    dtype (fp32 or bf16)."""
    if w.device.type == "cpu":
        new = _ref_flat_adam(w, g, mean, var, master, lr, wd, beta1, omb1,
                             beta2, omb2, eps, rescale, clip, clip_on, mp_on)
        with torch.no_grad():
            for dst, src, on in ((w, new[0], True), (mean, new[1], True),
                                 (var, new[2], True),
                                 (master, new[3], mp_on)):
                if on and dst is not src:
                    dst.copy_(src)
        return w, mean, var, master
    if w.device.type != "cuda":
        raise ValueError("flat_adam: no kernel for device %s" % w.device)
    _check("flat_adam", w, g, [("mean", mean), ("var", var)], master, mp_on)
    if var.dtype != mean.dtype:
        raise ValueError("flat_adam: mean and var must share one dtype, got "
                         "%s %s" % (mean.dtype, var.dtype))
    n = w.numel()
    if n == 0:
        return w, mean, var, master
    lr_s, lr_v = _scalar_or_vec("flat_adam", "lr", lr, n, w.device)
    wd_s, wd_v = _scalar_or_vec("flat_adam", "wd", wd, n, w.device)
    if (lr_v is None) != (wd_v is None):
        raise ValueError("flat_adam: lr and wd must both be scalars or both "
                         "per-element vectors")
    flags = (_CLIP * bool(clip_on) | _MP * bool(mp_on)
             | _VEC * (lr_v is not None))
    # w, g, mean, var, master, lr_vec, wd_vec, n, lr, wd, beta1, omb1,
    # beta2, omb2, eps, rescale, clip, w_dtype, g_dtype, state_dtype,
    # flags, stream
    _launch("flat_adam", "mx_flat_adam",
            [_P] * 7 + [ctypes.c_longlong] + [_F] * 9 + [_I] * 4 + [_P],
            [w.data_ptr(), g.data_ptr(), mean.data_ptr(), var.data_ptr(),
             _ptr(master) if mp_on else None, _ptr(lr_v), _ptr(wd_v), n,
             lr_s, wd_s, float(beta1), float(omb1), float(beta2),
             float(omb2), float(eps), float(rescale),
             float(clip) if clip_on else 0.0, _DTYPES[w.dtype],
             _DTYPES[g.dtype], _DTYPES[mean.dtype], flags], w.device)
    return w, mean, var, master


def flat_update_fn(kind, momentum_on, clip_on, mp_on):
    """The flat-shard update with the reference's call signature per kind
    (`mxnet_tpu.ops.fused_optimizer.flat_update_fn`):

        sgd:  fn(w, g, mom, master, lr_vec, wd_vec, momentum, rescale, clip)
              -> (w, mom, master)
        adam: fn(w, g, mean, var, master, lr_vec, wd_vec, beta1, omb1,
                 beta2, omb2, eps, rescale, clip) -> (w, mean, var, master)

    The tensors are updated in place and returned."""
    if kind == "sgd":
        def fn(w, g, mom, master, lr_vec, wd_vec, momentum, rescale, clip):
            return flat_sgd(w, g, mom, master, lr_vec, wd_vec, momentum,
                            rescale, clip, momentum_on, clip_on, mp_on)
    elif kind == "adam":
        def fn(w, g, mean, var, master, lr_vec, wd_vec, beta1, omb1, beta2,
               omb2, eps, rescale, clip):
            return flat_adam(w, g, mean, var, master, lr_vec, wd_vec, beta1,
                             omb1, beta2, omb2, eps, rescale, clip, clip_on,
                             mp_on)
    else:
        raise KeyError(kind)
    return fn
