"""Tensor ops of the Gluon path (the port of the part of
`mxnet_tpu.ops.tensor` that Gluon's ResNet layers, the losses and NDArray
arithmetic call): the binary broadcast ops, unary math, cast, reshape,
Flatten, the reductions, pick and dot."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import alias, register

_BINARY = {"broadcast_add": torch.add, "broadcast_sub": torch.sub,
           "broadcast_mul": torch.mul, "broadcast_div": torch.div}


def _binary(f):
    def fn(a, b):
        if not torch.is_tensor(a):      # scalar on the left: a - x, a / x
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        return f(a, b)
    return fn


for _n, _f in _BINARY.items():
    register(_n)(_binary(_f))

alias("broadcast_add", "elemwise_add", "_plus", "_add")
alias("broadcast_sub", "elemwise_sub", "_minus", "_sub")
alias("broadcast_mul", "elemwise_mul", "_mul")
alias("broadcast_div", "elemwise_div", "_div")


_UNARY = {"negative": torch.neg, "square": torch.square, "abs": torch.abs,
          "exp": torch.exp, "relu": torch.relu, "sigmoid": torch.sigmoid,
          "tanh": torch.tanh}

for _n, _f in _UNARY.items():
    register(_n, arity=1)(_f)


@register("cast")
def _cast(x, dtype=None):
    return x.to(torch_dtype(dtype), copy=True)


alias("cast", "Cast")


@register("flatten")
def _flatten(x):
    """Keeps dim 0, flattens the rest."""
    return x.reshape(x.shape[0], -1)


alias("flatten", "Flatten")


@register("reshape")
def _reshape(x, shape=None, reverse=False):
    """Reshape; 0 copies the input's dim at that position, -1 is
    inferred (the reference's codes -2..-4 are not ported)."""
    if reverse:
        raise NotImplementedError("reshape: reverse=True is not ported")
    shape = tuple(x.shape[i] if d == 0 else d for i, d in enumerate(shape))
    if any(d < -1 for d in shape):
        raise NotImplementedError("reshape: special codes below -1 are not "
                                  "ported, got %s" % (shape,))
    return x.reshape(shape)


alias("reshape", "Reshape")


def _axes(axis, exclude, ndim):
    if axis is None:
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _reduce(f):
    def fn(x, axis=None, keepdims=False, exclude=False):
        ax = _axes(axis, exclude, x.dim())
        if not ax:
            return x.clone()
        return f(x, dim=ax, keepdim=keepdims)
    return fn


register("sum")(_reduce(torch.sum))
register("mean")(_reduce(torch.mean))
alias("sum", "sum_axis")


@register("pick")
def _pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """x[..., index, ...] along `axis`; indices are clipped into range."""
    if mode != "clip":
        raise NotImplementedError("pick: only mode='clip' is ported")
    axis %= x.dim()
    idx = index.long().clamp(0, x.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register("dot")
def _dot(a, b, transpose_a=False, transpose_b=False):
    """Matrix product over a's last axis and b's first (2-D operands may be
    transposed first)."""
    if transpose_a:
        a = a.t()
    if transpose_b:
        b = b.t()
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=1)
