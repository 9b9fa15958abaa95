"""Tensor ops of the Gluon path (the port of the part of
`mxnet_tpu.ops.tensor` that Gluon's ResNet and BERT layers, the losses and
NDArray arithmetic call): the binary broadcast ops and comparisons, unary
math, identity, zeros_like, cast, reshape (with the codes 0, -1, -3),
Flatten, transpose, slice_axis, broadcast_to, the reductions, pick, dot
and Embedding."""
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

_CMP = {"broadcast_equal": torch.eq, "broadcast_not_equal": torch.ne,
        "broadcast_greater": torch.gt, "broadcast_greater_equal": torch.ge,
        "broadcast_lesser": torch.lt, "broadcast_lesser_equal": torch.le}


def _compare(f):
    def fn(a, b):
        """1 where the comparison holds, else 0, in a's dtype when a is a
        float tensor, else float32."""
        if not torch.is_tensor(a):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        if not torch.is_tensor(b):
            b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        dt = a.dtype if a.is_floating_point() else torch.float32
        return f(a, b).to(dt)
    return fn


for _n, _f in _CMP.items():
    register(_n, differentiable=False)(_compare(_f))

alias("broadcast_equal", "_equal", "_equal_scalar")
alias("broadcast_not_equal", "_not_equal")
alias("broadcast_greater", "_greater", "_greater_scalar")
alias("broadcast_lesser", "_lesser", "_lesser_scalar")


_UNARY = {"negative": torch.neg, "square": torch.square, "abs": torch.abs,
          "exp": torch.exp, "relu": torch.relu, "sigmoid": torch.sigmoid,
          "tanh": torch.tanh}

for _n, _f in _UNARY.items():
    register(_n, arity=1)(_f)


@register("identity")
def _identity(x):
    return x


alias("identity", "_copy")


@register("zeros_like", differentiable=False)
def _zeros_like(x):
    return torch.zeros_like(x)


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
    """Reshape with the reference's codes: 0 copies the input's dim, -1 is
    inferred, -3 merges the next two input dims into one (-2, -4 and
    reverse=True are not ported)."""
    if reverse:
        raise NotImplementedError("reshape: reverse=True is not ported")
    src, out, i = tuple(x.shape), [], 0
    for d in shape:
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d >= -1:
            out.append(d)
            i += 1
        else:
            raise NotImplementedError("reshape: code %d is not ported" % d)
    return x.reshape(tuple(out))


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


@register("transpose")
def _transpose(x, axes=None):
    """Permute the axes (reversed without `axes`)."""
    return x.permute(*axes) if axes else x.permute(
        *reversed(range(x.dim())))


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


@register("broadcast_to")
def _broadcast_to(x, shape=None):
    """Broadcast to `shape`; 0 keeps the input's dim."""
    return x.expand(tuple(x.shape[i] if s == 0 else s
                          for i, s in enumerate(shape)))


@register("Embedding")
def _embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
               sparse_grad=False):
    """weight[data]: the rows of the (input_dim, output_dim) table at the
    (float or integer) indices, a negative index counted from the end. The
    gradient is dense (a scatter-add into the table); row-sparse gradients
    come with the port's sparse slice."""
    if sparse_grad:
        raise NotImplementedError("Embedding(sparse_grad=True) comes with "
                                  "the port's sparse slice")
    idx = data.long()
    idx = torch.where(idx < 0, idx + weight.shape[0], idx)
    return torch.nn.functional.embedding(idx, weight)


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
