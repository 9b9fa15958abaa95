"""Tensor ops of the Gluon path (the port of the part of
`mxnet_tpu.ops.tensor` that Gluon's ResNet and BERT layers, the losses and
NDArray arithmetic call): the binary broadcast ops and comparisons, unary
math, identity, zeros_like, cast, reshape (with the codes 0, -1, -3),
Flatten, transpose, slice_axis, broadcast_to, the reductions, pick, dot,
Embedding (dense or row-sparse gradient) and the CSR dot
``_sparse_dot_csr_dense``; and for the loss blocks, the image augmenters
and the DataLoader: maximum/minimum, sqrt, ones_like, where, norm,
swapaxes, reverse, stack, add_n, one_hot and pad; and for the recurrent
cells: split (SliceChannel), _split_v2, expand_dims, clip and the
Sequence* ops."""
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
          "tanh": torch.tanh, "log": torch.log}

for _n, _f in _UNARY.items():
    register(_n, arity=1)(_f)


@register("identity")
def _identity(x):
    return x


alias("identity", "_copy")


@register("BlockGrad")
def _block_grad(x):
    """The input, with no gradient flowing back through it."""
    return x.detach()


alias("BlockGrad", "stop_gradient")


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


@register("_getitem")
def _getitem(x, index=None):
    """x[index] (NDArray.__getitem__): basic indices give a view."""
    return x[index]


@register("broadcast_to")
def _broadcast_to(x, shape=None):
    """Broadcast to `shape`; 0 keeps the input's dim."""
    return x.expand(tuple(x.shape[i] if s == 0 else s
                          for i, s in enumerate(shape)))


class _SparseLookup(torch.autograd.Function):
    """weight[ids] whose weight gradient is row-sparse (the reference's
    ``RowSparseRows`` recorder): an uncoalesced sparse COO tensor of one
    row per lookup, duplicates kept, which `autograd` merges into a
    `RowSparseNDArray`. `ids` are in range; the rows of `valid` False
    carry a zero cotangent."""

    @staticmethod
    def forward(ctx, ids, valid, weight):
        ctx.save_for_backward(ids, valid)
        ctx.weight_shape = weight.shape
        return weight[ids]

    @staticmethod
    def backward(ctx, cot):
        ids, valid = ctx.saved_tensors
        row = ctx.weight_shape[1:]
        vals = cot.reshape((-1,) + tuple(row))
        vals = torch.where(valid.reshape((-1,) + (1,) * len(row)), vals,
                           torch.zeros((), dtype=vals.dtype,
                                       device=vals.device))
        grad = torch.sparse_coo_tensor(ids.reshape(1, -1), vals,
                                       ctx.weight_shape,
                                       check_invariants=False)
        return None, None, grad


@register("Embedding")
def _embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
               sparse_grad=False):
    """weight[data]: the rows of the (input_dim, output_dim) table at the
    (float or integer) indices, as the reference's ``jnp.take``: a
    negative index counts from the end once, and an index still outside
    the table reads a NaN row (the smallest value for an integer table)
    and gets no gradient. The gather itself never leaves the table: the
    ids are masked first, then the fill is written. The weight gradient
    is dense, or row-sparse with `sparse_grad` (`_SparseLookup`)."""
    rows = weight.shape[0]
    idx = data.long()
    idx = torch.where(idx < 0, idx + rows, idx)
    valid = (idx >= 0) & (idx < rows)
    safe = idx.clamp(0, max(rows - 1, 0))
    if sparse_grad:
        out = _SparseLookup.apply(safe.reshape(-1), valid.reshape(-1),
                                  weight).reshape(
            tuple(idx.shape) + tuple(weight.shape[1:]))
    else:
        out = torch.nn.functional.embedding(safe, weight)
    fill = float("nan") if weight.is_floating_point() \
        else torch.iinfo(weight.dtype).min
    return torch.where(valid.reshape(tuple(valid.shape) + (1,) * (
        weight.dim() - 1)), out, torch.full((), fill, dtype=out.dtype,
                                            device=out.device))


@register("_sparse_dot_csr_dense", arity=4)
def _sparse_dot_csr_dense(sp_data, sp_indices, rows, rhs, m=0, k=0,
                          transpose_a=False):
    """csr (m, k) . dense (k, n), or csr^T . dense (m, n) -> (k, n): each
    stored entry's product with its rhs row, summed into the output rows
    by `ops.sparse_ops.segment_sum` in occurrence order (kernel #11 on a
    card; the reference's gather + ``jax.ops.segment_sum``). `rows` is the
    row of each stored entry. The rhs gets a gradient (the other
    orientation of the same product); the CSR values get none."""
    return _CSRDot.apply(sp_data, sp_indices.long(), rows.long(), rhs,
                         int(m), int(k), bool(transpose_a))


def _csr_products(data, gather_at, scatter_at, rhs, segments):
    from .sparse_ops import segment_sum
    vals = data.reshape((-1,) + (1,) * (rhs.dim() - 1)) * rhs[gather_at]
    return segment_sum(vals, scatter_at, segments)


class _CSRDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, cols, rows, rhs, m, k, transpose_a):
        ctx.save_for_backward(data, cols, rows)
        ctx.dims = (m, k, transpose_a)
        if transpose_a:
            return _csr_products(data, rows, cols, rhs, k)
        return _csr_products(data, cols, rows, rhs, m)

    @staticmethod
    def backward(ctx, cot):
        data, cols, rows = ctx.saved_tensors
        m, k, transpose_a = ctx.dims
        grad = None
        if ctx.needs_input_grad[3]:
            grad = _csr_products(data, cols, rows, cot, m) if transpose_a \
                else _csr_products(data, rows, cols, cot, k)
        return None, None, None, grad, None, None, None


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


# ---------------------------------------------------------------------------
# the ops of the data and evaluation layer: the loss blocks, the image
# augmenters and the DataLoader's batchify
# ---------------------------------------------------------------------------
_BINARY_MORE = {"broadcast_maximum": torch.maximum,
                "broadcast_minimum": torch.minimum}


def _binary_both(f):
    def fn(a, b):
        """Either side may be a scalar."""
        if not torch.is_tensor(a):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        if not torch.is_tensor(b):
            b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return f(a, b)
    return fn


for _n, _f in _BINARY_MORE.items():
    register(_n)(_binary_both(_f))

alias("broadcast_maximum", "maximum", "_maximum")
alias("broadcast_minimum", "minimum", "_minimum")

register("sqrt", arity=1)(torch.sqrt)


@register("ones_like", differentiable=False)
def _ones_like(x):
    return torch.ones_like(x)


@register("where")
def _where(condition, x, y):
    """x where the condition is nonzero, else y (either may be a scalar)."""
    cond = condition != 0
    ref = x if torch.is_tensor(x) else y
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    if not torch.is_tensor(y):
        y = torch.as_tensor(y, dtype=ref.dtype, device=ref.device)
    return torch.where(cond, x, y)


@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False):
    """The 1- or 2-norm over `axis` (all axes by default), summed in fp32
    for a narrower float and returned in x's dtype: sqrt(sum(x^2)), as the
    reference computes it."""
    ax = _axes(axis, False, x.dim())
    xa = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    if ord == 1:
        r = xa.abs().sum(dim=ax, keepdim=keepdims)
    else:
        r = xa.square().sum(dim=ax, keepdim=keepdims).sqrt()
    return r.to(x.dtype)


@register("swapaxes")
def _swapaxes(x, dim1=0, dim2=1):
    return x.transpose(dim1, dim2)


alias("swapaxes", "SwapAxis")


@register("reverse")
def _reverse(x, axis=0):
    return torch.flip(x, dims=(axis,) if isinstance(axis, int)
                      else tuple(axis))


alias("reverse", "flip")


@register("stack", arity=None)
def _stack(*xs, axis=0, num_args=None):
    return torch.stack(xs, dim=axis)


@register("add_n", arity=None)
def _add_n(*xs, num_args=None):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


alias("add_n", "ElementWiseSum")


@register("one_hot", differentiable=False)
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """on_value at each index's position along a new last axis of size
    `depth`, off_value elsewhere; an index outside [0, depth) gives a row
    of off_value."""
    idx = indices.long()
    hit = idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
    dt = torch_dtype(dtype)
    return torch.where(hit, torch.tensor(on_value, dtype=dt,
                                         device=idx.device),
                       torch.tensor(off_value, dtype=dt, device=idx.device))


@register("pad")
def _pad(x, mode="constant", pad_width=None, constant_value=0.0):
    """Pad with (before, after) pairs per axis, flattened in axis order;
    constant mode only."""
    if mode != "constant":
        raise NotImplementedError("pad: only mode='constant' is ported")
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(x.dim())]
    flat = [p for pair in reversed(pairs) for p in pair]
    return torch.nn.functional.pad(x, flat, value=constant_value)


alias("pad", "Pad")


@register("concat", arity=None)
def _concat(*xs, dim=1, num_args=None):
    return torch.cat(xs, dim=dim)


alias("concat", "Concat")


# ---------------------------------------------------------------------------
# the ops of the recurrent cells: split (SliceChannel), _split_v2,
# expand_dims, clip and the Sequence* ops
# ---------------------------------------------------------------------------
def _split_parts(x, sections, axis, squeeze_axis):
    if isinstance(sections, int):
        if x.shape[axis] % sections:
            raise ValueError("split: axis %d of size %d does not divide "
                             "into %d equal parts"
                             % (axis, x.shape[axis], sections))
    else:
        sections = list(sections)
    parts = torch.tensor_split(x, sections, dim=axis)
    if squeeze_axis:
        parts = tuple(p.squeeze(axis) for p in parts)
    return tuple(parts)


@register("split", num_outputs=0)
def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    """`num_outputs` equal parts along `axis` (a tuple; the one part when
    `num_outputs` is 1), each without that axis with `squeeze_axis`."""
    parts = _split_parts(x, num_outputs, axis, squeeze_axis)
    return parts if num_outputs > 1 else parts[0]


alias("split", "SliceChannel")


@register("_split_v2", num_outputs=0)
def _split_v2(x, indices_or_sections=1, axis=0, squeeze_axis=False):
    """Split into a number of equal parts or at the given indices; always
    a tuple."""
    return _split_parts(x, indices_or_sections, axis, squeeze_axis)


@register("expand_dims")
def _expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("clip")
def _clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


def _lengths(sequence_length):
    # the reference's astype(int32): float lengths truncate
    return sequence_length.to(torch.int32)


@register("SequenceMask")
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """`value` at the steps of each sequence at or past its length, along
    time axis 0 (TN...) or 1 (NT...)."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    lengths = _lengths(sequence_length)
    if axis == 0:
        mask = steps[:, None] < lengths[None, :]
    else:
        mask = steps[None, :] < lengths[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.as_tensor(
        value, dtype=data.dtype, device=data.device))


@register("SequenceLast")
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """Each sequence's last valid step (the last step without lengths);
    a length of 0 reads the final step, as the reference's index -1."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    idx = (_lengths(sequence_length) - 1).long()
    idx = torch.where(idx < 0, idx + data.shape[axis], idx)
    if axis == 0:
        idx = idx.reshape((1, -1) + (1,) * (data.dim() - 2))
    else:
        idx = idx.reshape((-1, 1) + (1,) * (data.dim() - 2))
    idx = idx.expand(tuple(1 if i == axis else s
                           for i, s in enumerate(data.shape)))
    return torch.gather(data, axis, idx).squeeze(axis)


@register("SequenceReverse")
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """Reverse each sequence's first `length` steps along axis 0, the rest
    in place; the whole axis without lengths. `axis` is accepted and, as
    in the reference, time is always axis 0."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lengths = _lengths(sequence_length)[None, :].long()
    rev = torch.where(steps < lengths, lengths - 1 - steps, steps)
    rev = rev.reshape(tuple(rev.shape) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, rev.expand(data.shape))
