"""Tensor ops (the port of `mxnet_tpu.ops.tensor`). First those of the
Gluon path (the ResNet and BERT layers, the losses and NDArray
arithmetic): the binary broadcast ops and comparisons, unary math,
identity, zeros_like, cast, reshape (every code of the reference),
Flatten, transpose, slice_axis, broadcast_to, the reductions, pick, dot,
Embedding (dense or row-sparse gradient) and the CSR dot
``_sparse_dot_csr_dense``; and for the loss blocks, the image augmenters
and the DataLoader: maximum/minimum, sqrt, ones_like, where, norm,
swapaxes, reverse, stack, add_n, one_hot and pad; and for the recurrent
cells: split (SliceChannel), _split_v2, expand_dims, clip and the
Sequence* ops. Then the rest of the reference's set: unary math (the
trigonometric and hyperbolic functions, erf/erfinv, gamma/gammaln,
rounding, ...), mod/power/hypot/arctan2 and the logical ops, the other
reductions, argmax/argmin, sort/argsort/topk (stable: ties keep index
order, as ``jnp.argsort`` and ``lax.top_k``), cumsum, squeeze, tile,
repeat, slice (negative steps too), the indexing ops, diag, eye and
batch_dot with the first linalg_* ops. `boolean_mask` and `where_index`
have shapes that depend on the values, so they have no symbolic shape."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import alias, register

_BINARY = {"broadcast_add": torch.add, "broadcast_sub": torch.sub,
           "broadcast_mul": torch.mul, "broadcast_div": torch.div}


def div_once(a, b):
    """a / b with one rounding on every device, either side a Python
    number. On a card torch divides by a Python number as a multiplication
    by its reciprocal, and a Python number by a tensor as the reciprocal
    times the number: two roundings, where the reference (and torch on the
    CPU) rounds once. Where the quotient is floored, ceiled or rounded to
    an integer, that ulp can change the result."""
    ref = a if torch.is_tensor(a) else b
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device) / \
        torch.as_tensor(b, dtype=ref.dtype, device=ref.device)


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
    """Reshape with the reference's codes (0, -1, -2, -3, -4, and
    `reverse`; `_mx_reshape`)."""
    shape = tuple(shape)
    if reverse or any(s in (0, -2, -3, -4) for s in shape):
        shape = _mx_reshape(tuple(x.shape), shape, reverse)
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
    """x[..., index, ...] along `axis`. The indices are clipped into range
    in every mode, as the reference's op does (its `mode` is accepted and
    not read)."""
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
    """Pad with (before, after) pairs per axis, flattened in axis order:
    the constant, the nearest edge ("edge") or the mirror image without
    the edge (any other mode, as the reference's "reflect")."""
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(x.dim())]
    if mode == "constant":
        flat = [p for pair in reversed(pairs) for p in pair]
        return torch.nn.functional.pad(x, flat, value=constant_value)
    mode = "edge" if mode == "edge" else "reflect"
    for ax, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


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


# ---------------------------------------------------------------------------
# the rest of the reference's tensor ops: unary math, the other binary and
# logic ops, reductions, ordering, shape, indexing and linear algebra
# ---------------------------------------------------------------------------
def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _softsign(x):
    return x / (1 + torch.abs(x))


def _logical_not(x):
    return torch.logical_not(x).to(x.dtype)


_UNARY_MORE = {
    "sign": torch.sign, "reciprocal": torch.reciprocal, "rsqrt": torch.rsqrt,
    "cbrt": _cbrt, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "expm1": torch.expm1, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "arcsin": torch.asin,
    "arccos": torch.acos, "arctan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh, "erf": torch.erf, "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma, "softsign": _softsign,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "logical_not": _logical_not,
}
for _n, _f in _UNARY_MORE.items():
    register(_n, arity=1)(lambda x, _f=_f: _f(x))

_UNARY_NONDIFF = {
    "round": torch.round, "rint": torch.round, "ceil": torch.ceil,
    "floor": torch.floor, "trunc": torch.trunc, "fix": torch.trunc,
    "isnan": lambda x: torch.isnan(x).to(torch.float32),
    "isinf": lambda x: torch.isinf(x).to(torch.float32),
    "isfinite": lambda x: torch.isfinite(x).to(torch.float32),
}
for _n, _f in _UNARY_NONDIFF.items():
    register(_n, arity=1, differentiable=False)(lambda x, _f=_f: _f(x))


def _floor_mod(a, b):
    """a mod b with the divisor's sign, from the exact fmod, as
    ``jnp.mod`` computes it."""
    r = torch.fmod(a, b)
    fix = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(fix, r + b, r)


_BINARY_EXTRA = {"broadcast_mod": _floor_mod, "broadcast_power": torch.pow,
                 "broadcast_hypot": torch.hypot, "arctan2": torch.atan2}
for _n, _f in _BINARY_EXTRA.items():
    register(_n)(_binary_both(_f))

alias("broadcast_add", "_plus_scalar")
alias("broadcast_sub", "_minus_scalar")
alias("broadcast_mul", "_mul_scalar")
alias("broadcast_div", "_div_scalar")
alias("broadcast_power", "_power", "_power_scalar", "pow")

_LOGIC = {"broadcast_logical_and": torch.logical_and,
          "broadcast_logical_or": torch.logical_or,
          "broadcast_logical_xor": torch.logical_xor}
for _n, _f in _LOGIC.items():
    register(_n, differentiable=False)(_compare(_f))


@register("smooth_l1")
def _smooth_l1(x, scalar=1.0):
    """0.5 (s x)^2 where |x| < 1/s^2, else |x| - 0.5/s^2."""
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


@register("shape_array", differentiable=False)
def _shape_array(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@register("size_array", differentiable=False)
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


alias("identity", "_copyto", "stop_gradient_passthrough", "BlockGrad_inner")
alias("cast", "amp_cast")
alias("_getitem", "_internal_getitem")


def _prod_dims(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _nanprod_dims(x, dim, keepdim):
    return _prod_dims(torch.where(torch.isnan(x), torch.ones_like(x), x),
                      dim, keepdim)


register("prod")(_reduce(_prod_dims))
register("max")(_reduce(torch.amax))
register("min")(_reduce(torch.amin))
register("nansum")(_reduce(torch.nansum))
register("nanprod")(_reduce(_nanprod_dims))
alias("max", "max_axis")
alias("min", "min_axis")


@register("logsumexp")
def _logsumexp(x, axis=None, keepdims=False):
    return torch.logsumexp(x, dim=_axes(axis, False, x.dim()),
                           keepdim=keepdims)


def _arg_reduce(f):
    def fn(x, axis=None, keepdims=False):
        """The index of the first extreme value, as float32 (the
        reference's float indices)."""
        if axis is None:
            r = f(x.reshape(-1), dim=0)
            if keepdims:
                r = r.reshape((1,) * x.dim())
        else:
            r = f(x, dim=axis, keepdim=keepdims)
        return r.to(torch.float32)
    return fn


register("argmax", differentiable=False)(_arg_reduce(torch.argmax))
register("argmin", differentiable=False)(_arg_reduce(torch.argmin))


@register("argsort", differentiable=False)
def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    """Stable: equal values keep their order, either way."""
    idx = torch.argsort(x if is_ascend else -x, dim=axis, stable=True)
    return idx.to(torch_dtype(dtype))


@register("sort")
def _sort(x, axis=-1, is_ascend=True):
    s = torch.sort(x, dim=axis, stable=True).values
    return s if is_ascend else torch.flip(s, dims=(axis,))


@register("topk", differentiable=False)
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    """The k largest (smallest with `is_ascend`) along `axis`, ties in
    index order (a stable sort, as the reference's ``lax.top_k``).
    ret_typ "value", "both" (values, indices) or indices; as in the
    reference, "mask" returns the indices too."""
    s = torch.sort(x, dim=axis, descending=not is_ascend, stable=True)
    vals = s.values.narrow(axis, 0, k)
    idx = s.indices.narrow(axis, 0, k).to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx


@register("cumsum")
def _cumsum(x, axis=None, dtype=None):
    """Cumulative sum along `axis` (of the flattened array without one),
    in the input's dtype unless `dtype` is given."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    r = torch.cumsum(x, dim=axis)
    return r.to(torch_dtype(dtype) if dtype is not None else x.dtype)


# -- reshape with every code --------------------------------------------
def _mx_reshape(ishape, target, reverse=False):
    """MXNet's reshape codes: 0 copies a dim, -1 is inferred, -2 copies the
    rest, -3 merges two dims, -4 splits one into the next two values (one
    may be -1); with `reverse` the codes apply from the right."""
    ishape = list(ishape[::-1]) if reverse else list(ishape)
    tgt = list(target[::-1]) if reverse else list(target)
    out, i, j = [], 0, 0
    while j < len(tgt):
        t = tgt[j]
        if t == 0:
            out.append(ishape[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(ishape[i:])
            i = len(ishape)
        elif t == -3:
            out.append(ishape[i] * ishape[i + 1])
            i += 2
        elif t == -4:
            d1, d2 = tgt[j + 1], tgt[j + 2]
            if d1 == -1:
                d1 = ishape[i] // d2
            if d2 == -1:
                d2 = ishape[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(t)
            i += 1
        j += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in ishape:
            total *= d
        out[out.index(-1)] = total // known
    return tuple(out[::-1]) if reverse else tuple(out)


@register("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(axis if isinstance(axis, int) else tuple(axis))


@register("moveaxis")
def _moveaxis(x, source=0, destination=0):
    return torch.movedim(x, source, destination)


@register("broadcast_axis")
def _broadcast_axis(x, axis=None, size=None):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return x.expand(tuple(tgt))


alias("broadcast_axis", "broadcast_axes")


@register("tile")
def _tile(x, reps=None):
    return torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps))


@register("repeat")
def _repeat(x, repeats=1, axis=None):
    """Each element `repeats` times along `axis` (of the flattened array
    without one)."""
    return torch.repeat_interleave(x, repeats, dim=axis)


def _pad_index(n, lo, hi, mode, device):
    """The source index of each position of an axis padded by (lo, hi):
    the nearest edge ("edge") or the mirror without the edge
    ("reflect"), as numpy's modes."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


@register("slice")
def _slice(x, begin=None, end=None, step=None):
    """x[b0:e0:s0, b1:e1:s1, ...] over the leading axes (None keeps an
    end); a negative step walks backwards, as in numpy."""
    nd = x.dim()
    begin = list(begin) + [None] * (nd - len(begin))
    end = list(end) + [None] * (nd - len(end))
    step = (list(step) + [None] * (nd - len(step))) if step else [None] * nd
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        if s is not None and s < 0:
            idx = range(*slice(b, e, s).indices(x.shape[ax]))
            x = x.index_select(ax, torch.tensor(list(idx), dtype=torch.long,
                                                device=x.device))
        elif (b, e, s) != (None, None, None):
            x = x[(slice(None),) * ax + (slice(b, e, s),)]
    return x


@register("slice_like")
def _slice_like(x, shape_like, axes=None):
    """The leading corner of x with shape_like's size on `axes` (all by
    default)."""
    tgt = list(x.shape)
    for a in (axes if axes else range(x.dim())):
        tgt[a] = shape_like.shape[a]
    return x[tuple(slice(0, t) for t in tgt)]


@register("space_to_depth")
def _space_to_depth(x, block_size=1):
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space")
def _depth_to_space(x, block_size=1):
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


def _tmat(x, t):
    return x.transpose(-1, -2) if t else x


@register("batch_dot")
def _batch_dot(a, b, transpose_a=False, transpose_b=False):
    """Matrix products over the leading (batch) dims."""
    return torch.matmul(_tmat(a, transpose_a), _tmat(b, transpose_b))


@register("linalg_gemm2")
def _linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    return alpha * torch.matmul(_tmat(a, transpose_a), _tmat(b, transpose_b))


@register("linalg_potrf")
def _linalg_potrf(a):
    """The lower Cholesky factor L (A = L L^T)."""
    return torch.linalg.cholesky(a)


@register("linalg_syrk")
def _linalg_syrk(a, transpose=False, alpha=1.0):
    """alpha A A^T (alpha A^T A with `transpose`)."""
    at = a.transpose(-1, -2)
    return alpha * (torch.matmul(at, a) if transpose else torch.matmul(a, at))


@register("khatri_rao", arity=None)
def _khatri_rao(*mats):
    """The column-wise Kronecker product of the matrices."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


# -- indexing -------------------------------------------------------------
def _as_index(i):
    """Float indices (the reference's convention) as int64; integer ones
    as they are."""
    return i if not i.is_floating_point() else i.to(torch.long)


@register("take")
def _take(a, indices, axis=0, mode="clip"):
    """a's slices along `axis` at the indices (clipped into range, or
    wrapped with mode="wrap"); the indices' shape replaces the axis."""
    axis %= a.dim()
    n = a.shape[axis]
    idx = _as_index(indices).long()
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                       + tuple(a.shape[axis + 1:]))


@register("take_along_axis")
def _take_along_axis(a, indices, axis=0):
    axis %= a.dim()
    idx = _as_index(indices).long()
    idx = torch.where(idx < 0, idx + a.shape[axis], idx)
    shape = torch.broadcast_shapes(
        tuple(1 if i == axis else s for i, s in enumerate(a.shape)),
        tuple(1 if i == axis else s for i, s in enumerate(idx.shape)))
    a_sh = tuple(a.shape[i] if i == axis else s for i, s in enumerate(shape))
    i_sh = tuple(idx.shape[i] if i == axis else s
                 for i, s in enumerate(shape))
    return torch.gather(a.expand(a_sh), axis, idx.expand(i_sh))


@register("gather_nd")
def _gather_nd(data, indices):
    """data[indices[0], indices[1], ...]: indices (M, ...) address the
    first M axes."""
    return data[tuple(_as_index(indices).long())]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=None):
    """A zero array of `shape` with data written at the indices."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(_as_index(indices).long()), data)


@register("boolean_mask", differentiable=False)
def _boolean_mask(data, index, axis=0):
    """The slices of data along `axis` where index is nonzero (the size
    depends on the values: no symbolic shape)."""
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return data.index_select(axis, keep)


@register("where_index", differentiable=False)
def _where_index(x):
    """The axis-0 coordinate of each nonzero element, in order, as
    int32."""
    return torch.nonzero(x)[:, 0].to(torch.int32)


@register("diag")
def _diag(x, k=0):
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


@register("eye", creation=True, differentiable=False)
def _eye(N=1, M=0, k=0, ctx=None, dtype="float32"):
    from ..context import current_context
    dev = (ctx or current_context()).torch_device
    n, m = int(N), int(M) if M else int(N)
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(m, device=dev)[None, :]
    return (j - i == int(k)).to(torch_dtype(dtype))
