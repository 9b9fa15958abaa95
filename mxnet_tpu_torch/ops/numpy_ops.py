"""The `_np_*` ops of `mx.np` (the port of the op table in
`mxnet_tpu.numpy.__init__`), one torch implementation each.

Each op takes tensors (and numpy arrays, Python scalars and lists where
numpy takes them) and computes on its first tensor's device: nothing is
copied to the host and back. Ops whose result shape depends on the data
(`unique`, `nonzero`, `extract`, boolean masks, `trim_zeros`, ...) read
that shape on the host, as numpy does.

Result types are the reference's, which are jax.numpy's with 64-bit types
off: every 64-bit input and result is narrowed to its 32-bit type
(`canon`), Python scalars are weakly typed (an int array plus 2.5 is
float32, a float16 array plus 2.5 stays float16), index results are
int32, a mean of integers is float32, a sum of bool/int8/int16 is int32.
Gradients follow `jax.vjp` at kinks and ties: `maximum`/`minimum`/`clip`
split a tie evenly, `max`/`min`/`ptp` share it among the tied elements,
`fmax`/`fmin` send it to the second argument.

The ops are grouped as the reference's table groups them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["FUNCS", "SEQ_FUNCS", "LINALG_FUNCS", "canon", "canon_dtype",
           "to_tensor"]

# (name, differentiable): the reference's table, in its order
FUNCS = [
    ("add", True), ("subtract", True), ("multiply", True), ("divide", True),
    ("true_divide", True), ("mod", True), ("remainder", True), ("fmod", True),
    ("power", True), ("pow", True), ("float_power", True),
    ("maximum", True), ("minimum", True), ("fmax", True), ("fmin", True),
    ("hypot", True), ("negative", True), ("positive", True),
    ("reciprocal", True), ("abs", True), ("absolute", True), ("fabs", True),
    ("sign", True), ("heaviside", True), ("copysign", True), ("ldexp", True),
    ("nextafter", False), ("spacing", False), ("signbit", False),
    ("exp", True), ("exp2", True), ("expm1", True), ("log", True),
    ("log2", True), ("log10", True), ("log1p", True),
    ("logaddexp", True), ("logaddexp2", True),
    ("sqrt", True), ("cbrt", True), ("square", True),
    ("sin", True), ("cos", True), ("tan", True),
    ("arcsin", True), ("arccos", True), ("arctan", True), ("arctan2", True),
    ("asin", True), ("acos", True), ("atan", True), ("atan2", True),
    ("sinh", True), ("cosh", True), ("tanh", True),
    ("arcsinh", True), ("arccosh", True), ("arctanh", True),
    ("asinh", True), ("acosh", True), ("atanh", True),
    ("sinc", True), ("i0", True), ("angle", True), ("unwrap", True),
    ("degrees", True), ("radians", True), ("deg2rad", True),
    ("rad2deg", True),
    ("rint", True), ("floor", True), ("ceil", True), ("trunc", True),
    ("round", True), ("around", True), ("clip", True), ("nan_to_num", True),
    ("dot", True), ("matmul", True), ("inner", True), ("outer", True),
    ("tensordot", True), ("einsum", True), ("vdot", True), ("vecdot", True),
    ("kron", True), ("cross", True), ("trace", True),
    ("matrix_transpose", True),
    ("sum", True), ("prod", True), ("mean", True), ("std", True),
    ("var", True), ("cumsum", True), ("cumprod", True),
    ("max", True), ("min", True), ("amax", True), ("amin", True),
    ("ptp", True), ("median", True), ("quantile", True),
    ("percentile", True), ("average", True),
    ("nansum", True), ("nanprod", True), ("nanmean", True),
    ("nanstd", True), ("nanvar", True), ("nanmedian", True),
    ("nanquantile", True), ("nanpercentile", True),
    ("nanmax", True), ("nanmin", True),
    ("nancumsum", True), ("nancumprod", True),
    ("nanargmax", False), ("nanargmin", False),
    ("trapezoid", True), ("corrcoef", True), ("cov", True),
    ("reshape", True), ("ravel", True), ("transpose", True),
    ("permute_dims", True), ("swapaxes", True), ("moveaxis", True),
    ("rollaxis", True), ("expand_dims", True), ("squeeze", True),
    ("broadcast_to", True), ("concatenate", True), ("concat", True),
    ("stack", True), ("vstack", True), ("hstack", True), ("dstack", True),
    ("column_stack", True), ("split", True), ("array_split", True),
    ("vsplit", True), ("hsplit", True), ("dsplit", True),
    ("tile", True), ("repeat", True), ("roll", True), ("flip", True),
    ("fliplr", True), ("flipud", True), ("rot90", True), ("pad", True),
    ("append", True), ("delete", True), ("insert", True), ("resize", True),
    ("trim_zeros", True), ("broadcast_arrays", True), ("atleast_1d", True),
    ("atleast_2d", True), ("atleast_3d", True), ("astype", True),
    ("copy", True),
    ("take", True), ("take_along_axis", True), ("where", True),
    ("select", True), ("compress", True), ("choose", True),
    ("extract", False), ("diag", True), ("diagflat", True),
    ("diagonal", True), ("tril", True), ("triu", True),
    ("meshgrid", True), ("ix_", False),
    ("sort", True), ("partition", True), ("argpartition", False),
    ("argmax", False), ("argmin", False), ("argsort", False),
    ("argwhere", False), ("searchsorted", False), ("flatnonzero", False),
    ("count_nonzero", False), ("nonzero", False), ("lexsort", False),
    ("sort_complex", False), ("digitize", False),
    ("floor_divide", False), ("equal", False), ("not_equal", False),
    ("greater", False), ("greater_equal", False), ("less", False),
    ("less_equal", False), ("logical_and", False), ("logical_or", False),
    ("logical_not", False), ("logical_xor", False),
    ("isnan", False), ("isinf", False), ("isfinite", False),
    ("isposinf", False), ("isneginf", False), ("isreal", False),
    ("iscomplex", False), ("all", False), ("any", False),
    ("allclose", False), ("isclose", False), ("array_equal", False),
    ("array_equiv", False), ("isin", False),
    ("unique", False), ("union1d", False), ("intersect1d", False),
    ("setdiff1d", False), ("setxor1d", False),
    ("unique_all", False), ("unique_counts", False),
    ("unique_inverse", False), ("unique_values", False),
    ("lcm", False), ("gcd", False), ("bincount", False),
    ("bitwise_and", False), ("bitwise_or", False), ("bitwise_xor", False),
    ("bitwise_not", False), ("bitwise_invert", False),
    ("bitwise_count", False), ("invert", False),
    ("left_shift", False), ("right_shift", False),
    ("bitwise_left_shift", False), ("bitwise_right_shift", False),
    ("packbits", False), ("unpackbits", False),
    ("interp", True), ("diff", True), ("ediff1d", True), ("gradient", True),
    ("convolve", True), ("correlate", True), ("real", True), ("imag", True),
    ("conj", True), ("conjugate", True), ("histogram", False),
    ("histogram2d", False), ("histogramdd", False),
    ("histogram_bin_edges", False),
    ("frexp", False), ("modf", True), ("divmod", False),
    ("unravel_index", False), ("ravel_multi_index", False),
    ("polyval", True), ("polyadd", True), ("polysub", True),
    ("polymul", True), ("polyder", True), ("polyint", True),
    ("polydiv", True), ("polyfit", True), ("poly", False), ("roots", False),
    ("vander", True),
    ("apply_along_axis", False), ("apply_over_axes", False),
    ("piecewise", False),
]

# functions whose first argument is a sequence of arrays: `mx.np` unpacks
# the sequence into positional arguments, so the tape sees every input
SEQ_FUNCS = {"concatenate", "concat", "stack", "vstack", "hstack",
             "dstack", "column_stack", "lexsort"}

# (name, differentiable, outputs) of `mx.np.linalg`
LINALG_FUNCS = [
    ("norm", True, 1), ("svd", True, 3), ("cholesky", True, 1),
    ("qr", True, 2), ("pinv", True, 1), ("solve", True, 1),
    ("lstsq", False, 4), ("eig", False, 2), ("eigvals", False, 1),
    ("eigh", True, 2), ("eigvalsh", True, 1), ("matrix_rank", False, 1),
    ("matrix_power", True, 1), ("multi_dot", True, 1),
    ("tensorinv", True, 1), ("tensorsolve", True, 1),
]

# ---------------------------------------------------------------------------
# types: jax.numpy's with 64-bit types off
# ---------------------------------------------------------------------------
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64, torch.uint64: torch.uint32}
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def canon_dtype(dtype):
    """A dtype (torch, numpy, string or Python type) as the torch dtype
    `mx.np` gives it: 64-bit types narrowed to 32 bits; None stays None."""
    if dtype is None:
        return None
    if not isinstance(dtype, torch.dtype):
        if isinstance(dtype, str) and dtype == "bfloat16":
            return torch.bfloat16
        if dtype is float:
            return _F32
        if dtype is int:
            return _I32
        from ..base import torch_dtype
        dtype = torch_dtype(np.dtype(dtype))
    return _NARROW.get(dtype, dtype)


def canon(t):
    """Narrow a 64-bit tensor to its 32-bit type."""
    d = _NARROW.get(t.dtype)
    return t if d is None else t.to(d)


def to_tensor(x, device=None, dtype=None):
    """An array-like (tensor, numpy array, list, scalar) as a tensor of the
    reference's type, on `device`."""
    if torch.is_tensor(x):
        t = canon(x)
        if device is not None and t.device != torch.device(device):
            t = t.to(device)
    else:
        a = np.asarray(x)
        if a.dtype == object:
            raise TypeError("mx.np: cannot make an array of %r" % (x,))
        t = canon(torch.from_numpy(np.array(a)))
        if device is not None:
            t = t.to(device)
    if dtype is not None:
        t = t.to(canon_dtype(dtype))
    return t


def _device(args):
    for a in args:
        if torch.is_tensor(a):
            return a.device
        if isinstance(a, (list, tuple)):
            d = _device(a)
            if d is not None:
                return d
    return None


def _prep(a, dev):
    """Numpy arrays and scalars become tensors; tensors are narrowed;
    containers are walked; everything else passes through."""
    if torch.is_tensor(a):
        return canon(a)
    if isinstance(a, (np.ndarray, np.generic)):
        return to_tensor(a, dev)
    if isinstance(a, list):
        return [_prep(v, dev) for v in a]
    if isinstance(a, tuple):
        return tuple(_prep(v, dev) for v in a)
    return a


def _post(out):
    if torch.is_tensor(out):
        return canon(out)
    if isinstance(out, (list, tuple)):
        return tuple(_post(o) for o in out)
    return out


def _op(name, differentiable, num_outputs=1):
    """Register `fn` as `_np_<name>`: inputs prepared and results narrowed to
    the reference's types, sequences returned as tuples."""
    def deco(fn):
        def impl(*args, **kwargs):
            dev = _device(args) or _device(list(kwargs.values()))
            args = [_prep(a, dev) for a in args]
            kwargs = {k: _prep(v, dev) for k, v in kwargs.items()}
            return _post(fn(*args, **kwargs))
        impl.__name__ = fn.__name__
        impl.__doc__ = fn.__doc__
        register("_np_" + name, differentiable=differentiable,
                 num_outputs=num_outputs)(impl)
        return fn
    return deco


def _is_float(dt):
    return dt.is_floating_point or dt.is_complex


def _arr(x, like=None, dtype=None):
    dev = like.device if torch.is_tensor(like) else None
    return to_tensor(x, dev, dtype)


def _inexact(x, like=None):
    t = _arr(x, like)
    return t if _is_float(t.dtype) else t.to(_F32)


def _common(*xs, inexact=False):
    """Tensors of the promoted type of `xs` (Python scalars weakly typed,
    as jax.numpy types them)."""
    dev = _device(xs)
    tens = [x for x in xs if torch.is_tensor(x)]
    if tens:
        dt = tens[0].dtype
        for t in tens[1:]:
            dt = torch.promote_types(dt, t.dtype)
        for x in xs:
            if isinstance(x, (int, float, complex)) and \
                    not isinstance(x, bool):
                # a weak Python scalar: an int keeps the array's type, a
                # float makes an integer array float32
                dt = torch.result_type(torch.empty((), dtype=dt), x)
            elif not torch.is_tensor(x) and not isinstance(x, bool):
                dt = torch.promote_types(dt, to_tensor(x).dtype)
    else:
        dt = None
        for x in xs:
            t = to_tensor(x)
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    dt = _NARROW.get(dt, dt)
    if inexact and not _is_float(dt):
        dt = _F32
    return [to_tensor(x, dev, dt) if not torch.is_tensor(x) else x.to(dt)
            for x in xs]


def _axis(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(a % ndim if ndim else a for a in axis)
    return (axis % ndim if ndim else axis,)


def _reduce(fn, x, axis, keepdims):
    if x.dim() == 0:
        return fn(x)
    if axis is None and not keepdims:
        return fn(x)
    return fn(x, dim=_axis(axis, x.dim()), keepdim=bool(keepdims))


def _sum_dtype(dt):
    """The type jax.numpy sums (and multiplies) `dt` in."""
    if dt == _BOOL or dt in (torch.int8, torch.int16):
        return _I32
    if dt in (torch.uint8, torch.uint16):
        return torch.uint32
    return dt


# ---------------------------------------------------------------------------
# elementwise arithmetic
# ---------------------------------------------------------------------------
def _binary(name, fn, inexact=False, diff=True):
    @_op(name, diff)
    def impl(x1, x2, **kw):
        a, b = _common(x1, x2, inexact=inexact)
        return fn(a, b, **kw)
    impl.__name__ = name
    return impl


def _unary(name, fn, inexact=True, diff=True):
    @_op(name, diff)
    def impl(x, **kw):
        t = _inexact(x) if inexact else _arr(x)
        return fn(t, **kw)
    impl.__name__ = name
    return impl


def _add(a, b):
    return torch.logical_or(a, b) if a.dtype == _BOOL else a + b


def _mul(a, b):
    return torch.logical_and(a, b) if a.dtype == _BOOL else a * b


for _n, _f in [("add", _add), ("subtract", torch.sub),
               ("multiply", _mul), ("remainder", torch.remainder),
               ("mod", torch.remainder), ("fmod", torch.fmod)]:
    _binary(_n, _f)
for _n in ("divide", "true_divide"):
    _binary(_n, torch.div, inexact=True)


_binary("power", torch.pow)
_binary("pow", torch.pow)
_binary("float_power", torch.pow, inexact=True)
_binary("maximum", torch.maximum)
_binary("minimum", torch.minimum)
_binary("fmax", lambda a, b: torch.where((a > b) | torch.isnan(b), a, b))
_binary("fmin", lambda a, b: torch.where((a < b) | torch.isnan(b), a, b))


def _hypot(a, b):
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    out = torch.where(hi == 0, hi, hi * torch.sqrt(1 + (lo / safe) ** 2))
    return torch.where(torch.isinf(a) | torch.isinf(b),
                       torch.full_like(out, math.inf), out)


_binary("hypot", _hypot, inexact=True)
_unary("negative", torch.neg, inexact=False)
_unary("positive", lambda x: x.clone(), inexact=False)
_unary("reciprocal", torch.reciprocal)


def _abs(x):
    if x.dtype == _BOOL:
        return x
    if _is_float(x.dtype) and not x.is_complex():
        # jax's derivative of |x| at 0 is +1
        return torch.where(x >= 0, x, -x)
    return torch.abs(x)


_unary("abs", _abs, inexact=False)
_unary("absolute", _abs, inexact=False)
_unary("fabs", _abs)
_unary("sign", torch.sgn, inexact=False)


def _heaviside(a, b):
    return torch.where(a < 0, torch.zeros_like(a),
                       torch.where(a > 0, torch.ones_like(a), b))


_binary("heaviside", _heaviside, inexact=True)


def _copysign(a, b):
    return torch.where(torch.signbit(b), -torch.abs(a), torch.abs(a))


_binary("copysign", _copysign, inexact=True)


@_op("ldexp", True)
def _ldexp(x1, x2):
    x = _inexact(x1)
    e = _arr(x2, x)
    return x * torch.pow(torch.tensor(2.0, dtype=x.dtype, device=x.device),
                         e.to(x.dtype))


_binary("nextafter", torch.nextafter, inexact=True, diff=False)


@_op("spacing", False)
def _spacing(x):
    x = _inexact(x)
    inf = torch.full_like(x, math.inf)
    if x.dtype == torch.float16:
        return torch.nextafter(x, inf) - x
    res = torch.nextafter(x, torch.copysign(inf, x)) - x
    tiny = torch.finfo(x.dtype).smallest_normal * \
        torch.finfo(x.dtype).eps
    return torch.where(res == 0, torch.copysign(torch.full_like(x, tiny), x),
                       res)


_unary("signbit", torch.signbit, inexact=False, diff=False)

# ---------------------------------------------------------------------------
# exp / log / trig
# ---------------------------------------------------------------------------
for _n, _f in [("exp", torch.exp), ("exp2", torch.exp2),
               ("expm1", torch.expm1), ("log", torch.log),
               ("log2", torch.log2), ("log10", torch.log10),
               ("log1p", torch.log1p), ("sqrt", torch.sqrt),
               ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
               ("arcsin", torch.asin), ("arccos", torch.acos),
               ("arctan", torch.atan), ("asin", torch.asin),
               ("acos", torch.acos), ("atan", torch.atan),
               ("sinh", torch.sinh), ("cosh", torch.cosh),
               ("tanh", torch.tanh), ("arcsinh", torch.asinh),
               ("arccosh", torch.acosh), ("arctanh", torch.atanh),
               ("asinh", torch.asinh), ("acosh", torch.acosh),
               ("atanh", torch.atanh), ("i0", torch.special.i0)]:
    _unary(_n, _f)
_binary("logaddexp", torch.logaddexp, inexact=True)
_binary("logaddexp2", torch.logaddexp2, inexact=True)
_binary("arctan2", torch.atan2, inexact=True)
_binary("atan2", torch.atan2, inexact=True)
_unary("cbrt", lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0))
_unary("square", torch.square, inexact=False)


def _sinc(x):
    safe = torch.where(x == 0, torch.ones_like(x), x)
    pix = math.pi * safe
    return torch.where(x == 0, torch.ones_like(x), torch.sin(pix) / pix)


_unary("sinc", _sinc)


@_op("angle", True)
def _angle(z, deg=False):
    z = _inexact(z)
    if z.is_complex():
        out = torch.atan2(z.imag, z.real)
    else:
        out = torch.atan2(torch.zeros_like(z), z)
    return out * (180.0 / math.pi) if deg else out


@_op("unwrap", True)
def _unwrap(p, discont=None, axis=-1, period=2 * math.pi):
    p = _arr(p)
    if not _is_float(p.dtype):
        p = p.to(_F32)
    if p.shape[axis] == 0:
        return p
    interval = period / 2
    if discont is None:
        discont = interval
    dd = torch.diff(p, dim=axis)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0),
                        torch.full_like(ddmod, interval), ddmod)
    corr = torch.where(dd.abs() < discont, torch.zeros_like(dd), ddmod - dd)
    n = p.shape[axis]
    return torch.cat([p.narrow(axis, 0, 1),
                      p.narrow(axis, 1, n - 1) + torch.cumsum(corr, axis)],
                     dim=axis)


for _n, _c in [("degrees", 180.0 / math.pi), ("rad2deg", 180.0 / math.pi),
               ("radians", math.pi / 180.0), ("deg2rad", math.pi / 180.0)]:
    _unary(_n, lambda x, c=_c: x * c)

# ---------------------------------------------------------------------------
# rounding
# ---------------------------------------------------------------------------
_unary("rint", torch.round)


def _int_keep(fn):
    def impl(x):
        return x.clone() if not _is_float(x.dtype) else fn(x)
    return impl


for _n, _f in [("floor", torch.floor), ("ceil", torch.ceil),
               ("trunc", torch.trunc)]:
    _unary(_n, _int_keep(_f), inexact=False)
register("_np_fix", differentiable=True)(
    lambda x: _post(_int_keep(torch.trunc)(_prep(x, None))))


def _round(x, decimals=0, out=None):
    x = _arr(x)
    if not _is_float(x.dtype):
        if decimals >= 0:
            return x.clone()
        f = 10 ** (-decimals)
        return (torch.round(x.to(_F32) / f) * f).to(x.dtype)
    if decimals == 0:
        return torch.round(x)
    f = torch.tensor(10.0 ** decimals, dtype=x.dtype, device=x.device)
    return torch.round(x * f) / f


_op("round", True)(_round)
_op("around", True)(_round)


@_op("clip", True)
def _clip(arr, min=None, max=None, a_min=None, a_max=None):
    lo = min if min is not None else a_min
    hi = max if max is not None else a_max
    x = _arr(arr)
    if lo is not None:
        lo_t, x = _common(lo, x)
        x = torch.maximum(lo_t, x)
    if hi is not None:
        hi_t, x = _common(hi, x)
        x = torch.minimum(hi_t, x)
    return x


@_op("nan_to_num", True)
def _nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    x = _arr(x)
    if not _is_float(x.dtype):
        return x.clone()
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# ---------------------------------------------------------------------------
# linear algebra / products
# ---------------------------------------------------------------------------
@_op("dot", True)
def _dot(a, b):
    a, b = _common(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1:
        return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


@_op("matmul", True)
def _matmul(a, b):
    a, b = _common(a, b)
    if a.dtype == _BOOL:
        return torch.matmul(a.to(_I32), b.to(_I32)) != 0
    return torch.matmul(a, b)


@_op("inner", True)
def _inner(a, b):
    a, b = _common(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 1]))


@_op("outer", True)
def _outer(a, b):
    a, b = _common(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


@_op("tensordot", True)
def _tensordot(a, b, axes=2):
    a, b = _common(a, b)
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(x) if isinstance(x, (list, tuple)) else (x,)
                     for x in axes)
    return torch.tensordot(a, b, dims=axes)


@_op("einsum", True)
def _einsum(subscripts, *operands, optimize=None, precision=None,
            preferred_element_type=None):
    ops = _common(*operands)
    return torch.einsum(subscripts, *ops)


@_op("vdot", True)
def _vdot(a, b):
    a, b = _common(a, b)
    return torch.sum(a.reshape(-1).conj() * b.reshape(-1))


@_op("vecdot", True)
def _vecdot(x1, x2, axis=-1):
    a, b = _common(x1, x2)
    a, b = torch.broadcast_tensors(a, b)
    return torch.sum(a.conj() * b, dim=axis)


@_op("kron", True)
def _kron(a, b):
    a, b = _common(a, b)
    return torch.kron(a, b)


@_op("cross", True)
def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _common(a, b)
    if axis is not None:
        axisa = axisb = axisc = axis
    a = torch.movedim(a, axisa, -1)
    b = torch.movedim(b, axisb, -1)
    if a.shape[-1] == 2:
        a = F.pad(a, (0, 1))
    if b.shape[-1] == 2:
        b = F.pad(b, (0, 1))
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    c = torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                     a0 * b1 - a1 * b0], dim=-1)
    return torch.movedim(c, -1, axisc)


@_op("trace", True)
def _trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    a = _arr(a)
    d = torch.diagonal(a, offset=offset, dim1=axis1, dim2=axis2)
    dt = canon_dtype(dtype) or _sum_dtype(a.dtype)
    return torch.sum(d.to(dt) if d.dtype != dt else d, dim=-1)


@_op("matrix_transpose", True)
def _matrix_transpose(x):
    return _arr(x).transpose(-1, -2)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _where_mask(x, where, fill):
    if where is None:
        return x
    w = _arr(where, x).to(_BOOL)
    return torch.where(w, x, torch.full_like(x, fill))


@_op("sum", True)
def _sum(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
         where=None, promote_integers=True):
    a = _arr(a)
    dt = canon_dtype(dtype) or _sum_dtype(a.dtype)
    a = _where_mask(a, where, 0)
    acc = a.to(dt) if dt != a.dtype else a
    if dt == torch.uint32:
        acc = a.to(torch.int64)
    r = _reduce(torch.sum, acc, axis, keepdims)
    if initial is not None:
        r = r + initial
    return r.to(dt)


@_op("prod", True)
def _prod(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
          where=None, promote_integers=True):
    a = _arr(a)
    dt = canon_dtype(dtype) or _sum_dtype(a.dtype)
    a = _where_mask(a, where, 1)
    acc = a.to(dt) if dt != torch.uint32 else a.to(torch.int64)
    if acc.dim() == 0:
        r = acc.clone()
    else:
        r = acc
        for ax in sorted(_axis(axis, acc.dim()), reverse=True):
            r = torch.prod(r, dim=ax, keepdim=bool(keepdims))
    if initial is not None:
        r = r * initial
    return r.to(dt)


def _mean_dtype(a, dtype):
    if dtype is not None:
        return canon_dtype(dtype)
    return a.dtype if _is_float(a.dtype) else _F32


def _count(a, axis):
    return math.prod(a.shape[i] for i in _axis(axis, a.dim())) \
        if a.dim() else 1


@_op("mean", True)
def _mean(a, axis=None, dtype=None, out=None, keepdims=False, where=None):
    a = _arr(a)
    dt = _mean_dtype(a, dtype)
    acc = torch.float32 if dt in (torch.float16, torch.bfloat16) else dt
    if where is not None:
        w = _arr(where, a).to(_BOOL)
        w = torch.broadcast_to(w, a.shape)
        s = _reduce(torch.sum, torch.where(w, a.to(acc),
                                           torch.zeros((), dtype=acc,
                                                       device=a.device)),
                    axis, keepdims)
        n = _reduce(torch.sum, w.to(acc), axis, keepdims)
        return (s / n).to(dt)
    s = _reduce(torch.sum, a.to(acc), axis, keepdims)
    return (s / _count(a, axis)).to(dt)


def _var_impl(a, axis, dtype, ddof, keepdims, nan=False):
    a = _arr(a)
    dt = _mean_dtype(a, dtype)
    acc = torch.float32 if dt in (torch.float16, torch.bfloat16) else dt
    x = a.to(acc)
    if nan:
        ok = ~torch.isnan(x)
        n = _reduce(torch.sum, ok.to(acc), axis, True)
        mu = _reduce(torch.sum, torch.where(ok, x, torch.zeros_like(x)),
                     axis, True) / n
        c = torch.where(ok, x - mu, torch.zeros_like(x))
        sq = (c * c.conj()).real if c.is_complex() else c * c
        s = _reduce(torch.sum, sq, axis, keepdims)
        nn_ = _reduce(torch.sum, ok.to(acc), axis, keepdims)
        return (s / (nn_ - ddof)).to(dt)
    mu = _reduce(torch.sum, x, axis, True) / _count(x, axis)
    c = x - mu
    sq = (c * c.conj()).real if c.is_complex() else c * c
    s = _reduce(torch.sum, sq, axis, keepdims)
    return (s / (_count(x, axis) - ddof)).to(dt)


@_op("var", True)
def _var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, *,
         where=None, correction=None):
    return _var_impl(a, axis, dtype, ddof if correction is None
                     else correction, keepdims)


@_op("std", True)
def _std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, *,
         where=None, correction=None):
    return torch.sqrt(_var_impl(a, axis, dtype, ddof if correction is None
                                else correction, keepdims))


def _cum(fn, a, axis, dtype, fill=None):
    a = _arr(a)
    if fill is not None and _is_float(a.dtype):
        a = torch.where(torch.isnan(a), torch.full_like(a, fill), a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    dt = canon_dtype(dtype) or (_I32 if a.dtype == _BOOL else a.dtype)
    if a.dim() == 0:
        return a.to(dt).reshape(1) if axis is None else a.to(dt)
    return fn(a.to(dt), dim=axis).to(dt)


@_op("cumsum", True)
def _cumsum(a, axis=None, dtype=None, out=None):
    return _cum(torch.cumsum, a, axis, dtype)


@_op("cumprod", True)
def _cumprod(a, axis=None, dtype=None, out=None):
    return _cum(torch.cumprod, a, axis, dtype)


@_op("nancumsum", True)
def _nancumsum(a, axis=None, dtype=None, out=None):
    return _cum(torch.cumsum, a, axis, dtype, fill=0.0)


@_op("nancumprod", True)
def _nancumprod(a, axis=None, dtype=None, out=None):
    return _cum(torch.cumprod, a, axis, dtype, fill=1.0)


def _amax(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    a = _arr(a)
    if where is not None:
        lo = -math.inf if _is_float(a.dtype) else torch.iinfo(a.dtype).min
        a = _where_mask(a, where, lo if initial is None else initial)
    if a.dtype == _BOOL:
        r = _reduce(torch.amax, a.to(torch.uint8), axis, keepdims).to(_BOOL)
    else:
        r = _reduce(torch.amax, a, axis, keepdims)
    if initial is not None:
        r = torch.maximum(r, torch.tensor(initial, dtype=r.dtype,
                                          device=r.device))
    return r


def _amin(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    a = _arr(a)
    if where is not None:
        hi = math.inf if _is_float(a.dtype) else torch.iinfo(a.dtype).max
        a = _where_mask(a, where, hi if initial is None else initial)
    if a.dtype == _BOOL:
        r = _reduce(torch.amin, a.to(torch.uint8), axis, keepdims).to(_BOOL)
    else:
        r = _reduce(torch.amin, a, axis, keepdims)
    if initial is not None:
        r = torch.minimum(r, torch.tensor(initial, dtype=r.dtype,
                                          device=r.device))
    return r


for _n in ("max", "amax"):
    _op(_n, True)(_amax)
for _n in ("min", "amin"):
    _op(_n, True)(_amin)


@_op("ptp", True)
def _ptp(a, axis=None, out=None, keepdims=False):
    return _amax(a, axis, keepdims=keepdims) - _amin(a, axis,
                                                     keepdims=keepdims)


def _quantile_impl(a, q, axis, method, keepdims, nan):
    a = _inexact(a)
    q = _arr(q, a).to(a.dtype)
    if axis is None:
        x = a.reshape(-1)
        ax = 0
    else:
        ax = axis % a.dim()
        x = a
    x = torch.movedim(x, ax, -1)
    n = x.shape[-1]
    xs = torch.sort(x, dim=-1, stable=True).values
    if nan:
        cnt = (~torch.isnan(x)).sum(-1, keepdim=True).to(a.dtype)
    else:
        cnt = torch.full(x.shape[:-1] + (1,), float(n), dtype=a.dtype,
                         device=a.device)
    qf = q.reshape(q.shape + (1,) * (xs.dim()))
    pos = qf * (cnt - 1)
    if method == "linear":
        lo = torch.floor(pos)
        hi = torch.ceil(pos)
    elif method == "lower":
        lo = hi = torch.floor(pos)
    elif method == "higher":
        lo = hi = torch.ceil(pos)
    elif method == "nearest":
        lo = hi = torch.round(pos)
    elif method == "midpoint":
        lo, hi = torch.floor(pos), torch.ceil(pos)
    else:
        raise ValueError("quantile: unknown method %r" % method)
    hw = pos - lo
    lw = 1 - hw
    lo_i = torch.clamp(lo, 0, n - 1).to(torch.int64)
    hi_i = torch.clamp(hi, 0, n - 1).to(torch.int64)
    big = torch.broadcast_to(xs, qf.shape[:q.dim()] + xs.shape)
    lv = torch.gather(big, -1, torch.broadcast_to(lo_i, big.shape[:-1] + (1,)))
    hv = torch.gather(big, -1, torch.broadcast_to(hi_i, big.shape[:-1] + (1,)))
    if method == "midpoint":
        out = (lv + hv) * 0.5
    elif method == "linear":
        out = lv * lw + hv * hw
    else:
        out = lv
    out = out[..., 0]
    if nan:
        out = torch.where(cnt[..., 0] == 0, torch.full_like(out, math.nan),
                          out)
    else:
        out = torch.where(torch.isnan(x).any(-1), torch.full_like(out,
                                                                  math.nan),
                          out)
    if keepdims:
        if axis is None:
            out = out.reshape(q.shape + (1,) * a.dim())
        else:
            out = out.unsqueeze(q.dim() + ax)
    return out


@_op("quantile", True)
def _quantile(a, q, axis=None, out=None, overwrite_input=False,
              method="linear", keepdims=False, *, interpolation=None):
    return _quantile_impl(a, q, axis, interpolation or method, keepdims,
                          False)


@_op("nanquantile", True)
def _nanquantile(a, q, axis=None, out=None, overwrite_input=False,
                 method="linear", keepdims=False, *, interpolation=None):
    return _quantile_impl(a, q, axis, interpolation or method, keepdims,
                          True)


@_op("percentile", True)
def _percentile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False, *, interpolation=None):
    q = _arr(q, _arr(a))
    return _quantile_impl(a, q / 100, axis, interpolation or method,
                          keepdims, False)


@_op("nanpercentile", True)
def _nanpercentile(a, q, axis=None, out=None, overwrite_input=False,
                   method="linear", keepdims=False, *, interpolation=None):
    q = _arr(q, _arr(a))
    return _quantile_impl(a, q / 100, axis, interpolation or method,
                          keepdims, True)


@_op("median", True)
def _median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return _quantile_impl(a, 0.5, axis, "linear", keepdims, False)


@_op("nanmedian", True)
def _nanmedian(a, axis=None, out=None, overwrite_input=False,
               keepdims=False):
    return _quantile_impl(a, 0.5, axis, "linear", keepdims, True)


@_op("average", True)
def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _arr(a)
    if weights is None:
        x = a if _is_float(a.dtype) else a.to(_F32)
        avg = _reduce(torch.sum, x, axis, keepdims) / _count(x, axis)
        wsum = torch.full_like(avg, float(_count(x, axis)))
    else:
        x, w = _common(a, weights, inexact=True)
        if w.dim() == 1 and x.dim() > 1 and axis is not None:
            shape = [1] * x.dim()
            shape[axis % x.dim()] = -1
            w = w.reshape(shape)
        w = torch.broadcast_to(w, x.shape)
        wsum = _reduce(torch.sum, w, axis, keepdims)
        avg = _reduce(torch.sum, x * w, axis, keepdims) / wsum
    if returned:
        return avg, torch.broadcast_to(wsum, avg.shape).clone()
    return avg


def _nan_fill(a, fill):
    a = _arr(a)
    if not _is_float(a.dtype):
        return a
    return torch.where(torch.isnan(a), torch.full_like(a, fill), a)


@_op("nansum", True)
def _nansum(a, axis=None, dtype=None, out=None, keepdims=False,
            initial=None, where=None):
    return _sum(_nan_fill(a, 0.0), axis, dtype, keepdims=keepdims,
                initial=initial, where=where)


@_op("nanprod", True)
def _nanprod(a, axis=None, dtype=None, out=None, keepdims=False,
             initial=None, where=None):
    return _prod(_nan_fill(a, 1.0), axis, dtype, keepdims=keepdims,
                 initial=initial, where=where)


@_op("nanmean", True)
def _nanmean(a, axis=None, dtype=None, out=None, keepdims=False,
             where=None):
    a = _arr(a)
    if not _is_float(a.dtype):
        return _mean(a, axis, dtype, keepdims=keepdims)
    dt = _mean_dtype(a, dtype)
    ok = ~torch.isnan(a)
    s = _reduce(torch.sum, torch.where(ok, a, torch.zeros_like(a)).to(dt),
                axis, keepdims)
    n = _reduce(torch.sum, ok.to(dt), axis, keepdims)
    return s / n


@_op("nanvar", True)
def _nanvar(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            where=None):
    return _var_impl(a, axis, dtype, ddof, keepdims, nan=True)


@_op("nanstd", True)
def _nanstd(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            where=None):
    return torch.sqrt(_var_impl(a, axis, dtype, ddof, keepdims, nan=True))


def _nanext(a, axis, keepdims, fn, fill):
    a = _arr(a)
    if not _is_float(a.dtype):
        return fn(a, axis, keepdims=keepdims)
    nan = torch.isnan(a)
    r = fn(torch.where(nan, torch.full_like(a, fill), a), axis,
           keepdims=keepdims)
    alln = _reduce(torch.all, nan, axis, keepdims)
    return torch.where(alln, torch.full_like(r, math.nan), r)


@_op("nanmax", True)
def _nanmax(a, axis=None, out=None, keepdims=False, initial=None,
            where=None):
    return _nanext(a, axis, keepdims, _amax, -math.inf)


@_op("nanmin", True)
def _nanmin(a, axis=None, out=None, keepdims=False, initial=None,
            where=None):
    return _nanext(a, axis, keepdims, _amin, math.inf)


def _arg(fn, a, axis, keepdims):
    a = _arr(a)
    if a.dtype == _BOOL:
        a = a.to(torch.uint8)
    if axis is None:
        r = fn(a.reshape(-1), dim=0)
        if keepdims:
            r = r.reshape((1,) * a.dim())
        return r.to(_I32)
    return fn(a, dim=axis, keepdim=bool(keepdims)).to(_I32)


def _nanarg(a, axis, keepdims, fn, fill):
    a = _arr(a)
    if not _is_float(a.dtype):
        return _arg(fn, a, axis, keepdims)
    nan = torch.isnan(a)
    r = _arg(fn, torch.where(nan, torch.full_like(a, fill), a), axis,
             keepdims)
    alln = _reduce(torch.all, nan, axis, keepdims)
    return torch.where(alln, torch.full_like(r, -1), r)


@_op("nanargmax", False)
def _nanargmax(a, axis=None, out=None, keepdims=None):
    return _nanarg(a, axis, keepdims, torch.argmax, -math.inf)


@_op("nanargmin", False)
def _nanargmin(a, axis=None, out=None, keepdims=None):
    return _nanarg(a, axis, keepdims, torch.argmin, math.inf)


@_op("argmax", False)
def _argmax(a, axis=None, out=None, keepdims=None):
    return _arg(torch.argmax, a, axis, keepdims)


@_op("argmin", False)
def _argmin(a, axis=None, out=None, keepdims=None):
    return _arg(torch.argmin, a, axis, keepdims)


@_op("trapezoid", True)
def _trapezoid(y, x=None, dx=1.0, axis=-1):
    y = _inexact(y)
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    y, x = _common(y, x, inexact=True)
    return torch.trapezoid(y, x, dim=axis)


def _cov_impl(m, y=None, rowvar=True, bias=False, ddof=None):
    m = _inexact(m)
    X = torch.atleast_2d(m)
    if not rowvar and m.dim() != 1:
        X = X.T
    if y is not None:
        X, y = _common(X, y, inexact=True)
        Y = torch.atleast_2d(y)
        if not rowvar and Y.shape[0] != 1:
            Y = Y.T
        X = torch.cat([X, Y], dim=0)
    if ddof is None:
        ddof = 0 if bias else 1
    n = X.shape[1]
    Xc = X - X.mean(dim=1, keepdim=True)
    c = Xc @ Xc.T.conj() / (n - ddof)
    return c.squeeze()


@_op("cov", True)
def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None, dtype=None):
    if fweights is not None or aweights is not None:
        m = _inexact(m)
        X = torch.atleast_2d(m)
        if not rowvar and m.dim() != 1:
            X = X.T
        if y is not None:
            X, y = _common(X, y, inexact=True)
            Y = torch.atleast_2d(y)
            if not rowvar and Y.shape[0] != 1:
                Y = Y.T
            X = torch.cat([X, Y], dim=0)
        if ddof is None:
            ddof = 0 if bias else 1
        w = None
        if fweights is not None:
            w = _arr(fweights, X).abs().to(X.dtype)
        if aweights is not None:
            aw = _arr(aweights, X).abs().to(X.dtype)
            w = aw if w is None else w * aw
        w_sum = w.sum()
        avg = (X * w).sum(1) / w_sum
        if ddof == 0:
            fact = w_sum
        elif aweights is None:
            fact = w_sum - ddof
        else:
            fact = w_sum - ddof * torch.sum(w * aw) / w_sum
        Xc = X - avg[:, None]
        return ((Xc * w) @ Xc.T.conj() / fact).squeeze()
    return _cov_impl(m, y, rowvar, bias, ddof)


@_op("corrcoef", True)
def _corrcoef(x, y=None, rowvar=True, dtype=None):
    c = _cov_impl(x, y, rowvar)
    if c.dim() == 0:
        return c / c
    d = torch.diagonal(c)
    sd = torch.sqrt(d.real if d.is_complex() else d).to(c.dtype)
    c = c / sd[:, None] / sd[None, :]
    return torch.minimum(torch.maximum(c, torch.tensor(-1.0, dtype=c.dtype,
                                                       device=c.device)),
                         torch.tensor(1.0, dtype=c.dtype, device=c.device))


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------
def _shape_arg(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


@_op("reshape", True)
def _reshape(a, shape=None, order="C", *, newshape=None, copy=None):
    shape = newshape if shape is None else shape
    return _arr(a).reshape(_shape_arg(shape))


@_op("ravel", True)
def _ravel(a, order="C"):
    return _arr(a).reshape(-1)


@_op("transpose", True)
def _transpose(a, axes=None):
    a = _arr(a)
    if axes is None:
        return a.permute(*range(a.dim() - 1, -1, -1))
    return a.permute(*axes)


@_op("permute_dims", True)
def _permute_dims(a, axes=None):
    return _transpose(a, axes)


@_op("swapaxes", True)
def _swapaxes(a, axis1, axis2):
    return _arr(a).transpose(axis1, axis2)


@_op("moveaxis", True)
def _moveaxis_op(a, source, destination):
    return torch.movedim(_arr(a), source, destination)


@_op("rollaxis", True)
def _rollaxis(a, axis, start=0):
    a = _arr(a)
    n = a.dim()
    axis %= n
    if start < 0:
        start += n
    if axis < start:
        start -= 1
    return torch.movedim(a, axis, start)


@_op("expand_dims", True)
def _expand_dims(a, axis):
    a = _arr(a)
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    n = a.dim() + len(axes)
    axes = sorted(ax % n for ax in axes)
    for ax in axes:
        a = a.unsqueeze(ax)
    return a


@_op("squeeze", True)
def _squeeze(a, axis=None):
    a = _arr(a)
    if axis is None:
        return a.squeeze()
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    for ax in sorted((x % a.dim() for x in axes), reverse=True):
        if a.shape[ax] != 1:
            raise ValueError("cannot select an axis to squeeze out which "
                             "has size not equal to one")
        a = a.squeeze(ax)
    return a


@_op("broadcast_to", True)
def _broadcast_to(array, shape):
    return torch.broadcast_to(_arr(array), _shape_arg(shape))


def _concat(arrays, axis=0, dtype=None):
    ts = _common(*arrays)
    if dtype is not None:
        ts = [t.to(canon_dtype(dtype)) for t in ts]
    if axis is None:
        return torch.cat([t.reshape(-1) for t in ts])
    return torch.cat(ts, dim=axis)


@_op("concatenate", True)
def _concatenate(*arrays, axis=0, dtype=None):
    return _concat(arrays, axis, dtype)


@_op("concat", True)
def _concat_op(*arrays, axis=0):
    return _concat(arrays, axis)


@_op("stack", True)
def _stack(*arrays, axis=0, out=None, dtype=None):
    ts = _common(*arrays)
    if dtype is not None:
        ts = [t.to(canon_dtype(dtype)) for t in ts]
    return torch.stack(ts, dim=axis)


@_op("vstack", True)
def _vstack(*tup, dtype=None):
    return _concat([torch.atleast_2d(t) for t in _common(*tup)], 0, dtype)


@_op("hstack", True)
def _hstack(*tup, dtype=None):
    ts = [torch.atleast_1d(t) for t in _common(*tup)]
    return _concat(ts, 0 if ts[0].dim() == 1 else 1, dtype)


@_op("dstack", True)
def _dstack(*tup, dtype=None):
    return _concat([torch.atleast_3d(t) for t in _common(*tup)], 2, dtype)


@_op("column_stack", True)
def _column_stack(*tup):
    ts = [t.reshape(-1, 1) if t.dim() < 2 else t for t in _common(*tup)]
    return torch.cat(ts, dim=1)


def _split_impl(a, ios, axis, strict):
    a = _arr(a)
    if torch.is_tensor(ios):
        ios = ios.tolist()
    if isinstance(ios, int):
        if strict and a.shape[axis] % ios:
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(a, ios, dim=axis))
    return tuple(torch.tensor_split(a, [int(i) for i in ios], dim=axis))


@_op("split", True)
def _split(ary, indices_or_sections, axis=0):
    return _split_impl(ary, indices_or_sections, axis, True)


@_op("array_split", True)
def _array_split(ary, indices_or_sections, axis=0):
    return _split_impl(ary, indices_or_sections, axis, False)


@_op("vsplit", True)
def _vsplit(ary, indices_or_sections):
    return _split_impl(ary, indices_or_sections, 0, True)


@_op("hsplit", True)
def _hsplit(ary, indices_or_sections):
    a = _arr(ary)
    return _split_impl(a, indices_or_sections, 0 if a.dim() == 1 else 1,
                       True)


@_op("dsplit", True)
def _dsplit(ary, indices_or_sections):
    return _split_impl(ary, indices_or_sections, 2, True)


@_op("tile", True)
def _tile(A, reps):
    a = _arr(A)
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(a, reps)


@_op("repeat", True)
def _repeat(a, repeats, axis=None, *, total_repeat_length=None):
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    if torch.is_tensor(repeats):
        repeats = repeats.to(a.device).long()
    elif isinstance(repeats, (list, tuple)):
        repeats = torch.tensor(repeats, device=a.device)
    return torch.repeat_interleave(a, repeats, dim=axis)


@_op("roll", True)
def _roll(a, shift, axis=None):
    a = _arr(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, dims=axis)


@_op("flip", True)
def _flip(m, axis=None):
    m = _arr(m)
    dims = _axis(axis, m.dim())
    return torch.flip(m, dims)


@_op("fliplr", True)
def _fliplr(m):
    return torch.flip(_arr(m), (1,))


@_op("flipud", True)
def _flipud(m):
    return torch.flip(_arr(m), (0,))


@_op("rot90", True)
def _rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(_arr(m), k, list(axes))


def _pad_widths(pad_width, ndim):
    a = np.asarray(pad_width, dtype=np.int64)
    if a.ndim == 0:
        pw = np.full((ndim, 2), int(a))
    elif a.ndim == 1:
        pw = np.broadcast_to(a.reshape(1, -1) if a.size == 2
                             else a.reshape(-1, 1), (ndim, 2))
    else:
        pw = np.broadcast_to(a, (ndim, 2))
    return [(int(b), int(e)) for b, e in pw]


def _pad_index(n, before, after, mode):
    """Source index of every padded position along one axis."""
    i = np.arange(-before, n + after)
    if mode == "edge":
        return np.clip(i, 0, n - 1)
    if mode == "wrap":
        return np.mod(i, n)
    if mode == "reflect":
        if n == 1:
            return np.zeros_like(i)
        period = 2 * (n - 1)
        j = np.mod(i, period)
        return np.where(j >= n, period - j, j)
    if mode == "symmetric":
        period = 2 * n
        j = np.mod(i, period)
        return np.where(j >= n, period - 1 - j, j)
    raise ValueError(mode)


@_op("pad", True)
def _pad(array, pad_width, mode="constant", **kwargs):
    a = _arr(array)
    widths = _pad_widths(pad_width, a.dim())
    if callable(mode):
        raise NotImplementedError("mx.np.pad: a callable mode")
    if mode == "constant":
        cv = kwargs.get("constant_values", 0)
        cva = np.asarray(cv.tolist() if torch.is_tensor(cv) else cv)
        if cva.ndim == 0:
            cv2 = [(float(cva), float(cva))] * a.dim()
        else:
            cv2 = [tuple(float(v) for v in r) for r in np.broadcast_to(
                cva.reshape(-1, 2) if cva.size == 2 or cva.ndim > 1
                else cva.reshape(-1, 1), (a.dim(), 2))]
        out = a
        for ax, ((b, e), (vb, ve)) in enumerate(zip(widths, cv2)):
            parts = []
            if b:
                shp = list(out.shape)
                shp[ax] = b
                parts.append(torch.full(shp, vb, dtype=a.dtype,
                                        device=a.device))
            parts.append(out)
            if e:
                shp = list(out.shape)
                shp[ax] = e
                parts.append(torch.full(shp, ve, dtype=a.dtype,
                                        device=a.device))
            out = torch.cat(parts, dim=ax)
        return out
    if mode == "empty":
        return _pad(a, pad_width, "constant")
    if mode in ("maximum", "minimum", "mean", "median"):
        out = a
        red = {"maximum": lambda t, ax: t.amax(ax, keepdim=True),
               "minimum": lambda t, ax: t.amin(ax, keepdim=True),
               "mean": lambda t, ax: t.mean(ax, keepdim=True),
               "median": lambda t, ax: _quantile_impl(
                   t, 0.5, ax, "linear", True, False)}[mode]
        for ax, (b, e) in enumerate(widths):
            v = red(out, ax)
            if not _is_float(a.dtype) and mode in ("mean", "median"):
                v = torch.round(v.float()).to(a.dtype)
            parts = []
            if b:
                parts.append(v.expand(*[b if i == ax else s for i, s in
                                        enumerate(out.shape)]))
            parts.append(out)
            if e:
                parts.append(v.expand(*[e if i == ax else s for i, s in
                                        enumerate(out.shape)]))
            out = torch.cat(parts, dim=ax)
        return out
    if mode == "linear_ramp":
        end = kwargs.get("end_values", 0)
        ev = np.broadcast_to(np.asarray(end, dtype=np.float64).reshape(
            -1, 2) if np.ndim(end) else np.full((1, 2), float(end)),
            (a.dim(), 2))
        out = a
        for ax, ((b, e), (vb, ve)) in enumerate(zip(widths, ev)):
            n = out.shape[ax]
            parts = []
            if b:
                edge = out.narrow(ax, 0, 1)
                t = torch.arange(b, device=a.device, dtype=_F32) / b
                shp = [1] * out.dim()
                shp[ax] = b
                ramp = vb + (edge.float() - vb) * t.reshape(shp)
                parts.append(ramp.to(a.dtype))
            parts.append(out)
            if e:
                edge = out.narrow(ax, n - 1, 1)
                t = torch.arange(e, 0, -1, device=a.device, dtype=_F32) / e
                shp = [1] * out.dim()
                shp[ax] = e
                ramp = ve + (edge.float() - ve) * t.reshape(shp)
                parts.append(ramp.to(a.dtype))
            out = torch.cat(parts, dim=ax)
        return out
    out = a
    for ax, (b, e) in enumerate(widths):
        if b == 0 and e == 0:
            continue
        idx = _pad_index(out.shape[ax], b, e, mode)
        out = torch.index_select(out, ax, torch.as_tensor(
            idx, device=a.device))
    return out


@_op("append", True)
def _append(arr, values, axis=None):
    a, v = _common(arr, values)
    if axis is None:
        return torch.cat([a.reshape(-1), v.reshape(-1)])
    return torch.cat([a, v], dim=axis)


def _index_list(obj, n):
    if isinstance(obj, slice):
        return list(range(n))[obj]
    if torch.is_tensor(obj):
        obj = obj.tolist()
    if isinstance(obj, (int, np.integer)):
        return [int(obj)]
    return [int(o) for o in obj]


@_op("delete", True)
def _delete(arr, obj, axis=None, *, assume_unique_indices=False):
    a = _arr(arr)
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    if torch.is_tensor(obj) and obj.dtype == _BOOL:
        keep = ~obj.to(a.device)
        return a[(slice(None),) * (axis % a.dim()) + (keep,)]
    drop = {i % n for i in _index_list(obj, n)}
    keep = torch.as_tensor([i for i in range(n) if i not in drop],
                           dtype=torch.int64, device=a.device)
    return torch.index_select(a, axis, keep)


@_op("insert", True)
def _insert(arr, obj, values, axis=None):
    a = _arr(arr)
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.dim()
    n = a.shape[axis]
    v = _arr(values, a).to(a.dtype)
    scalar = isinstance(obj, (int, np.integer)) or (
        torch.is_tensor(obj) and obj.dim() == 0)
    if isinstance(obj, slice):
        idx = list(range(n))[obj]
    elif torch.is_tensor(obj):
        idx = obj.reshape(-1).tolist()
    else:
        idx = [int(o) for o in np.atleast_1d(obj)]
    idx = [i + n if i < 0 else i for i in idx]
    if scalar:
        # numpy: values gain leading axes up to arr's rank, their first
        # axis moves to `axis` and the rest broadcast against arr
        v = v.reshape((1,) * (a.dim() - v.dim()) + tuple(v.shape))
        v = torch.movedim(v, 0, axis)
        shp = list(a.shape)
        shp[axis] = v.shape[axis]
        v = torch.broadcast_to(v, shp)
        i = idx[0]
        return torch.cat([a.narrow(axis, 0, i), v,
                          a.narrow(axis, i, n - i)], dim=axis)
    k = len(idx)
    shp = list(a.shape)
    shp[axis] = k
    if v.dim() == 1 and v.shape[0] == k:
        vb = v.reshape([k if i == axis else 1 for i in range(a.dim())])
    else:
        vb = v
    vb = torch.broadcast_to(vb, shp)
    order = np.argsort(np.asarray(idx), kind="stable")
    pos = np.asarray(idx)[order] + np.arange(k)
    total = n + k
    is_new = np.zeros(total, dtype=bool)
    is_new[pos] = True
    src = np.empty(total, dtype=np.int64)
    src[~is_new] = np.arange(n)
    src[pos] = n + order
    both = torch.cat([a, vb.to(a.dtype)], dim=axis)
    return torch.index_select(both, axis, torch.as_tensor(src,
                                                          device=a.device))


@_op("resize", True)
def _resize(a, new_shape):
    a = _arr(a).reshape(-1)
    shape = _shape_arg(new_shape)
    size = math.prod(shape)
    if a.numel() == 0 or size == 0:
        return torch.zeros(shape, dtype=a.dtype, device=a.device)
    reps = -(-size // a.numel())
    return a.repeat(reps)[:size].reshape(shape)


@_op("trim_zeros", True)
def _trim_zeros(filt, trim="fb", axis=None):
    f = _arr(filt)
    nz = (f != 0).reshape(-1) if f.dim() == 1 else (f != 0)
    if f.dim() != 1:
        raise NotImplementedError("mx.np.trim_zeros: 1-D input only")
    idx = torch.nonzero(nz).reshape(-1)
    if idx.numel() == 0:
        return f[:0]
    lo = int(idx[0]) if "f" in trim.lower() else 0
    hi = int(idx[-1]) + 1 if "b" in trim.lower() else f.shape[0]
    return f[lo:hi]


@_op("broadcast_arrays", True)
def _broadcast_arrays(*args):
    return tuple(torch.broadcast_tensors(*[_arr(a) for a in args]))


def _atleast(fn, arys):
    out = tuple(fn(_arr(a)) for a in arys)
    return out[0] if len(out) == 1 else out


@_op("atleast_1d", True)
def _atleast_1d(*arys):
    return _atleast(torch.atleast_1d, arys)


@_op("atleast_2d", True)
def _atleast_2d(*arys):
    return _atleast(torch.atleast_2d, arys)


@_op("atleast_3d", True)
def _atleast_3d(*arys):
    return _atleast(torch.atleast_3d, arys)


@_op("astype", True)
def _astype(x, dtype, /, *, copy=False, device=None):
    return _arr(x).to(canon_dtype(dtype))


@_op("copy", True)
def _copy(a, order=None):
    return _arr(a).clone()


# ---------------------------------------------------------------------------
# indexing / selection
# ---------------------------------------------------------------------------
def _fill_value(dtype):
    if _is_float(dtype):
        return math.nan
    if dtype == _BOOL:
        return True
    if dtype in (torch.uint8, torch.uint16, torch.uint32):
        return torch.iinfo(dtype).max
    return torch.iinfo(dtype).min


def _gather_mode(a, idx, axis, mode, fill_value):
    """a's elements at `idx` along `axis` (idx broadcast against a's other
    axes by the caller), out-of-range indices handled as jax.numpy's
    `mode` says."""
    n = a.shape[axis]
    idx = idx.to(torch.int64)
    if mode in (None, "fill"):
        j = torch.where(idx < 0, idx + n, idx)
        bad = (j < 0) | (j >= n)
        j = torch.clamp(j, 0, max(n - 1, 0))
        return j, bad
    if mode == "clip":
        return torch.clamp(idx, 0, n - 1), None
    if mode == "wrap":
        return torch.remainder(idx, n), None
    if mode == "promise_in_bounds":
        return torch.where(idx < 0, idx + n, idx), None
    raise ValueError("take: invalid mode %r" % mode)


@_op("take", True)
def _take(a, indices, axis=None, out=None, mode=None, unique_indices=False,
          indices_are_sorted=False, fill_value=None):
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.dim()
    idx = _arr(indices, a)
    j, bad = _gather_mode(a, idx, axis, mode, fill_value)
    flat = torch.index_select(a, axis, j.reshape(-1))
    shp = a.shape[:axis] + tuple(idx.shape) + a.shape[axis + 1:]
    res = flat.reshape(shp)
    if bad is not None and bool(bad.any()):
        fv = _fill_value(a.dtype) if fill_value is None else fill_value
        m = bad.reshape((1,) * axis + tuple(idx.shape) +
                        (1,) * (a.dim() - axis - 1))
        res = torch.where(m, torch.full_like(res, fv), res)
    return res


@_op("take_along_axis", True)
def _take_along_axis(arr, indices, axis, mode=None, fill_value=None):
    a = _arr(arr)
    idx = _arr(indices, a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.dim()
    j, bad = _gather_mode(a, idx, axis, mode, fill_value)
    shp = list(torch.broadcast_shapes(
        tuple(1 if i == axis else s for i, s in enumerate(a.shape)),
        tuple(1 if i == axis else s for i, s in enumerate(j.shape))))
    ab = a.expand(*[a.shape[i] if i == axis else shp[i]
                    for i in range(a.dim())])
    jb = j.expand(*[j.shape[i] if i == axis else shp[i]
                    for i in range(a.dim())])
    res = torch.gather(ab, axis, jb)
    if bad is not None and bool(bad.any()):
        fv = _fill_value(a.dtype) if fill_value is None else fill_value
        res = torch.where(bad.expand_as(res), torch.full_like(res, fv), res)
    return res


def _nonzero(a):
    a = _arr(a)
    if a.dim() == 0:
        a = a.reshape(1)
    return tuple(i.to(_I32) for i in torch.nonzero(a, as_tuple=True))


@_op("where", True)
def _where(condition, x=None, y=None, /, *, size=None, fill_value=None):
    if x is None and y is None:
        return _nonzero(condition)
    c = _arr(condition).to(_BOOL)
    x, y = _common(x, y)
    return torch.where(c.to(x.device), x, y)


@_op("select", True)
def _select(condlist, choicelist, default=0):
    ch = _common(*choicelist, default)
    out = ch[-1]
    for c, v in zip(reversed(list(condlist)), reversed(ch[:-1])):
        out = torch.where(_arr(c, v).to(_BOOL), v, out)
    return out


@_op("compress", True)
def _compress(condition, a, axis=None, *, size=None, fill_value=0,
              out=None):
    a = _arr(a)
    c = _arr(condition, a).reshape(-1).to(_BOOL)
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    c = c[:n]
    idx = torch.nonzero(c).reshape(-1)
    return torch.index_select(a, axis, idx)


@_op("choose", True)
def _choose(a, choices, out=None, mode="raise"):
    idx = _arr(a)
    ch = _common(*choices)
    n = len(ch)
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    tens = torch.broadcast_tensors(idx, *ch)
    stacked = torch.stack(tens[1:], dim=0)
    return torch.gather(stacked, 0, tens[0].to(torch.int64).unsqueeze(0))[0]


@_op("extract", False)
def _extract(condition, arr, *, size=None, fill_value=0):
    a = _arr(arr).reshape(-1)
    c = _arr(condition, a).reshape(-1) != 0
    return a[c]


@_op("diag", True)
def _diag(v, k=0):
    return torch.diag(_arr(v), k)


@_op("diagflat", True)
def _diagflat(v, k=0):
    return torch.diagflat(_arr(v), k)


@_op("diagonal", True)
def _diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_arr(a), offset=offset, dim1=axis1, dim2=axis2)


@_op("tril", True)
def _tril(m, k=0):
    return torch.tril(_arr(m), k)


@_op("triu", True)
def _triu(m, k=0):
    return torch.triu(_arr(m), k)


@_op("meshgrid", True)
def _meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    ts = [_arr(x).reshape(-1) for x in xi]
    if sparse:
        n = len(ts)
        out = []
        for i, t in enumerate(ts):
            shp = [1] * n
            shp[i] = -1
            out.append(t.reshape(shp))
        if indexing == "xy" and n >= 2:
            out = [o.transpose(0, 1) if o.dim() >= 2 else o for o in out]
        return tuple(out)
    return tuple(torch.meshgrid(*ts, indexing=indexing))


@_op("ix_", False)
def _ix(*args):
    n = len(args)
    out = []
    for i, a in enumerate(args):
        t = _arr(a)
        if t.dtype == _BOOL:
            t = torch.nonzero(t).reshape(-1).to(_I32)
        shp = [1] * n
        shp[i] = -1
        out.append(t.reshape(shp))
    return tuple(out)


# ---------------------------------------------------------------------------
# sorting / searching
# ---------------------------------------------------------------------------
def _sortable(a):
    return a.to(torch.uint8) if a.dtype == _BOOL else a


@_op("sort", True)
def _sort(a, axis=-1, *, kind=None, order=None, stable=True,
          descending=False):
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    if a.dtype == _BOOL:
        return torch.sort(a.to(torch.uint8), dim=axis, stable=True,
                          descending=descending).values.to(_BOOL)
    return torch.sort(a, dim=axis, stable=True, descending=descending).values


@_op("argsort", False)
def _argsort(a, axis=-1, *, kind=None, order=None, stable=True,
             descending=False):
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.argsort(_sortable(a), dim=axis, stable=True,
                         descending=descending).to(_I32)


@_op("partition", True)
def _partition(a, kth, axis=-1):
    a = _arr(a)
    x = torch.movedim(a, axis, -1)
    n = x.shape[-1]
    kth = kth % n if kth < 0 else kth
    bottom = torch.sort(x, dim=-1, stable=True).values[..., :kth + 1]
    top = torch.topk(x, n - kth - 1, dim=-1, largest=True,
                     sorted=True).values
    return torch.movedim(torch.cat([bottom, top], dim=-1), -1, axis)


@_op("argpartition", False)
def _argpartition(a, kth, axis=-1):
    a = _arr(a)
    x = torch.movedim(a, axis, -1)
    n = x.shape[-1]
    kth = kth % n if kth < 0 else kth
    bottom = torch.argsort(_sortable(x), dim=-1, stable=True)[..., :kth + 1]
    mask = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    mask.scatter_(-1, bottom, 1)
    top = torch.argsort(mask, dim=-1, stable=True)[..., :n - kth - 1]
    return torch.movedim(torch.cat([bottom, top], dim=-1), -1,
                         axis).to(_I32)


@_op("argwhere", False)
def _argwhere(a, *, size=None, fill_value=None):
    a = _arr(a)
    if a.dim() == 0:
        return torch.argwhere(a.reshape(1))[:, :0].to(_I32)
    return torch.argwhere(a).to(_I32)


@_op("searchsorted", False)
def _searchsorted(a, v, side="left", sorter=None, *, method="scan"):
    a = _arr(a)
    v = _arr(v, a)
    a, v = _common(a, v)
    if sorter is not None:
        a = a[_arr(sorter, a).long()]
    scalar = v.dim() == 0
    out = torch.searchsorted(a.contiguous(), v.reshape(-1).contiguous()
                             if scalar else v.contiguous(),
                             right=(side == "right"))
    return out.reshape(()).to(_I32) if scalar else out.to(_I32)


@_op("flatnonzero", False)
def _flatnonzero(a, *, size=None, fill_value=None):
    return torch.nonzero(_arr(a).reshape(-1)).reshape(-1).to(_I32)


@_op("count_nonzero", False)
def _count_nonzero(a, axis=None, keepdims=False):
    a = _arr(a)
    return _reduce(torch.sum, (a != 0).to(_I32), axis, keepdims).to(_I32)


@_op("nonzero", False)
def _nonzero_op(a, *, size=None, fill_value=None):
    return _nonzero(a)


@_op("lexsort", False)
def _lexsort(*keys, axis=-1):
    ks = [_sortable(_arr(k)) for k in keys]
    ks = [torch.movedim(k, axis, -1) for k in ks]
    idx = torch.argsort(ks[0], dim=-1, stable=True)
    for k in ks[1:]:
        idx = torch.gather(idx, -1, torch.argsort(
            torch.gather(k, -1, idx), dim=-1, stable=True))
    return torch.movedim(idx, -1, axis).to(_I32)


@_op("sort_complex", False)
def _sort_complex(a):
    a = _arr(a)
    if not a.is_complex():
        a = a.to(torch.complex64) if a.dtype != torch.float64 else \
            a.to(torch.complex128)
    re, im = a.real, a.imag
    idx = torch.argsort(im, dim=-1, stable=True)
    idx = torch.gather(idx, -1, torch.argsort(torch.gather(re, -1, idx),
                                              dim=-1, stable=True))
    return torch.gather(a, -1, idx)


@_op("digitize", False)
def _digitize(x, bins, right=False, *, method=None):
    x = _arr(x)
    b = _arr(bins, x)
    x, b = _common(x, b)
    side = "left" if right else "right"
    if b.shape[0] == 0:
        return torch.zeros(x.shape, dtype=_I32, device=x.device)
    inc = bool(b[-1] >= b[0])
    if inc:
        return torch.searchsorted(b.contiguous(), x.contiguous(),
                                  right=(side == "right")).to(_I32)
    return (b.shape[0] - torch.searchsorted(
        torch.flip(b, (0,)).contiguous(), x.contiguous(),
        right=(side == "right"))).to(_I32)


# ---------------------------------------------------------------------------
# logic / comparison
# ---------------------------------------------------------------------------
@_op("floor_divide", False)
def _floor_divide(x1, x2):
    a, b = _common(x1, x2)
    if a.dtype == _BOOL:
        return torch.floor_divide(a.to(torch.uint8), b.to(torch.uint8))
    if _is_float(a.dtype):
        return _float_divmod(a, b)[0]
    return torch.floor_divide(a, b)


def _float_divmod(a, b):
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    mod = torch.where(ind, mod + b, mod)
    div = torch.where(ind, div - 1, div)
    return torch.round(div), mod


for _n, _f in [("equal", torch.eq), ("not_equal", torch.ne),
               ("greater", torch.gt), ("greater_equal", torch.ge),
               ("less", torch.lt), ("less_equal", torch.le)]:
    _binary(_n, _f, diff=False)
for _n, _f in [("logical_and", torch.logical_and),
               ("logical_or", torch.logical_or),
               ("logical_xor", torch.logical_xor)]:
    _binary(_n, _f, diff=False)
_unary("logical_not", torch.logical_not, inexact=False, diff=False)


def _isfn(fn, default):
    def impl(x):
        return fn(x) if _is_float(x.dtype) else torch.full(
            x.shape, default, dtype=_BOOL, device=x.device)
    return impl


_unary("isnan", _isfn(torch.isnan, False), inexact=False, diff=False)
_unary("isinf", _isfn(torch.isinf, False), inexact=False, diff=False)
_unary("isfinite", _isfn(torch.isfinite, True), inexact=False, diff=False)
_unary("isposinf", _isfn(torch.isposinf, False), inexact=False, diff=False)
_unary("isneginf", _isfn(torch.isneginf, False), inexact=False, diff=False)
_unary("isreal", lambda x: x.imag == 0 if x.is_complex() else torch.ones(
    x.shape, dtype=_BOOL, device=x.device), inexact=False, diff=False)
_unary("iscomplex", lambda x: x.imag != 0 if x.is_complex() else torch.zeros(
    x.shape, dtype=_BOOL, device=x.device), inexact=False, diff=False)


@_op("all", False)
def _all(a, axis=None, out=None, keepdims=False, *, where=None):
    a = _arr(a).to(_BOOL)
    a = _where_mask(a, where, True)
    return _reduce(torch.all, a, axis, keepdims)


@_op("any", False)
def _any(a, axis=None, out=None, keepdims=False, *, where=None):
    a = _arr(a).to(_BOOL)
    a = _where_mask(a, where, False)
    return _reduce(torch.any, a, axis, keepdims)


def _isclose_t(a, b, rtol, atol, equal_nan):
    a, b = _common(a, b, inexact=True)
    ok = torch.abs(a - b) <= atol + rtol * torch.abs(b)
    ok = ok & torch.isfinite(a) & torch.isfinite(b) | (a == b)
    if equal_nan:
        ok = ok | (torch.isnan(a) & torch.isnan(b))
    return ok


@_op("isclose", False)
def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _isclose_t(a, b, rtol, atol, equal_nan)


@_op("allclose", False)
def _allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.all(_isclose_t(a, b, rtol, atol, equal_nan))


@_op("array_equal", False)
def _array_equal(a1, a2, equal_nan=False):
    a, b = _common(a1, a2)
    dev = a.device
    if a.shape != b.shape:
        return torch.tensor(False, device=dev)
    eq = a == b
    if equal_nan and _is_float(a.dtype):
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return torch.all(eq)


@_op("array_equiv", False)
def _array_equiv(a1, a2):
    a, b = _common(a1, a2)
    try:
        a, b = torch.broadcast_tensors(a, b)
    except RuntimeError:
        return torch.tensor(False, device=a.device)
    return torch.all(a == b)


@_op("isin", False)
def _isin(element, test_elements, assume_unique=False, invert=False, *,
          method="auto"):
    e, t = _common(element, test_elements)
    return torch.isin(e, t.reshape(-1), invert=invert)


# ---------------------------------------------------------------------------
# sets
# ---------------------------------------------------------------------------
def _first_index(inv, k):
    n = inv.shape[0]
    pos = torch.arange(n, device=inv.device)
    first = torch.full((k,), n, dtype=torch.int64, device=inv.device)
    return first.scatter_reduce(0, inv, pos, reduce="amin")


@_op("unique", False)
def _unique(ar, return_index=False, return_inverse=False,
            return_counts=False, axis=None, *, equal_nan=True, size=None,
            fill_value=None, sorted=True):
    a = _arr(ar)
    shape = a.shape
    if axis is None:
        flat = _sortable(a.reshape(-1))
        vals, inv, cnt = torch.unique(flat, sorted=True, return_inverse=True,
                                      return_counts=True)
        if a.dtype == _BOOL:
            vals = vals.to(_BOOL)
    else:
        vals, inv, cnt = torch.unique(a, sorted=True, return_inverse=True,
                                      return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        out.append(_first_index(inv, vals.shape[0 if axis is None
                                                else axis]).to(_I32))
    if return_inverse:
        out.append((inv.reshape(shape) if axis is None else inv).to(_I32))
    if return_counts:
        out.append(cnt.to(_I32))
    return out[0] if len(out) == 1 else tuple(out)


@_op("unique_all", False)
def _unique_all(x):
    a = _arr(x)
    vals, inv, cnt = torch.unique(_sortable(a.reshape(-1)), sorted=True,
                                  return_inverse=True, return_counts=True)
    if a.dtype == _BOOL:
        vals = vals.to(_BOOL)
    idx = _first_index(inv, vals.shape[0])
    return (vals, idx.to(_I32), inv.reshape(a.shape).to(_I32),
            cnt.to(_I32))


@_op("unique_counts", False)
def _unique_counts(x):
    v, _, _, c = _unique_all(x)
    return v, c


@_op("unique_inverse", False)
def _unique_inverse(x):
    v, _, i, _ = _unique_all(x)
    return v, i


@_op("unique_values", False)
def _unique_values(x):
    return _unique_all(x)[0]


def _u(x):
    return torch.unique(_sortable(_arr(x).reshape(-1)), sorted=True)


@_op("union1d", False)
def _union1d(ar1, ar2, *, size=None, fill_value=None):
    a, b = _common(ar1, ar2)
    return _u(torch.cat([a.reshape(-1), b.reshape(-1)]))


@_op("intersect1d", False)
def _intersect1d(ar1, ar2, assume_unique=False, return_indices=False, *,
                 size=None, fill_value=None):
    a, b = _common(ar1, ar2)
    ua, ia = torch.unique(a.reshape(-1), sorted=True, return_inverse=True)
    ub, ib = torch.unique(b.reshape(-1), sorted=True, return_inverse=True)
    keep = torch.isin(ua, ub)
    vals = ua[keep]
    if not return_indices:
        return vals
    fa = _first_index(ia, ua.shape[0])[keep]
    fb = _first_index(ib, ub.shape[0])[torch.isin(ub, ua)]
    return vals, fa.to(_I32), fb.to(_I32)


@_op("setdiff1d", False)
def _setdiff1d(ar1, ar2, assume_unique=False, *, size=None,
               fill_value=None):
    a, b = _common(ar1, ar2)
    ua = _u(a)
    return ua[~torch.isin(ua, b.reshape(-1))]


@_op("setxor1d", False)
def _setxor1d(ar1, ar2, assume_unique=False, *, size=None,
              fill_value=None):
    a, b = _common(ar1, ar2)
    ua, ub = _u(a), _u(b)
    return torch.cat([ua[~torch.isin(ua, ub)],
                      ub[~torch.isin(ub, ua)]]).sort().values


# ---------------------------------------------------------------------------
# integer / bit ops
# ---------------------------------------------------------------------------
_binary("lcm", torch.lcm, diff=False)
_binary("gcd", torch.gcd, diff=False)


@_op("bincount", False)
def _bincount(x, weights=None, minlength=0, *, length=None):
    x = _arr(x)
    n = length if length is not None else max(
        int(minlength), int(x.max()) + 1 if x.numel() else 0)
    xi = torch.clamp(x.reshape(-1).to(torch.int64), 0, n - 1) \
        if length is not None else x.reshape(-1).to(torch.int64)
    if weights is None:
        out = torch.zeros(n, dtype=_I32, device=x.device)
        return out.index_add_(0, xi, torch.ones_like(xi, dtype=_I32))
    w = _arr(weights, x)
    w = w if _is_float(w.dtype) or w.dtype == _I32 else w.to(_I32)
    out = torch.zeros(n, dtype=w.dtype, device=x.device)
    return out.index_add_(0, xi, w.reshape(-1))


def _bitop(name, fn):
    @_op(name, False)
    def impl(x1, x2):
        a, b = _common(x1, x2)
        return fn(a, b)
    return impl


_bitop("bitwise_and", torch.bitwise_and)
_bitop("bitwise_or", torch.bitwise_or)
_bitop("bitwise_xor", torch.bitwise_xor)
for _n in ("bitwise_not", "bitwise_invert", "invert"):
    _unary(_n, torch.bitwise_not, inexact=False, diff=False)


def _shift(fn, bits_if_over):
    def impl(a, b):
        nbits = torch.iinfo(a.dtype).bits if a.dtype != _BOOL else 8
        over = (b >= nbits) | (b < 0)
        safe = torch.where(over, torch.zeros_like(b), b)
        r = fn(a, safe)
        if bits_if_over == "zero":
            fillv = torch.zeros_like(r)
        else:
            fillv = torch.where(a < 0, torch.full_like(r, -1),
                                torch.zeros_like(r))
        return torch.where(over, fillv, r)
    return impl


for _n in ("left_shift", "bitwise_left_shift"):
    _bitop(_n, _shift(torch.bitwise_left_shift, "zero"))
for _n in ("right_shift", "bitwise_right_shift"):
    _bitop(_n, _shift(torch.bitwise_right_shift, "sign"))


@_op("bitwise_count", False)
def _bitwise_count(x):
    x = _arr(x)
    if x.dtype == _BOOL:
        return x.to(torch.uint8)
    bits = torch.iinfo(x.dtype).bits
    v = torch.abs(x.to(torch.int64)) if x.is_signed() else x.to(torch.int64)
    cnt = torch.zeros_like(v)
    for i in range(bits):
        cnt += (v >> i) & 1
    return cnt.to(torch.uint8)


@_op("packbits", False)
def _packbits(a, axis=None, bitorder="big"):
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    b = torch.movedim((a != 0).to(torch.uint8), axis, -1)
    n = b.shape[-1]
    pad = (-n) % 8
    if pad:
        b = F.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (-1, 8)).to(torch.int32)
    w = torch.tensor([1 << (7 - i) for i in range(8)] if bitorder == "big"
                     else [1 << i for i in range(8)], dtype=torch.int32,
                     device=a.device)
    out = (b * w).sum(-1).to(torch.uint8)
    return torch.movedim(out, -1, axis)


@_op("unpackbits", False)
def _unpackbits(a, axis=None, count=None, bitorder="big"):
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    x = torch.movedim(a, axis, -1).to(torch.int32)
    sh = torch.arange(7, -1, -1, device=a.device) if bitorder == "big" \
        else torch.arange(8, device=a.device)
    bits = ((x.unsqueeze(-1) >> sh) & 1).to(torch.uint8)
    bits = bits.reshape(x.shape[:-1] + (-1,))
    if count is not None:
        bits = bits[..., :count]
    return torch.movedim(bits, -1, axis)


# ---------------------------------------------------------------------------
# misc numerics
# ---------------------------------------------------------------------------
@_op("interp", True)
def _interp(x, xp, fp, left=None, right=None, period=None):
    x, xp, fp = _common(x, xp, fp, inexact=True)
    if period is not None:
        x = torch.remainder(x, period)
        xp = torch.remainder(xp, period)
        order = torch.argsort(xp)
        xp, fp = xp[order], fp[order]
        xp = torch.cat([xp[-1:] - period, xp, xp[:1] + period])
        fp = torch.cat([fp[-1:], fp, fp[:1]])
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0,
                                                     torch.ones_like(dx),
                                                     dx)) * df)
    if period is None:
        lv = fp[0] if left is None else torch.tensor(
            float(left), dtype=f.dtype, device=f.device)
        rv = fp[-1] if right is None else torch.tensor(
            float(right), dtype=f.dtype, device=f.device)
        f = torch.where(x < xp[0], lv, f)
        f = torch.where(x > xp[-1], rv, f)
    return f


@_op("diff", True)
def _diff(a, n=1, axis=-1, prepend=None, append=None):
    a = _arr(a)
    parts = []
    if prepend is not None:
        p = _arr(prepend, a).to(a.dtype)
        if p.dim() == 0:
            shp = list(a.shape)
            shp[axis] = 1
            p = p.expand(shp)
        parts.append(p)
    parts.append(a)
    if append is not None:
        p = _arr(append, a).to(a.dtype)
        if p.dim() == 0:
            shp = list(a.shape)
            shp[axis] = 1
            p = p.expand(shp)
        parts.append(p)
    x = torch.cat(parts, dim=axis) if len(parts) > 1 else a
    for _ in range(n):
        m = x.shape[axis]
        hi, lo = x.narrow(axis, 1, m - 1), x.narrow(axis, 0, m - 1)
        x = hi != lo if x.dtype == _BOOL else hi - lo
    return x


@_op("ediff1d", True)
def _ediff1d(ary, to_end=None, to_begin=None):
    a = _arr(ary).reshape(-1)
    r = a[1:] - a[:-1]
    parts = []
    if to_begin is not None:
        parts.append(_arr(to_begin, a).to(a.dtype).reshape(-1))
    parts.append(r)
    if to_end is not None:
        parts.append(_arr(to_end, a).to(a.dtype).reshape(-1))
    return torch.cat(parts) if len(parts) > 1 else r


@_op("gradient", True)
def _gradient(f, *varargs, axis=None, edge_order=None):
    f = _inexact(f)
    axes = _axis(axis, f.dim())
    spacing = [float(v) for v in varargs] if varargs else [1.0] * len(axes)
    if len(spacing) == 1 and len(axes) > 1:
        spacing = spacing * len(axes)
    out = []
    for ax, h in zip(axes, spacing):
        n = f.shape[ax]
        x = f
        first = (x.narrow(ax, 1, 1) - x.narrow(ax, 0, 1)) / h
        mid = (x.narrow(ax, 2, n - 2) - x.narrow(ax, 0, n - 2)) / (2 * h)
        last = (x.narrow(ax, n - 1, 1) - x.narrow(ax, n - 2, 1)) / h
        out.append(torch.cat([first, mid, last], dim=ax))
    return out[0] if len(out) == 1 else tuple(out)


def _conv1d(a, v, mode, flip):
    """numpy's 1-D convolve (flip) or correlate: the full result, then the
    mode's slice of it."""
    a, v = _common(a, v)
    af, vf = (a, v) if _is_float(a.dtype) else (a.to(_F32), v.to(_F32))
    if flip:
        vf = torch.flip(vf, (0,))
    n, m = af.shape[0], vf.shape[0]
    full = F.conv1d(F.pad(af.reshape(1, 1, -1), (m - 1, m - 1)),
                    vf.reshape(1, 1, -1)).reshape(-1)
    if mode == "full":
        out = full
    elif mode == "same":
        start = (m - 1) // 2 if flip else m // 2
        out = full[start:start + n]
    elif mode == "valid":
        out = full[m - 1:n]
    else:
        raise ValueError("mode must be full, same or valid")
    return out if _is_float(a.dtype) else torch.round(out).to(a.dtype)


@_op("convolve", True)
def _convolve(a, v, mode="full", *, precision=None,
              preferred_element_type=None):
    a, v = _arr(a), _arr(v)
    if v.shape[0] > a.shape[0]:
        a, v = v, a
    return _conv1d(a, v, mode, flip=True)


@_op("correlate", True)
def _correlate(a, v, mode="valid", *, precision=None,
               preferred_element_type=None):
    a, v = _arr(a), _arr(v)
    if v.is_complex():
        v = v.conj()
    if v.shape[0] > a.shape[0]:
        return torch.flip(_conv1d(v, a, mode, flip=False), (0,))
    return _conv1d(a, v, mode, flip=False)


@_op("real", True)
def _real(val):
    x = _arr(val)
    return x.real if x.is_complex() else x.clone()


@_op("imag", True)
def _imag(val):
    x = _arr(val)
    return x.imag if x.is_complex() else torch.zeros_like(x)


for _n in ("conj", "conjugate"):
    _unary(_n, lambda x: x.conj().resolve_conj() if x.is_complex()
           else x.clone(), inexact=False)


def _bin_edges(a, bins, range_):
    a = _arr(a)
    if torch.is_tensor(bins) and bins.dim() == 1:
        return a, bins.to(a.dtype if _is_float(a.dtype) else _F32)
    if isinstance(bins, (list, tuple)):
        return a, _arr(bins, a).to(_F32 if not _is_float(a.dtype)
                                   else a.dtype)
    dt = a.dtype if _is_float(a.dtype) else _F32
    if range_ is None:
        lo, hi = a.min().to(dt), a.max().to(dt)
    else:
        lo = torch.tensor(float(range_[0]), dtype=dt, device=a.device)
        hi = torch.tensor(float(range_[1]), dtype=dt, device=a.device)
    eq = lo == hi
    lo = torch.where(eq, lo - 0.5, lo)
    hi = torch.where(eq, hi + 0.5, hi)
    n = int(bins)
    return a, _linspace(lo, hi, n + 1, dt)


def _linspace(lo, hi, num, dt):
    """jax.numpy's linspace between 0-d tensors (endpoint included)."""
    if num == 1:
        return lo.reshape(1).to(dt)
    div = num - 1
    i = torch.arange(num, dtype=dt, device=lo.device)
    out = lo + i * ((hi - lo) / div)
    out = torch.cat([out[:-1], hi.reshape(1).to(dt)])
    return out.to(dt)


@_op("histogram_bin_edges", False)
def _histogram_bin_edges(a, bins=10, range=None, weights=None):
    return _bin_edges(a, bins, range)[1]


def _hist_counts(a, edges, weights, density):
    a = a.reshape(-1).to(edges.dtype)
    w = torch.ones_like(a) if weights is None else \
        _arr(weights, a).reshape(-1).to(a.dtype)
    idx = torch.searchsorted(edges.contiguous(), a.contiguous(), right=True)
    idx = torch.where(a == edges[-1], torch.full_like(idx,
                                                      edges.shape[0] - 1),
                      idx)
    counts = torch.zeros(edges.shape[0] + 1, dtype=w.dtype,
                         device=a.device).index_add_(0, idx, w)
    counts = counts[1:edges.shape[0]]
    if density:
        bw = edges[1:] - edges[:-1]
        counts = counts / bw / counts.sum()
    return counts


@_op("histogram", False)
def _histogram(a, bins=10, range=None, weights=None, density=None):
    a, edges = _bin_edges(a, bins, range)
    return _hist_counts(a, edges, weights, density), edges


def _histdd(sample, bins, range_, weights, density):
    s = _arr(sample)
    if s.dim() == 1:
        s = s.reshape(-1, 1)
    n, d = s.shape
    dt = s.dtype if _is_float(s.dtype) else _F32
    if isinstance(bins, int) or (torch.is_tensor(bins) and bins.dim() == 0):
        bins = [int(bins)] * d
    edges = []
    for k in range(d):
        _, e = _bin_edges(s[:, k], bins[k], None if range_ is None
                          else range_[k])
        edges.append(e.to(dt))
    flat = torch.zeros(n, dtype=torch.int64, device=s.device)
    shape = []
    for k, e in enumerate(edges):
        nb = e.shape[0] + 1
        col = s[:, k].to(dt).contiguous()
        idx = torch.searchsorted(e.contiguous(), col, right=True)
        idx = torch.where(col == e[-1], torch.full_like(idx, nb - 2), idx)
        flat = flat * nb + idx
        shape.append(nb)
    # unweighted counts are int32, as the reference's
    w = torch.ones(n, dtype=_I32, device=s.device) if weights is None else \
        _arr(weights, s).reshape(-1).to(dt)
    counts = torch.zeros(math.prod(shape), dtype=w.dtype,
                         device=s.device).index_add_(0, flat, w)
    counts = counts.reshape(shape)[tuple(slice(1, -1) for _ in shape)]
    if density:
        counts = counts.to(dt) / counts.sum()
        for k, e in enumerate(edges):
            shp = [1] * d
            shp[k] = -1
            counts = counts / (e[1:] - e[:-1]).reshape(shp)
    return counts, edges


@_op("histogramdd", False)
def _histogramdd(sample, bins=10, range=None, weights=None, density=None):
    h, edges = _histdd(sample, bins, range, weights, density)
    if len({e.shape[0] for e in edges}) == 1:
        return h, torch.stack(edges)
    return (h,) + tuple(edges)


@_op("histogram2d", False)
def _histogram2d(x, y, bins=10, range=None, weights=None, density=None):
    x, y = _common(x, y)
    if isinstance(bins, int):
        bins = [bins, bins]
    h, edges = _histdd(torch.stack([x, y], dim=1), bins, range, weights,
                       density)
    return h, edges[0], edges[1]


# ---------------------------------------------------------------------------
# multi-output numerics
# ---------------------------------------------------------------------------
@_op("frexp", False)
def _frexp(x):
    x = _inexact(x)
    m, e = torch.frexp(x)
    return m, e.to(_I32)


@_op("modf", True)
def _modf(x, out=None):
    x = _inexact(x)
    whole = torch.trunc(x)
    return x - whole, whole


@_op("divmod", False)
def _divmod(x1, x2):
    a, b = _common(x1, x2)
    if _is_float(a.dtype):
        return _float_divmod(a, b)
    return torch.floor_divide(a, b), torch.remainder(a, b)


@_op("unravel_index", False)
def _unravel_index(indices, shape):
    idx = _arr(indices)
    shape = _shape_arg(shape)
    size = math.prod(shape)
    idx = torch.clamp(torch.where(idx < 0, idx + size, idx), 0, size - 1)
    out = []
    for d in reversed(shape):
        out.append(torch.remainder(idx, d))
        idx = torch.div(idx, d, rounding_mode="floor")
    return tuple(o.to(_I32) for o in reversed(out))


@_op("ravel_multi_index", False)
def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    idx = [_arr(i) for i in multi_index]
    dims = tuple(int(d) for d in dims)
    if mode == "raise":
        for i, d in zip(idx, dims):
            if bool(((i < 0) | (i >= d)).any()):
                raise ValueError("invalid entry in coordinates array")
    elif mode == "clip":
        idx = [torch.clamp(i, 0, d - 1) for i, d in zip(idx, dims)]
    elif mode == "wrap":
        idx = [torch.remainder(i, d) for i, d in zip(idx, dims)]
    if order == "F":
        strides = np.cumprod((1,) + dims[:-1])
    else:
        strides = np.cumprod((1,) + dims[1:][::-1])[::-1]
    res = torch.zeros((), dtype=idx[0].dtype, device=idx[0].device)
    for i, s in zip(idx, strides):
        res = res + i * int(s)
    return res


# ---------------------------------------------------------------------------
# polynomials
# ---------------------------------------------------------------------------
@_op("polyval", True)
def _polyval(p, x, *, unroll=16):
    p, x = _common(p, x)
    y = torch.zeros_like(x)
    for k in range(p.shape[0]):
        y = y * x + p[k]
    return y


def _poly_pad(a1, a2):
    a, b = _common(a1, a2)
    n = max(a.shape[0], b.shape[0])
    return F.pad(a, (n - a.shape[0], 0)), F.pad(b, (n - b.shape[0], 0))


@_op("polyadd", True)
def _polyadd(a1, a2):
    a, b = _poly_pad(a1, a2)
    return a + b


@_op("polysub", True)
def _polysub(a1, a2):
    a, b = _poly_pad(a1, a2)
    return a - b


@_op("polymul", True)
def _polymul(a1, a2, *, trim_leading_zeros=False):
    a, b = _common(_arr(a1), _arr(a2), inexact=True)
    if a.shape[0] < b.shape[0]:
        a, b = b, a
    return _conv1d(a, b, "full", flip=True)


@_op("polyder", True)
def _polyder(p, m=1):
    p = _inexact(p)
    if m == 0:
        return p
    n = p.shape[0]
    coeff = torch.ones(n - m, dtype=p.dtype, device=p.device)
    k = torch.arange(m, n, dtype=p.dtype, device=p.device)
    for j in range(m):
        coeff = coeff * (k - j)
    return p[:-m] * torch.flip(coeff, (0,))


@_op("polyint", True)
def _polyint(p, m=1, k=None):
    p = _inexact(p)
    if m == 0:
        return p
    kk = _arr(0 if k is None else k, p).to(p.dtype).reshape(-1)
    if kk.shape[0] == 1:
        kk = kk.expand(m)
    n = p.shape[0]
    grid = torch.arange(n + m, dtype=p.dtype, device=p.device)[None] - \
        torch.arange(m, dtype=p.dtype, device=p.device)[:, None]
    coeff = torch.clamp(grid, min=1).prod(0).flip(0)
    return torch.cat([p, kk]) / coeff


@_op("polydiv", True)
def _polydiv(u, v, *, trim_leading_zeros=False):
    u, v = _common(u, v, inexact=True)
    m, n = u.shape[0] - 1, v.shape[0] - 1
    scale = 1.0 / v[0]
    q = []
    for k in range(0, m - n + 1):
        d = scale * u[k]
        q.append(d)
        u = torch.cat([u[:k], u[k:k + n + 1] - d * v, u[k + n + 1:]])
    q = torch.stack(q) if q else torch.zeros(1, dtype=u.dtype,
                                              device=u.device)
    return q, u


def _svd_lstsq(a, b, rcond):
    """Least squares by the SVD (device-agnostic: torch's CUDA lstsq has
    no rank or singular values)."""
    m, n = a.shape
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    if rcond is None:
        rcond = float(torch.finfo(a.dtype).eps) * max(m, n)
    cut = rcond * s[0] if s.numel() else s.new_zeros(())
    keep = s > cut
    inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    vec = b.dim() == 1
    bb = b.reshape(-1, 1) if vec else b
    x = vh.T.conj() @ (inv[:, None] * (u.T.conj() @ bb))
    rank = keep.sum().to(_I32)
    if bool(rank == n) and m > n:
        r = bb - a @ x
        resid = (r.abs() ** 2).sum(0)
    else:
        resid = torch.zeros((0,), dtype=s.dtype, device=a.device)
    if vec:
        x = x.reshape(-1)
        resid = resid.reshape(-1)
    return x, resid, rank, s


@_op("polyfit", True)
def _polyfit(x, y, deg, rcond=None, full=False, w=None, cov=False):
    x, y = _common(x, y, inexact=True)
    order = deg + 1
    if rcond is None:
        rcond = x.shape[0] * float(torch.finfo(x.dtype).eps)
    lhs = _vander_t(x, order, False)
    rhs = y
    if w is not None:
        wt = _arr(w, x).to(x.dtype)
        lhs = lhs * wt[:, None]
        rhs = rhs * (wt[:, None] if rhs.dim() == 2 else wt)
    scale = torch.sqrt((lhs * lhs).sum(0))
    lhs = lhs / scale[None, :]
    c, resids, rank, s = _svd_lstsq(lhs, rhs, rcond)
    c = c / scale.reshape((-1,) + (1,) * (c.dim() - 1))
    if full:
        return c, resids, rank, s, torch.tensor(rcond, dtype=x.dtype,
                                                device=x.device)
    if cov:
        Vbase = torch.linalg.inv(lhs.T @ lhs)
        Vbase = Vbase / torch.outer(scale, scale)
        fac = resids / (x.shape[0] - order) if cov != "unscaled" else 1
        return c, Vbase * fac
    return c


@_op("poly", False)
def _poly(seq_of_zeros):
    z = _arr(seq_of_zeros)
    if z.dim() == 2 and z.shape[0] == z.shape[1] and z.shape[0] != 0:
        z = torch.linalg.eigvals(z.to(_F32) if not _is_float(z.dtype)
                                 else z)
    if not _is_float(z.dtype):
        z = z.to(_F32)
    a = torch.ones(1, dtype=z.dtype, device=z.device)
    for k in range(z.shape[0]):
        a = torch.cat([a, torch.zeros(1, dtype=a.dtype, device=a.device)]) \
            - z[k] * torch.cat([torch.zeros(1, dtype=a.dtype,
                                            device=a.device), a])
    if a.is_complex() and bool((a.imag == 0).all()):
        a = a.real
    return a


@_op("roots", False)
def _roots(p, *, strip_zeros=True):
    p = _inexact(torch.atleast_1d(_arr(p)))
    ctype = torch.complex64
    if p.shape[0] < 2:
        return torch.zeros(0, dtype=ctype, device=p.device)
    nz = torch.nonzero(p != 0).reshape(-1)
    if nz.numel() == 0:
        return torch.zeros(0, dtype=ctype, device=p.device)
    p = p[int(nz[0]):]
    trail = p.shape[0] - 1 - int(torch.nonzero(p != 0).reshape(-1)[-1])
    p = p[:p.shape[0] - trail]
    n = p.shape[0] - 1
    if n < 1:
        return torch.zeros(trail, dtype=ctype, device=p.device)
    comp = torch.zeros((n, n), dtype=p.dtype, device=p.device)
    comp[0] = -p[1:] / p[0]
    if n > 1:
        comp[1:, :-1] = torch.eye(n - 1, dtype=p.dtype, device=p.device)
    r = torch.linalg.eigvals(comp).to(ctype)
    return torch.cat([r, torch.zeros(trail, dtype=ctype, device=p.device)])


def _vander_t(x, N, increasing):
    n = x.shape[0] if N is None else N
    pw = torch.arange(n, device=x.device)
    if not increasing:
        pw = torch.flip(pw, (0,))
    return x[:, None] ** pw[None, :].to(x.dtype if _is_float(x.dtype)
                                        else x.dtype)


@_op("vander", True)
def _vander(x, N=None, increasing=False):
    x = _arr(x)
    if N is None:
        N = x.shape[0]
    cols = []
    acc = torch.ones_like(x)
    for _ in range(N):
        cols.append(acc)
        acc = acc * x
    if not increasing:
        cols = cols[::-1]
    return torch.stack(cols, dim=1) if cols else x[:, None][:, :0]


# ---------------------------------------------------------------------------
# functional (the callables take and return tensors)
# ---------------------------------------------------------------------------
@_op("apply_along_axis", False)
def _apply_along_axis(func1d, axis, arr, *args, **kwargs):
    a = _arr(arr)
    x = torch.movedim(a, axis, -1)
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    outs = [torch.as_tensor(func1d(r, *args, **kwargs), device=a.device)
            for r in rows]
    res = torch.stack(outs)
    res = res.reshape(lead + res.shape[1:])
    if res.dim() > len(lead):
        k = res.dim() - len(lead)
        res = torch.movedim(res, tuple(range(len(lead),
                                                      res.dim())),
                            tuple(range(axis % a.dim(),
                                                 axis % a.dim() + k)))
    return res


@_op("apply_over_axes", False)
def _apply_over_axes(func, a, axes):
    a = _arr(a)
    for ax in (axes if isinstance(axes, (list, tuple)) else [axes]):
        b = torch.as_tensor(func(a, ax), device=a.device)
        if b.dim() == a.dim() - 1:
            b = b.unsqueeze(ax)
        a = b
    return a


@_op("piecewise", False)
def _piecewise(x, condlist, funclist, *args, **kw):
    x = _arr(x)
    if torch.is_tensor(condlist) and condlist.dim() <= x.dim():
        condlist = [condlist] if condlist.dim() == x.dim() or \
            condlist.dim() == 0 else list(condlist)
    conds = [_arr(c, x).to(_BOOL) for c in condlist]
    nc = len(conds)
    funcs = list(funclist)

    def val(f):
        if callable(f):
            return torch.as_tensor(f(x, *args, **kw), device=x.device).to(
                x.dtype)
        return torch.full_like(x, f)
    out = val(funcs[-1]) if len(funcs) == nc + 1 else torch.zeros_like(x)
    for c, f in zip(conds, funcs[:nc]):
        out = torch.where(c, val(f), out)
    return out


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------
def _lreg(name, diff, nout):
    """Register `_np_linalg_<name>`."""
    return _op("linalg_" + name, diff, nout)


@_lreg("norm", True, 1)
def _norm(x, ord=None, axis=None, keepdims=False):
    x = _inexact(x)
    if axis is None and ord is None:
        r = torch.sqrt(torch.sum((x * x.conj()).real if x.is_complex()
                                 else x * x))
        return r.reshape((1,) * x.dim()) if keepdims else r
    if isinstance(axis, int):
        axis = (axis,)
    if axis is None:
        axis = tuple(range(x.dim()))
    if len(axis) == 1:
        return torch.linalg.vector_norm(x, ord=2 if ord is None else ord,
                                        dim=axis, keepdim=keepdims)
    return torch.linalg.matrix_norm(x, ord="fro" if ord is None else ord,
                                    dim=axis, keepdim=keepdims)


@_lreg("svd", True, 3)
def _svd(a, full_matrices=False, compute_uv=True, hermitian=False,
         subset_by_index=None):
    a = _inexact(a)
    if not compute_uv:
        return torch.linalg.svdvals(a)
    u, s, vh = torch.linalg.svd(a, full_matrices=full_matrices)
    return u, s, vh


@_lreg("cholesky", True, 1)
def _cholesky(a, *, upper=False, symmetrize_input=True):
    a = _inexact(a)
    if symmetrize_input:
        a = (a + a.transpose(-1, -2).conj()) / 2
    return torch.linalg.cholesky(a, upper=upper)


@_lreg("qr", True, 2)
def _qr(a, mode="reduced"):
    a = _inexact(a)
    if mode == "r":
        return torch.linalg.qr(a, mode="r")[1]
    q, r = torch.linalg.qr(a, mode=mode)
    return q, r


@_lreg("pinv", True, 1)
def _pinv(a, rtol=None, hermitian=False, *, rcond=None):
    a = _inexact(a)
    if rtol is None:
        rtol = rcond
    if rtol is None:
        m, n = a.shape[-2:]
        rtol = 10.0 * max(m, n) * float(torch.finfo(a.dtype).eps)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = rtol * s.amax(-1, keepdim=True)
    inv = torch.where(s > cut, 1.0 / torch.where(s > cut, s,
                                                 torch.ones_like(s)),
                      torch.zeros_like(s))
    return (vh.transpose(-1, -2).conj() * inv[..., None, :]) @ \
        u.transpose(-1, -2).conj()


@_lreg("solve", True, 1)
def _solve(a, b):
    a, b = _common(a, b, inexact=True)
    if b.dim() == 1:
        return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.solve(a, b)


@_lreg("lstsq", False, 4)
def _lstsq(a, b, rcond=None, *, numpy_resid=False):
    a, b = _common(a, b, inexact=True)
    return _svd_lstsq(a, b, rcond)


@_lreg("eig", False, 2)
def _eig(a):
    w, v = torch.linalg.eig(_inexact(a))
    return w.to(torch.complex64), v.to(torch.complex64)


@_lreg("eigvals", False, 1)
def _eigvals(a):
    return torch.linalg.eigvals(_inexact(a)).to(torch.complex64)


@_lreg("eigh", True, 2)
def _eigh(a, UPLO=None, symmetrize_input=True):
    a = _inexact(a)
    if symmetrize_input:
        a = (a + a.transpose(-1, -2).conj()) / 2
    w, v = torch.linalg.eigh(a, UPLO=UPLO or "L")
    return w, v


@_lreg("eigvalsh", True, 1)
def _eigvalsh(a, UPLO="L", *, symmetrize_input=True):
    return _eigh(a, UPLO, symmetrize_input)[0]


@_lreg("matrix_rank", False, 1)
def _matrix_rank(M, rtol=None, *, tol=None):
    M = _inexact(M)
    if M.dim() < 2:
        return (M != 0).any().to(_I32)
    s = torch.linalg.svdvals(M)
    if tol is None:
        if rtol is None:
            rtol = max(M.shape[-2:]) * float(
                torch.finfo(s.dtype).eps)
        tol = s.amax(-1) * rtol
    tol = _arr(tol, s) if not torch.is_tensor(tol) else tol
    return (s > tol[..., None] if tol.dim() else s > tol).sum(-1).to(_I32)


@_lreg("matrix_power", True, 1)
def _matrix_power(a, n):
    return torch.linalg.matrix_power(_arr(a), n)


@_lreg("multi_dot", True, 1)
def _multi_dot(*arrays, precision=None):
    ts = _common(*arrays)
    out = ts[0]
    for t in ts[1:]:
        out = _dot(out, t) if out.dim() and t.dim() else out * t
    return out


@_lreg("tensorinv", True, 1)
def _tensorinv(a, ind=2):
    a = _inexact(a)
    out_shape = a.shape[ind:] + a.shape[:ind]
    n = math.prod(a.shape[:ind])
    return torch.linalg.inv(a.reshape(n, -1)).reshape(out_shape)


@_lreg("tensorsolve", True, 1)
def _tensorsolve(a, b, axes=None):
    a, b = _common(a, b, inexact=True)
    if axes is not None:
        allax = list(range(a.dim()))
        for k in axes:
            allax.remove(k % a.dim())
            allax.insert(a.dim(), k % a.dim())
        a = a.permute(allax)
    q = a.shape[b.dim():]
    n = math.prod(q)
    x = torch.linalg.solve(a.reshape(-1, n), b.reshape(-1))
    return x.reshape(q)
