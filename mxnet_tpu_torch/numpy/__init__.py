"""`mx.np`: the numpy-compatible array namespace (the port of
`mxnet_tpu.numpy`).

Every function of the reference's table is one registered op,
`_np_<name>` (`ops.numpy_ops`), run through the port's `invoke`, so it
records under `autograd.record()` like any `mx.nd` op and computes on its
inputs' device; its results are `mx.np.ndarray`s. Beside the ops:
creation functions on the current context (or ``ctx=``), the mutating
functions (`fill_diagonal`, `place`, `put`, `put_along_axis`, `copyto`)
written into the target's tensor in place, host-side metadata (numpy's
own), file I/O through numpy, and the `c_`/`r_`/`s_` indexers.

Types are the reference's, which are jax.numpy's with 64-bit types off:
`array` of a Python list is float32 (the reference's deviation from
numpy), 64-bit sources narrow to 32 bits, `arange(5)` is int32.
`bfloat16` is the port's string ``"bfloat16"``.
"""
from __future__ import annotations

import builtins as _b
import math as _math

import numpy as _onp
import torch

from ..context import current_context
from ..ndarray.ndarray import NDArray, invoke
from ..ops import numpy_ops as _ops
from ..ops import registry as _reg
from .multiarray import as_np_ndarray, ndarray, np_view

_FUNCS = _ops.FUNCS
_SEQ_FUNCS = _ops.SEQ_FUNCS


def _raw(a, dev):
    """Arrays inside lists and tuples as their tensors (the tape follows
    them), numpy arrays and scalars as tensors on the call's device; a
    top-level NDArray stays for `invoke` to unwrap."""
    if isinstance(a, (list, tuple)):
        return type(a)(_inner(v, dev) for v in a)
    if isinstance(a, (_onp.ndarray, _onp.generic)):
        return _ops.to_tensor(a, dev)
    return a


def _inner(a, dev):
    if isinstance(a, NDArray):
        return a._data
    if isinstance(a, (list, tuple)):
        return type(a)(_inner(v, dev) for v in a)
    if isinstance(a, (_onp.ndarray, _onp.generic)):
        return _ops.to_tensor(a, dev)
    return a


def _ctx_of(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, NDArray):
            return a.context
        if isinstance(a, (list, tuple)):
            c = _ctx_of(a, {})
            if c is not None:
                return c
    return None


def _call(op_name, args, kwargs):
    op = _reg.get(op_name)
    ctx = _ctx_of(args, kwargs) or kwargs.pop("ctx", None) or \
        current_context()
    kwargs.pop("ctx", None)
    dev = ctx.torch_device
    out = invoke(op_name, *[_raw(a, dev) for a in args], ctx=ctx,
                 **{k: _raw(v, dev) for k, v in kwargs.items()})
    if out is kwargs.get("out") and out is not None:
        return out          # the caller's own destination: not retagged
    if isinstance(out, list) and len(out) == 1 and op.num_outputs == 1:
        out = out[0]
    return as_np_ndarray(out)


def _make(op_name, public_name, seq):
    def fn(*args, **kwargs):
        if seq and args and isinstance(args[0], (list, tuple)):
            if len(args) > 1:
                # numpy takes the axis positionally: concatenate((a, b), 1)
                kwargs.setdefault("axis", args[1])
            args = tuple(args[0])
        return _call(op_name, args, kwargs)
    fn.__name__ = fn.__qualname__ = public_name
    fn.__doc__ = "numpy-compatible %s (the `%s` op)" % (public_name, op_name)
    return fn


_here = globals()
for _name, _diff in _FUNCS:
    _here[_name] = _make("_np_" + _name, _name, _name in _SEQ_FUNCS)
fix = _make("_np_fix", "fix", False)


def histogramdd(sample, bins=10, range=None, weights=None, density=None):
    """(counts, edges): the edges as one (D, bins + 1) array when every
    axis has as many bins, as the reference gives them."""
    out = _call("_np_histogramdd", (sample,), dict(
        bins=bins, range=range, weights=weights, density=density))
    return out if len(out) == 2 else [out[0], list(out[1:])]


# ---------------------------------------------------------------------------
# constants and types
# ---------------------------------------------------------------------------
pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan
newaxis = None

float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
half = _onp.half
single = _onp.single
double = _onp.double
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
intc = _onp.intc
intp = _onp.intp
int_ = _onp.int_
uint8 = _onp.uint8
uint16 = _onp.uint16
uint32 = _onp.uint32
uint64 = _onp.uint64
uint = _onp.uint
byte = _onp.byte
ubyte = _onp.ubyte
short = _onp.short
ushort = _onp.ushort
longlong = _onp.longlong
ulonglong = _onp.ulonglong
complex64 = _onp.complex64
complex128 = _onp.complex128
csingle = _onp.csingle
cdouble = _onp.cdouble
bool_ = _onp.bool_
float_ = _onp.float64
generic = _onp.generic
number = _onp.number
integer = _onp.integer
signedinteger = _onp.signedinteger
unsignedinteger = _onp.unsignedinteger
inexact = _onp.inexact
floating = _onp.floating
complexfloating = _onp.complexfloating
dtype = _onp.dtype
bfloat16 = "bfloat16"


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _device(ctx):
    return (ctx or current_context()).torch_device


def _wrap(t, ctx=None):
    ctx = ctx or current_context()
    return as_np_ndarray(NDArray(_ops.canon(t), ctx=ctx))


def _host_dtype(a):
    """A numpy array's type as the reference keeps it: 64-bit narrowed."""
    return {"int64": _onp.int32, "float64": _onp.float32,
            "complex128": _onp.complex64,
            "uint64": _onp.uint32}.get(a.dtype.name, a.dtype)


def array(obj, dtype=None, ctx=None, copy=True, ndmin=0):
    """An array of `obj` on `ctx` (default the current context). A Python
    list or scalar gives float32 unless `dtype` says otherwise; a source
    with a type keeps it, narrowed to 32 bits."""
    if isinstance(obj, NDArray):
        if dtype is None and not copy and ndmin == 0 and (
                ctx is None or ctx == obj.context):
            return np_view(obj)
        t = obj._data.detach().clone()
        if dtype is not None:
            t = t.to(_ops.canon_dtype(dtype))
        while t.dim() < ndmin:
            t = t.unsqueeze(0)
        c = ctx or current_context()
        return _wrap(t.to(c.torch_device), c)
    if torch.is_tensor(obj):
        obj = obj.detach().cpu().numpy()
    host = _onp.array(obj, ndmin=ndmin)
    if dtype is None:
        dt = _host_dtype(host) if hasattr(obj, "dtype") else _onp.float32
        t = torch.from_numpy(_onp.array(host, dtype=dt))
    else:
        tdt = _ops.canon_dtype(dtype)
        t = torch.from_numpy(_onp.array(host)).to(tdt) \
            if host.dtype != object else torch.tensor(host.tolist(),
                                                      dtype=tdt)
    c = ctx or current_context()
    return _wrap(t.to(c.torch_device), c)


def asarray(obj, dtype=None, ctx=None):
    if isinstance(obj, NDArray) and dtype is None and ctx is None:
        return np_view(obj)
    return array(obj, dtype=dtype, ctx=ctx)


def ascontiguousarray(a, dtype=None):
    return asarray(a, dtype=dtype)


asfortranarray = ascontiguousarray


def asnumpy(a):
    return a.asnumpy() if isinstance(a, NDArray) else _onp.asarray(a)


def _shape(shape):
    return (int(shape),) if isinstance(shape, (int, _onp.integer)) \
        else tuple(int(s) for s in shape)


def _dt(dtype, default=torch.float32):
    return _ops.canon_dtype(dtype) or default


def zeros(shape, dtype=None, order="C", ctx=None):
    return _wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                             device=_device(ctx)), ctx)


def ones(shape, dtype=None, order="C", ctx=None):
    return _wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                            device=_device(ctx)), ctx)


def empty(shape, dtype=None, order="C", ctx=None):
    """Zeros: the reference has no uninitialized allocation."""
    return zeros(shape, dtype=dtype, ctx=ctx)


def _scalar_dtype(v):
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, int):
        return torch.int32
    if isinstance(v, complex):
        return torch.complex64
    if isinstance(v, float):
        return torch.float32
    return _ops.to_tensor(v).dtype


def full(shape, fill_value, dtype=None, order="C", ctx=None):
    dev = _device(ctx)
    if isinstance(fill_value, NDArray) or isinstance(
            fill_value, (_onp.ndarray, list)):
        v = _ops.to_tensor(fill_value._data if isinstance(fill_value, NDArray)
                           else fill_value, dev, dtype)
        return _wrap(torch.broadcast_to(v, _shape(shape)).clone(), ctx)
    return _wrap(torch.full(_shape(shape), fill_value,
                            dtype=_dt(dtype, _scalar_dtype(fill_value)),
                            device=dev), ctx)


def zeros_like(a, dtype=None, ctx=None):
    return zeros(a.shape, dtype=dtype or _tdtype(a),
                 ctx=ctx or getattr(a, "context", None))


def ones_like(a, dtype=None, ctx=None):
    return ones(a.shape, dtype=dtype or _tdtype(a),
                ctx=ctx or getattr(a, "context", None))


def full_like(a, fill_value, dtype=None, ctx=None):
    return full(a.shape, fill_value, dtype=dtype or _tdtype(a),
                ctx=ctx or getattr(a, "context", None))


empty_like = zeros_like


def _tdtype(a):
    return a._data.dtype if isinstance(a, NDArray) else a.dtype


def arange(start, stop=None, step=None, dtype=None, ctx=None):
    """[start, stop) by `step`: int32 for integer arguments, float32
    otherwise (values as numpy computes them, then narrowed)."""
    args = [v for v in (start, stop, step) if v is not None]
    host = _onp.arange(*args)
    dt = _ops.canon_dtype(dtype) if dtype is not None else (
        torch.float32 if host.dtype.kind == "f" else torch.int32)
    return _wrap(torch.from_numpy(host).to(dt).to(_device(ctx)), ctx)


def _lin(start, stop, num, endpoint, dt, dev):
    """jax.numpy's linspace: start * (1 - t) + stop * t, t = i / div, the
    end point appended."""
    s = torch.as_tensor(start, dtype=dt, device=dev)
    p = torch.as_tensor(stop, dtype=dt, device=dev)
    if num == 0:
        return torch.zeros((0,) + tuple(torch.broadcast_shapes(
            s.shape, p.shape)), dtype=dt, device=dev)
    if num == 1:
        return torch.broadcast_to(s, torch.broadcast_shapes(
            s.shape, p.shape)).unsqueeze(0).clone()
    div = num - 1 if endpoint else num
    t = (torch.arange(div, dtype=dt, device=dev) /
         torch.tensor(div, dtype=dt, device=dev))
    t = t.reshape((-1,) + (1,) * _b.max(s.dim(), p.dim()))
    out = s * (1 - t) + p * t
    if endpoint:
        out = torch.cat([out, torch.broadcast_to(p, out.shape[1:])
                         .unsqueeze(0)])
    return out


def _inexact_of(*vals):
    dt = None
    for v in vals:
        d = _scalar_dtype(v) if not isinstance(v, NDArray) else \
            _ops.canon(v._data).dtype
        dt = d if dt is None else torch.promote_types(dt, d)
    dt = _ops.canon_dtype(dt)
    return dt if (dt.is_floating_point or dt.is_complex) else torch.float32


def _val(v):
    return v._data if isinstance(v, NDArray) else v


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None):
    dev = _device(ctx)
    dt = _inexact_of(start, stop)
    out = _lin(_val(start), _val(stop), num, endpoint, dt, dev)
    if axis != 0:
        out = torch.movedim(out, 0, axis)
    tdt = _ops.canon_dtype(dtype)
    if tdt is not None and tdt != dt:
        out = torch.floor(out).to(tdt) if not (
            tdt.is_floating_point or tdt.is_complex) else out.to(tdt)
    res = _wrap(out, ctx)
    if retstep:
        div = (num - 1) if endpoint else num
        step = (torch.as_tensor(_val(stop), dtype=dt, device=dev) -
                torch.as_tensor(_val(start), dtype=dt, device=dev)) / div
        return res, _wrap(step, ctx)
    return res


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, ctx=None):
    dev = _device(ctx)
    dt = _inexact_of(start, stop)
    lin = _lin(_val(start), _val(stop), num, endpoint, dt, dev)
    out = torch.pow(torch.as_tensor(base, dtype=dt, device=dev), lin)
    if axis != 0:
        out = torch.movedim(out, 0, axis)
    return _wrap(out.to(_ops.canon_dtype(dtype) or dt), ctx)


def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0,
              ctx=None):
    dev = _device(ctx)
    dt = _inexact_of(start, stop)
    s = torch.as_tensor(_val(start), dtype=dt, device=dev)
    p = torch.as_tensor(_val(stop), dtype=dt, device=dev)
    sign = torch.sign(s)
    lin = _lin(torch.log10(s / sign), torch.log10(p / sign), num, endpoint,
               dt, dev)
    out = sign * torch.pow(torch.tensor(10.0, dtype=dt, device=dev), lin)
    if axis != 0:
        out = torch.movedim(out, 0, axis)
    return _wrap(out.to(_ops.canon_dtype(dtype) or dt), ctx)


def eye(N, M=None, k=0, dtype=None, ctx=None):
    M = N if M is None else M
    dev = _device(ctx)
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return _wrap((j - i == k).to(_dt(dtype)), ctx)


def identity(n, dtype=None, ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def tri(N, M=None, k=0, dtype=None, ctx=None):
    M = N if M is None else M
    dev = _device(ctx)
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return _wrap((j <= i + k).to(_dt(dtype)), ctx)


def indices(dimensions, dtype=None, sparse=False, ctx=None):
    dev = _device(ctx)
    dims = _shape(dimensions)
    dt = _dt(dtype, torch.int32)
    n = len(dims)
    grids = []
    for i, d in enumerate(dims):
        shp = [1] * n
        shp[i] = d
        g = torch.arange(d, dtype=dt, device=dev).reshape(shp)
        grids.append(g if sparse else g.expand(dims))
    if sparse:
        return tuple(_wrap(g, ctx) for g in grids)
    return _wrap(torch.stack(grids) if grids else
                 torch.zeros((0,), dtype=dt, device=dev), ctx)


def _window(M, fn, ctx):
    dev = _device(ctx)
    if M <= 1:
        return _wrap(torch.ones((_b.max(M, 0),), dtype=torch.float32,
                                device=dev), ctx)
    n = torch.arange(M, dtype=torch.float32, device=dev)
    return _wrap(fn(n, M), ctx)


def bartlett(M, ctx=None):
    return _window(M, lambda n, M: 1 - torch.abs(2 * n + 1 - M) / (M - 1),
                   ctx)


def blackman(M, ctx=None):
    return _window(M, lambda n, M: 0.42 - 0.5 * torch.cos(
        2 * _math.pi * n / (M - 1)) + 0.08 * torch.cos(
        4 * _math.pi * n / (M - 1)), ctx)


def hamming(M, ctx=None):
    return _window(M, lambda n, M: 0.54 - 0.46 * torch.cos(
        2 * _math.pi * n / (M - 1)), ctx)


def hanning(M, ctx=None):
    return _window(M, lambda n, M: 0.5 * (1 - torch.cos(
        2 * _math.pi * n / (M - 1))), ctx)


def kaiser(M, beta, ctx=None):
    def fn(n, M):
        alpha = 0.5 * (M - 1)
        b = torch.tensor(float(beta), dtype=torch.float32, device=n.device)
        return torch.special.i0(b * torch.sqrt(
            1 - ((n - alpha) / alpha) ** 2)) / torch.special.i0(b)
    return _window(M, fn, ctx)


def _index_pairs(mask, ctx):
    r, c = torch.nonzero(mask, as_tuple=True)
    return _wrap(r.to(torch.int32), ctx), _wrap(c.to(torch.int32), ctx)


def tril_indices(n, k=0, m=None, ctx=None):
    return _index_pairs(tri(n, m, k, dtype="bool", ctx=ctx)._data, ctx)


def triu_indices(n, k=0, m=None, ctx=None):
    return _index_pairs(~tri(n, m, k - 1, dtype="bool", ctx=ctx)._data, ctx)


def diag_indices(n, ndim=2, ctx=None):
    i = torch.arange(n, dtype=torch.int32, device=_device(ctx))
    return tuple(_wrap(i.clone(), ctx) for _ in range(ndim))


def mask_indices(n, mask_func, k=0, ctx=None):
    """Indices where ``mask_func(ones((n, n)), k)`` is nonzero; `mask_func`
    takes and returns `mx.np` arrays (`mx.np.triu`, `mx.np.tril`)."""
    m = mask_func(ones((n, n), dtype="int32", ctx=ctx), k)
    return _index_pairs(m._data != 0, ctx)


def tril_indices_from(arr, k=0):
    return tril_indices(arr.shape[-2], k=k, m=arr.shape[-1],
                        ctx=getattr(arr, "context", None))


def triu_indices_from(arr, k=0):
    return triu_indices(arr.shape[-2], k=k, m=arr.shape[-1],
                        ctx=getattr(arr, "context", None))


def diag_indices_from(arr):
    return diag_indices(arr.shape[0], ndim=arr.ndim,
                        ctx=getattr(arr, "context", None))


def frombuffer(buffer, dtype=float, count=-1, offset=0):
    return array(_onp.frombuffer(buffer, dtype=dtype, count=count,
                                 offset=offset))


def fromiter(iterable, dtype, count=-1):
    return array(_onp.fromiter(iterable, dtype, count=count))


def fromfunction(function, shape, *, dtype=float, **kwargs):
    return array(_onp.fromfunction(function, shape, dtype=dtype, **kwargs))


def fromstring(string, dtype=float, count=-1, sep=" "):
    return array(_onp.fromstring(string, dtype=dtype, count=count, sep=sep))


def fromfile(file, dtype=float, count=-1, sep="", offset=0):
    return array(_onp.fromfile(file, dtype=dtype, count=count, sep=sep,
                               offset=offset))


def block(arrays):
    """numpy's block: the innermost lists join along the last axis, each
    enclosing level along the axis before."""
    def depth(x):
        return 1 + depth(x[0]) if isinstance(x, list) else 0

    def ndim(x):
        return _b.max(ndim(v) for v in x) if isinstance(x, list) else (
            x.ndim if isinstance(x, NDArray) else _onp.ndim(x))
    d = depth(arrays)
    nd = _b.max(d, ndim(arrays))

    def join(x, level):
        if not isinstance(x, list):
            a = x if isinstance(x, NDArray) else array(x)
            while a.ndim < nd:
                a = a.reshape((1,) + a.shape)
            return a
        parts = [join(v, level + 1) for v in x]
        return concatenate(parts, axis=-(d - level))
    return join(arrays, 0)


# ---------------------------------------------------------------------------
# mutating functions: written into the target's tensor in place
# ---------------------------------------------------------------------------
def _tensor_like(v, target):
    t = v._data if isinstance(v, NDArray) else _ops.to_tensor(v)
    return t.to(target._data.device)


def _cycled(v, n, dtype):
    v = v.reshape(-1).to(dtype)
    if v.numel() == 0 or n == 0:
        return v[:0]
    return v.repeat(-(-n // v.numel()))[:n]


def fill_diagonal(a, val, wrap=False):
    t = a._data
    if t.dim() == 2:
        step = t.shape[1] + 1
        end = None if wrap else t.shape[1] * t.shape[1]
    else:
        if len(set(t.shape)) != 1:
            raise ValueError("All dimensions of input must be of equal "
                             "length")
        step = 1 + int(_onp.cumprod(t.shape[:-1]).sum())
        end = None
    with torch.no_grad():
        flat = t.view(-1)
        pos = torch.arange(0, flat.numel() if end is None else
                           _b.min(end, flat.numel()), step, device=t.device)
        flat[pos] = _cycled(_tensor_like(val, a), pos.numel(), t.dtype)


def place(arr, mask, vals):
    t = arr._data
    m = _tensor_like(mask, arr).to(torch.bool).reshape(t.shape)
    with torch.no_grad():
        n = int(m.sum())
        t[m] = _cycled(_tensor_like(vals, arr), n, t.dtype)


def put(a, ind, v, mode="clip"):
    t = a._data
    flat = t.view(-1)
    i = _tensor_like(ind, a).reshape(-1).long()
    n = flat.numel()
    if mode == "clip":
        i = torch.clamp(i, 0, n - 1)
    elif mode == "wrap":
        i = torch.remainder(i, n)
    else:
        i = torch.where(i < 0, i + n, i)
    with torch.no_grad():
        flat[i] = _cycled(_tensor_like(v, a), i.numel(), t.dtype)


def put_along_axis(arr, indices, values, axis, inplace=True, *, mode=None):
    t = arr._data
    idx = _tensor_like(indices, arr).long()
    n = t.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    vals = torch.broadcast_to(_tensor_like(values, arr).to(t.dtype),
                              idx.shape)
    with torch.no_grad():
        t.scatter_(axis, idx, vals)


def copyto(dst, src, casting="same_kind", where=True):
    t = dst._data
    s = torch.broadcast_to(_tensor_like(src, dst).to(t.dtype), t.shape)
    with torch.no_grad():
        if where is True:
            t.copy_(s)
        else:
            w = torch.broadcast_to(_tensor_like(where, dst).to(torch.bool),
                                   t.shape)
            t.copy_(torch.where(w, s, t))


# ---------------------------------------------------------------------------
# host-side metadata (numpy's own)
# ---------------------------------------------------------------------------
finfo = _onp.finfo
iinfo = _onp.iinfo
can_cast = _onp.can_cast
promote_types = _onp.promote_types
issubdtype = _onp.issubdtype
isscalar = _onp.isscalar
iterable = _onp.iterable
broadcast_shapes = _onp.broadcast_shapes
isdtype = _onp.isdtype
get_printoptions = _onp.get_printoptions
set_printoptions = _onp.set_printoptions
printoptions = _onp.printoptions
einsum_path = _onp.einsum_path


def _np_dtype(a):
    d = a.dtype
    return _onp.float32 if isinstance(d, str) else d


def result_type(*args):
    return _onp.result_type(*[_np_dtype(a) if isinstance(a, NDArray)
                              else a for a in args])


def iscomplexobj(x):
    d = x._data.dtype.is_complex if isinstance(x, NDArray) else \
        _onp.iscomplexobj(x)
    return bool(d)


def isrealobj(x):
    return not iscomplexobj(x)


def shape(a):
    return a.shape if hasattr(a, "shape") else _onp.shape(a)


def ndim(a):
    return len(shape(a))


def size(a):
    s = 1
    for d in shape(a):
        s *= d
    return s


def array_repr(arr, *args, **kwargs):
    return _onp.array_repr(asnumpy(arr), *args, **kwargs)


def array_str(a, *args, **kwargs):
    return _onp.array_str(asnumpy(a), *args, **kwargs)


def shares_memory(a, b, max_work=None):
    """True when both arrays' tensors lie in one storage."""
    if not (isinstance(a, NDArray) and isinstance(b, NDArray)):
        return False
    return a._data.untyped_storage().data_ptr() == \
        b._data.untyped_storage().data_ptr()


may_share_memory = shares_memory


def save(file, arr):
    _onp.save(file, asnumpy(arr))


def savez(file, *args, **kwargs):
    _onp.savez(file, *[asnumpy(a) for a in args],
               **{k: asnumpy(v) for k, v in kwargs.items()})


def load(file, **kwargs):
    out = _onp.load(file, **kwargs)
    if isinstance(out, _onp.ndarray):
        return array(out)
    return out      # an NpzFile: numpy's lazy dict of host arrays


def loadtxt(fname, **kwargs):
    return array(_onp.loadtxt(fname, **kwargs))


def savetxt(fname, X, **kwargs):
    _onp.savetxt(fname, asnumpy(X), **kwargs)


def vectorize(pyfunc, **kwargs):
    vf = _onp.vectorize(pyfunc, **kwargs)

    def wrapped(*args, **kw):
        return array(vf(*[asnumpy(a) if isinstance(a, NDArray) else a
                          for a in args], **kw))
    return wrapped


def r_like(*rows):
    return concatenate([atleast_1d(array(r)) for r in rows])


class _CClass:
    """The `c_`/`r_` concatenation indexers. A slice key expands as
    numpy's: r_[0:5] is arange(0, 5), a complex step a point count
    (r_[0:1:5j])."""

    def __init__(self, axis):
        self.axis = axis

    @staticmethod
    def _expand(a):
        if isinstance(a, slice):
            start = a.start if a.start is not None else 0
            stop = a.stop
            step = a.step if a.step is not None else 1
            if isinstance(step, complex):
                return linspace(start, stop, int(_b.abs(step)))
            return arange(start, stop, step)
        return a if isinstance(a, NDArray) else array(a)

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        parts = [self._expand(a) for a in key]
        if self.axis == -1:
            parts = [p.reshape(-1, 1) if p.ndim == 1 else p for p in parts]
            return concatenate(parts, axis=1)
        return concatenate([atleast_1d(p) for p in parts], axis=0)


c_ = _CClass(-1)
r_ = _CClass(0)
s_ = _onp.s_
index_exp = _onp.index_exp


from . import random  # noqa: E402
from . import linalg  # noqa: E402

__all__ = ["ndarray", "array", "asarray", "asnumpy", "zeros", "ones",
           "empty", "full", "arange", "linspace", "logspace", "geomspace",
           "eye", "identity", "tri", "indices", "zeros_like", "ones_like",
           "full_like", "empty_like", "frombuffer", "fromiter",
           "fromfunction", "block", "fill_diagonal", "place", "put",
           "put_along_axis", "copyto", "result_type", "finfo", "iinfo",
           "shares_memory", "may_share_memory", "save", "savez", "load",
           "random", "linalg", "fix", "pi", "e", "inf", "nan", "newaxis"] + \
    [n for n, _ in _FUNCS]
