"""The `mx.np.ndarray` type (the port of `mxnet_tpu.numpy.multiarray`).

A subclass of the port's `NDArray` with the same slots, so a legacy array
becomes one by `__class__` assignment and an `mx.np.ndarray` is an
`NDArray` everywhere the port takes one. Its surface is numpy's: a numpy
`repr`, `item`/`tolist`, zero-dim arrays, boolean-mask and fancy
indexing, `flatten()` to 1-D, `.sort()` in place, `fill`, comparisons
that give bool arrays, no hash, and arithmetic through the `_np_*` ops,
so result types are the reference's (jax.numpy's with 64-bit types off).
The in-place operators write into the array's own tensor.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..ndarray.ndarray import NDArray, invoke

__all__ = ["ndarray", "as_np_ndarray", "np_view"]


def _key(key, device):
    """An index as torch takes it: arrays become tensors on `device`
    (bool masks stay bool, other integers become int64), a list is a fancy
    index."""
    if isinstance(key, NDArray):
        t = key._data.detach()
    elif isinstance(key, _onp.ndarray):
        t = torch.from_numpy(_onp.array(key))
    elif isinstance(key, list):
        t = torch.as_tensor(_onp.asarray(key))
    elif isinstance(key, tuple):
        return tuple(_key(k, device) for k in key)
    elif torch.is_tensor(key):
        t = key.detach()
    else:
        return key
    if t.dtype != torch.bool:
        t = t.long()
    return t.to(device)


def _consumed(k):
    if k is None or k is Ellipsis:
        return 0
    if torch.is_tensor(k) and k.dtype == torch.bool:
        return k.dim()
    return 1


def _backward_slices(shape, key):
    """The axes a key slices with a negative step, and the key with those
    slices stepping forward over the axes flipped (torch slices step
    forward only); ([], key) when there is none."""
    k = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(s, slice) and s.step is not None and s.step < 0
               for s in k):
        return [], key
    rest = len(shape) - sum(_consumed(s) for s in k)
    dim, out, axes = 0, [], []
    for s in k:
        if s is Ellipsis:
            dim += rest
        elif isinstance(s, slice) and s.step is not None and s.step < 0:
            n = shape[dim]
            idx = range(*s.indices(n))
            axes.append(dim)
            s = slice(n - 1 - idx[0], n - idx[-1], -s.step) if len(idx) \
                else slice(0, 0)
        dim += _consumed(s)
        out.append(s)
    return axes, tuple(out)


def np_view(obj):
    """An `mx.np.ndarray` over the same tensor as `obj` (the same storage
    and, under `autograd.record()`, the same node of the tape), sharing its
    gradient buffer. `obj` itself is not changed."""
    if type(obj) is ndarray:
        return obj
    view = object.__new__(ndarray)
    view._data = obj._data
    view._ctx = obj._ctx
    view._grad = obj._grad
    view._grad_req = obj._grad_req
    return view


def as_np_ndarray(x):
    """Retag legacy NDArray results (and lists and tuples of them) as
    `mx.np.ndarray` in place."""
    if isinstance(x, NDArray):
        if type(x) is NDArray:
            x.__class__ = ndarray
        return x
    if isinstance(x, (list, tuple)):
        return type(x)(as_np_ndarray(v) for v in x)
    return x


def _np(op, *args, **kwargs):
    return as_np_ndarray(invoke(op, *args, **kwargs))


def _binop(op, reflected=False):
    if reflected:
        def method(self, other):
            return _np(op, other, self)
    else:
        def method(self, other):
            return _np(op, self, other)
    return method


def _inplace(op):
    def method(self, other):
        res = invoke(op, self, other)
        with torch.no_grad():
            self._data.copy_(res._data)
        return self
    return method


class ndarray(NDArray):
    __slots__ = ()

    __hash__ = None

    # -- numpy's surface ------------------------------------------------
    def __repr__(self):
        return repr(self.asnumpy())

    __str__ = __repr__

    def item(self, *args):
        return self.asnumpy().item(*args)

    def tolist(self):
        return self.asnumpy().tolist()

    def tobytes(self, order="C"):
        return self.asnumpy().tobytes(order=order)

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __index__(self):
        if self._data.is_floating_point():
            raise TypeError("only integer arrays can be an index")
        return int(self.item())

    def astype(self, dtype, copy=True):
        return _np("_np_astype", self, dtype)

    @property
    def T(self):
        return _np("_np_transpose", self)

    @property
    def itemsize(self):
        return self._data.element_size()

    @property
    def nbytes(self):
        return self.size * self.itemsize

    @property
    def real(self):
        return _np("_np_real", self)

    @property
    def imag(self):
        return _np("_np_imag", self)

    @property
    def flat(self):
        return iter(self.reshape(-1))

    @property
    def grad(self):
        return as_np_ndarray(self._grad)

    def __getitem__(self, key):
        key = _key(key, self._data.device)
        axes, key = _backward_slices(self.shape, key)
        src = _np("_np_flip", self, tuple(axes)) if axes else self
        return _np("_getitem", src, index=key)

    def __setitem__(self, key, value):
        key = _key(key, self._data.device)
        axes, fwd = _backward_slices(self.shape, key)
        if axes:
            # a flipped copy would not reach this array: write through the
            # flipped view of each axis's positions instead
            k = key if isinstance(key, tuple) else (key,)
            if not all(isinstance(s, (int, slice)) or s is Ellipsis
                       for s in k):
                raise IndexError("a negative-step slice can be assigned "
                                 "with ints and slices only")
            rest = self.ndim - sum(_consumed(s) for s in k)
            dims, dim = [], 0
            for s in k:
                if s is Ellipsis:
                    dims += [slice(None)] * rest
                    dim += rest
                    continue
                dims.append(s)
                dim += 1
            dims += [slice(None)] * (self.ndim - dim)
            grids = [torch.arange(n, device=self._data.device)[s]
                     if isinstance(s, slice) and (s.step or 1) > 0 else
                     torch.as_tensor(list(range(n))[s],
                                     device=self._data.device)
                     for s, n in zip(dims, self.shape)]
            lens = [g.dim() for g in grids]
            mesh = []
            for i, g in enumerate(grids):
                if g.dim():
                    shp = [1] * sum(lens)
                    shp[sum(lens[:i])] = -1
                    g = g.reshape(shp)
                mesh.append(g)
            key = tuple(mesh)
        NDArray.__setitem__(self, key, value)

    def __iter__(self):
        # not a generator: iter() of a 0-d array raises at once
        if self.ndim == 0:
            raise TypeError("iteration over a 0-d array")
        return (self[i] for i in range(self.shape[0]))

    def __contains__(self, value):
        return bool((self == value).asnumpy().any())

    def as_nd_ndarray(self):
        """A legacy `mx.nd.NDArray` over the same tensor."""
        out = NDArray(self._data, ctx=self._ctx)
        out._grad, out._grad_req = self._grad, self._grad_req
        return out

    def as_np_ndarray(self):
        return self

    def copy(self):
        return _np("_np_copy", self)

    def detach(self):
        return as_np_ndarray(NDArray.detach(self))

    def as_in_context(self, context):
        out = NDArray.as_in_context(self, context)
        return out if out is self else as_np_ndarray(out)

    as_in_ctx = as_in_context

    def copyto(self, other):
        out = NDArray.copyto(self, other)
        return out if out is other else as_np_ndarray(out)

    # -- numpy's deviations from the legacy namespace -----------------
    def flatten(self, order="C"):
        """All axes into one (the legacy `flatten` keeps the batch
        axis)."""
        return _np("_np_reshape", self, (-1,))

    def ravel(self, order="C"):
        return self.flatten()

    def reshape(self, *shape, order="C"):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return _np("_np_reshape", self, shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _np("_np_transpose", self, axes if axes else None)

    def sort(self, axis=-1, kind=None, order=None):
        """In place, as numpy's (the function `np.sort` gives a copy)."""
        res = invoke("_np_sort", self, axis=axis)
        with torch.no_grad():
            self._data.copy_(res._data)

    def fill(self, value):
        with torch.no_grad():
            self._data.fill_(value)

    # -- the method surface, each on its `_np_*` op ---------------------
    def all(self, axis=None, keepdims=False):
        return _np("_np_all", self, axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False):
        return _np("_np_any", self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _np("_np_argmax", self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _np("_np_argmin", self, axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, kind=None, order=None):
        return _np("_np_argsort", self, axis=axis)

    def cumsum(self, axis=None, dtype=None):
        return _np("_np_cumsum", self, axis=axis, dtype=dtype)

    def cumprod(self, axis=None, dtype=None):
        return _np("_np_cumprod", self, axis=axis, dtype=dtype)

    def std(self, axis=None, ddof=0, keepdims=False):
        return _np("_np_std", self, axis=axis, ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, ddof=0, keepdims=False):
        return _np("_np_var", self, axis=axis, ddof=ddof, keepdims=keepdims)

    def dot(self, b):
        return _np("_np_dot", self, b)

    def diagonal(self, offset=0, axis1=0, axis2=1):
        return _np("_np_diagonal", self, offset=offset, axis1=axis1,
                   axis2=axis2)

    def trace(self, offset=0, axis1=0, axis2=1):
        return _np("_np_trace", self, offset=offset, axis1=axis1,
                   axis2=axis2)

    def nonzero(self):
        out = invoke("_np_nonzero", self)
        return tuple(as_np_ndarray(o) for o in out)

    def searchsorted(self, v, side="left", sorter=None):
        return _np("_np_searchsorted", self, v, side=side)

    def ptp(self, axis=None, keepdims=False):
        return _np("_np_ptp", self, axis=axis, keepdims=keepdims)

    def conj(self):
        return _np("_np_conj", self)

    conjugate = conj

    def compress(self, condition, axis=None):
        return _np("_np_compress", condition, self, axis=axis)

    def repeat(self, repeats, axis=None):
        return _np("_np_repeat", self, repeats, axis=axis)

    def take(self, indices, axis=None, mode="clip"):
        return _np("_np_take", self, indices, axis=axis, mode=mode)

    def clip(self, a_min=None, a_max=None):
        return _np("_np_clip", self, a_min, a_max)

    def round(self, decimals=0):
        return _np("_np_round", self, decimals=decimals)

    def mean(self, axis=None, dtype=None, keepdims=False):
        return _np("_np_mean", self, axis=axis, dtype=dtype,
                   keepdims=keepdims)

    def sum(self, axis=None, dtype=None, keepdims=False):
        return _np("_np_sum", self, axis=axis, dtype=dtype,
                   keepdims=keepdims)

    def prod(self, axis=None, dtype=None, keepdims=False):
        return _np("_np_prod", self, axis=axis, dtype=dtype,
                   keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return _np("_np_max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return _np("_np_min", self, axis=axis, keepdims=keepdims)

    def squeeze(self, axis=None):
        return _np("_np_squeeze", self, axis=axis)

    def expand_dims(self, axis):
        return _np("_np_expand_dims", self, axis)

    def swapaxes(self, axis1, axis2):
        return _np("_np_swapaxes", self, axis1, axis2)

    def broadcast_to(self, shape):
        return _np("_np_broadcast_to", self, shape)

    def tile(self, reps):
        return _np("_np_tile", self, reps)

    def flip(self, axis=None):
        return _np("_np_flip", self, axis)

    def split(self, indices_or_sections, axis=0):
        return list(_np("_np_split", self, indices_or_sections, axis=axis))

    def pick(self, index, axis=-1, keepdims=False):
        return _np("pick", self, index, axis=axis, keepdims=keepdims)

    def slice_axis(self, axis, begin, end):
        return as_np_ndarray(NDArray.slice_axis(self, axis, begin, end))

    def norm(self, ord=None, axis=None, keepdims=False):
        return _np("_np_linalg_norm", self, ord, axis, keepdims)

    def exp(self):
        return _np("_np_exp", self)

    def log(self):
        return _np("_np_log", self)

    def sqrt(self):
        return _np("_np_sqrt", self)

    def square(self):
        return _np("_np_square", self)

    def abs(self):
        return _np("_np_abs", self)

    def sign(self):
        return _np("_np_sign", self)

    def relu(self):
        return as_np_ndarray(NDArray.relu(self))

    def sigmoid(self):
        return as_np_ndarray(NDArray.sigmoid(self))

    def tanh(self):
        return _np("_np_tanh", self)

    def attach_grad(self, grad_req="write", stype=None):
        NDArray.attach_grad(self, grad_req, stype)
        if stype in (None, "default"):
            as_np_ndarray(self._grad)

    # -- the operator protocols ------------------------------------------
    __add__ = _binop("_np_add")
    __radd__ = _binop("_np_add", True)
    __sub__ = _binop("_np_subtract")
    __rsub__ = _binop("_np_subtract", True)
    __mul__ = _binop("_np_multiply")
    __rmul__ = _binop("_np_multiply", True)
    __truediv__ = _binop("_np_true_divide")
    __rtruediv__ = _binop("_np_true_divide", True)
    __floordiv__ = _binop("_np_floor_divide")
    __rfloordiv__ = _binop("_np_floor_divide", True)
    __mod__ = _binop("_np_remainder")
    __rmod__ = _binop("_np_remainder", True)
    __pow__ = _binop("_np_power")
    __rpow__ = _binop("_np_power", True)
    __matmul__ = _binop("_np_matmul")
    __rmatmul__ = _binop("_np_matmul", True)
    __and__ = _binop("_np_bitwise_and")
    __rand__ = _binop("_np_bitwise_and", True)
    __or__ = _binop("_np_bitwise_or")
    __ror__ = _binop("_np_bitwise_or", True)
    __xor__ = _binop("_np_bitwise_xor")
    __rxor__ = _binop("_np_bitwise_xor", True)
    __lshift__ = _binop("_np_left_shift")
    __rlshift__ = _binop("_np_left_shift", True)
    __rshift__ = _binop("_np_right_shift")
    __rrshift__ = _binop("_np_right_shift", True)
    __eq__ = _binop("_np_equal")
    __ne__ = _binop("_np_not_equal")
    __lt__ = _binop("_np_less")
    __le__ = _binop("_np_less_equal")
    __gt__ = _binop("_np_greater")
    __ge__ = _binop("_np_greater_equal")

    __iadd__ = _inplace("_np_add")
    __isub__ = _inplace("_np_subtract")
    __imul__ = _inplace("_np_multiply")
    __itruediv__ = _inplace("_np_true_divide")
    __ifloordiv__ = _inplace("_np_floor_divide")
    __imod__ = _inplace("_np_remainder")
    __ipow__ = _inplace("_np_power")
    __iand__ = _inplace("_np_bitwise_and")
    __ior__ = _inplace("_np_bitwise_or")
    __ixor__ = _inplace("_np_bitwise_xor")

    def __neg__(self):
        return _np("_np_negative", self)

    def __pos__(self):
        return _np("_np_positive", self)

    def __abs__(self):
        return _np("_np_absolute", self)

    def __invert__(self):
        return _np("_np_invert", self)

    def __divmod__(self, other):
        q, r = invoke("_np_divmod", self, other)
        return as_np_ndarray(q), as_np_ndarray(r)

    def __rdivmod__(self, other):
        q, r = invoke("_np_divmod", other, self)
        return as_np_ndarray(q), as_np_ndarray(r)
