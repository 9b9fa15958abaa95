"""NDArray over one `torch.Tensor` (the port of `mxnet_tpu.ndarray`).

An `NDArray` holds a tensor and the `Context` it lives on. Ops run eagerly
through `invoke`, which unwraps the arrays, picks the op's implementation
for the context (`Operator.best_fn`: the hand-written kernel on a GPU) and
wraps the result. There is no async engine and no poisoned outputs. The
autograd tape is torch.autograd (`mxnet_tpu_torch.autograd`): `invoke`
runs an op with torch's grad mode on only under `autograd.record()` and
only for ops the registry marks `differentiable`, so arrays used outside a
recording build no graph; `attach_grad`, `.grad`, `.backward()` and
`detach()` are the reference's.

Deviation from the reference: numpy has no bfloat16 without ml_dtypes, so
`asnumpy()` of a bfloat16 array returns float32 (exact: every bfloat16 is a
float32), and `dtype` names bfloat16 by the string ``"bfloat16"`` where the
other types are numpy dtypes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import autograd as _autograd
from ..base import dtype_name, torch_dtype
from ..context import Context, context_of, current_context
from ..ops import registry as _reg

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "arange", "save",
           "load", "split_v2"]


class NDArray:
    """A tensor and its context."""

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = ctx or context_of(data.device)
        self._grad = None
        self._grad_req = "null"

    @property
    def data_torch(self):
        """The underlying torch.Tensor, cut from the tape (the same
        storage: in-place writes reach the array)."""
        return self._data.detach()

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _dtype_of(self._data.dtype)

    @property
    def stype(self):
        """The storage type: ``default`` (dense); the sparse arrays of
        `ndarray.sparse` say ``row_sparse`` or ``csr``."""
        return "default"

    def tostype(self, stype):
        from . import sparse
        return sparse.cast_storage(self, stype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(d) for d in self.shape), self._ctx)

    def asnumpy(self):
        """Blocking copy to numpy (bfloat16 comes back as float32); a copy
        on the CPU too, so later in-place updates of the array do not
        reach it."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def copy(self):
        return NDArray(self._data.detach().clone(), ctx=self._ctx)

    def copyto(self, other):
        """Copy into another array (cast to its dtype) or onto a Context."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                if other.stype == "row_sparse":
                    # every row becomes stored, as the reference's write
                    other._write(self._data.detach().to(
                        other._values.device, other._values.dtype,
                        copy=True))
                else:
                    other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True), ctx=other)
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self.copyto(context)

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True):
        """A cast copy; recorded under `autograd.record()`."""
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return invoke("cast", self, dtype=dtype)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return invoke("reshape", self, shape=shape)

    def broadcast_to(self, shape):
        return invoke("broadcast_to", self, shape=shape)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __getitem__(self, key):
        """x[key]: a basic index gives a view of the same storage, an
        advanced one (an array of indices) a copy; recorded under
        `autograd.record()`."""
        if isinstance(key, NDArray):
            key = key._data.long()
        return invoke("_getitem", self, index=key)

    @property
    def T(self):
        return invoke("transpose", self)

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("Truth value of multi-element NDArray is ambiguous")

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return invoke("transpose", self, axes=axes if axes else None)

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def sum(self, axis=None, keepdims=False):
        return invoke("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def sqrt(self):
        return invoke("sqrt", self)

    def square(self):
        return invoke("square", self)

    def expand_dims(self, axis):
        return invoke("expand_dims", self, axis=axis)

    def relu(self):
        return invoke("relu", self)

    def sigmoid(self):
        return invoke("sigmoid", self)

    def tanh(self):
        return invoke("tanh", self)

    # -- autograd (reference: NDArray.attach_grad / grad / backward) -------
    def attach_grad(self, grad_req="write", stype=None):
        """Give this array a zero gradient buffer and mark it as a variable
        of the tape; ``stype="row_sparse"`` makes the buffer a
        `RowSparseNDArray` with no rows, which `backward` fills with the
        rows a row-sparse cotangent touched."""
        if stype == "row_sparse":
            from .sparse import zeros as sparse_zeros
            self._grad = sparse_zeros("row_sparse", self.shape, ctx=self._ctx,
                                      dtype=self.dtype)
        elif stype in (None, "default"):
            self._grad = zeros(self.shape, ctx=self._ctx, dtype=self.dtype)
        else:
            raise ValueError("attach_grad: stype must be default or "
                             "row_sparse, got %s" % stype)
        _autograd.mark_variable(self, grad_req)

    @property
    def grad(self):
        return self._grad

    def zero_grad(self):
        """Zero the gradient buffer (a row-sparse one keeps no rows)."""
        if self._grad is not None:
            _zero_buffer(self._grad)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _autograd.backward([self], [out_grad] if out_grad is not None
                           else None, retain_graph=retain_graph,
                           train_mode=train_mode)

    def detach(self):
        """The same values, cut from the tape."""
        return NDArray(self._data.detach(), ctx=self._ctx)

    def __setitem__(self, key, value):
        """Write in place: a scalar, a numpy array, a tensor or an NDArray,
        converted to this array's dtype and device."""
        if isinstance(value, NDArray):
            value = value._data
        elif isinstance(value, np.ndarray):
            value = _tensor_from_numpy(value)
        if torch.is_tensor(value):
            value = value.to(self._data.device, self._data.dtype)
        with torch.no_grad():
            self._data[key] = value

    def __add__(self, other):
        return invoke("broadcast_add", self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return invoke("broadcast_sub", self, other)

    def __rsub__(self, other):
        return invoke("broadcast_sub", other, self)

    def __mul__(self, other):
        return invoke("broadcast_mul", self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return invoke("broadcast_div", self, other)

    def __rtruediv__(self, other):
        return invoke("broadcast_div", other, self)

    def __neg__(self):
        return invoke("negative", self)

    # comparisons give 1/0 arrays; == and != stay Python's identity tests
    # (arrays are dict keys and list members in the port)
    def __lt__(self, other):
        return invoke("broadcast_lesser", self, other)

    def __le__(self, other):
        return invoke("broadcast_lesser_equal", self, other)

    def __gt__(self, other):
        return invoke("broadcast_greater", self, other)

    def __ge__(self, other):
        return invoke("broadcast_greater_equal", self, other)

    def __imul__(self, other):
        """x *= y in place: the product is written into x's storage (so
        views and the lists holding x see it), in x's dtype."""
        res = invoke("broadcast_mul", self, other)
        with torch.no_grad():
            self._data.copy_(res._data)
        return self


def _zero_buffer(buf):
    """Zero a gradient buffer in place: a row-sparse one keeps no rows."""
    with torch.no_grad():
        if buf.stype == "row_sparse":
            buf._set_rows(buf._values[:0], buf._indices[:0])
        else:
            buf._data.zero_()


def _dtype_of(torch_dt):
    """A torch dtype as the port names it: a numpy dtype, or the string
    ``"bfloat16"``."""
    name = dtype_name(torch_dt)
    return name if name == "bfloat16" else np.dtype(name)


def _unwrap(a):
    return a._data if isinstance(a, NDArray) else a


# installed by `contrib.amp.init()`: (op fn, op name) -> the fn with its
# inputs cast by the AMP lists
_AMP_WRAP = None
# set by `profiler.set_state()`: a plain bool, so the off path costs one
# global read a call
_PROFILE_IMPERATIVE = False


def invoke(op_name, *args, out=None, **kwargs):
    """Run registered op `op_name` on `args` (NDArrays, scalars) in the
    context of the first NDArray argument (else ``ctx=`` or the current
    context); the GPU context takes the op's CUDA implementation, and a
    creation op (no array input) gets that context as ``ctx=``. An
    NDArray given by keyword (`SequenceMask`'s ``sequence_length=``)
    reaches the op as its tensor. Torch records the op only under
    `autograd.record()`. Under AMP the op's inputs are cast inside the
    call, so a gradient flows back through the cast; while the profiler
    runs, the call's host time goes to its op table."""
    if _PROFILE_IMPERATIVE:
        from .. import profiler as _profiler
        t0 = time.perf_counter()
        try:
            return _invoke(op_name, args, out, kwargs)
        finally:
            _profiler.record_op(op_name, time.perf_counter() - t0)
    return _invoke(op_name, args, out, kwargs)


def _invoke(op_name, args, out, kwargs):
    op = _reg.get(op_name)
    kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
    ctx = next((a._ctx for a in args if isinstance(a, NDArray)), None)
    if ctx is None:
        ctx = kwargs.pop("ctx", None) or current_context()
    else:
        kwargs.pop("ctx", None)
    if op.creation:
        kwargs["ctx"] = ctx
    fn = op.best_fn(ctx.device_type == "gpu")
    if _AMP_WRAP is not None:
        fn = _AMP_WRAP(fn, op_name)
    rec = op.differentiable and _autograd.is_recording()
    if rec == torch.is_grad_enabled():
        raw = fn(*(_unwrap(a) for a in args), **kwargs)
    else:
        with torch.set_grad_enabled(rec):
            raw = fn(*(_unwrap(a) for a in args), **kwargs)
    outs = [NDArray(r, ctx=ctx) for r in raw] \
        if isinstance(raw, (tuple, list)) else NDArray(raw, ctx=ctx)
    if out is not None:
        with torch.no_grad():
            for s, d in zip(outs if isinstance(outs, list) else [outs],
                            out if isinstance(out, (tuple, list))
                            else [out]):
                d._data.copy_(s._data)
        return out
    return outs


def split_v2(ary, indices_or_sections, axis=0, squeeze_axis=False):
    """Split `ary` into equal parts or at the given indices: a list."""
    return invoke("_split_v2", ary, indices_or_sections=indices_or_sections,
                  axis=axis, squeeze_axis=squeeze_axis)


def _tensor_from_numpy(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes, where present
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _put(t, ctx):
    ctx = ctx or current_context()
    return NDArray(t.to(ctx.torch_device), ctx=ctx)


def array(source_array, ctx=None, dtype=None):
    """An array from an NDArray, tensor or array-like, on `ctx` (default
    the current context). The dtype defaults to float32, except for an
    NDArray or tensor source, which keeps its own."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if torch.is_tensor(source_array):
        t = source_array.detach().clone()
    else:
        t = _tensor_from_numpy(source_array)
        if dtype is None:
            dtype = "float32"
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return _put(t, ctx)


def zeros(shape, ctx=None, dtype=None):
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx or current_context()
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype),
                               device=ctx.torch_device), ctx=ctx)


def ones(shape, ctx=None, dtype=None):
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx or current_context()
    return NDArray(torch.ones(shape, dtype=torch_dtype(dtype),
                              device=ctx.torch_device), ctx=ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """[start, stop) in steps of `step` (each value `repeat` times), float32
    by default, on `ctx` (default the current context)."""
    ctx = ctx or current_context()
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=ctx.torch_device)
    if repeat != 1:
        t = t.repeat_interleave(repeat)
    return NDArray(t, ctx=ctx)


def _record(arr):
    """NDArray -> (numpy array, dtype name) for the `.params` format."""
    t = arr._data.detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    if name == "bfloat16":
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_record(a, name):
    if name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return NDArray(t, ctx=context_of(t.device))


def save(fname, data):
    """Save a dict of NDArrays (or a list, or one array) as a `.params`
    file."""
    from ..io import params_serde
    if isinstance(data, NDArray):
        data = [data]
    names = list(data.keys()) if isinstance(data, dict) else []
    arrays = [data[k] for k in names] if names else list(data)
    params_serde.save_records(fname, names, [_record(a) for a in arrays])


def load(fname):
    """Load a `.params` file: a dict when the file names its arrays, else
    a list. The arrays stay on the host (`cpu()`), where the file was read;
    `Parameter` loading moves them to the parameter's context."""
    from ..io import params_serde
    names, records = params_serde.load_records(fname)
    arrays = [_from_record(a, name) for a, name in records]
    return dict(zip(names, arrays)) if names else arrays
