"""Sparse NDArrays: ``row_sparse`` and ``csr`` storage (the port of
`mxnet_tpu.ndarray.sparse`).

A `RowSparseNDArray` is a set of rows: sorted unique int32 `indices` and
their `data` rows, every other row zero. A `CSRNDArray` is (data,
indices, indptr). Both are NDArrays: a dense op reads them densified, as
the reference's fall back to dense does. Duplicate rows are summed by
`merge_rows` through `ops.sparse_ops.segment_sum` (kernel #11 on a card),
which adds them in occurrence order on every run; torch's CUDA
``index_add_`` adds with atomics, so with three or more duplicates its sums
would change from run to run.

`dot` with a CSR left-hand side needs the ``_sparse_dot_csr_dense`` op and
its gradient; it comes with the port's Gluon-sparse slice (the
factorization-machine path), and raises here until then.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from ..context import context_of, current_context
from ..ops import sparse_ops as _sops
from .ndarray import NDArray, _dtype_of, invoke

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "zeros",
           "retain", "dot", "merge_rows", "add", "elemwise_add"]

_GLUON_SPARSE = "the port's Gluon-sparse slice"


def _tensor(a, dtype, device):
    """A tensor of `dtype` (None: its own) on `device` from a tensor, an
    NDArray or an array-like."""
    if isinstance(a, NDArray):
        a = a._data
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.array(a))
    return a.detach().to(device=device, dtype=dtype)


def _ctx_for(ctx, *tensors):
    if ctx is not None:
        return ctx
    for t in tensors:
        if torch.is_tensor(t):
            return context_of(t.device)
    return current_context()


class BaseSparseNDArray(NDArray):
    """Common base. ``_data`` is the dense tensor, built when read, so any
    dense op still works on a sparse array."""

    __slots__ = ()

    def _init_base(self, ctx):
        self._ctx = ctx
        self._grad = None
        self._grad_req = "null"

    @property
    def _data(self):
        return self._dense()

    @property
    def shape(self):
        return self._shape_full

    def tostype(self, stype):
        return cast_storage(self, stype)


class RowSparseNDArray(BaseSparseNDArray):
    """The rows `indices` (sorted unique) of a `shape` array, with their
    `data`; absent rows are zero."""

    __slots__ = ("_indices", "_values", "_shape_full")

    def __init__(self, values, indices, shape, ctx=None):
        ctx = _ctx_for(ctx, values, indices)
        dev = ctx.torch_device
        self._init_base(ctx)
        self._values = _tensor(values, None, dev)
        self._indices = _tensor(indices, torch.int32, dev)
        self._shape_full = tuple(int(s) for s in shape)

    @property
    def stype(self):
        return "row_sparse"

    @property
    def dtype(self):
        return _dtype_of(self._values.dtype)

    @property
    def indices(self):
        return NDArray(self._indices, ctx=self._ctx)

    @property
    def data(self):
        return NDArray(self._values, ctx=self._ctx)

    def _dense(self):
        out = torch.zeros(self._shape_full, dtype=self._values.dtype,
                          device=self._values.device)
        out[self._indices.long()] = self._values
        return out

    def _write(self, value):
        """A dense write: every row becomes stored."""
        self._indices = torch.arange(self._shape_full[0], dtype=torch.int32,
                                     device=value.device)
        self._values = value

    def _set_rows(self, values, indices):
        """Replace the stored rows; `indices` sorted unique."""
        self._values = values
        self._indices = indices

    def copy(self):
        return RowSparseNDArray(self._values.clone(), self._indices.clone(),
                                self._shape_full, ctx=self._ctx)

    def __repr__(self):
        return "\n<RowSparseNDArray %s @%s>" % (
            "x".join(str(d) for d in self._shape_full), self._ctx)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows: `data` and column `indices` of the nonzeros,
    row by row, and `indptr`, where each row's entries start."""

    __slots__ = ("_sp_data", "_sp_indices", "_indptr", "_shape_full")

    def __init__(self, data, indices, indptr, shape, ctx=None):
        ctx = _ctx_for(ctx, data, indices, indptr)
        dev = ctx.torch_device
        self._init_base(ctx)
        self._sp_data = _tensor(data, None, dev)
        self._sp_indices = _tensor(indices, torch.int32, dev)
        self._indptr = _tensor(indptr, torch.int32, dev)
        self._shape_full = tuple(int(s) for s in shape)

    @property
    def stype(self):
        return "csr"

    @property
    def dtype(self):
        return _dtype_of(self._sp_data.dtype)

    @property
    def data(self):
        return NDArray(self._sp_data, ctx=self._ctx)

    @property
    def indices(self):
        return NDArray(self._sp_indices, ctx=self._ctx)

    @property
    def indptr(self):
        return NDArray(self._indptr, ctx=self._ctx)

    def _row_ids(self):
        """The row of each stored entry."""
        nnz = self._sp_data.shape[0]
        return torch.searchsorted(
            self._indptr, torch.arange(nnz, dtype=torch.int32,
                                       device=self._indptr.device),
            right=True).long() - 1

    def _dense(self):
        out = torch.zeros(self._shape_full, dtype=self._sp_data.dtype,
                          device=self._sp_data.device)
        out.index_put_((self._row_ids(), self._sp_indices.long()),
                       self._sp_data, accumulate=True)
        return out

    def _write(self, value):
        raise NotImplementedError("in-place write to csr is not supported "
                                  "(as in the reference)")

    def __repr__(self):
        return "\n<CSRNDArray %s @%s>" % (
            "x".join(str(d) for d in self._shape_full), self._ctx)


# ---------------------------------------------------------------------------
# constructors (reference: mx.nd.sparse.row_sparse_array / csr_matrix)
# ---------------------------------------------------------------------------
def _dense_numpy(arg1):
    if isinstance(arg1, NDArray):
        return arg1.asnumpy()
    if torch.is_tensor(arg1):
        return arg1.detach().float().cpu().numpy() \
            if arg1.dtype == torch.bfloat16 else arg1.detach().cpu().numpy()
    return np.asarray(arg1)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """From ``(data, indices)`` and `shape`, or from a dense array (its
    nonzero rows)."""
    ctx = ctx or current_context()
    dt = torch_dtype("float32" if dtype is None else dtype)
    dev = ctx.torch_device
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and not np.isscalar(arg1[0]):
        values, indices = arg1
        return RowSparseNDArray(_tensor(values, dt, dev),
                                _tensor(indices, torch.int32, dev), shape,
                                ctx=ctx)
    dense = _dense_numpy(arg1)
    nz = np.where(np.any(dense.reshape(dense.shape[0], -1) != 0,
                         axis=1))[0]
    return RowSparseNDArray(_tensor(dense[nz], dt, dev),
                            _tensor(nz, torch.int32, dev), dense.shape,
                            ctx=ctx)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """From ``(data, indices, indptr)`` and `shape`, or from a dense
    matrix (its nonzeros, row by row, columns ascending)."""
    ctx = ctx or current_context()
    dt = torch_dtype("float32" if dtype is None else dtype)
    dev = ctx.torch_device
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(_tensor(data, dt, dev),
                          _tensor(indices, torch.int32, dev),
                          _tensor(indptr, torch.int32, dev), shape, ctx=ctx)
    dense = _dense_numpy(arg1)
    rows, cols = np.nonzero(dense)
    indptr = np.zeros(dense.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return CSRNDArray(_tensor(dense[rows, cols], dt, dev),
                      _tensor(cols, torch.int32, dev),
                      _tensor(np.cumsum(indptr), torch.int32, dev),
                      dense.shape, ctx=ctx)


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type `stype`."""
    ctx = ctx or current_context()
    dt = torch_dtype("float32" if dtype is None else dtype)
    dev = ctx.torch_device
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), shape, ctx=ctx)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape, ctx=ctx)
    from .ndarray import zeros as dzeros
    return dzeros(shape, ctx=ctx, dtype=dtype)


# ---------------------------------------------------------------------------
# storage casts and sparse ops
# ---------------------------------------------------------------------------
def cast_storage(arr, stype):
    """`arr` as storage type `stype` (``default``, ``row_sparse``,
    ``csr``)."""
    if stype == arr.stype:
        return arr
    if stype == "default":
        return NDArray(arr._data, ctx=arr._ctx)
    if stype == "row_sparse":
        return row_sparse_array(arr._data, ctx=arr._ctx, dtype=arr.dtype)
    if stype == "csr":
        return csr_matrix(arr._data, ctx=arr._ctx, dtype=arr.dtype)
    raise ValueError("unknown stype " + stype)


def retain(arr, indices):
    """Only the rows `indices` of a row-sparse array (zero where `arr`
    stores no such row)."""
    dev = arr._values.device
    idx = _tensor(indices, torch.int32, dev)
    n = arr._indices.shape[0]
    if n:
        pos = torch.searchsorted(arr._indices, idx).clamp(0, n - 1)
        present = arr._indices[pos] == idx
        vals = arr._values[pos] * present.reshape(
            (-1,) + (1,) * (arr._values.dim() - 1)).to(arr._values.dtype)
    else:
        vals = torch.zeros((idx.shape[0],) + tuple(arr._values.shape[1:]),
                           dtype=arr._values.dtype, device=dev)
    return RowSparseNDArray(vals, idx, arr.shape, ctx=arr._ctx)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse dot. A row-sparse lhs multiplies its stored rows; a CSR lhs
    comes with the Gluon-sparse slice; dense operands go to the ``dot``
    op."""
    if isinstance(lhs, CSRNDArray):
        raise NotImplementedError("dot with a csr lhs comes with %s"
                                  % _GLUON_SPARSE)
    if isinstance(lhs, RowSparseNDArray) \
            and not isinstance(rhs, BaseSparseNDArray):
        if transpose_a:
            # rsp^T (m, k) . dense (m, n): only the stored rows contribute
            return NDArray(lhs._values.T @ rhs._data[lhs._indices.long()],
                           ctx=lhs._ctx)
        return NDArray(lhs._dense() @ rhs._data, ctx=lhs._ctx)
    return invoke("dot", lhs, rhs, transpose_a=transpose_a,
                  transpose_b=transpose_b)


def merge_rows(indices, values):
    """Raw (indices, values) rows -> (sorted unique int32 indices, their
    summed rows). The unique runs on the host (one small copy of the ids,
    as in the reference); the rows are summed on their device by
    `segment_sum`, in occurrence order."""
    uniq, inv = np.unique(indices.detach().cpu().numpy(),
                          return_inverse=True)
    dev = values.device
    summed = _sops.segment_sum(
        values, torch.as_tensor(inv.reshape(-1), device=dev), len(uniq))
    return torch.as_tensor(uniq.astype(np.int32), device=dev), summed


def elemwise_add(a, b):
    """a + b; two row-sparse arrays give a row-sparse sum."""
    if isinstance(a, RowSparseNDArray) and isinstance(b, RowSparseNDArray):
        if a.shape != b.shape:
            raise ValueError("shape mismatch")
        idx, summed = merge_rows(torch.cat([a._indices, b._indices]),
                                 torch.cat([a._values, b._values]))
        return RowSparseNDArray(summed, idx, a.shape, ctx=a._ctx)
    return NDArray(a._data + b._data, ctx=a._ctx)


add = elemwise_add
