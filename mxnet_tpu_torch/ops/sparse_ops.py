"""Dense scatter-add of sparse rows (the port of `mxnet_tpu.ops.sparse_ops`).

`segment_sum(values, ids, num_segments)` computes

    out = zeros((num_segments,) + values.shape[1:]);  out[ids[j]] += values[j]

for every row j in occurrence order, each add rounded to the values' dtype,
and drops the rows whose id is negative (the padding of the sparse slabs)
or not below `num_segments`. It is what every sparse dedup and embedding
update of the port goes through: `parallel.collectives.merge_unique_rows`,
`embedding.ShardedEmbedding`, `ndarray.sparse.merge_rows`,
`scatter_add_rows` and the registered ``_sparse_segment_sum`` op.

A CUDA tensor goes through kernel #11 (``csrc/segment_sum.cu``), by one of
two routes that `segment_sum_plan` picks from the shape before the launch.
Up to `FUSED_MAX_NNZ` rows ("fused"): one persistent launch zeroes the
output while a block for each `SORT_CHUNK` ids checks their order (and,
only if they are out of order, sorts them in shared memory), then sums
each run of equal ids in order; ids that arrive sorted, as on every main
path, are never sorted.
Above it ("presorted"): a stable ``torch.sort`` of the int32 ids here gives
the permutation, then one launch zeroes the output and another sums each
run in sorted order, which the stable sort makes occurrence order. No
atomics on either route: the sums are the same on every run and bit-equal
to the plain version. Each call counts one launch with its route as the
variant (`ops.variant_counts`). A CPU tensor goes through the plain
version, `_segment_sum_plain`: zeros, then ``index_add_`` of the kept rows,
which on the CPU adds them one at a time in occurrence order, rounding
after each add.

Unlike the reference, no gate sends a call elsewhere: the reference sends
any destination slab over its 8 MB VMEM budget to XLA, so on a TPU only
the dedup reached its kernel, where the port runs #11 at every shape.
The reference's XLA path wraps negative ids (its docstring forbids them
there); the port drops them on both paths, as the kernel does.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import barrier_words, count_launch
from . import registry as _reg
from ._build import bind

__all__ = ["segment_sum", "scatter_add_rows", "segment_sum_plan",
           "SegsumPlan", "FUSED_MAX_NNZ"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT32_MAX = 2 ** 31 - 1
# the fused route's ids: up to 16 sorting blocks of 1024 ids, whose 16384
# 8-byte keys are 128 KB of a block's 227 KB of shared memory
SORT_CHUNK = 1024
FUSED_MAX_NNZ = 16 * SORT_CHUNK


class SegsumPlan(collections.namedtuple("SegsumPlan",
                                        "variant vec lanes sort_keys")):
    """Kernel #11's route ("fused" or "presorted") and, for the fused one,
    the values a lane loads (1, or 16 bytes' worth), the lanes that share
    a row (a power of two up to 32) and the sort keys its shared memory
    holds (nnz rounded up to whole chunks of SORT_CHUNK)."""


def _pow2_at_least(n):
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def segment_sum_plan(nnz, dim, dtype, aligned=True):
    """The route kernel #11 takes for `nnz` rows of `dim` values of
    `dtype`: "fused" up to FUSED_MAX_NNZ rows, with 16-byte loads where dim
    is a multiple of 16 bytes' worth of values and the values are 16-byte
    `aligned`; "presorted" above (or for rows of 2**31 values or more)."""
    if nnz > FUSED_MAX_NNZ or dim > _INT32_MAX:
        return SegsumPlan("presorted", 1, 32, 0)
    per16 = 16 // torch.tensor([], dtype=dtype).element_size()
    vec = per16 if aligned and dim % per16 == 0 else 1
    return SegsumPlan("fused", vec, min(32, _pow2_at_least(dim // vec)),
                      max(1, -(-nnz // SORT_CHUNK)) * SORT_CHUNK)


def _segment_sum_plain(values, ids, num_segments):
    """zeros((num_segments, ...)), then the rows whose id is in [0,
    num_segments) added in occurrence order, each add in the values' dtype.
    At fp32 that is ``index_add_``, which on the CPU adds one row at a
    time in order. At bf16/fp16 ``index_add_`` accumulates in fp32 and
    rounds once, so there the j-th occurrences of all ids are added
    together, for j = 0, 1, ...: each add is one rounded tensor add."""
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    keep = (ids >= 0) & (ids < num_segments)
    ids, values = ids[keep].long(), values[keep]
    if values.dtype == torch.float32 or ids.numel() == 0:
        return out.index_add_(0, ids, values)
    sk, order = torch.sort(ids, stable=True)
    pos = torch.arange(sk.numel(), device=sk.device)
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    occurrence = torch.empty_like(pos)
    occurrence[order] = pos - torch.cummax(torch.where(start, pos, 0),
                                           0).values
    for j in range(int(occurrence.max()) + 1):
        sel = occurrence == j
        rows = ids[sel]                 # distinct within one occurrence
        out[rows] = out[rows] + values[sel]
    return out


_FUSED_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
               + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_PRESORTED_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])


def _launch(dev, symbol, argtypes, args_of):
    """Call #11's C entry `symbol` with args_of(stream) on dev's current
    stream (the last argument); raise on a launch error."""
    lib, fn = bind("segment_sum", symbol, argtypes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args_of(stream), stream)
    if err:
        raise RuntimeError("segment_sum: launch failed: %s"
                           % lib.mx_cuda_error_string(err).decode())


def _segment_sum_cuda(values, ids, num_segments):
    if values.dtype not in _DTYPES:
        raise TypeError("segment_sum: the kernel takes float32/bfloat16/"
                        "float16 values, got %s" % values.dtype)
    if ids.dim() != 1 or ids.shape[0] != values.shape[0] \
            or ids.device != values.device or ids.is_floating_point():
        raise ValueError("segment_sum: ids must be (nnz,) integers on %s, "
                         "got %s %s on %s" % (values.device, ids.dtype,
                                              tuple(ids.shape), ids.device))
    shape = (num_segments,) + tuple(values.shape[1:])
    dev = values.device
    out = torch.empty(shape, dtype=values.dtype, device=dev)
    if num_segments == 0:
        return out
    nnz, dim = values.shape[0], math.prod(values.shape[1:])
    vals = values.reshape(nnz, dim).contiguous()
    plan = segment_sum_plan(nnz, dim, values.dtype, vals.data_ptr() % 16 == 0)
    dtype = _DTYPES[values.dtype]
    if plan.variant == "fused":
        if ids.dtype not in (torch.int32, torch.int64):
            ids = ids.long()
        ids = ids.contiguous()
        # the sorted chunks' keys, then the sorted ids and positions
        scratch = torch.empty(plan.sort_keys + nnz, dtype=torch.int64,
                              device=dev)
        _launch(dev, "mx_segment_sum_fused", _FUSED_ARGS, lambda stream: (
            vals.data_ptr(), ids.data_ptr(), ids.element_size(),
            out.data_ptr(), scratch.data_ptr(),
            barrier_words(dev, stream).data_ptr(), nnz, dim, num_segments,
            dtype, plan.vec, plan.lanes, plan.sort_keys))
    else:
        if ids.dtype != torch.int32:
            # out-of-range ids become -1 before the cast, so none wraps
            # into range
            ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                              -1).to(torch.int32)
        sorted_ids, perm = torch.sort(ids, stable=True)
        _launch(dev, "mx_segment_sum", _PRESORTED_ARGS, lambda stream: (
            vals.data_ptr(), sorted_ids.data_ptr(), perm.data_ptr(),
            out.data_ptr(), nnz, dim, num_segments, dtype))
    count_launch("segment_sum", plan.variant)
    return out


def segment_sum(values, ids, num_segments):
    """Dense scatter-add of (nnz, *row) `values` at their (nnz,) integer
    `ids` into a (num_segments, *row) tensor, in occurrence order; rows
    with an id outside [0, num_segments) are dropped. Kernel #11 for a
    CUDA tensor (float32/bfloat16/float16 values, int32 or int64 ids),
    the plain version for a CPU tensor."""
    num_segments = int(num_segments)
    if not 0 <= num_segments <= _INT32_MAX:
        raise ValueError("segment_sum: num_segments must be in [0, 2**31), "
                         "got %d" % num_segments)
    if values.dim() < 1:
        raise ValueError("segment_sum: values must have a row axis")
    if values.is_cuda:
        return _segment_sum_cuda(values, ids, num_segments)
    return _segment_sum_plain(values, ids, num_segments)


def scatter_add_rows(table, ids, values):
    """``table`` plus the segment sum of `values` at `ids` over its rows (a
    new tensor, as the reference's ``table.at[ids].add(values)``)."""
    delta = segment_sum(values, ids, table.shape[0])
    return table + delta.to(table.dtype)


# registry surface: the plain version on the CPU, kernel #11 on a GPU
@_reg.register("_sparse_segment_sum", arity=2, differentiable=False,
               doc="dense scatter-add of (ids, values) rows into a "
                   "num_segments-row table")
def _sparse_segment_sum(values, ids, num_segments=0):
    return _segment_sum_plain(values, ids, int(num_segments))


@_reg.get("_sparse_segment_sum").cuda_impl
def _sparse_segment_sum_cuda(values, ids, num_segments=0):
    return segment_sum(values, ids, int(num_segments))
