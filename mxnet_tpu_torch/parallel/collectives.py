"""Collectives over process groups, the bucketed multi-tensor forms, the
row-sparse exchange and the all-reduce benchmark (the port of
`mxnet_tpu.parallel.collectives`).

The JAX package's collectives run inside `shard_map` over a mesh axis.
Here every rank is a process, and a collective names its ranks by
`axis_name`: None (the whole world), an axis of the current mesh
(`mesh_scope`), or a torch ProcessGroup. NCCL carries CUDA tensors and
gloo CPU tensors (`parallel.dist`). A process that runs alone has no
group, and every collective is then the identity (a sum over one rank).

All of them return new tensors and leave their inputs as they were.
NCCL runs on the current stream: the results are ready in stream order,
as any kernel's are.

Transport of ranks that share a card. NCCL refuses two ranks on one
device, so such ranks run gloo (`launch`), and gloo's CUDA support covers
only ``broadcast`` and ``all_reduce``. Every collective of a CUDA tensor
under gloo is therefore staged through host memory: the tensor is copied
to the host, the CPU collective runs, and the result is copied back to
the card. This is the choice of a transport, not a fallback of a kernel:
no kernel runs in a collective, and the arithmetic (a sum in gloo's
order) is gloo's either way.

Autograd-aware forms, over one axis (Megatron's pair and the FSDP
gather): `copy_to_group` (identity forward, all-reduce of the cotangent),
`reduce_from_group` (all-reduce forward, identity backward),
`gather_on_use` (all-gather along a dimension; backward the
reduce-scatter of the cotangent, or this rank's slice of it when every
rank of the axis computed the same thing), `all_reduce_sum` (all-reduce
both ways: the cross-rank sums of batch statistics) and `all_reduce_max`
(no gradient). A group of one rank makes each of them the identity.

`batch_stats_scope(group)` names the group over which the training-mode
BatchNorms (`ops.nn` BatchNorm, the fused conv-BN-ReLU training op)
reduce their batch statistics while a data-parallel `FusedTrainStep`
runs its forward; `batch_stats_group()` reads it (None outside).

`merge_unique_rows` sums the rows of duplicate ids in a static-shape slab:
a stable sort and one `segment_sum` (kernel #11 on a card), so
duplicates add in occurrence order. `psum_unique_rows` is the sparse
all-reduce: one all-gather of each rank's fixed-size (ids, rows) slab,
then that dedup, so the bytes on the wire scale with the touched rows.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .. import engine as _engine
from .. import telemetry as _telem
from ..ops import sparse_ops as _sops
from . import dist

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "ppermute",
           "psum_bucketed", "all_reduce_multi", "reduce_scatter_multi",
           "all_gather_multi", "all_gather_rows", "psum_unique_rows",
           "merge_unique_rows", "barrier", "allreduce_bench",
           "resolve_group", "copy_to_group", "reduce_from_group",
           "gather_on_use", "all_reduce_sum", "all_reduce_max",
           "batch_stats_group", "batch_stats_scope", "batch_ratio"]

_SENTINEL = 2 ** 31 - 1


def resolve_group(axis_name=None):
    """(group, world, rank) of `axis_name`: None for the world, a name of
    the current mesh's axes, or a ProcessGroup. (None, 1, 0) when the
    process runs alone."""
    if not dist.has_group():
        return None, 1, 0
    import torch.distributed as tdist
    group = axis_name
    if isinstance(axis_name, (str, tuple)):
        from .mesh import current_mesh
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("collective over axis %r needs a mesh_scope"
                             % axis_name)
        group = mesh.group(axis_name)
        if group is None:
            return None, 1, 0
    return (group, tdist.get_world_size(group),
            tdist.get_rank(group))


def _tdist():
    import torch.distributed as tdist
    return tdist


def _staged(x):
    """True when `x` must go through host memory: a CUDA tensor under
    gloo (ranks sharing a card)."""
    return x.is_cuda and dist.backend() == "gloo"


def gather_into(out, src, group=None, async_op=False):
    """``all_gather_single`` where torch has it, else its older name."""
    tdist = _tdist()
    fn = getattr(tdist, "all_gather_single", None) or \
        tdist.all_gather_into_tensor
    return fn(out, src, group=group, async_op=async_op)


def scatter_into(out, src, group=None, async_op=False):
    """``reduce_scatter_single`` (a sum) where torch has it, else its
    older name."""
    tdist = _tdist()
    fn = getattr(tdist, "reduce_scatter_single", None) or \
        tdist.reduce_scatter_tensor
    return fn(out, src, group=group, async_op=async_op)


def all_reduce(x, axis_name=None, op="sum"):
    """The sum (or max/min) of `x` over the ranks of `axis_name`."""
    group, world, _ = resolve_group(axis_name)
    if world == 1:
        return x.clone()
    tdist = _tdist()
    _telem.inc("comm.collectives")
    out = x.cpu() if _staged(x) else x.clone()
    tdist.all_reduce(out, op=getattr(tdist.ReduceOp, op.upper()),
                     group=group)
    return out.to(x.device) if _staged(x) else out


def all_gather(x, axis_name=None, axis=0, tiled=True):
    """Every rank's `x` joined along `axis` (stacked on a new leading axis
    with ``tiled=False``), in rank order."""
    group, world, _ = resolve_group(axis_name)
    if world == 1:
        return x.clone() if tiled else x.unsqueeze(0).clone()
    tdist = _tdist()
    src = (x.movedim(axis, 0) if tiled else x.unsqueeze(0)).contiguous()
    host = _staged(x)
    if host:
        src = src.cpu()
    out = torch.empty((world * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=src.device)
    _telem.inc("comm.all_gather")
    gather_into(out, src, group)
    if host:
        out = out.to(x.device)
    return out.movedim(0, axis) if tiled else out


def reduce_scatter(x, axis_name=None, axis=0):
    """This rank's contiguous 1/world slice (along `axis`) of the sum of
    every rank's `x`."""
    group, world, _ = resolve_group(axis_name)
    if world == 1:
        return x.clone()
    tdist = _tdist()
    src = x.movedim(axis, 0).contiguous()
    if src.shape[0] % world:
        raise ValueError("reduce_scatter: dim %d of %d does not split over "
                         "%d ranks" % (axis, src.shape[0], world))
    host = _staged(x)
    if host:
        src = src.cpu()
    out = torch.empty((src.shape[0] // world,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=src.device)
    _telem.inc("comm.reduce_scatter")
    scatter_into(out, src, group)
    if host:
        out = out.to(x.device)
    return out.movedim(0, axis)


def ppermute(x, axis_name, perm):
    """Send `x` along the (src, dst) pairs of `perm` (positions in the
    group); returns what this rank received (zeros where nothing
    arrives), as `lax.ppermute` does."""
    group, world, me = resolve_group(axis_name)
    if world == 1:
        got = [s for s, d in perm if d == 0]
        return x.clone() if got else torch.zeros_like(x)
    tdist = _tdist()
    ranks = tdist.get_process_group_ranks(group) if group is not None \
        else list(range(world))
    host = _staged(x)
    src = x.cpu().contiguous() if host else x.contiguous()
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me:
            ops.append(tdist.P2POp(tdist.isend, src, ranks[d], group))
        if d == me:
            ops.append(tdist.P2POp(tdist.irecv, out, ranks[s], group))
    for req in tdist.batch_isend_irecv(ops) if ops else []:
        req.wait()
    return out.to(x.device) if host else out


def barrier(axis_name=None):
    """Wait until every rank of `axis_name` arrives (a one-element
    all-reduce on the rank's device, so that NCCL orders it behind the
    stream's work); the identity alone."""
    group, _, _ = resolve_group(axis_name)
    if not dist.has_group():
        return
    tdist = _tdist()
    t = torch.ones(1, device=dist.device())
    if _staged(t):
        torch.cuda.current_stream().synchronize()
        t = t.cpu()
    tdist.all_reduce(t, group=group)
    if t.is_cuda:
        torch.cuda.current_stream().synchronize()


def psum_bucketed(xs, axis_name=None, bucket_mb=None):
    """The sum over ranks of a LIST of tensors as few flat all-reduces:
    size-capped single-dtype buckets (`engine.bucketize`), each packed,
    reduced in one call and split back. Without a cap, one all-reduce per
    tensor. Returns the sums in input order."""
    cap = _engine.bucket_bytes(bucket_mb)
    if not cap or len(xs) < 2:
        return [all_reduce(x, axis_name) for x in xs]
    out = list(xs)
    for bucket in _engine.bucketize(enumerate(xs), cap):
        flat = _engine.pack_bucket(bucket)
        red = _all_reduce_(flat, axis_name)
        for idx, part in zip(bucket.keys,
                             _engine.unpack_bucket(bucket, red)):
            out[idx] = part
    return out


def _all_reduce_(flat, axis_name=None):
    """In-place sum of a buffer this module owns."""
    group, world, _ = resolve_group(axis_name)
    if world > 1:
        _telem.inc("comm.collectives")
        if _staged(flat):
            host = flat.cpu()
            _tdist().all_reduce(host, group=group)
            flat.copy_(host)
        else:
            _tdist().all_reduce(flat, group=group)
    return flat


def all_reduce_multi(arrays, axis_name=None, bucket_mb=None):
    """`psum_bucketed` under the eager name of the JAX package: the
    reduced tensors in input order (zero-size ones stay as they are)."""
    keep = [i for i, a in enumerate(arrays) if a.numel()]
    red = psum_bucketed([arrays[i] for i in keep], axis_name, bucket_mb)
    out = [a.clone() for a in arrays]
    for i, r in zip(keep, red):
        out[i] = r
    return out


def reduce_scatter_multi(xs, axis_name=None, axis_size=None, layout=None,
                         bucket_mb=None):
    """Reduce-scatter a LIST of tensors bucket by bucket over a persistent
    `engine.BucketLayout` (frozen from `xs` on first use: pass the
    returned layout back in later). Each bucket's flat vector is padded to
    a multiple of the world and reduced in one call; this rank keeps its
    contiguous shard. Returns ``(shards, layout)``."""
    group, world, _ = resolve_group(axis_name)
    if any(x.numel() == 0 for x in xs):
        raise ValueError("reduce_scatter_multi: zero-size arrays have no "
                         "shard; filter them out before the call")
    if layout is None:
        n = world if axis_size is None else int(axis_size)
        layout = _engine.BucketLayout.from_entries(
            ((str(i), x) for i, x in enumerate(xs)), n,
            _engine.bucket_bytes(bucket_mb))
    else:
        layout.assert_matches([str(i) for i in range(len(xs))])
    by_key = {str(i): x for i, x in enumerate(xs)}
    shards = []
    for spec in layout:
        flat = _engine.pack_flat(spec, [by_key[k] for k in spec.keys])
        shards.append(reduce_scatter(flat, axis_name))
    return shards, layout


def all_gather_multi(shards, layout, axis_name=None):
    """Inverse of `reduce_scatter_multi`: each bucket's shards gathered to
    the padded flat vector and unpacked (padding dropped), in the
    layout's key order."""
    outs = {}
    for spec, shard in zip(layout, shards):
        flat = all_gather(shard, axis_name)
        for k, part in zip(spec.keys, _engine.unpack_flat(spec, flat)):
            outs[k] = part
    return [outs[k] for k in layout.keys()]


def merge_unique_rows(ids, vals, pad_id=-1):
    """Sum the rows of duplicate ids in an ``(n,)`` / ``(n, *row)`` slab;
    negative ids are padding. Returns ``(out_ids, out_vals)`` of the same
    shapes: the unique real rows first, ids ascending, then `pad_id` and
    zero rows. A stable sort by id, the starts of its runs, and one
    `segment_sum` into n slots, so duplicates add in occurrence order."""
    n = ids.shape[0]
    ids32 = ids.to(torch.int32)
    valid = ids32 >= 0
    key = torch.where(valid, ids32, _SENTINEL)
    sk, order = torch.sort(key, stable=True)
    sv = vals[order]
    svalid = sk != _SENTINEL
    starts = torch.ones_like(svalid)
    starts[1:] = sk[1:] != sk[:-1]
    starts &= svalid
    seg = torch.cumsum(starts, 0, dtype=torch.int32) - 1
    # pad rows go to the last slot with zeroed values: with at least one
    # pad row there are fewer than n real segments, so the last slot is
    # then no real segment; without one, it may be
    seg = torch.where(svalid, seg, n - 1)
    mask = svalid.reshape((n,) + (1,) * (sv.dim() - 1))
    merged = _sops.segment_sum(torch.where(mask, sv, torch.zeros_like(sv)),
                               seg, n)
    out_ids = torch.full((n,), pad_id, dtype=torch.int32, device=ids.device)
    out_ids[seg.long()] = torch.where(svalid, sk, pad_id).to(torch.int32)
    return out_ids, merged.to(vals.dtype)


def all_gather_rows(ids, vals, axis_name=None):
    """Every rank's fixed-size ``(n,)`` ids and ``(n, *row)`` rows, joined
    in rank order: ``(world*n,)`` / ``(world*n, *row)``."""
    _telem.inc("comm.sparse.all_gather_rows")
    return (all_gather(ids.to(torch.int32), axis_name),
            all_gather(vals, axis_name))


def psum_unique_rows(ids, vals, axis_name=None, pad_id=-1):
    """Sum row-sparse contributions over the ranks without densifying:
    the gathered slabs deduplicated by `merge_unique_rows`. Returns
    ``(world*n,)`` ids and rows: the unique rows first, then padding."""
    _telem.inc("comm.sparse.psum_unique_rows")
    gids, gvals = all_gather_rows(ids, vals, axis_name)
    return merge_unique_rows(gids, gvals, pad_id=pad_id)


def allreduce_bench(size_mb=64, iters=20, axis_name=None,
                    dtype=torch.float32, device=None, warmup=3):
    """Time an in-place all-reduce of `size_mb` megabytes (1e6 bytes) over
    the ranks of `axis_name`. Returns a dict: ``algo_gbps`` (bytes of the
    buffer over the time), ``bus_gbps`` (``algo_gbps * 2(n-1)/n``, the
    bytes a ring moves per rank: BASELINE's KVStore all-reduce metric,
    0 at one rank), ``seconds`` per call, ``world``, ``bytes`` and
    ``backend``. CUDA buffers are timed with CUDA events on the current
    stream (NCCL is asynchronous), CPU ones by the host clock."""
    import time
    group, world, _ = resolve_group(axis_name)
    dev = dist.device() if device is None else torch.device(device)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    n = max(1, int(size_mb * 1e6 / itemsize))
    x = torch.ones(n, dtype=dtype, device=dev)

    def once():
        if dist.has_group():
            _all_reduce_(x, group)

    for _ in range(warmup):
        once()
    if x.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            once()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            once()
        dt = (time.perf_counter() - t0) / iters
    nbytes = n * itemsize
    algo = nbytes / dt / 1e9 if dt > 0 else float("inf")
    return {"algo_gbps": algo, "bus_gbps": algo * 2 * (world - 1) / world,
            "seconds": dt, "world": world, "bytes": nbytes,
            "backend": dist.backend()}


# ------------------------------------------------------- autograd-aware forms
def _slice(x, dim, world, rank):
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n).contiguous()


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, the cotangent summed backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _AllReduceSum(torch.autograd.Function):
    """The sum both ways: every rank's contribution reaches every rank's
    result, so every rank's cotangent reaches every input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.group), None


class _GatherOnUse(torch.autograd.Function):
    """All-gather along `dim`; backward the reduce-scatter of the
    cotangent (``summed``: the ranks computed different things) or this
    rank's slice of it (they computed the same thing)."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        _, world, rank = resolve_group(group)
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        ctx.world, ctx.rank = world, rank
        return all_gather(x, group, axis=dim)

    @staticmethod
    def backward(ctx, dy):
        if ctx.summed:
            return reduce_scatter(dy, ctx.group, axis=ctx.dim), None, None, \
                None
        return _slice(dy, ctx.dim, ctx.world, ctx.rank), None, None, None


def _group_of(axis_name):
    """(group, world) of `axis_name`, resolved now (a backward may run on
    another thread, outside the caller's mesh_scope)."""
    group, world, _ = resolve_group(axis_name)
    return group, world


def copy_to_group(x, axis_name):
    """Identity forward; the cotangent all-reduced over `axis_name` in the
    backward (the input of a column-parallel product)."""
    group, world = _group_of(axis_name)
    return x if world == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x, axis_name):
    """The sum over `axis_name`; the cotangent passed through unchanged
    (the output of a row-parallel product)."""
    group, world = _group_of(axis_name)
    return x if world == 1 else _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x, axis_name):
    """The sum over `axis_name`, differentiable: the backward all-reduces
    the cotangent."""
    group, world = _group_of(axis_name)
    return x if world == 1 else _AllReduceSum.apply(x, group)


def all_reduce_max(x, axis_name):
    """The elementwise max over `axis_name`, cut from the graph."""
    group, world = _group_of(axis_name)
    x = x.detach()
    return x if world == 1 else all_reduce(x, group, op="max")


def gather_on_use(x, axis_name, dim, summed=True):
    """Every rank's `x` of the `axis_name` group joined along `dim` in
    rank order. Backward: with ``summed`` the reduce-scatter of the
    cotangent (the FSDP gather, and any whose ranks computed different
    parts of the loss), else this rank's slice of it (every rank of the
    group computed the same thing with the whole tensor)."""
    group, world = _group_of(axis_name)
    if world == 1:
        return x
    return _GatherOnUse.apply(x, group, dim, bool(summed))


# ----------------------------------------------------- batch statistics
_STATS = threading.local()


def batch_stats_group():
    """The group the current forward's BatchNorm statistics span, or
    None (this rank's batch alone)."""
    return getattr(_STATS, "group", None)


@contextlib.contextmanager
def batch_stats_scope(group):
    """Within the block, training-mode BatchNorm statistics are summed
    over `group` (a process group; None keeps them per rank)."""
    prev = batch_stats_group()
    _STATS.group = group
    try:
        yield
    finally:
        _STATS.group = prev


def batch_ratio(total, count, axes=("data", "fsdp")):
    """``total / max(count, 1)`` over the global batch, as this rank's
    share of it: a loss that is a ratio of sums (a masked mean) whose
    count differs between the batch slices. `parallel.ShardedTrainStep`
    averages the ranks' losses and gradients over the `axes` ranks of the
    current mesh, so each rank returns ``total * ranks / sum of every
    rank's count``: their mean is the ratio of the global sums, as the
    reference's one program computes it. Without a mesh (or over one
    rank), the plain ratio."""
    from .mesh import current_mesh
    mesh = current_mesh()
    n = 1 if mesh is None else mesh.axes_size(axes)
    if n == 1:
        return total / torch.clamp(count, min=1.0)
    count = all_reduce(count.detach(), axes)
    return total * n / torch.clamp(count, min=1.0)
