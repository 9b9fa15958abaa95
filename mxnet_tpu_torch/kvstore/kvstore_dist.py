"""The distributed KVStore (the port of `mxnet_tpu.kvstore.kvstore_dist`).

Types ``dist_sync``, ``dist_device_sync``, ``dist`` (an alias) and
``dist_async``, which has no synchronous-collective analog and runs
synchronously with the reference's warning. Every process is a worker of
one torch process group (`parallel.dist`: NCCL for CUDA tensors, gloo for
CPU ones), and there are no server processes: a push sums each key's
local replicas, then all-reduces the sum over the workers, and every
worker applies the same update to its own copy of the store (the
server-side optimizer of `set_optimizer`), which stays identical across
workers because the summed gradient is. `init` broadcasts worker 0's
value, as the reference's servers keep the first worker's.

* A multi-key dense push packs the keys into size-capped buckets
  (`engine.GradBucketer`) and all-reduces each bucket's flat vector in one
  call (`_push_bucketed`).
* 2-bit gradient compression (`GradientCompression`): each worker
  quantizes (value + residual) to {-t, 0, +t}, packs four 2-bit codes a
  byte (the reference's wire bytes), all-gathers the packed bytes, and
  every worker decodes and adds them in rank order; the quantization
  error stays in the residual for the next push. Buckets of a frozen
  layout carry the residuals of a multi-key push.
* Row-sparse pushes: the locally merged rows are exchanged as a
  unique-rows all-gather (`_sparse_sync`): one max all-reduce sizes a
  slab, every worker pads its (ids, rows) to it, and
  `collectives.psum_unique_rows` dedups the gathered rows (kernel #11 on
  a card), so the bytes on the wire scale with the touched rows.
* ZeRO (`set_optimizer(..., zero=True)`): `DistZeroComm` reduce-scatters
  the gradient buckets, all-gathers the updated shards and all-reduces
  LAMB's per-key norms.
* Readiness-ordered rounds launch each bucket's all-reduce asynchronously
  from the grad-ready hook (NCCL runs it on its own stream, beside
  backward's kernels) and wait for it at step time.
* Wire checksum (``MXNET_TPU_COMM_CHECKSUM=1``): a bucketed push checks
  each bucket's sum finite after the exchange (site
  ``kvstore_dist.bucket``), raising `DivergenceError` before any write;
  counter ``comm.checksum.buckets``. It costs one host read a bucket, so
  it is a switch of its own. The reference also digests the send buffer
  before and after the exchange; torch's all-reduce works on the packed
  bucket in place and nothing else holds that buffer, so the digest has
  no counterpart here.
"""
from __future__ import annotations

import time
import warnings

import torch

from .. import engine as _engine
from .. import ndarray as nd
from .. import telemetry as _telem
from ..base import MXNetError
from ..parallel import collectives as _coll
from ..parallel import dist
from ..resilience import integrity as _integrity
from .kvstore import KVStoreLocal, _key_list, _val_list

__all__ = ["KVStoreDist", "GradientCompression", "DistZeroComm"]


def _tdist():
    import torch.distributed as tdist
    return tdist


class _Pending:
    """An asynchronous exchange: `wait()` returns its result."""

    __slots__ = ("_work", "_out")

    def __init__(self, work, out):
        self._work, self._out = work, out

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out


class DistZeroComm:
    """The cross-worker `optimizer.zero.ZeroComm`: reduce-scatter,
    all-gather and all-reduce over the world group. `reduce_scatter_async`
    starts the exchange and returns a handle, for readiness rounds."""

    @property
    def world(self):
        return dist.num_workers()

    @property
    def rank(self):
        return dist.rank()

    def reduce_scatter_async(self, spec, flat):
        if not dist.has_group():
            return _Pending(None, flat)
        out = torch.empty(spec.shard, dtype=flat.dtype, device=flat.device)
        work = _coll.scatter_into(out, flat.contiguous(), async_op=True)
        return _Pending(work, out)

    def reduce_scatter(self, spec, flat):
        return self.reduce_scatter_async(spec, flat).wait()

    def all_gather(self, spec, shard):
        if not dist.has_group():
            return shard
        return _coll.all_gather(shard)

    def all_reduce(self, spec, value):
        if not dist.has_group():
            return value
        return _coll.all_reduce(value)


class GradientCompression:
    """2-bit threshold compression with error feedback and the
    reference's packed wire format: values >= +threshold are code 1,
    <= -threshold code 2, else 0; four codes a byte, the first in the low
    bits. The quantization error is carried into the next push."""

    CODES_PER_BYTE = 4

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self._residual = {}

    def compress(self, key, arr):
        """Tensor -> uint8 tensor of ceil(n/4) packed bytes."""
        t = self.threshold
        res = self._residual.get(key)
        acc = arr if res is None else arr + res
        pos, neg = acc >= t, acc <= -t
        zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
        q = torch.where(pos, zero + t, torch.where(neg, zero - t, zero))
        self._residual[key] = acc - q
        codes = torch.where(pos, 1, torch.where(neg, 2, 0)).to(
            torch.uint8).reshape(-1)
        pad = (-codes.numel()) % self.CODES_PER_BYTE
        if pad:
            codes = torch.cat([codes, codes.new_zeros(pad)])
        codes = codes.reshape(-1, self.CODES_PER_BYTE)
        return (codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4)
                | (codes[:, 3] << 6))

    def decompress(self, packed, shape, dtype):
        """Packed bytes (with any leading dims) -> values of `shape`."""
        t = self.threshold
        shifts = torch.arange(0, 8, 2, dtype=torch.uint8,
                              device=packed.device)
        codes = (packed.unsqueeze(-1) >> shifts) & 3
        codes = codes.reshape(tuple(packed.shape[:-1]) + (-1,))
        n = torch.Size(shape).numel()
        codes = codes[..., :n]
        one = torch.ones((), dtype=dtype, device=packed.device)
        vals = torch.where(codes == 1, one * t,
                           torch.where(codes == 2, one * -t, one * 0))
        return vals.reshape(tuple(packed.shape[:-1]) + tuple(shape))


class KVStoreDist(KVStoreLocal):
    """Types dist_sync, dist_device_sync, dist_async and dist."""

    def __init__(self, type_name="dist_sync"):
        super().__init__(type_name)
        if "async" in type_name:
            warnings.warn("dist_async has no synchronous-collective "
                          "analog; running synchronously")
        dist.initialize()
        self._gc = None
        self._gc_layout = None

    @property
    def rank(self):
        return dist.rank()

    @property
    def num_workers(self):
        return dist.num_workers()

    def init(self, key, value):
        """Store each key's value, worker 0's on every worker."""
        super().init(key, value)
        if dist.has_group() and dist.num_workers() > 1:
            for k in _key_list(key):
                stored = self._store[str(k)]
                if isinstance(stored, nd.sparse.RowSparseNDArray):
                    continue
                _tdist().broadcast(stored._data, 0)

    def set_gradient_compression(self, compression_params):
        from ..optimizer.zero import ZeroUpdater
        if isinstance(self._updater, ZeroUpdater):
            raise MXNetError(
                "gradient compression cannot be enabled on a store running "
                "the ZeRO sharded update (no compressed reduce-scatter)")
        params = dict(compression_params)
        if params.get("type", "2bit") != "2bit":
            raise ValueError("unsupported compression type %s"
                             % params.get("type"))
        self._gc = GradientCompression(params.get("threshold", 0.5))
        self._gc_layout = None
        self._compression_params = params

    def _zero_comm(self):
        return DistZeroComm()

    # -- exchanges -------------------------------------------------------
    def _allreduce(self, flat):
        """The sum over the workers of a tensor this store owns (in
        place)."""
        _telem.inc("comm.collectives")
        if dist.has_group():
            _tdist().all_reduce(flat)
        return flat

    def _allreduce_compressed(self, raw, key):
        """2-bit exchange: ceil(n/4) bytes a worker on the wire, decoded
        and added in rank order on every worker."""
        packed = self._gc.compress(key, raw)
        _telem.inc("comm.collectives")
        if not dist.has_group():
            return self._gc.decompress(packed, tuple(raw.shape), raw.dtype)
        gathered = _coll.all_gather(packed, tiled=False)
        vals = self._gc.decompress(gathered, tuple(raw.shape), raw.dtype)
        acc = vals[0]
        for r in range(1, vals.shape[0]):
            acc = acc + vals[r]
        return acc

    # -- push ------------------------------------------------------------
    def push(self, key, value, priority=0):
        keys = _key_list(key)
        values = _val_list(value, len(keys))
        assert len(keys) == len(values), "key/value length mismatch"
        self._check_keys(keys)
        if self._maybe_push_zero(keys, values):
            return
        cap = _engine.bucket_bytes()
        if cap and len(keys) > 1:
            entries = self._bucketable_entries(keys, values)
            if entries is not None:
                if self._gc is not None:
                    self._push_bucketed_compressed(entries)
                else:
                    self._push_bucketed(entries, cap)
                return
            sentries = self._sparse_entries(keys, values)
            if sentries is not None:
                self._push_sparse_bucketed(sentries, cap)
                return
        for k, v in zip(keys, values):
            merged = self._merge(v if isinstance(v, (list, tuple)) else [v])
            k = str(k)
            ts = _telem.span_clock()
            t0 = time.perf_counter()
            self._push_one(k, merged)
            _telem.record_span(_engine.comm_span_name(k, "key"),
                               _engine.SPAN_CAT_COMM, ts,
                               time.perf_counter() - t0)

    def _push_one(self, k, merged):
        if isinstance(merged, nd.sparse.RowSparseNDArray):
            self._count_sparse([merged], merged)
            ids, vals = self._sparse_sync(k, merged._indices,
                                          merged._values, merged.shape)
            self._apply_sparse(k, ids, vals, merged.shape)
            return
        raw = merged._data.detach()
        if self._gc is not None:
            summed = self._allreduce_compressed(raw, k)
        else:
            summed = self._allreduce(raw.clone())
        self._apply_merged(k, nd.NDArray(summed, ctx=merged.context))

    def _push_bucketed(self, entries, cap):
        """Each size-capped bucket packed flat and all-reduced in one
        call, then split back and applied key by key."""
        bucketer = _engine.GradBucketer(cap)

        wire_check = _integrity.comm_checksum_enabled()

        def apply_bucket(bucket):
            flat = _engine.pack_bucket(bucket)
            ts = _telem.span_clock()
            t0 = time.perf_counter()
            self._allreduce(flat)
            _telem.record_span(bucket.span_name(), _engine.SPAN_CAT_COMM,
                               ts, time.perf_counter() - t0)
            if wire_check:
                _telem.inc("comm.checksum.buckets")
                _integrity.check_finite([flat], site="kvstore_dist.bucket",
                                        keys=bucket.keys)
            self._apply_parts(bucket.keys,
                              _engine.unpack_bucket(bucket, flat))

        for k, vals in entries:
            for bucket in bucketer.add(k, self._merge(vals)._data.detach()):
                apply_bucket(bucket)
        tail = bucketer.flush()
        if tail is not None:
            apply_bucket(tail)

    def _apply_parts(self, keys, parts, out_map=None):
        for k, part in zip(keys, parts):
            stored = self._store[k]
            self._apply_merged(k, nd.NDArray(part, ctx=stored.context))
            if out_map is not None:
                for t in out_map[k]:
                    stored.copyto(t)

    def _push_bucketed_compressed(self, entries):
        """2-bit compression over the buckets of a layout frozen at the
        first multi-key push: the residuals key on the bucket, one quantize
        and one packed exchange a bucket. Elementwise this is the per-key
        path (packing concatenates; quantization and the residual are
        elementwise). A changed key set re-freezes the layout and drops
        the bucket residuals, with a warning."""
        keys = [k for k, _ in entries]
        if self._gc_layout is not None:
            try:
                self._gc_layout.assert_matches(keys)
            except ValueError:
                warnings.warn(
                    "gradient-compression bucket layout re-frozen: the "
                    "pushed key set changed, so the per-bucket "
                    "error-feedback residuals accumulated so far are "
                    "dropped (one-time quantization-error loss)")
                for rk in [k for k in self._gc._residual
                           if str(k).startswith("__bucket__")]:
                    del self._gc._residual[rk]
                self._gc_layout = None
        merged = {k: self._merge(vals)._data.detach() for k, vals in entries}
        if self._gc_layout is None:
            self._gc_layout = _engine.BucketLayout.from_entries(
                ((k, merged[k]) for k in keys), 1, _engine.bucket_bytes())
        for spec in self._gc_layout:
            flat = _engine.pack_flat(spec, [merged[k] for k in spec.keys])
            ts = _telem.span_clock()
            t0 = time.perf_counter()
            summed = self._allreduce_compressed(flat,
                                                "__bucket__%d" % spec.index)
            _telem.record_span(_engine.comm_span_name(spec.key_range()),
                               _engine.SPAN_CAT_COMM, ts,
                               time.perf_counter() - t0)
            self._apply_parts(spec.keys, _engine.unpack_flat(spec, summed))

    # -- row-sparse ------------------------------------------------------
    def _sparse_sync(self, key, ids, vals, shape):
        """The cross-worker sum of a locally merged row-sparse push as a
        unique-rows exchange; returns (sorted unique ids, rows)."""
        if not dist.has_group():
            return ids, vals
        nnz = int(ids.shape[0])
        row_nb = vals[0:1].numel() * vals.element_size() if nnz else 0
        ts = _telem.span_clock()
        t0 = time.perf_counter()
        slab = int(_coll.all_reduce(
            torch.tensor([nnz], dtype=torch.int64, device=vals.device),
            op="max").item())
        pad = slab - nnz
        ids_p = torch.cat([ids.to(torch.int32),
                           torch.full((pad,), -1, dtype=torch.int32,
                                      device=ids.device)])
        vals_p = torch.cat([vals, vals.new_zeros((pad,) +
                                                 tuple(vals.shape[1:]))])
        gids, gvals = self._cross_worker_unique_rows(ids_p, vals_p)
        _telem.record_span(_engine.comm_span_name(key, "sparse"),
                           _engine.SPAN_CAT_COMM, ts,
                           time.perf_counter() - t0)
        n_union = int((gids >= 0).sum().item())
        if _telem.ENABLED:
            _telem.inc("comm.sparse.sync")
            _telem.inc("comm.sparse.bytes",
                       slab * (4 + row_nb) * dist.num_workers())
            _telem.inc("comm.sparse.bytes_dense_equiv",
                       int(shape[0]) * 4 + n_union * row_nb)
        return gids[:n_union], gvals[:n_union]

    def _cross_worker_unique_rows(self, ids_p, vals_p):
        """`psum_unique_rows` over the world: the gathered slabs with
        duplicate rows summed (kernel #11 on a card)."""
        _telem.inc("comm.collectives")
        return _coll.psum_unique_rows(ids_p, vals_p)

    # -- readiness-ordered rounds -----------------------------------------
    def _ready_layout(self, canonical, cap):
        """The registration path's buckets over the canonical key order,
        frozen (None, one key at a time, without a cap or an order). A
        worker's flat vector fixes which peer adds which element when:
        the same layout gives the registration path's bits."""
        if not cap or canonical is None:
            return None
        return _engine.BucketLayout.from_entries(
            ((k, self._store[k]._data) for k in canonical), 1, cap)

    def _ready_ingest(self, sess, key, vals):
        merged = self._merge(vals)._data.detach()
        sess.raw_slots[key] = merged
        return merged

    def _ready_launch(self, sess, bucket):
        """Pack one bucket and start its all-reduce without waiting (NCCL
        runs it on its own stream); returns the pending exchange."""
        flat = _engine.pack_bucket(bucket)
        _telem.inc("comm.collectives")
        if not dist.has_group():
            return _Pending(None, flat)
        return _Pending(_tdist().all_reduce(flat, async_op=True), flat)

    def _ready_apply(self, sess, bucket, pending):
        """Wait for one bucket's exchange (its span times the wait: the
        exchange left exposed) and apply it."""
        ts = _telem.span_clock()
        t0 = time.perf_counter()
        flat = pending.wait()
        _telem.record_span(bucket.span_name(), _engine.SPAN_CAT_COMM, ts,
                           time.perf_counter() - t0)
        self._apply_parts(bucket.keys, _engine.unpack_bucket(bucket, flat),
                          sess.out_map)

    def barrier(self):
        """Wait for every worker."""
        _coll.barrier()
