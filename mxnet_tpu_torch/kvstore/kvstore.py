"""KVStore: the key-value gradient/parameter aggregation API (the port of
the single-process part of `mxnet_tpu.kvstore.kvstore`).

`local` and `device` (``nccl`` is an alias of ``device``, as in the
reference) sum the values pushed for a key across its replicas; without an
updater the sum replaces the stored value, with one (`set_optimizer`) the
store holds the weights and the updater applies the summed gradient. With
``zero=True`` the updater is the ZeRO-1 `optimizer.zero.ZeroUpdater`, which
takes every key of a multi-key push in one call (world 1 on one process).
`pull` copies the stored value into the given arrays.

Row-sparse values: the replicas of a row-sparse push stay row-sparse when
summed (`ndarray.sparse.elemwise_add`), so an updater takes its lazy path
and touches only the pushed rows. A multi-key row-sparse push goes through
`engine.SparseGradBucketer`, its buckets sized by the touched rows.
`init_embedding` registers an `embedding.ShardedEmbedding` under a key: a
row-sparse push to it is the table's `apply_grads`, and `row_sparse_pull`
answers from the table's `EmbeddingLookupService`. `row_sparse_pull` of a
dense or row-sparse stored value gathers the requested rows. The counters
``comm.sparse.push``, ``comm.sparse.rows`` and ``comm.sparse.unique_rows``
are the reference's.

The reference's fused per-bucket merge programs are a JAX launch-count
device; here the per-key sum is the same arithmetic (replicas added in
order). `ready_session` opens a readiness-ordered push round
(`ReadyPushSession`): the Trainer feeds each gradient from the grad-ready
hook as backward finishes it, exchanges start at once, and every write
waits for `finish()` at step time. The ``dist*`` types are
`kvstore_dist.KVStoreDist`.

With ``MXNET_TPU_INTEGRITY=1`` the summed dense values of a push (of a
readiness bucket) are checked finite before any write (site
``kvstore.bucket``), so a poisoned push raises `DivergenceError` and
leaves the store as it was; off, nothing is read back.
"""
from __future__ import annotations

import torch

from .. import engine as _engine
from .. import ndarray as nd
from .. import optimizer as opt
from .. import telemetry as _telem
from ..base import MXNetError

__all__ = ["KVStore", "KVStoreLocal", "ReadyPushSession", "create"]


def _guard_merged(keys, merged):
    """The integrity sentinel over a push's summed dense values (site
    ``kvstore.bucket``): one finite reduction and one host read before
    any store or updater write; nothing when off."""
    from ..resilience import integrity as _integrity
    if not _integrity.enabled():
        return
    dense = [m._data for m in merged
             if not isinstance(m, nd.sparse.BaseSparseNDArray)]
    if dense:
        _integrity.check_finite(dense, site="kvstore.bucket",
                                keys=[str(k) for k in keys])


def _key_list(key):
    return key if isinstance(key, (list, tuple)) else [key]


def _val_list(value, nkeys):
    if isinstance(value, (list, tuple)):
        if len(value) and isinstance(value[0], (list, tuple)):
            return list(value)
        if nkeys == 1:
            return [list(value)] if isinstance(value[0], nd.NDArray) and \
                len(value) > 1 else [value[0] if len(value) == 1 else
                                     list(value)]
        return list(value)
    return [value]


class KVStore:
    """Base store."""

    def __init__(self):
        self._updater = None
        self._compression_params = None

    @property
    def type(self):
        raise NotImplementedError

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError

    def set_gradient_compression(self, compression_params):
        """Recorded only: a local store compresses nothing (reference:
        local stores note it). Refused beside the ZeRO updater, which has
        no compressed reduce-scatter."""
        from ..optimizer.zero import ZeroUpdater
        if isinstance(self._updater, ZeroUpdater):
            raise MXNetError(
                "gradient compression cannot be enabled on a store running "
                "the ZeRO sharded update (no compressed reduce-scatter)")
        self._compression_params = dict(compression_params)

    def set_optimizer(self, optimizer, zero=None):
        """Run the optimizer on the store. zero=True (or
        ``MXNET_TPU_ZERO=1``) makes the updater the ZeRO-1 `ZeroUpdater`
        with this store's exchange (`_zero_comm`: world 1 here)."""
        from ..optimizer.zero import ZeroUpdater, zero_enabled
        if zero_enabled(zero):
            self._set_updater(ZeroUpdater(opt.create(optimizer),
                                          comm=self._zero_comm()))
        else:
            self._set_updater(opt.get_updater(optimizer))

    def _zero_comm(self):
        from ..optimizer.zero import ZeroComm
        return ZeroComm()

    def _set_updater(self, updater):
        self._updater = updater

    def barrier(self):
        """Nothing to wait for on one process."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, \
            "Cannot save states for distributed training"
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, \
            "Cannot load states for distributed training"
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


class KVStoreLocal(KVStore):
    """Single-process aggregation store (types local and device)."""

    def __init__(self, type_name="local"):
        super().__init__()
        self._type = type_name
        self._store = {}          # key -> stored NDArray
        self._embeddings = {}     # key -> ShardedEmbedding
        self._embed_services = {}  # key -> EmbeddingLookupService

    @property
    def type(self):
        return self._type

    def init(self, key, value):
        keys = _key_list(key)
        values = _val_list(value, len(keys))
        assert len(keys) == len(values), "key/value length mismatch"
        for k, v in zip(keys, values):
            if isinstance(v, (list, tuple)):
                v = v[0]
            if str(k) in self._store:
                raise ValueError("duplicate init of key " + str(k))
            self._store[str(k)] = v.copy()

    def init_embedding(self, key, table, max_batch=1024, warmup=True):
        """Register a vocab-sharded `embedding.ShardedEmbedding` under
        `key`: row-sparse pushes to it go to the table's update of its
        owned rows, and `row_sparse_pull` to an `EmbeddingLookupService`
        over the table, warmed here so that steady pulls count no retrace.
        Returns the service."""
        from ..embedding.serving import EmbeddingLookupService
        k = str(key)
        if k in self._store or k in self._embeddings:
            raise ValueError("duplicate init of key " + k)
        self._embeddings[k] = table
        svc = EmbeddingLookupService(table, max_batch=max_batch)
        if warmup:
            svc.warmup()
        self._embed_services[k] = svc
        return svc

    def ready_session(self, canonical_keys=None):
        """Open a readiness-ordered push round; `canonical_keys` is the
        registration-order key sequence (it freezes layouts as the
        registration path would)."""
        return ReadyPushSession(self, canonical_keys=canonical_keys)

    def _ready_layout(self, canonical, cap):
        """The frozen bucket layout of a readiness round, or None for
        free-mode assembly. Local merges are elementwise, so any bucketing
        gives the same bits: free mode."""
        return None

    def _ready_ingest(self, sess, key, vals):
        """Keep one key's replicas for the round; returns the tensor the
        bucket assembly sizes it by."""
        sess.raw_slots[key] = vals
        return vals[0]._data

    def _ready_launch(self, sess, bucket):
        """One bucket's merge: each key's replicas summed in order, as
        `_merge` does."""
        _telem.inc("comm.collectives")
        merged = [self._merge(sess.raw_slots[k]) for k in bucket.keys]
        _guard_merged(bucket.keys, merged)
        return merged

    def _ready_apply(self, sess, bucket, merged):
        """The deferred writes of one launched bucket: the updater (or a
        store write), then the out broadcast."""
        for k, m in zip(bucket.keys, merged):
            self._apply_merged(k, m)
            if sess.out_map is not None:
                src = self._store[k]
                for t in sess.out_map[k]:
                    src.copyto(t)

    def _apply_merged(self, k, merged):
        stored = self._store[k]
        if self._updater is not None:
            self._updater(int(k) if k.isdigit() else k, merged, stored)
        else:
            _write(stored, merged)

    def _check_keys(self, keys):
        for k in keys:
            if str(k) not in self._store and str(k) not in self._embeddings:
                raise MXNetError("key %s has not been initialized" % str(k))

    def _merge(self, vals):
        """The sum of a key's replicas, in order, on the first replica's
        context; row-sparse replicas give a row-sparse sum."""
        if isinstance(vals, nd.NDArray):
            return vals
        if len(vals) == 1:
            return vals[0]
        if all(isinstance(v, nd.sparse.RowSparseNDArray) for v in vals):
            acc = vals[0]
            for v in vals[1:]:
                acc = nd.sparse.elemwise_add(acc, v)
            return acc
        ctx = vals[0].context
        with torch.no_grad():
            acc = vals[0]._data.detach().clone()
            for v in vals[1:]:
                acc = acc + v._data.detach().to(acc.device)
        return nd.NDArray(acc, ctx=ctx)

    def _bucketable_entries(self, keys, values):
        """[(str key, [dense replica NDArrays])] when every key is dense
        with one replica count; else None."""
        entries, nrep = [], None
        for k, v in zip(keys, values):
            vals = list(v) if isinstance(v, (list, tuple)) else [v]
            if not vals or any(not isinstance(x, nd.NDArray)
                               or isinstance(x, nd.sparse.BaseSparseNDArray)
                               for x in vals):
                return None
            if nrep is None:
                nrep = len(vals)
            elif len(vals) != nrep:
                return None
            entries.append((str(k), vals))
        return entries

    def _maybe_push_zero(self, keys, values):
        """Send a push through the ZeRO updater when the store has one: the
        replicas of each key summed, then one `ZeroUpdater.step` over every
        key. Returns True when handled."""
        from ..optimizer.zero import ZeroUpdater
        if not isinstance(self._updater, ZeroUpdater):
            return False
        entries = self._bucketable_entries(keys, values)
        if entries is None:
            raise MXNetError(
                "ZeRO sharded update requires dense gradients with a "
                "uniform replica count (keys %s)" % (keys,))
        zkeys, grads, weights = [], [], []
        for k, vals in entries:
            zkeys.append(k)
            grads.append(self._merge(vals)._data.detach())
            weights.append(self._store[k])
        self._updater.step(zkeys, grads, weights)
        return True

    def push(self, key, value, priority=0):
        """Sum the pushed replicas per key. Without an updater the sum
        replaces the stored value; with one, the updater applies it to the
        stored weight (one call over every key for ZeRO)."""
        keys = _key_list(key)
        values = _val_list(value, len(keys))
        assert len(keys) == len(values), "key/value length mismatch"
        self._check_keys(keys)
        if self._embeddings:
            keys, values = self._push_embeddings(keys, values)
            if not keys:
                return
        if self._maybe_push_zero(keys, values):
            return
        cap = _engine.bucket_bytes()
        if cap and len(keys) > 1:
            sentries = self._sparse_entries(keys, values)
            if sentries is not None:
                self._push_sparse_bucketed(sentries, cap)
                return
        merged = [self._merge(v if isinstance(v, (list, tuple)) else [v])
                  for v in values]
        _guard_merged(keys, merged)
        for k, m in zip(keys, merged):
            self._apply_merged(str(k), m)

    # -- row-sparse pushes -------------------------------------------------
    def _sparse_entries(self, keys, values):
        """[(str key, [RowSparseNDArray replicas])] when every key is
        row-sparse and none is a registered embedding; else None."""
        entries = []
        for k, v in zip(keys, values):
            if str(k) in self._embeddings:
                return None
            vals = list(v) if isinstance(v, (list, tuple)) else [v]
            if not vals or any(not isinstance(x, nd.sparse.RowSparseNDArray)
                               for x in vals):
                return None
            entries.append((str(k), vals))
        return entries

    def _sparse_sync(self, key, ids, vals, shape):
        """The cross-worker completion of a locally merged sparse push:
        the identity on a local store, where one worker holds every
        replica. Returns the (ids, vals) of the globally merged rows."""
        return ids, vals

    def _apply_sparse(self, k, ids, vals, shape):
        """The updater (or store write) for one merged sparse key."""
        self._apply_merged(k, nd.sparse.RowSparseNDArray(
            vals, ids, shape, ctx=self._store[k].context))

    def _count_sparse(self, vals, merged):
        _telem.inc("comm.sparse.push")
        _telem.inc("comm.sparse.rows",
                   sum(int(v._indices.shape[0]) for v in vals))
        _telem.inc("comm.sparse.unique_rows", int(merged._indices.shape[0]))

    def _push_sparse_bucketed(self, entries, cap):
        """Each key's replicas merged (deduped), then size-capped
        `SparseGradBucketer` buckets applied as they close. A bucket's
        bytes count the touched rows, not the table's."""
        shapes = {}

        def apply_bucket(bucket):
            for k, ids, vals in zip(bucket.keys, bucket.ids, bucket.vals):
                gids, gvals = self._sparse_sync(k, ids, vals, shapes[k])
                self._apply_sparse(k, gids, gvals, shapes[k])

        bucketer = _engine.SparseGradBucketer(cap)
        for k, vals in entries:
            merged = self._merge(vals)
            shapes[k] = merged.shape
            self._count_sparse(vals, merged)
            for bucket in bucketer.add(k, merged._indices, merged._values):
                apply_bucket(bucket)
        tail = bucketer.flush()
        if tail is not None:
            apply_bucket(tail)

    def _push_embeddings(self, keys, values):
        """Apply the pushes to registered sharded tables (row-sparse
        gradients -> `ShardedEmbedding.apply_grads`, then a fresh serving
        snapshot) and return the other (keys, values)."""
        rest_k, rest_v = [], []
        for k, v in zip(keys, values):
            table = self._embeddings.get(str(k))
            if table is None:
                rest_k.append(k)
                rest_v.append(v)
                continue
            vals = list(v) if isinstance(v, (list, tuple)) else [v]
            if any(not isinstance(x, nd.sparse.RowSparseNDArray)
                   for x in vals):
                raise MXNetError(
                    "push to sharded embedding key %s requires row_sparse "
                    "gradients" % k)
            merged = self._merge(vals)
            self._count_sparse(vals, merged)
            table.apply_grads(merged._indices, merged._values)
            svc = self._embed_services.get(str(k))
            if svc is not None:
                svc.refresh()   # serving reads the post-step snapshot
        return rest_k, rest_v

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into its arrays."""
        assert out is not None, "pull requires out="
        keys = _key_list(key)
        outs = _val_list(out, len(keys))
        self._check_keys(keys)
        for k, o in zip(keys, outs):
            src = self._store[str(k)]
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                src.copyto(t)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows `row_ids` (sorted and deduped here) into
        row-sparse `out` arrays: from a registered table's lookup service,
        or gathered from a dense or row-sparse stored value."""
        assert out is not None and row_ids is not None
        keys = _key_list(key)
        outs = _val_list(out, len(keys))
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        if len(rids) == 1 and len(keys) > 1:
            rids = rids * len(keys)
        self._check_keys(keys)
        for k, o, r in zip(keys, outs, rids):
            svc = self._embed_services.get(str(k))
            src = None if svc is not None else self._store[str(k)]
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                if not isinstance(t, nd.sparse.RowSparseNDArray):
                    raise ValueError(
                        "row_sparse_pull requires row_sparse outs "
                        "(reference kvstore restriction); got stype %s"
                        % t.stype)
                dev = svc._weight.device if svc is not None \
                    else src.context.torch_device
                # sorted unique ids: the RowSparseNDArray invariant
                rows = torch.unique(nd.sparse._tensor(r, torch.int32, dev))
                if svc is not None:
                    vals = svc.lookup(rows)
                elif isinstance(src, nd.sparse.RowSparseNDArray):
                    vals = nd.sparse.retain(src, rows)._values
                else:
                    vals = src._data[rows.long()]
                t._set_rows(vals.to(t._values.dtype), rows)


def _write(stored, value):
    """Replace a stored value with `value` (dense or row-sparse), cast to
    the stored dtype."""
    dense = value.as_in_context(stored.context)._data
    with torch.no_grad():
        if isinstance(stored, nd.sparse.RowSparseNDArray):
            stored._write(dense.to(stored._values.dtype))
        else:
            stored._data.copy_(dense)


class ReadyPushSession:
    """One readiness-ordered round of gradient exchange.

    The Trainer opens it before backward, feeds `push(key, vals)` from the
    grad-ready hook as each parameter's gradient is final, and calls
    `finish()` at step time. Bucket assembly is an `engine.ReadyScheduler`;
    each completed bucket launches its exchange at once, and every write
    (updater, store, out broadcast) waits for `finish()`, so a round that
    is abandoned has changed nothing and the registration path stays a
    safe fallback.

    * a local store: free-mode buckets, applied at finish in launch order;
    * a dist store: the buckets the registration path would make from the
      canonical order, frozen, so that every flat vector (and so every
      element's order of summation across workers) is the registration
      path's, whatever order backward finishes the keys in;
    * a `ZeroUpdater` with a frozen layout: frozen-mode buckets, each
      reduce-scatter launched from backward (`ZeroUpdater.scatter_ready`),
      the updates and all-gathers at finish (`finish_ready`);
    * a `ZeroUpdater` before its first step: the gradients are kept and
      pushed at finish in the canonical order, so the layout freezes as
      the registration path would freeze it on every rank.

    Ranks running the same program see the same readiness order (torch
    finishes leaves in a deterministic order for one graph), so the launch
    order agrees across ranks; `finish()` checks the pushed keys against
    `canonical_keys`.
    """

    def __init__(self, store, canonical_keys=None):
        from ..optimizer.zero import ZeroUpdater
        self.store = store
        self.cap = _engine.bucket_bytes()
        self.canonical = (None if canonical_keys is None
                          else [str(k) for k in canonical_keys])
        self.raw_slots = {}
        self.nrep = None
        self.out_map = None
        self.launched = []     # [(bucket, handle)] in launch order
        self.arrivals = []     # ZeRO: [(spec, shard handle)]
        self.pushed = []       # keys in arrival order
        self.finished = False
        self._zero = isinstance(store._updater, ZeroUpdater)
        self._buffer = None
        if self._zero:
            layout = store._updater.layout
            if layout is None:
                self._sched = None
                self._buffer = {}
            else:
                self._sched = _engine.ReadyScheduler(self._dispatch_zero,
                                                     layout=layout)
        else:
            self._sched = _engine.ReadyScheduler(
                self._dispatch, cap_bytes=self.cap,
                layout=store._ready_layout(self.canonical, self.cap))

    def _dispatch(self, bucket, spec=None):
        self.launched.append((bucket, self.store._ready_launch(self,
                                                               bucket)))

    def _dispatch_zero(self, bucket, spec):
        flat_g = _engine.pack_flat(spec, bucket.raws)
        handle = self.store._updater.scatter_ready(spec, flat_g,
                                                   self.store._store)
        self.arrivals.append((spec, handle))

    def push(self, key, vals):
        """Feed one parameter's gradients (one per replica) during
        backward; launches whatever buckets that completes."""
        k = str(key)
        vals = list(vals) if isinstance(vals, (list, tuple)) else [vals]
        if not vals or any(not isinstance(v, nd.NDArray)
                           or isinstance(v, nd.sparse.BaseSparseNDArray)
                           for v in vals):
            raise MXNetError("readiness push requires dense NDArray "
                             "gradients (key %s)" % (key,))
        if self.nrep is None:
            self.nrep = len(vals)
        elif len(vals) != self.nrep:
            raise MXNetError("readiness push saw %d replicas for key %s, "
                             "expected %d" % (len(vals), key, self.nrep))
        self.pushed.append(k)
        if self._buffer is not None:
            self._buffer[k] = vals
            return
        if self._zero:
            raw = self.store._merge(vals)._data.detach()
            self.raw_slots[k] = raw
        else:
            raw = self.store._ready_ingest(self, k, vals)
        self._sched.add(k, raw)

    def finish(self, outs=None):
        """Complete the round at step time: drain the tails, then apply
        the launched buckets in launch order (or run ZeRO's updates and
        all-gathers). `outs` is [(key, [targets])] for the fused pull of
        a store without an updater."""
        if self.finished:
            raise MXNetError("ReadyPushSession.finish() called twice")
        self.finished = True
        store = self.store
        if self._buffer is not None:
            order = self.canonical if self.canonical is not None \
                else list(self._buffer)
            keys = [k for k in order if k in self._buffer]
            if len(keys) != len(self._buffer):
                raise MXNetError(
                    "readiness round pushed keys outside the canonical "
                    "order (%s vs %s)" % (sorted(self._buffer),
                                          sorted(order)))
            store._maybe_push_zero(keys, [self._buffer[k] for k in keys])
            return
        self._sched.drain()
        if self._zero:
            store._updater.finish_ready(self.arrivals, store._store)
            return
        if outs is not None:
            self.out_map = {str(k): targets for k, targets in outs}
        for bucket, handle in self.launched:
            store._ready_apply(self, bucket, handle)


def create(name="local"):
    """A store by type name: local, device (and its aliases nccl,
    local_allreduce_cpu, local_allreduce_device), or dist_sync,
    dist_device_sync, dist_async and dist (`kvstore_dist.KVStoreDist`)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "local_allreduce_cpu", "local_allreduce_device",
                "device", "nccl"):
        return KVStoreLocal("device" if name in ("device", "nccl") else
                            "local")
    if name.startswith("dist"):
        from .kvstore_dist import KVStoreDist
        return KVStoreDist(name)
    raise ValueError("unknown KVStore type %s" % name)
