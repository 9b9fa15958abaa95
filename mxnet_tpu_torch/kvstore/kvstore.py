"""KVStore: the key-value gradient/parameter aggregation API (the port of
the single-process part of `mxnet_tpu.kvstore.kvstore`).

`local` and `device` (``nccl`` is an alias of ``device``, as in the
reference) sum the values pushed for a key across its replicas; without an
updater the sum replaces the stored value, with one (`set_optimizer`) the
store holds the weights and the updater applies the summed gradient. With
``zero=True`` the updater is the ZeRO-1 `optimizer.zero.ZeroUpdater`, which
takes every key of a multi-key push in one call (world 1 on one process).
`pull` copies the stored value into the given arrays.

The reference's fused per-bucket merge programs are a JAX launch-count
device; here the per-key sum is the same arithmetic (replicas added in
order). Row-sparse values and `row_sparse_pull`, sharded embeddings,
readiness-ordered push sessions and the ``dist*`` stores raise
NotImplementedError naming the slice that brings them.
"""
from __future__ import annotations

import torch

from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError

__all__ = ["KVStore", "KVStoreLocal", "create"]

_COMM = "the port's multi-rank communication slice"
_SPARSE = "the port's sparse slice"


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
        raise NotImplementedError("row_sparse_pull comes with %s" % _SPARSE)

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
        raise NotImplementedError("sharded embeddings come with %s"
                                  % _SPARSE)

    def ready_session(self, canonical_keys=None):
        raise NotImplementedError("readiness-ordered push sessions come "
                                  "with %s" % _COMM)

    def _check_keys(self, keys):
        for k in keys:
            if str(k) not in self._store:
                raise MXNetError("key %s has not been initialized" % str(k))

    def _merge(self, vals):
        """The sum of a key's replicas, in order, on the first replica's
        context."""
        if isinstance(vals, nd.NDArray):
            return vals
        if len(vals) == 1:
            return vals[0]
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
            if not vals or any(not isinstance(x, nd.NDArray) for x in vals):
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
        if self._maybe_push_zero(keys, values):
            return
        for k, v in zip(keys, values):
            merged = self._merge(v if isinstance(v, (list, tuple)) else [v])
            k = str(k)
            stored = self._store[k]
            if self._updater is not None:
                self._updater(int(k) if k.isdigit() else k, merged, stored)
            else:
                merged.copyto(stored)

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


def create(name="local"):
    """A store by type name: local, device (and its aliases nccl,
    local_allreduce_cpu, local_allreduce_device); dist* raises."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "local_allreduce_cpu", "local_allreduce_device",
                "device", "nccl"):
        return KVStoreLocal("device" if name in ("device", "nccl") else
                            "local")
    if name.startswith("dist"):
        raise NotImplementedError("kvstore %r comes with %s" % (name, _COMM))
    raise ValueError("unknown KVStore type %s" % name)
