"""Gradient buckets and the persistent bucket layout (the port of the part
of `mxnet_tpu.engine` that the ZeRO updater needs).

`GradBucketer` packs gradients, fed in the order their exchange should
start (the Trainer feeds reverse registration order, about the order
backward finishes them), into single-dtype flat buckets of at most
`bucket_bytes()` (``MXNET_TPU_COMM_BUCKET_MB``, default 25 MB); a gradient
at or above the cap travels alone. `BucketLayout`/`BucketSpec` freeze one
bucketing run into a checkpointable bucket -> key layout: the unit of
ZeRO-1 weight-update sharding, each bucket padded to a multiple of the
world size so that every rank owns one contiguous shard of it.
`pack_flat`/`unpack_flat` are the concat+pad / split inverses, on the
tensors' own device. `SparseGradBucketer` packs row-sparse pushes ((key,
ids, rows) triples) into `SparseBucket`s sized by the bytes of the touched
rows, not of the table, so a huge table whose push touches a few thousand
rows packs beside its neighbours.

Dtypes are named by string ("float32", "bfloat16", ...), as the `.params`
format and `BucketLayout.to_payload` name them. `pack_bucket` /
`unpack_bucket` are the flatten and split around a bucket's exchange.
`ready.ReadyScheduler` packs buckets in the order backward finishes the
gradients, and `autotune` picks the (bucket cap, flush policy) schedule.
Every comm launch records one span of category ``comm`` named by
`comm_span_name`.
"""
from __future__ import annotations

import contextlib

import torch

from .. import telemetry as _telem
from ..base import dtype_name, get_env, register_env, torch_dtype

__all__ = ["DEFAULT_BUCKET_MB", "bucket_bytes", "set_bucket_mb",
           "bucket_mb_scope", "Bucket", "GradBucketer", "bucketize",
           "BucketSpec", "BucketLayout", "pack_flat", "unpack_flat",
           "pack_bucket", "unpack_bucket", "SPAN_CAT_COMM", "comm_span_name",
           "SparseBucket", "SparseGradBucketer"]

# the category of every comm launch's span
SPAN_CAT_COMM = "comm"


def comm_span_name(key_range, kind="bucket"):
    """``comm.<kind>[<key range>]``: kind "bucket" for a bucket's launch,
    "key" for one key, "rs"/"ag" for ZeRO's two legs, "sparse" for a
    row-sparse exchange."""
    return "comm.%s[%s]" % (kind, key_range)

DEFAULT_BUCKET_MB = 25.0

register_env("MXNET_TPU_COMM_BUCKET_MB", DEFAULT_BUCKET_MB, float,
             "Cap of a gradient bucket in megabytes (0: no buckets, one key "
             "at a time).")


# process-wide override (set_bucket_mb, bucket_mb_scope, a pinned comm
# schedule); None leaves the cap to the environment
_BUCKET_MB_OVERRIDE = None


def set_bucket_mb(mb):
    """Override the bucket cap (megabytes; 0 turns bucketing off, None
    hands it back to ``MXNET_TPU_COMM_BUCKET_MB``). Returns the previous
    override."""
    global _BUCKET_MB_OVERRIDE
    prev = _BUCKET_MB_OVERRIDE
    _BUCKET_MB_OVERRIDE = None if mb is None else float(mb)
    return prev


@contextlib.contextmanager
def bucket_mb_scope(mb):
    """A scope with another bucket cap."""
    prev = set_bucket_mb(mb)
    try:
        yield
    finally:
        set_bucket_mb(prev)


def bucket_bytes(bucket_mb=None):
    """The bucket cap in bytes (0: bucketing off): `bucket_mb` when given,
    else the `set_bucket_mb` override, else ``MXNET_TPU_COMM_BUCKET_MB``
    (default 25)."""
    mb = bucket_mb
    if mb is None:
        mb = _BUCKET_MB_OVERRIDE
    if mb is None:
        try:
            mb = get_env("MXNET_TPU_COMM_BUCKET_MB")
        except (TypeError, ValueError):
            mb = DEFAULT_BUCKET_MB
    mb = float(mb)
    if mb <= 0:
        return 0
    return int(mb * 1024 * 1024)


def _nbytes(t):
    return t.numel() * t.element_size()


class Bucket:
    """One flat comm unit: ordered (key, tensor) pairs of a single dtype."""

    __slots__ = ("keys", "raws", "shapes", "dtype", "nbytes", "reason")

    def __init__(self, items, reason):
        self.keys = [k for k, _ in items]
        self.raws = [r for _, r in items]
        self.shapes = [tuple(r.shape) for r in self.raws]
        self.dtype = dtype_name(self.raws[0].dtype)
        self.nbytes = sum(_nbytes(r) for r in self.raws)
        self.reason = reason

    def __len__(self):
        return len(self.keys)

    def key_range(self):
        if len(self.keys) == 1:
            return str(self.keys[0])
        return "%s..%s" % (self.keys[0], self.keys[-1])

    def span_name(self):
        return comm_span_name(self.key_range())

    def __repr__(self):
        return ("Bucket(%d arrays, %d bytes, %s, reason=%s)"
                % (len(self), self.nbytes, self.dtype, self.reason))


def _count_bucket(bucket):
    _telem.inc("comm.bucket.count")
    _telem.inc("comm.bucket.bytes", bucket.nbytes)
    _telem.inc("comm.bucket.flush_reason.%s" % bucket.reason)
    return bucket


def pack_bucket(bucket):
    """A new flat vector of the bucket's tensors, in order (the buffer an
    exchange may reduce in place)."""
    if len(bucket.raws) == 1:
        return bucket.raws[0].reshape(-1).clone()
    return torch.cat([r.reshape(-1) for r in bucket.raws])


def unpack_bucket(bucket, flat):
    """Views of a flat vector in the bucket's shapes."""
    out, off = [], 0
    for s in bucket.shapes:
        n = torch.Size(s).numel()
        out.append(flat[off:off + n].view(s))
        off += n
    return out


class GradBucketer:
    """Greedy size-capped packer. `add` returns the buckets that just
    closed. Flush reasons: ``full`` (the next gradient would cross the
    cap), ``dtype_split`` (buckets hold one dtype), ``oversize`` (a
    gradient at or above the cap, alone), ``final`` (the last bucket)."""

    def __init__(self, cap_bytes=None):
        self.cap = bucket_bytes() if cap_bytes is None else int(cap_bytes)
        self._open = []
        self._open_bytes = 0
        self._dtype = None

    def add(self, key, raw):
        """Queue one gradient; empty or None gradients are skipped."""
        ready = []
        if raw is None or raw.numel() == 0:
            return ready
        dt = raw.dtype
        nbytes = _nbytes(raw)
        if self._open and dt != self._dtype:
            ready.append(self._flush("dtype_split"))
        if self.cap and nbytes >= self.cap:
            if self._open:
                ready.append(self._flush("full"))
            ready.append(Bucket([(key, raw)], "oversize"))
            return ready
        if self._open and self.cap and self._open_bytes + nbytes > self.cap:
            ready.append(self._flush("full"))
        self._open.append((key, raw))
        self._open_bytes += nbytes
        self._dtype = dt
        return ready

    def flush(self, reason="final"):
        """Close the open bucket; returns it (or None if empty)."""
        if not self._open:
            return None
        return self._flush(reason)

    def _flush(self, reason):
        b = Bucket(self._open, reason)
        self._open = []
        self._open_bytes = 0
        self._dtype = None
        return b


def bucketize(entries, cap_bytes=None):
    """Pack an iterable of (key, tensor) into a list of Buckets."""
    bucketer = GradBucketer(cap_bytes)
    out = []
    for key, raw in entries:
        out.extend(bucketer.add(key, raw))
    tail = bucketer.flush()
    if tail is not None:
        out.append(tail)
    return out


# ---------------------------------------------------------------------------
# sparse (row_sparse) buckets: the comm unit is a set of keys' (row ids,
# rows) pairs, sized by the touched bytes
# ---------------------------------------------------------------------------
class SparseBucket:
    """One sparse comm unit: ordered (key, ids, vals) triples of a single
    row dtype. `nbytes` counts the ids and the touched rows, not the dense
    table."""

    __slots__ = ("keys", "ids", "vals", "dtype", "nbytes", "reason")

    def __init__(self, items, reason):
        self.keys = [k for k, _, _ in items]
        self.ids = [i for _, i, _ in items]
        self.vals = [v for _, _, v in items]
        self.dtype = dtype_name(self.vals[0].dtype)
        self.nbytes = sum(_nbytes(i) + _nbytes(v)
                          for i, v in zip(self.ids, self.vals))
        self.reason = reason

    def __len__(self):
        return len(self.keys)

    def key_range(self):
        if len(self.keys) == 1:
            return str(self.keys[0])
        return "%s..%s" % (self.keys[0], self.keys[-1])

    def __repr__(self):
        return ("SparseBucket(keys=[%s], %d keys, %d bytes, %s, reason=%s)"
                % (self.key_range(), len(self), self.nbytes, self.dtype,
                   self.reason))


class SparseGradBucketer:
    """`GradBucketer` over (key, ids, vals) sparse pushes, counting the
    touched rows' bytes. Flush reasons are the dense packer's and count
    under ``comm.sparse.bucket.flush_reason.*``."""

    def __init__(self, cap_bytes=None):
        self.cap = bucket_bytes() if cap_bytes is None else int(cap_bytes)
        self._open = []
        self._open_bytes = 0
        self._dtype = None

    def add(self, key, ids, vals):
        """Queue one key's rows; returns the buckets that just closed.
        A push with no rows is skipped (``comm.sparse.bucket.skipped``)."""
        ready = []
        if vals is None or vals.numel() == 0:
            _telem.inc("comm.sparse.bucket.skipped")
            return ready
        dt = vals.dtype
        nbytes = _nbytes(ids) + _nbytes(vals)
        if self._open and dt != self._dtype:
            ready.append(self._flush("dtype_split"))
        if self.cap and nbytes >= self.cap:
            if self._open:
                ready.append(self._flush("full"))
            ready.append(_count_sparse_bucket(
                SparseBucket([(key, ids, vals)], "oversize")))
            return ready
        if self._open and self.cap and self._open_bytes + nbytes > self.cap:
            ready.append(self._flush("full"))
        self._open.append((key, ids, vals))
        self._open_bytes += nbytes
        self._dtype = dt
        return ready

    def flush(self, reason="final"):
        if not self._open:
            return None
        return self._flush(reason)

    def _flush(self, reason):
        b = SparseBucket(self._open, reason)
        self._open = []
        self._open_bytes = 0
        self._dtype = None
        return _count_sparse_bucket(b)


def _count_sparse_bucket(bucket):
    _telem.inc("comm.sparse.bucket.count")
    _telem.inc("comm.sparse.bucket.bytes", bucket.nbytes)
    _telem.inc("comm.sparse.bucket.flush_reason.%s" % bucket.reason)
    return bucket


class BucketSpec:
    """One bucket of a frozen `BucketLayout`, without payloads: its keys,
    shapes and dtype. `padded` is the element count rounded up to a
    multiple of the world size, so the bucket splits into `world` equal
    contiguous shards of `shard` elements."""

    __slots__ = ("index", "keys", "shapes", "dtype", "sizes", "size",
                 "padded", "shard")

    def __init__(self, index, keys, shapes, dtype, world):
        self.index = int(index)
        self.keys = [str(k) for k in keys]
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.dtype = dtype_name(dtype)
        self.sizes = [int(torch.Size(s).numel()) for s in self.shapes]
        self.size = int(sum(self.sizes))
        world = max(1, int(world))
        self.padded = (self.size + world - 1) // world * world
        self.shard = self.padded // world

    def __len__(self):
        return len(self.keys)

    def key_range(self):
        if len(self.keys) == 1:
            return str(self.keys[0])
        return "%s..%s" % (self.keys[0], self.keys[-1])

    @property
    def torch_dtype(self):
        return torch_dtype(self.dtype)

    def nbytes(self):
        return self.size * torch.tensor([], dtype=self.torch_dtype) \
            .element_size()

    def segments(self):
        """[(key, offset, size, shape)] over the unpadded flat vector."""
        out, off = [], 0
        for k, n, s in zip(self.keys, self.sizes, self.shapes):
            out.append((k, off, n, s))
            off += n
        return out

    def shard_segments(self, rank):
        """The pieces of `rank`'s shard as (key, start_in_shard, length,
        start_in_key); padding belongs to no key."""
        lo, hi = rank * self.shard, (rank + 1) * self.shard
        out = []
        for k, off, n, _ in self.segments():
            s, e = max(off, lo), min(off + n, hi)
            if s < e:
                out.append((k, s - lo, e - s, s - off))
        return out

    def __repr__(self):
        return ("BucketSpec(#%d keys=[%s] %d elems pad=%d shard=%d %s)"
                % (self.index, self.key_range(), self.size, self.padded,
                   self.shard, self.dtype))


class BucketLayout:
    """Persistent bucket -> key layout, frozen after the first step: the
    contract between the gradient reduce-scatter, the sharded optimizer
    state and the weight all-gather. Every later step must feed the same
    keys in the same order (`assert_matches`)."""

    VERSION = 1

    def __init__(self, buckets, world):
        self.world = max(1, int(world))
        self.buckets = list(buckets)

    @classmethod
    def from_entries(cls, entries, world, cap_bytes=None):
        """Freeze a layout from (key, tensor) pairs through `bucketize`."""
        return cls([BucketSpec(i, b.keys, b.shapes, b.dtype, world)
                    for i, b in enumerate(bucketize(entries, cap_bytes))],
                   world)

    def __len__(self):
        return len(self.buckets)

    def __iter__(self):
        return iter(self.buckets)

    def keys(self):
        out = []
        for b in self.buckets:
            out.extend(b.keys)
        return out

    def assert_matches(self, keys):
        keys = [str(k) for k in keys]
        if keys != self.keys():
            raise ValueError(
                "bucket layout is frozen: step fed keys %s but the layout "
                "holds %s — a changed parameter set needs a new layout "
                "(and fresh sharded optimizer state)" % (keys, self.keys()))

    def total_nbytes(self):
        return sum(b.nbytes() for b in self.buckets)

    def to_payload(self):
        """JSON-able dict, the reference's format."""
        return {"version": self.VERSION, "world": self.world,
                "buckets": [{"keys": list(b.keys),
                             "shapes": [list(s) for s in b.shapes],
                             "dtype": b.dtype} for b in self.buckets]}

    @classmethod
    def from_payload(cls, payload, world=None):
        """Rebuild from `to_payload` output; `world` overrides the saved
        world size (same buckets, new shard boundaries)."""
        if int(payload.get("version", -1)) != cls.VERSION:
            raise ValueError("unsupported bucket-layout payload version %r"
                             % (payload.get("version"),))
        world = payload["world"] if world is None else world
        return cls([BucketSpec(i, b["keys"], b["shapes"], b["dtype"], world)
                    for i, b in enumerate(payload["buckets"])], world)

    def __repr__(self):
        return ("BucketLayout(%d buckets, %d keys, world=%d, %dB)"
                % (len(self.buckets), len(self.keys()), self.world,
                   self.total_nbytes()))


def pack_flat(spec, raws):
    """One concat of the bucket's tensors (cast to its dtype), zero-padded
    to `spec.padded`, on the first tensor's device."""
    dt = spec.torch_dtype
    parts = [r.reshape(-1).to(dt) for r in raws]
    pad = spec.padded - spec.size
    if pad:
        parts.append(torch.zeros(pad, dtype=dt, device=parts[0].device))
    return torch.cat(parts) if len(parts) > 1 else parts[0].clone()


def unpack_flat(spec, flat):
    """Views of a padded flat vector in the bucket's shapes (the padding
    dropped)."""
    out, off = [], 0
    for n, s in zip(spec.sizes, spec.shapes):
        out.append(flat[off:off + n].view(s))
        off += n
    return out


from .ready import ReadyScheduler            # noqa: E402
from . import autotune                       # noqa: E402
from .autotune import (                      # noqa: E402
    CommSchedule, ScheduleAutotuner, autotune_enabled, current_schedule,
    restore_schedule, schedule_payload, set_schedule)

__all__ += ["ReadyScheduler", "autotune", "CommSchedule",
            "ScheduleAutotuner", "autotune_enabled", "current_schedule",
            "set_schedule", "schedule_payload", "restore_schedule"]
