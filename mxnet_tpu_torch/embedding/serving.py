"""Kvstore-served embedding lookups with the serve warm-up discipline (the
port of `mxnet_tpu.embedding.serving`).

`EmbeddingLookupService` answers `kvstore.row_sparse_pull` against a
sharded table from a snapshot of the full table (`gathered_weight`),
padding every batch of ids up to one of a fixed set of bucket sizes. The
reference compiles one gather per bucket at `warmup`; PyTorch runs
eagerly, so here a bucket's "program" is its padded gather, made ready at
`warmup`, and a batch that lands in a bucket that was not warmed after
warm-up counts ``serve.retrace``, as the reference's trace miss does.

`refresh` takes a new snapshot after training steps. The table's update
builds a new weight tensor each step, so a snapshot is never changed under
the reader. Lookup latency goes to the ``embedding.serve.lookup_ms``
histogram.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import telemetry as _telem

__all__ = ["EmbeddingLookupService", "default_buckets"]


def default_buckets(max_batch=1024):
    """Power-of-two id-batch buckets from 8 up to `max_batch`."""
    out, b = [], 8
    while b < int(max_batch):
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


def _gather(weight, ids):
    """Rows of `weight` for `ids`; negative ids (the bucket padding) give
    zero rows."""
    valid = ids >= 0
    rows = weight[ids.clamp(0, weight.shape[0] - 1).long()]
    return torch.where(valid[:, None], rows, 0)


class EmbeddingLookupService:
    """Fixed-bucket gathers over a table snapshot. `table` is a
    `ShardedEmbedding` (snapshotted through `gathered_weight`) or a
    (vocab, dim) tensor."""

    def __init__(self, table, max_batch=1024, buckets=None):
        from .table import ShardedEmbedding
        self._table = table if isinstance(table, ShardedEmbedding) else None
        self.buckets = tuple(sorted(buckets or default_buckets(max_batch)))
        self.max_batch = self.buckets[-1]
        self._fns = {}
        self._warm = False
        self._weight = None if self._table is not None \
            else torch.as_tensor(table)
        self.refresh()

    # -- snapshot ------------------------------------------------------------
    def refresh(self):
        """Take the table's current weights as the served snapshot."""
        if self._table is not None:
            weight = self._table.gathered_weight()
        elif self._weight is None:
            raise ValueError("EmbeddingLookupService needs a "
                             "ShardedEmbedding or a (vocab, dim) tensor")
        else:
            weight = self._weight
        self._weight = weight
        self.vocab, self.dim = int(weight.shape[0]), int(weight.shape[1])

    # -- programs ------------------------------------------------------------
    def _bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            "lookup batch %d exceeds the largest bucket %d: size the "
            "service with max_batch at admission capacity"
            % (n, self.max_batch))

    def _fn(self, bucket):
        fn = self._fns.get(bucket)
        if fn is None:
            if self._warm:
                _telem.inc("serve.retrace")
            fn = self._fns[bucket] = _gather
        return fn

    def warmup(self):
        """Make every bucket's gather ready (one padded gather each); after
        this, steady lookups count no retrace."""
        for b in self.buckets:
            self._fn(b)(self._weight, torch.full(
                (b,), -1, dtype=torch.int32, device=self._weight.device))
        self._warm = True

    # -- lookup --------------------------------------------------------------
    def lookup(self, ids):
        """The (n, dim) rows for `ids` ((n,) ints, n <= max_batch), padded
        to the bucket inside."""
        if not torch.is_tensor(ids):
            ids = torch.as_tensor(np.asarray(ids))
        ids = ids.to(device=self._weight.device, dtype=torch.int32)
        n = int(ids.shape[0])
        bucket = self._bucket_for(n)
        if n < bucket:
            ids = torch.cat([ids, ids.new_full((bucket - n,), -1)])
        t0 = time.perf_counter()
        out = self._fn(bucket)(self._weight, ids)[:n]
        _telem.inc("embedding.serve.lookup")
        _telem.inc("embedding.serve.rows", n)
        _telem.observe("embedding.serve.lookup_ms",
                       (time.perf_counter() - t0) * 1e3)
        return out
