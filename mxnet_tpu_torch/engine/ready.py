"""Readiness-ordered bucket assembly (the port of
`mxnet_tpu.engine.ready`).

`ReadyScheduler` is fed from the autograd grad-ready hook
(`autograd.add_grad_ready_hook`) the moment each parameter's gradient is
final, and hands each completed bucket to a dispatch function at once, so
the first exchange starts while the rest of backward still runs.

* **free** (``layout=None``): greedy size-capped packing with one open
  bucket per dtype (readiness interleaves dtypes; one open bucket would
  split on every change). Capacity flushes count
  ``comm.bucket.flush_reason.ready``; `drain()` flushes the tails as
  ``final``. ``cap_bytes=0`` dispatches every key alone, at once.
* **frozen** (``layout=BucketLayout``): membership is fixed; a bucket
  dispatches the moment all its members have arrived, in any bucket
  order, and is built in the layout's key order whatever the arrival
  order, so its packed vector is the registration path's byte for byte
  and every rank launches the same exchanges. The ZeRO and dist mode.

Single-threaded: the hook fires on the thread that runs backward, and
`drain()` runs on it at step time.
"""
from __future__ import annotations

__all__ = ["ReadyScheduler"]


def _in_backward():
    from .. import autograd
    return autograd.in_backward()


class ReadyScheduler:
    """Feed `add(key, raw)` in readiness order; ``dispatch_fn(bucket,
    spec)`` fires when a bucket completes (``spec`` is the `BucketSpec` in
    frozen mode, None in free mode).

    ``comm.ready.flush_during_backward`` counts dispatches made while
    backward still ran, ``comm.ready.first_flush_before_backward_end``
    ticks once per round whose first dispatch beat the end of backward."""

    def __init__(self, dispatch_fn, cap_bytes=None, layout=None):
        from . import bucket_bytes
        self._dispatch_fn = dispatch_fn
        self.cap = bucket_bytes() if cap_bytes is None else int(cap_bytes)
        self.layout = layout
        self.dispatched = 0
        self._first_dispatch_done = False
        if layout is not None:
            self._spec_by_key = {k: spec for spec in layout
                                 for k in spec.keys}
            self._pending = {}      # spec.index -> {key: raw}
        else:
            self._open = {}         # dtype -> (items, nbytes)

    def _dispatch(self, bucket, spec=None):
        from .. import telemetry as _telem
        if _telem.ENABLED and _in_backward():
            _telem.inc("comm.ready.flush_during_backward")
            if not self._first_dispatch_done:
                _telem.inc("comm.ready.first_flush_before_backward_end")
        self._first_dispatch_done = True
        self.dispatched += 1
        self._dispatch_fn(bucket, spec)

    def _add_free(self, key, raw):
        from . import Bucket, _count_bucket, _nbytes
        nbytes = _nbytes(raw)
        if self.cap == 0:
            self._dispatch(_count_bucket(Bucket([(key, raw)], "ready")))
            return 1
        if nbytes >= self.cap:
            self._dispatch(_count_bucket(Bucket([(key, raw)], "oversize")))
            return 1
        items, held = self._open.get(raw.dtype, ([], 0))
        n = 0
        if items and held + nbytes > self.cap:
            self._dispatch(_count_bucket(Bucket(items, "ready")))
            items, held = [], 0
            n = 1
        items.append((key, raw))
        self._open[raw.dtype] = (items, held + nbytes)
        return n

    def _add_frozen(self, key, raw):
        from . import Bucket, _count_bucket
        key = str(key)
        spec = self._spec_by_key.get(key)
        if spec is None:
            raise ValueError(
                "ReadyScheduler: key %r is not in the frozen bucket layout "
                "(layout keys: %s): a changed parameter set needs a new "
                "layout" % (key, sorted(self._spec_by_key)[:8]))
        got = self._pending.setdefault(spec.index, {})
        got[key] = raw
        if len(got) < len(spec.keys):
            return 0
        del self._pending[spec.index]
        # the layout's key order, not the arrival order
        bucket = Bucket([(k, got[k]) for k in spec.keys], "ready")
        self._dispatch(_count_bucket(bucket), spec)
        return 1

    def add(self, key, raw):
        """Feed one final gradient; returns the buckets dispatched. Empty
        or None gradients are skipped (``comm.bucket.skipped``)."""
        from .. import telemetry as _telem
        if raw is None or raw.numel() == 0:
            _telem.inc("comm.bucket.skipped")
            return 0
        if self.layout is not None:
            return self._add_frozen(key, raw)
        return self._add_free(key, raw)

    def drain(self):
        """End of the round: free mode flushes the open tails (reason
        ``final``, dtypes in name order); frozen mode raises when a bucket
        still misses members. Returns the buckets dispatched."""
        from . import Bucket, _count_bucket
        n = 0
        if self.layout is not None:
            if self._pending:
                missing = {}
                for idx, got in sorted(self._pending.items()):
                    spec = next(s for s in self.layout if s.index == idx)
                    missing[idx] = [k for k in spec.keys if k not in got]
                raise ValueError(
                    "ReadyScheduler: frozen layout drained with incomplete "
                    "buckets (missing grads): %s" % (missing,))
        else:
            for dt in sorted(self._open, key=str):
                items, _ = self._open[dt]
                if items:
                    self._dispatch(_count_bucket(Bucket(items, "final")))
                    n += 1
            self._open = {}
        self._first_dispatch_done = False
        return n
