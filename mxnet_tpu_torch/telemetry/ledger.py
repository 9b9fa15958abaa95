"""Device memory ledger: bytes attributed to the subsystem holding them.

The port of `mxnet_tpu.telemetry.ledger`. A registry of named memory
scopes, set by explicit `account()` calls where the port allocates:

======================  ====================================================
scope                   accounted by
======================  ====================================================
``kv_pool``             `serve.KVBlockPool` storage (the target model)
``kv_draft``            the draft model's mirrored pool (spec decoding)
``prefix_cache``        blocks pinned by the prefix index (OVERLAY: these
                        bytes live inside ``kv_pool`` and are left out of
                        the reconcile sum)
``unattributed``        the reconcile residual
======================  ====================================================

`reconcile()` compares the scoped total with what the card's allocator
holds (`torch.cuda.memory_allocated`, summed over the initialised cards);
on the CPU there is no such count and the source reads ``none``. Each
scope exports a ``memory.scope.<name>.bytes`` gauge; `breakdown()` is the
one-line summary an `Overloaded(kv_exhausted)` carries. Inert under
``MXNET_TPU_TELEMETRY=0``. Not ported: the JAX package's per-program
footprints (`harvest`, `note_program`), its budget check and its
``MXNET_TPU_LEDGER`` switch.
"""
from __future__ import annotations

import threading
import time

__all__ = ["account", "scopes", "reconcile", "maybe_reconcile",
           "tree_nbytes", "breakdown", "reset", "OVERLAY_SCOPES",
           "MIN_RECONCILE_S"]

OVERLAY_SCOPES = frozenset({"prefix_cache"})

MIN_RECONCILE_S = 1.0

_lock = threading.Lock()
_scopes = {}            # scope -> bytes (absolute)
_last = {"ts": 0.0}    # the last reconcile, on the monotonic clock


def _telem():
    from .. import telemetry
    return telemetry


def _gauge(scope, nbytes):
    _telem().registry.gauge("memory.scope.%s.bytes" % scope).set(int(nbytes))


def account(scope, nbytes):
    """Set `scope`'s byte total (absolute). No-op when disabled."""
    if not _telem().ENABLED:
        return
    nbytes = int(nbytes)
    with _lock:
        _scopes[str(scope)] = nbytes
    _gauge(scope, nbytes)


def scopes():
    """{scope: bytes}, overlays and the last residual included."""
    with _lock:
        return dict(_scopes)


def _device_bytes():
    """(bytes the allocator holds, source, cards counted)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0, "none", 0
    n = torch.cuda.device_count()
    return (sum(torch.cuda.memory_allocated(i) for i in range(n)),
            "memory_allocated", n)


def reconcile():
    """Set the ``unattributed`` scope to the allocator's bytes minus the
    scoped total. Returns {device_bytes, scoped_bytes, residual_bytes,
    source, device_count, ts}, or None when disabled."""
    if not _telem().ENABLED:
        return None
    device_total, source, n_dev = _device_bytes()
    with _lock:
        scoped = sum(v for k, v in _scopes.items()
                     if k not in OVERLAY_SCOPES and k != "unattributed")
        residual = device_total - scoped if source != "none" else 0
        _scopes["unattributed"] = residual
        report = {"device_bytes": device_total, "scoped_bytes": scoped,
                  "residual_bytes": residual, "source": source,
                  "device_count": n_dev, "ts": time.time()}
        _last["ts"] = time.monotonic()
    _gauge("unattributed", residual)
    return dict(report)


def maybe_reconcile():
    """`reconcile()` at most once per `MIN_RECONCILE_S` (the step plane
    calls it every step)."""
    if not _telem().ENABLED:
        return None
    with _lock:
        due = time.monotonic() - _last["ts"] >= MIN_RECONCILE_S
    return reconcile() if due else None


def tree_nbytes(tree):
    """Bytes of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    nbytes = getattr(tree, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


def _fmt_bytes(n):
    sign = "-" if n < 0 else ""
    n = abs(float(n))
    if n < 1024:
        return "%s%dB" % (sign, int(n))
    for unit in ("KiB", "MiB", "GiB"):
        n /= 1024.0
        if n < 1024 or unit == "GiB":
            return "%s%.1f%s" % (sign, n, unit)


def breakdown(top=4):
    """``kv_pool=1.5GiB, kv_draft=1.5GiB, ... (scoped 3.0GiB)``; empty when
    the ledger holds nothing."""
    snap = scopes()
    ranked = sorted(((k, v) for k, v in snap.items()
                     if k != "unattributed" and v), key=lambda kv: -kv[1])
    if not ranked:
        return ""
    total = sum(v for k, v in snap.items()
                if k not in OVERLAY_SCOPES and k != "unattributed")
    return "%s (scoped %s)" % (", ".join("%s=%s" % (k, _fmt_bytes(v))
                                         for k, v in ranked[:top]),
                               _fmt_bytes(total))


def reset():
    with _lock:
        _scopes.clear()
        _last["ts"] = 0.0
