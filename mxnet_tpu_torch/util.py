"""Crash-safe file commits shared by the port's checkpointing.

The port's own copies of `mxnet_tpu.util.atomic_write`,
`write_latest_marker` and `read_latest_marker`.
"""
from __future__ import annotations

import os

__all__ = ["atomic_write", "write_latest_marker", "read_latest_marker"]


def atomic_write(path, data):
    """Write `data` (bytes) to `path` via tmp + fsync + os.replace: a crash
    at any point leaves the previous content or the new one, never a torn
    file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_latest_marker(root, step):
    """Commit `root`/LATEST naming the newest fully-durable checkpoint
    step. Call strictly after the step's payload is on disk."""
    atomic_write(os.path.join(root, "LATEST"), ("%d\n" % int(step)).encode())


def read_latest_marker(root):
    """The step named by `root`/LATEST, or None (missing or corrupt marker:
    callers fall back to a directory scan, so a lost marker never loses
    checkpoints)."""
    try:
        with open(os.path.join(root, "LATEST")) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None
