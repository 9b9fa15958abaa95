"""Crash-safe file commits shared by the port's checkpointing, and the
np-mode switches.

The port's own copies of `mxnet_tpu.util.atomic_write`,
`write_latest_marker`, `read_latest_marker` and the np-mode functions
(`set_np`, `reset_np`, `is_np_array`, `is_np_shape`, the `np_array` and
`np_shape` scopes, `use_np`, `default_array`).
"""
from __future__ import annotations

import functools
import os

__all__ = ["atomic_write", "write_latest_marker", "read_latest_marker",
           "set_np", "reset_np", "is_np_array", "is_np_shape", "np_array",
           "np_shape", "use_np", "default_array"]


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


# np-mode switches: the state lives in `numpy_extension`
def set_np(shape=True, array=True):
    from . import numpy_extension as npx
    npx.set_np(shape=shape, array=array)


def reset_np():
    from . import numpy_extension as npx
    npx.reset_np()


def is_np_array():
    from . import numpy_extension as npx
    return npx.is_np_array()


def is_np_shape():
    from . import numpy_extension as npx
    return npx.is_np_shape()


class _NpScope:
    """A scope (or decorator) with np semantics set inside: `array` and
    `shape` are the flags' values there; None leaves a flag as it is."""

    def __init__(self, array=None, shape=None):
        self._array, self._shape = array, shape

    def __enter__(self):
        self._saved = (is_np_shape(), is_np_array())
        set_np(shape=self._saved[0] if self._shape is None else self._shape,
               array=self._saved[1] if self._array is None else self._array)
        return self

    def __exit__(self, *exc):
        set_np(shape=self._saved[0], array=self._saved[1])
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with type(self)(self._array, self._shape):
                return fn(*args, **kwargs)
        return wrapper


def np_array(active=True):
    return _NpScope(array=bool(active), shape=None)


def np_shape(active=True):
    return _NpScope(array=None, shape=bool(active))


def use_np(fn):
    """Decorator: run `fn` with np shape and array semantics on."""
    return _NpScope(array=True, shape=True)(fn)


def default_array(source, ctx=None, dtype=None):
    """`array()` of whichever namespace np mode selects."""
    if is_np_array():
        from . import numpy as np_ns
        return np_ns.array(source, dtype=dtype, ctx=ctx)
    from .ndarray import array
    return array(source, ctx=ctx, dtype=dtype)
