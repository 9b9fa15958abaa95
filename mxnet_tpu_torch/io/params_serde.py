"""Binary serialization of named arrays: the `.params` checkpoint format,
numpy only (the port's copy of `mxnet_tpu.io.params_serde`).

Layout (little-endian), the reference's 1.x on-disk framing:
  uint64 kMXAPINDArrayListMagic (0x112)
  uint64 reserved (0)
  uint64 num_arrays
  per array (NDArray::Save V2):
    uint32 NDARRAY_V2_MAGIC (0xF993FAC9)
    int32  stype (0 = default)
    uint32 ndim, int64 dims[ndim]
    int32  dev_type, int32 dev_id        (context; ignored on load)
    int32  dtype (mshadow type code, `base.DTYPE_CODES`)
    raw data bytes (shape.prod * dtype size)
  uint64 num_names
  per name: uint64 len, bytes

Records are ``(array, dtype name)`` pairs. numpy has no bfloat16 without
ml_dtypes, so a bfloat16 record (code 12) travels as its raw ``uint16``
bits: a file the reference writes loads bit-exactly, and the reverse.
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import DTYPE_CODES

__all__ = ["save_records", "load_records"]

_LIST_MAGIC = 0x112
_NDARRAY_V2_MAGIC = 0xF993FAC9
_CODE_NAMES = {v: k for k, v in DTYPE_CODES.items()}


def _storage(name):
    """numpy dtype that holds a record of dtype `name` on disk."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _write_record(f, arr, name):
    a = np.ascontiguousarray(arr)
    if a.dtype != _storage(name):
        raise ValueError("params_serde: a %s record needs a %s array, got %s"
                         % (name, _storage(name), a.dtype))
    f.write(struct.pack("<I", _NDARRAY_V2_MAGIC))
    f.write(struct.pack("<i", 0))                       # stype: dense
    f.write(struct.pack("<I", a.ndim))
    for d in a.shape:
        f.write(struct.pack("<q", d))
    f.write(struct.pack("<ii", 1, 0))                   # cpu(0)
    f.write(struct.pack("<i", DTYPE_CODES[name]))
    f.write(a.tobytes())


def _read_record(f):
    magic, = struct.unpack("<I", f.read(4))
    if magic != _NDARRAY_V2_MAGIC:
        raise IOError("bad NDArray magic 0x%x (expected 0x%x)" %
                      (magic, _NDARRAY_V2_MAGIC))
    struct.unpack("<i", f.read(4))                      # stype
    ndim, = struct.unpack("<I", f.read(4))
    shape = struct.unpack("<%dq" % ndim, f.read(8 * ndim)) if ndim else ()
    struct.unpack("<ii", f.read(8))                     # context, ignored
    code, = struct.unpack("<i", f.read(4))
    if code not in _CODE_NAMES:
        raise IOError("unsupported dtype code %d" % code)
    name = _CODE_NAMES[code]
    dt = _storage(name)
    n = 1
    for d in shape:
        n *= d
    buf = f.read(n * dt.itemsize)
    return np.frombuffer(buf, dtype=dt).reshape(shape).copy(), name


def save_records(fname, names, records):
    """Write `records` [(array, dtype name)] under `names` (a list of the
    same length, or [] for an unnamed list)."""
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(records)))
        for arr, name in records:
            _write_record(f, arr, name)
        f.write(struct.pack("<Q", len(names)))
        for nm in names:
            b = nm.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load_records(fname):
    """(names, [(array, dtype name)]); names is [] for an unnamed list."""
    with open(fname, "rb") as f:
        magic, _ = struct.unpack("<QQ", f.read(16))
        if magic != _LIST_MAGIC:
            raise IOError("bad .params magic 0x%x" % magic)
        n, = struct.unpack("<Q", f.read(8))
        records = [_read_record(f) for _ in range(n)]
        n_names, = struct.unpack("<Q", f.read(8))
        names = []
        for _ in range(n_names):
            ln, = struct.unpack("<Q", f.read(8))
            names.append(f.read(ln).decode("utf-8"))
    return names, records
