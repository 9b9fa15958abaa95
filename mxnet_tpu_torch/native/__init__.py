"""The host helpers of the data pipeline (the port of `mxnet_tpu.native`):
the RecordIO framing scan and the uint8 HWC -> normalized float32 CHW
passes, in g++ host code (`mxnet_tpu_native.cc` beside this file).

The library is built at first use into ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the source and the flags, as the
CUDA kernels are (`ops._build`): ``g++ -O3 -fopenmp``, and without
``-fopenmp`` where the toolchain lacks OpenMP. A build that fails raises:
there is no Python route behind it. The ``*_plain`` functions are the
numpy versions, written to the C code's arithmetic so that both give the
same bits; they are for the tests.
"""
from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading
from pathlib import Path

import numpy as _np

__all__ = ["build", "index_recordio_buffer", "index_recordio_file",
           "img_to_chw_norm", "batch_to_chw_norm",
           "index_recordio_buffer_plain", "img_to_chw_norm_plain",
           "batch_to_chw_norm_plain"]

_SRC = Path(__file__).resolve().parent / "mxnet_tpu_native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "torch_kernels"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp"]

_lock = threading.Lock()
_lib = None

_MAGIC = 0xced7230a
_KFLAG_BITS = 29
_LENGTH_MASK = (1 << _KFLAG_BITS) - 1
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _target():
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / ("libmxnet_tpu_native-%s.so" % h.hexdigest()[:16])


def _compile(out):
    """g++ into a file of this process, moved into place when whole;
    retried without OpenMP. Raises with g++'s output when both fail."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    logs = []
    for flags in (FLAGS, [f for f in FLAGS if f != "-fopenmp"]):
        try:
            r = subprocess.run(["g++", *flags, str(_SRC), "-o", str(tmp)],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            logs.append(str(e))
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return
        logs.append(r.stdout + r.stderr)
    raise RuntimeError("mxnet_tpu_torch.native: g++ failed for %s:\n%s"
                       % (_SRC, "\n".join(logs)))


def build():
    """Build (where not built yet) and load the library; returns it."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out = _target()
            if not out.exists():
                _compile(out)
            cdll = ctypes.CDLL(str(out))
            cdll.mxtpu_recordio_index.restype = ctypes.c_int64
            cdll.mxtpu_recordio_index.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, _i64p, _i64p,
                ctypes.c_int64]
            cdll.mxtpu_img_to_chw_norm.restype = None
            cdll.mxtpu_img_to_chw_norm.argtypes = [
                _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _f32p, _f32p, _f32p]
            cdll.mxtpu_batch_to_chw_norm.restype = None
            cdll.mxtpu_batch_to_chw_norm.argtypes = [
                _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _f32p, _f32p, _f32p]
            _lib = cdll
    return _lib


def index_recordio_buffer(buf):
    """(starts, sizes): the int64 offsets and payload sizes of the logical
    records in a .rec buffer (bytes, or anything with the buffer
    protocol). A multi-part record is one record whose size sums its
    parts; a truncated tail is dropped. Raises IOError on a bad magic."""
    cdll = build()
    view = _np.frombuffer(buf, dtype=_np.uint8) if len(buf) else \
        _np.zeros(8, _np.uint8)
    n = len(buf)
    cap = max(16, n // 8)       # every record takes at least 8 bytes
    starts = _np.empty(cap, _np.int64)
    sizes = _np.empty(cap, _np.int64)
    count = cdll.mxtpu_recordio_index(
        view.ctypes.data, n, starts.ctypes.data_as(_i64p),
        sizes.ctypes.data_as(_i64p), cap)
    del view    # a memory map closes only once no array exports it
    if count == -1:
        raise IOError("Invalid RecordIO magic number")
    if count < 0:
        raise RuntimeError("mxtpu_recordio_index: %d records overflow a "
                           "table of %d" % (count, cap))
    return starts[:count].copy(), sizes[:count].copy()


def index_recordio_file(path):
    """`index_recordio_buffer` over a memory map of the file at `path`:
    the scan reads only the pages that hold record headers."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return index_recordio_buffer(b"")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            return index_recordio_buffer(mm)


def _f32(a):
    return None if a is None else _np.ascontiguousarray(a, _np.float32)


def img_to_chw_norm(img, mean=None, std=None):
    """uint8 HWC image -> float32 CHW, ((x / 255) - mean) / std in one
    pass."""
    cdll = build()
    img = _np.ascontiguousarray(img, dtype=_np.uint8)
    h, w, c = img.shape
    dst = _np.empty((c, h, w), _np.float32)
    mean, std = _f32(mean), _f32(std)
    cdll.mxtpu_img_to_chw_norm(
        img.ctypes.data_as(_u8p), h, w, c,
        None if mean is None else mean.ctypes.data_as(_f32p),
        None if std is None else std.ctypes.data_as(_f32p),
        dst.ctypes.data_as(_f32p))
    return dst


def batch_to_chw_norm(batch, mean=None, std=None):
    """uint8 (B, H, W, C) -> float32 (B, C, H, W), normalized as
    `img_to_chw_norm`, the images spread over OpenMP threads."""
    cdll = build()
    batch = _np.ascontiguousarray(batch, dtype=_np.uint8)
    b, h, w, c = batch.shape
    dst = _np.empty((b, c, h, w), _np.float32)
    mean, std = _f32(mean), _f32(std)
    cdll.mxtpu_batch_to_chw_norm(
        batch.ctypes.data_as(_u8p), b, h, w, c,
        None if mean is None else mean.ctypes.data_as(_f32p),
        None if std is None else std.ctypes.data_as(_f32p),
        dst.ctypes.data_as(_f32p))
    return dst


# -- the plain versions (numpy), for the tests ------------------------------
def index_recordio_buffer_plain(buf):
    """`index_recordio_buffer` in Python."""
    buf = bytes(buf)
    n, pos = len(buf), 0
    starts, sizes = [], []
    cur_start, cur_size = -1, 0
    while pos + 8 <= n:
        magic, lrec = _np.frombuffer(buf[pos:pos + 8], "<u4").tolist()
        if magic != _MAGIC:
            raise IOError("Invalid RecordIO magic number")
        cflag, length = (lrec >> _KFLAG_BITS) & 7, lrec & _LENGTH_MASK
        if pos + 8 + length > n:
            break
        if cflag in (0, 1):
            cur_start, cur_size = pos, length
        else:
            cur_size += length
        if cflag in (0, 3):
            starts.append(cur_start)
            sizes.append(cur_size)
        pos += 8 + ((length + 3) & ~3)
    return _np.array(starts, _np.int64), _np.array(sizes, _np.int64)


def img_to_chw_norm_plain(img, mean=None, std=None):
    """`img_to_chw_norm` in numpy, in the C code's order of float32
    operations: (x * (1/255) - m) * (1/s)."""
    img = _np.asarray(img, _np.uint8)
    c = img.shape[2]
    m = _np.zeros(c, _np.float32) if mean is None else _f32(mean)
    inv = _np.float32(1.0) / (_np.ones(c, _np.float32) if std is None
                              else _f32(std))
    x = img.astype(_np.float32) * (_np.float32(1.0) / _np.float32(255.0))
    return ((x - m) * inv).transpose(2, 0, 1).copy()


def batch_to_chw_norm_plain(batch, mean=None, std=None):
    """`batch_to_chw_norm` in numpy."""
    batch = _np.asarray(batch, _np.uint8)
    return _np.stack([img_to_chw_norm_plain(im, mean, std)
                      for im in batch]) if len(batch) else \
        _np.empty((0, batch.shape[3], batch.shape[1], batch.shape[2]),
                  _np.float32)
