"""Build the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each source is one ``.cu`` file with a plain C interface, holding one or
more kernels (`ops.KERNELS` maps each kernel name to its source). ``nvcc``
compiles a source for Hopper (``sm_90a``) into a shared library of its
own, which is loaded with ctypes. No file includes PyTorch's headers, so a
build takes seconds rather than the minutes a torch extension takes.
Libraries land in ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the source and the flags, so an unchanged source is
built once. `build` starts one ``nvcc`` per source, all at once, and waits
for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "build", "library", "build_log"]

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}      # source -> loaded library
_logs = {}      # source -> nvcc output of this process's build
_lock = threading.Lock()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("mxnet_tpu_torch: nvcc not found (set CUDA_HOME); "
                       "the CUDA kernels are built from source at first use")


def _source(name):
    from . import KERNELS
    return KERNELS[name][0]


def _target(source):
    src = _PKG / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / ("lib%s-%s.so" % (src.stem, digest[:16]))


def build(names):
    """Build (where not built yet) and load the named kernels' libraries,
    one ``nvcc`` per distinct source. Returns {source: seconds spent
    building or loading it in this call}."""
    with _lock:
        jobs = {}
        for source in dict.fromkeys(_source(n) for n in names):
            if source in _libs:
                continue
            src, out = _target(source)
            if out.exists():
                jobs[source] = (out, None, None, time.perf_counter())
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[source] = (out, proc, tmp, time.perf_counter())
        seconds = {}
        for source, (out, proc, tmp, t0) in jobs.items():
            if proc is not None:
                log, _ = proc.communicate()
                _logs[source] = log
                if proc.returncode != 0:
                    raise RuntimeError("mxnet_tpu_torch: nvcc failed for "
                                       "%s:\n%s" % (source, log))
                os.replace(tmp, out)
            _libs[source] = ctypes.CDLL(str(out))
            seconds[source] = time.perf_counter() - t0
        return seconds


def library(name):
    """The loaded shared library holding kernel `name` (built at first
    use)."""
    source = _source(name)
    lib = _libs.get(source)
    if lib is None:
        build([name])
        lib = _libs[source]
    return lib


def build_log(source):
    """nvcc's output (with ``-Xptxas -v``: registers, shared memory and
    spills per kernel) from this process's build of `source` (a path in
    the package, as in `ops.KERNELS`), or None when the library was already
    built."""
    return _logs.get(source)
