"""Base error type, device resolution, dtypes and the env-flag registry of
the PyTorch/CUDA port.

Every entry point of the port (`llama_init`, `init_kv_pools`,
`KVBlockPool`, `InferenceServer`, the default `Context`) runs on the CUDA
card unless the caller passes ``device="cpu"`` (``ctx=mx.cpu()``). Without
a card the default raises: the port never moves to the CPU on its own, so a
run that was meant for the card cannot quietly measure the host instead.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["MXNetError", "resolve_device", "register_env", "get_env",
           "dtype_name", "torch_dtype", "DTYPE_CODES"]


class MXNetError(Exception):
    """Base class of the port's errors (the counterpart of
    `mxnet_tpu.base.MXNetError`)."""


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` by default, or what the
    caller names. Raises when CUDA is asked for (or defaulted to) and is
    not available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "mxnet_tpu_torch runs on a CUDA device by default, and CUDA is "
            "not available here; pass device='cpu' to run on the host")
    return device


# ---------------------------------------------------------------------------
# dtypes: the reference's mshadow type codes (the `.params` format stores
# them), by canonical name. bfloat16 has no numpy type without ml_dtypes,
# so the port names dtypes by string and converts at the edges.
# ---------------------------------------------------------------------------
DTYPE_CODES = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
               "int32": 4, "int8": 5, "int64": 6, "bool": 7, "bfloat16": 12}

_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "uint8": torch.uint8,
          "int32": torch.int32, "int8": torch.int8, "int64": torch.int64,
          "bool": torch.bool, "bfloat16": torch.bfloat16,
          # the rest of `mx.np`'s types (no `.params` type code)
          "int16": torch.int16, "uint16": torch.uint16,
          "uint32": torch.uint32, "uint64": torch.uint64,
          "complex64": torch.complex64, "complex128": torch.complex128}
_NAMES = {v: k for k, v in _TORCH.items()}


def dtype_name(dtype):
    """Canonical name ("float32", "bfloat16", ...) of a dtype given as a
    string, numpy dtype or type, or torch dtype. None means float32."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        return _NAMES[dtype]
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    name = np.dtype(dtype).name
    if name not in _TORCH:
        raise TypeError("mxnet_tpu_torch: unsupported dtype %r" % (dtype,))
    return name


def torch_dtype(dtype):
    return _TORCH[dtype_name(dtype)]


# ---------------------------------------------------------------------------
# env flags (the counterpart of the reference's `register_env`/`get_env`
# catalog): only the variables the port reads
# ---------------------------------------------------------------------------
_ENV_CATALOG = {}


def register_env(name, default, typ, doc):
    _ENV_CATALOG[name] = (default, typ, doc)
    return name


def get_env(name, default=None):
    """Typed env lookup against the catalog."""
    if name in _ENV_CATALOG:
        cat_default, typ, _ = _ENV_CATALOG[name]
        raw = os.environ.get(name)
        if raw is None:
            return cat_default if default is None else default
        if typ is bool:
            return raw.lower() not in ("0", "false", "off", "")
        return typ(raw)
    raw = os.environ.get(name)
    return default if raw is None else raw


register_env("MXNET_TPU_FUSED_CONVBN", False, bool,
             "Build the model zoo's ResNets with fused conv3x3+BN+ReLU "
             "blocks (NHWC, stride 1) in place of the composed triple; the "
             "parameter names differ, so checkpoints do not cross the gate.")
register_env("MXNET_TPU_WHOLE_GRAPH", True, bool,
             "Run a bound symbolic graph as one whole-graph program "
             "(mx.compiler) in place of op-by-op dispatch; a graph the "
             "pipeline cannot lower falls back op by op, counted as "
             "compiler.fallback.<reason>.")
