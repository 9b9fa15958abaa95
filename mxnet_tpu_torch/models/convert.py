"""Carry parameters and optimizer state over from the JAX package to the
port.

`params_from_jax` takes the JAX parameter tree after
``jax.tree_util.tree_map(np.asarray, params)``: nested dicts of numpy
arrays, so this module needs no JAX. The layout is the same on both sides
(see `models.llama`; a tree with tied embeddings simply has no
``lm_head``), so the carry-over is a per-leaf copy. `opt_state_from_jax`
does the same for the state of `mxnet_tpu.parallel.train_step`'s
optimizers, so that a test can start both trainers from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import resolve_device

__all__ = ["params_from_jax", "opt_state_from_jax"]


def _leaf(name, a, dtype, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch view
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    # norm scales stay fp32, as the JAX package keeps them
    if dtype is not None and t.is_floating_point() \
            and not name.endswith("norm"):
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, dtype=None, device=None):
    """Nested dict of numpy arrays -> the same dict of tensors on `device`
    (default cuda). `dtype`, when given, casts every floating weight except
    the norm scales."""
    device = resolve_device(device)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _leaf(name, node, dtype, device)

    return walk(tree, "")


def opt_state_from_jax(tree, dtype=None, device=None):
    """A JAX optimizer state (numpy leaves) -> the port's: ``{"m", "v",
    "t"}`` (adam, adamw) with the step counter ``t`` as a Python int,
    ``{"mom"}`` (sgd with momentum) or ``{}`` (plain sgd). The per-parameter
    slots are carried over as `params_from_jax` carries parameters, `dtype`
    included."""
    out = {}
    for key, val in tree.items():
        if key == "t":
            out[key] = int(np.asarray(val))
        elif key in ("m", "v", "mom"):
            out[key] = params_from_jax(val, dtype=dtype, device=device)
        else:
            raise ValueError("opt_state_from_jax: unknown state slot %r"
                             % key)
    return out
