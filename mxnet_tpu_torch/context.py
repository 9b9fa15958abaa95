"""Device contexts (the port of `mxnet_tpu.context`).

`cpu()` is the host and `gpu(i)` is CUDA card i (``torch.device("cuda",
i)``). `with ctx:` makes a context the default of the arrays created inside
the scope, and `current_context()` reads it.

Deviation from the reference: the port's default context is `gpu(0)`, not
`cpu(0)`. That is the port's rule that entry points run on the card.
Without a card, placing an array on the default context raises
`MXNetError`; pass ``ctx=mx.cpu()`` to run on the host.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context"]


class Context:
    """Device context: a device type ("cpu" or "gpu") and an id."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self):
        """The torch device; raises for a GPU context without CUDA."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "mxnet_tpu_torch places arrays on gpu(0) by default, and "
                "CUDA is not available here; pass ctx=mx.cpu() "
                "(device='cpu') to run on the host")
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA card `device_id`."""
    return Context("gpu", device_id)


def current_context():
    """The `with ctx:` scope's context; `gpu(0)` outside any scope."""
    if not hasattr(Context._default_ctx, "value"):
        Context._default_ctx.value = Context("gpu", 0)
    return Context._default_ctx.value


def context_of(device):
    """The Context of a torch device."""
    if device.type == "cpu":
        return cpu()
    return gpu(device.index or 0)
