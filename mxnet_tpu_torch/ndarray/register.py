"""Generate the `mx.nd.*` namespace from the op registry (the port of
`mxnet_tpu.ndarray.register`)."""
from __future__ import annotations

from ..ops import registry as _reg
from .ndarray import invoke


def make_op_func(name):
    op = _reg.get(name)

    def op_func(*args, out=None, **kwargs):
        return invoke(name, *args, out=out, **kwargs)

    op_func.__name__ = name.lstrip("_") or name
    op_func.__qualname__ = op_func.__name__
    op_func.__doc__ = op.doc or ("%s (generated from the op registry)"
                                 % name)
    return op_func


def populate(namespace, names=None):
    for name in (names or _reg.list_ops()):
        namespace.setdefault(name, make_op_func(name))
    return namespace
