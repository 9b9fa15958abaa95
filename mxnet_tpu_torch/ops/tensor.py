"""Tensor ops of the ResNet path (the port of the part of
`mxnet_tpu.ops.tensor` that Gluon's ResNet layers and NDArray arithmetic
call): the binary broadcast ops, cast and Flatten."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import alias, register

_BINARY = {"broadcast_add": torch.add, "broadcast_sub": torch.sub,
           "broadcast_mul": torch.mul, "broadcast_div": torch.div}


def _binary(f):
    def fn(a, b):
        if not torch.is_tensor(a):      # scalar on the left: a - x, a / x
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        return f(a, b)
    return fn


for _n, _f in _BINARY.items():
    register(_n)(_binary(_f))

alias("broadcast_add", "elemwise_add", "_plus", "_add")
alias("broadcast_sub", "elemwise_sub", "_minus", "_sub")
alias("broadcast_mul", "elemwise_mul", "_mul")
alias("broadcast_div", "elemwise_div", "_div")


@register("cast")
def _cast(x, dtype=None):
    return x.to(torch_dtype(dtype))


alias("cast", "Cast")


@register("flatten")
def _flatten(x):
    """Keeps dim 0, flattens the rest."""
    return x.reshape(x.shape[0], -1)


alias("flatten", "Flatten")
