"""`mx.operator`: custom operators written in Python (the port of
`mxnet_tpu.operator`): `CustomOp`, `CustomOpProp`, `register` and
`invoke_custom`, the body of `nd.Custom`.

The user's `forward` and `backward` run inside a `torch.autograd.Function`:
under `autograd.record()` torch records the op, and its backward calls the
user's `backward` with the output gradients, as the reference's tape does.
Both run with recording paused, on NDArrays of the inputs' context, so a
custom op on the card computes there.

    @mx.operator.register("softsign")
    class SoftsignProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Softsign()

    class Softsign(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], x / (1 + x.abs()))
        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            ...

    y = mx.nd.Custom(x, op_type="softsign")
"""
from __future__ import annotations

import inspect

import numpy as _np
import torch

from . import autograd
from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_entry",
           "invoke_custom"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """The user's computation: `forward` and `backward` write their results
    with `assign`."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write `src` into `dst` by `req`: "null" skips, "write" and
        "inplace" overwrite, "add" accumulates."""
        if req == "null":
            return
        from .ndarray.ndarray import NDArray, _tensor_from_numpy
        if isinstance(src, NDArray):
            src = src._data
        elif not torch.is_tensor(src):
            src = _tensor_from_numpy(_np.asarray(src))
        src = src.detach().to(dst._data.device, dst._data.dtype)
        with torch.no_grad():
            if req in ("write", "inplace"):
                dst._data.copy_(src)
            elif req == "add":
                dst._data.add_(src)
            else:
                raise MXNetError("unknown req %r" % req)


class CustomOpProp:
    """Shapes, dtypes and the operator factory of a custom op."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = bool(need_top_grad)

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        t = in_type[0]
        return (in_type, [t] * len(self.list_outputs()),
                [t] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = list(out_grad) if self.need_top_grad_ else []
        return deps + list(in_data) + list(out_data)

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Class decorator: register a `CustomOpProp` as op_type `reg_name`."""
    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get_entry(op_type):
    prop_cls = _CUSTOM_REGISTRY.get(op_type)
    if prop_cls is None:
        raise MXNetError(
            "Custom op %r is not registered (mx.operator.register)" % op_type)
    return prop_cls


class _CustomFn(torch.autograd.Function):
    """Forward and backward through the user's CustomOp; `run` carries
    the op, its output shapes and dtypes, the auxiliary arrays and the
    context."""

    @staticmethod
    def forward(ctx, run, *tensors):
        from .ndarray.ndarray import NDArray
        in_data = [NDArray(t, ctx=run["ctx"]) for t in tensors]
        out_data = run["alloc"]()
        with autograd.pause(train_mode=run["train"]):
            run["op"].forward(run["train"], ["write"] * len(out_data),
                              in_data, out_data, run["aux"])
        ctx.run, ctx.in_data, ctx.out_data = run, in_data, out_data
        return tuple(o._data for o in out_data)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray, zeros
        run = ctx.run
        out_grad = [NDArray(g.contiguous(), ctx=run["ctx"]) for g in grads]
        in_grad = [zeros(a.shape, ctx=run["ctx"], dtype=a.dtype)
                   for a in ctx.in_data]
        with autograd.pause():
            run["op"].backward(["write"] * len(in_grad), out_grad,
                               ctx.in_data, ctx.out_data, in_grad,
                               run["aux"])
        return (None,) + tuple(g._data for g in in_grad)


def _prop_takes_kwargs(prop_cls, kwargs):
    return bool(kwargs) and \
        len(inspect.signature(prop_cls.__init__).parameters) > 1


def invoke_custom(*inputs, op_type=None, **kwargs):
    """Run registered custom op `op_type` on the input arrays (arguments,
    then auxiliary states); keyword arguments reach the prop's
    constructor as strings, as in the reference. One output comes back
    as an array, several as a list."""
    from .context import current_context
    from .ndarray.ndarray import NDArray, zeros
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    prop_cls = get_entry(op_type)
    prop = prop_cls(**{k: str(v) for k, v in kwargs.items()}) \
        if _prop_takes_kwargs(prop_cls, kwargs) else prop_cls()
    n_args = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    if len(inputs) != n_args + n_aux:
        raise MXNetError("Custom %r expects %d inputs (+%d aux), got %d"
                         % (op_type, n_args, n_aux, len(inputs)))
    in_data = list(inputs[:n_args])
    ctx = in_data[0].context if in_data else current_context()
    ishapes, oshapes, _ = prop.infer_shape([list(a.shape) for a in in_data])
    itypes, otypes, _ = prop.infer_type([a.dtype for a in in_data])
    run = {"op": prop.create_operator(ctx, ishapes, itypes),
           "ctx": ctx, "aux": list(inputs[n_args:]),
           "train": autograd.is_training(),
           "alloc": lambda: [zeros(tuple(s), ctx=ctx, dtype=t)
                             for s, t in zip(oshapes, otypes)]}
    with torch.set_grad_enabled(autograd.is_recording()):
        outs = _CustomFn.apply(run, *(a._data for a in in_data))
    outs = [NDArray(o, ctx=ctx) for o in outs]
    return outs[0] if len(outs) == 1 else outs
