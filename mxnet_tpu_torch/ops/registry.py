"""The operator registry (the port of `mxnet_tpu.ops.registry`).

One registration per op; the `mx.nd` namespace is generated from this
table (`ndarray.register.populate`). An op's `fn` takes raw `torch.Tensor`s
(and keyword attributes) and returns a tensor or a tuple of tensors.

Device dispatch: an op may register a CUDA implementation with
`cuda_impl` (the counterpart of the reference's `tpu_impl` hook). `best_fn`
returns it whenever the call's context is a GPU. Unlike the reference's
`MXNET_TPU_USE_PALLAS` gate, no environment variable switches it off: on a
card the kernel always runs.
"""
from __future__ import annotations

__all__ = ["Operator", "register", "get", "list_ops", "alias"]

_REGISTRY: dict = {}


class Operator:
    def __init__(self, name, fn, *, arity=None, differentiable=True,
                 creation=False, random=False, num_outputs=1, doc=None):
        self.name = name
        self.fn = fn
        self.arity = arity            # number of array inputs; None = variadic
        self.differentiable = differentiable
        self.creation = creation      # takes no array input; `invoke` hands
        #   it the call's context as ``ctx=`` (eye, linspace, the draws)
        self.random = random          # draws from the context's generator
        self.num_outputs = num_outputs
        self.doc = doc or (fn.__doc__ if fn else None)
        self.cuda_fn = None           # optional hand-written CUDA kernel path
        self.shape_hint = None        # fn(in_shapes, kwargs) -> in_shapes:
        #   fills unknown (None) input shapes from known ones, the forward
        #   half of the reference's FInferShape (`ops.shape_hints`)

    def cuda_impl(self, fn):
        """Register the implementation that runs on a GPU context (a
        hand-written kernel's wrapper)."""
        self.cuda_fn = fn
        return fn

    def best_fn(self, on_gpu):
        if on_gpu and self.cuda_fn is not None:
            return self.cuda_fn
        return self.fn

    def __repr__(self):
        return "Operator(%s)" % self.name


def register(name, **meta):
    """Decorator: register a torch-level op implementation under `name`."""
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError("op %s already registered" % name)
        _REGISTRY[name] = Operator(name, fn, **meta)
        return fn
    return deco


def alias(existing, *names):
    """Register additional names for an op."""
    op = _REGISTRY[existing]
    for n in names:
        _REGISTRY[n] = op


def get(name):
    return _REGISTRY[name]


def list_ops():
    return sorted(_REGISTRY)


def prefixed(prefix):
    """(short name, op name) of every op whose name starts with `prefix`:
    the reference's `contrib`, `image` and `linalg` sub-namespaces."""
    return [(n[len(prefix):], n) for n in list_ops() if n.startswith(prefix)]
