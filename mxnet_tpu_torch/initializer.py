"""Weight initializers (the port of the part of `mxnet_tpu.initializer`
that Gluon layers reach): `Initializer` with the reference's dispatch on
the parameter's name ("...weight", "...bias", "...gamma", ...), and
`Zero`, `One`, `Constant`, `Uniform`, `Normal`, `Xavier` and `FusedRNN`
(the flat parameter vector of the `RNN` op).

Random draws come from `mxnet_tpu_torch.random`, so `mx.random.seed` makes
initialization reproducible (though not equal to the reference's).
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Xavier", "FusedRNN"]

_INIT_REGISTRY = {}


class InitDesc(str):
    """Name + attrs descriptor handed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def register(klass):
    """Register an initializer class under its lowercased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs):
    """An initializer from a registered name, its `dumps()` JSON, an
    instance or None."""
    if init is None:
        return None
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str) and init.startswith("["):
        name, kw = json.loads(init)
        return _INIT_REGISTRY[name.lower()](**kw)
    if isinstance(init, str):
        return _INIT_REGISTRY[init.lower()](**kwargs)
    raise TypeError("cannot create initializer from %r" % (init,))


class Initializer:
    """Base class: dispatches on the parameter's name."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """JSON [name, kwargs]."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            # a parameter's own initializer, as `dumps` serialized it, or a
            # bare registered name ("zeros")
            create(init)._init_weight(desc, arr)
            return
        name = str(desc)
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta") \
                or name.endswith("running_mean") \
                or name.endswith("moving_mean") or name.endswith("min"):
            arr[:] = 0.0
        elif name.endswith("gamma") or name.endswith("running_var") \
                or name.endswith("moving_var") or name.endswith("max"):
            arr[:] = 1.0
        else:
            self._init_weight(desc, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override _init_weight")

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, ", ".join(
            "%s=%r" % kv for kv in self._kwargs.items()))

    def __eq__(self, other):
        return type(self) is type(other) and self._kwargs == other._kwargs

    __hash__ = object.__hash__


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


_INIT_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        if isinstance(self.value, (list, tuple, np.ndarray)):
            arr[:] = np.asarray(self.value, dtype=np.float32).reshape(
                arr.shape)
        else:
            arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale); default scale 0.07, as the reference."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        from . import random as _r
        arr[:] = _r.uniform(-self.scale, self.scale, shape=arr.shape,
                            ctx=arr.context)


@register
class Normal(Initializer):
    """N(0, sigma); default sigma 0.01, as the reference."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        from . import random as _r
        arr[:] = _r.normal(0, self.sigma, shape=arr.shape, ctx=arr.context)


@register
class Xavier(Initializer):
    """Glorot init: `rnd_type` "uniform" or "gaussian", `factor_type`
    "avg", "in" or "out", scale sqrt(magnitude / factor). Fans are
    shape[1] and shape[0] times the product of the trailing dims, as the
    reference computes them for every weight layout."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot init %s with shape "
                             "%s: at least 2D" % (name, shape))
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in, "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise ValueError("Incorrect factor type")
        scale = float(np.sqrt(self.magnitude / factor))
        from . import random as _r
        if self.rnd_type == "uniform":
            arr[:] = _r.uniform(-scale, scale, shape=shape, ctx=arr.context)
        elif self.rnd_type == "gaussian":
            arr[:] = _r.normal(0, scale, shape=shape, ctx=arr.context)
        else:
            raise ValueError("Unknown random type")


@register
class FusedRNN(Initializer):
    """The flat parameter vector of the `RNN` op, in the layout
    `ops/rnn_ops.py::_slice_params` reads: per layer and direction the
    i2h and h2h weight blocks, then all biases. `init` (an Initializer, a
    registered name, or None for the net's global initializer) fills each
    weight block as a weight named ``<name>_l<layer>[_r]_<i2h|h2h>_weight``;
    the biases are zero but the LSTM forget gate's, which gets
    `forget_bias`."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            init = create(init)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from . import ndarray as nd
        from .ops.rnn_ops import _gates, rnn_solve_input_size
        mode = {"rnn": "rnn_tanh"}.get(self._mode, self._mode)
        ng = _gates(mode)
        h = self._num_hidden
        ndir = 2 if self._bidirectional else 1
        L = self._num_layers
        total = int(np.prod(arr.shape))
        in_sz = rnn_solve_input_size(mode, total, h, L, self._bidirectional)
        flat = np.zeros((total,), dtype=np.float32)
        off = 0
        name = str(desc)
        block_init = self._init or getattr(desc, "global_init", None)
        for layer in range(L):
            for d in range(ndir):
                cur_in = in_sz if layer == 0 else h * ndir
                for part, shape in (("i2h", (ng * h, cur_in)),
                                    ("h2h", (ng * h, h))):
                    n = int(np.prod(shape))
                    if block_init is not None:
                        block = nd.zeros(shape, ctx=arr.context,
                                         dtype="float32")
                        # the block's own name, without the vector's
                        # __init__ (which names this initializer)
                        attrs = {k: v for k, v in getattr(
                            desc, "attrs", {}).items() if k != "__init__"}
                        block_init(InitDesc(
                            "%s_l%d%s_%s_weight" % (name, layer,
                                                    "_r" if d else "", part),
                            attrs), block)
                        flat[off:off + n] = block.asnumpy().reshape(-1)
                    off += n
        # biases: zeros, but the LSTM forget gate's (gate order [i,f,g,o])
        if mode == "lstm" and self._forget_bias:
            boff = off
            for _ in range(L * ndir * 2):
                flat[boff + h:boff + 2 * h] = self._forget_bias
                boff += ng * h
        arr[:] = flat.reshape(arr.shape)
