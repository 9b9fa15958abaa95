"""`mx.sym`: the symbolic namespace (the port of `mxnet_tpu.symbol`),
generated from the op registry, with the `random`, `contrib`, `image`,
`linalg` and `sparse` sub-namespaces holding what the port's registry
has."""
import sys as _sys
import types as _types

from .. import ndarray as _nd  # noqa: F401  (registers every op)
from ..ops import registry as _reg_mod
from .executor import Executor
from .symbol import (Group, Symbol, Variable, _make_op, arange, load,
                     load_json, ones, populate, var, zeros)

populate(globals())

_ALL_OPS = set(_reg_mod.list_ops())


def _sub(short, pairs):
    mod = _types.ModuleType(__name__ + "." + short)
    for public, full in pairs:
        setattr(mod, public, _make_op(full))
    _sys.modules[mod.__name__] = mod
    return mod


random = _sub("random", [(pub, src) for pub, src in [
    ("uniform", "_random_uniform"), ("normal", "_random_normal"),
    ("randint", "_random_randint"), ("gamma", "_random_gamma"),
    ("exponential", "_random_exponential"), ("poisson", "_random_poisson"),
    ("multinomial", "_sample_multinomial"), ("shuffle", "_shuffle")]
    if src in _ALL_OPS])
contrib = _sub("contrib", [(n[len("_contrib_"):], n) for n in sorted(_ALL_OPS)
                           if n.startswith("_contrib_")])
image = _sub("image", [(n[len("_image_"):], n) for n in sorted(_ALL_OPS)
                       if n.startswith("_image_")])
linalg = _sub("linalg", [(n[len("linalg_"):], n) for n in sorted(_ALL_OPS)
                         if n.startswith("linalg_")])
sparse = _sub("sparse", [(n, n) for n in (
    "dot", "elemwise_add", "cast_storage", "zeros_like", "square", "sqrt",
    "abs", "sum", "mean", "clip", "sign", "where", "negative")
    if n in _ALL_OPS])

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "arange", "Executor", "random", "contrib",
           "image", "linalg", "sparse"]
