"""`mx.sym`: the symbolic namespace (the port of `mxnet_tpu.symbol`),
generated from the op registry, with the `random`, `contrib` (the
`_contrib_*` ops and the control flow of `nd.contrib`), `image`, `linalg`
and `sparse` sub-namespaces of the reference."""
import sys as _sys
import types as _types

from .. import ndarray as _nd  # noqa: F401  (registers every op)
from .. import random as _random
from ..ndarray.contrib_flow import cond as _cond, foreach as _foreach, \
    while_loop as _while_loop
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


random = _sub("random", [(n, _random.OPS[n]) for n in _random.SYMBOL_NAMES])
contrib = _sub("contrib", _reg_mod.prefixed("_contrib_"))
contrib.foreach = _foreach
contrib.while_loop = _while_loop
contrib.cond = _cond
image = _sub("image", _reg_mod.prefixed("_image_"))
linalg = _sub("linalg", _reg_mod.prefixed("linalg_"))
sparse = _sub("sparse", [(n, n) for n in (
    "dot", "elemwise_add", "cast_storage", "zeros_like", "square", "sqrt",
    "abs", "sum", "mean", "clip", "sign", "where", "negative")
    if n in _ALL_OPS])

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "arange", "Executor", "random", "contrib",
           "image", "linalg", "sparse"]
