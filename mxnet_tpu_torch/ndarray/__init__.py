"""`mx.nd`: the imperative NDArray namespace (the port of
`mxnet_tpu.ndarray`). Every registered op appears here as a function,
generated from the registry, and every `_contrib_*` op under its short name
in `nd.contrib`."""
import sys as _sys
import types as _types

from ..ops import fused_conv as _fused_conv  # noqa: F401 (registers ops)
from ..ops import nn as _nn  # noqa: F401
from ..ops import optimizer_ops as _optimizer_ops  # noqa: F401
from ..ops import registry as _reg
from ..ops import sparse_ops as _sparse_ops  # noqa: F401
from ..ops import tensor as _tensor  # noqa: F401
from . import register as _register
from . import sparse  # noqa: F401  (row_sparse / csr)
from .ndarray import (NDArray, arange, array, invoke, load, ones, save,
                      zeros)

_register.populate(globals())

contrib = _types.ModuleType(__name__ + ".contrib")
for _full in _reg.list_ops():
    if _full.startswith("_contrib_"):
        setattr(contrib, _full[len("_contrib_"):],
                _register.make_op_func(_full))
_sys.modules[contrib.__name__] = contrib
