"""`mx.nd`: the imperative NDArray namespace (the port of
`mxnet_tpu.ndarray`). Every registered op appears here as a function,
generated from the registry; the sub-namespaces are built as the
reference builds them: `nd.random` (the reference's public draws),
`nd.image` and `nd.linalg` (the `_image_*` and `linalg_*` ops under their
short names), `nd.contrib` (every `_contrib_*` op under its short name,
and the control flow `foreach`/`while_loop`/`cond`) and `nd.Custom`."""
import sys as _sys
import types as _types

from .. import random as _random
from ..ops import contrib_vision as _contrib_vision  # noqa: F401 (registers)
from ..ops import extended as _extended  # noqa: F401
from ..ops import fused_conv as _fused_conv  # noqa: F401
from ..ops import image_ops as _image_ops  # noqa: F401
from ..ops import nn as _nn  # noqa: F401
from ..ops import optimizer_ops as _optimizer_ops  # noqa: F401
from ..ops import quantization_ops as _quantization_ops  # noqa: F401
from ..ops import random_ops as _random_ops  # noqa: F401
from ..ops import registry as _reg
from ..ops import rnn_ops as _rnn_ops  # noqa: F401
from ..ops import sparse_ops as _sparse_ops  # noqa: F401
from ..ops import tensor as _tensor  # noqa: F401
from ..ops import shape_hints as _shape_hints  # noqa: F401,E402
from . import register as _register
from . import sparse  # noqa: F401  (row_sparse / csr)
from .contrib_flow import cond as _cond, foreach as _foreach, \
    while_loop as _while_loop
from .ndarray import (NDArray, arange, array, invoke, load, ones, save,
                      split_v2, zeros)

_register.populate(globals())

def _namespace(short, pairs):
    mod = _types.ModuleType(__name__ + "." + short)
    for public, full in pairs:
        setattr(mod, public, _register.make_op_func(full))
    _sys.modules[mod.__name__] = mod
    return mod


random = _namespace("random", _random.OPS.items())
image = _namespace("image", _reg.prefixed("_image_"))
linalg = _namespace("linalg", _reg.prefixed("linalg_"))
contrib = _namespace("contrib", _reg.prefixed("_contrib_"))
contrib.foreach = _foreach
contrib.while_loop = _while_loop
contrib.cond = _cond


def Custom(*args, **kwargs):
    """Run a registered custom op (`mx.operator`): ``op_type=`` names
    it."""
    from ..operator import invoke_custom
    return invoke_custom(*args, **kwargs)
