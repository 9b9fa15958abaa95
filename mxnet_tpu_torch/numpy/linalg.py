"""`mx.np.linalg` (the port of `mxnet_tpu.numpy.linalg`).

Each function is one `_np_linalg_<name>` op on `torch.linalg`, run through
`invoke` (it records under `autograd.record()`); `svd` gives the reduced
factorization, and every multi-output result is a plain sequence. `det`,
`slogdet` and `inv` are the `mx.nd.linalg` ops `linalg_det`,
`linalg_slogdet` and `linalg_inverse`, not registered twice.
"""
from __future__ import annotations

from ..ndarray.ndarray import invoke  # noqa: F401 (the reference's name)
from ..ops.numpy_ops import LINALG_FUNCS
from . import _call
from .multiarray import as_np_ndarray  # noqa: F401

_ALIASED = {"det": "linalg_det", "slogdet": "linalg_slogdet",
            "inv": "linalg_inverse"}


def _make(op_name, public_name, seq):
    def fn(*args, **kwargs):
        if seq and args and isinstance(args[0], (list, tuple)):
            args = tuple(args[0]) + tuple(args[1:])
        return _call(op_name, args, kwargs)
    fn.__name__ = fn.__qualname__ = public_name
    fn.__doc__ = "numpy-compatible linalg.%s (the `%s` op)" % (
        public_name, op_name)
    return fn


_here = globals()
for _name, _diff, _nout in LINALG_FUNCS:
    _here[_name] = _make("_np_linalg_" + _name, _name, _name == "multi_dot")
for _name, _existing in _ALIASED.items():
    _here[_name] = _make(_existing, _name, False)

__all__ = sorted([n for n, _, _ in LINALG_FUNCS] + list(_ALIASED))
