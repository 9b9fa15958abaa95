"""The port's `mx.np` surface against the reference's catalog.

The reference's catalog of tests/test_numpy_catalog.py (at least 400
names over `mx.np`, `mx.np.linalg`, `mx.np.random` and `mx.npx`) resolves
in the port, and the port's public names on each namespace include every
one of the reference's (less the names its modules import for their own
use: `annotations`, and jax's `jnp` and `from_jax`).
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

# the reference's catalog, read from its own test file
from test_numpy_catalog import (LINALG_FUNCS, NP_CONSTANTS, NP_DTYPES,
                                      NP_FUNCS, NPX_FUNCS, RANDOM_FUNCS)

IMPORTED = {"annotations", "jnp", "from_jax"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")} - IMPORTED


SPACES = [("np", lambda p: p.np, 400), ("npx", lambda p: p.npx, 40),
          ("np.random", lambda p: p.np.random, 32),
          ("np.linalg", lambda p: p.np.linalg, 19)]


@pytest.mark.parametrize("name,get,least", SPACES,
                         ids=[s[0] for s in SPACES])
def test_port_exposes_every_reference_name(name, get, least):
    ref, port = _public(get(jmx)), _public(get(mx))
    assert len(ref) >= least, (name, len(ref))
    assert ref <= port, sorted(ref - port)


def test_reference_counts():
    """The reference's public names: 410 on np (as dir() lists them), 42
    on npx, 32 on np.random, 19 on np.linalg (less their imports)."""
    raw = {n: len([x for x in dir(m) if not x.startswith("_")])
           for n, m in (("np", jmx.np), ("npx", jmx.npx),
                        ("random", jmx.np.random),
                        ("linalg", jmx.np.linalg))}
    assert raw["np"] == 410
    assert len(_public(jmx.npx)) == 43 and "invoke" in _public(jmx.npx)
    assert len(_public(jmx.npx) - {"invoke"}) == 42
    assert len(_public(jmx.np.random) - {"NDArray", "invoke"}) == 32
    assert len(_public(jmx.np.linalg) - {"invoke", "as_np_ndarray"}) == 19


def test_np_function_catalog_resolves():
    missing = [n for n in NP_FUNCS if not callable(getattr(mx.np, n, None))]
    assert not missing, missing


def test_np_constants_and_dtypes():
    for n in NP_CONSTANTS:
        assert hasattr(mx.np, n), n
    missing = [n for n in NP_DTYPES if not hasattr(mx.np, n)]
    assert not missing, missing
    assert mx.np.float32 is onp.float32
    assert mx.np.dtype("int64") == onp.int64
    assert mx.np.bfloat16 == "bfloat16"


@pytest.mark.parametrize("space,names", [
    ("linalg", LINALG_FUNCS), ("random", RANDOM_FUNCS), ("npx", NPX_FUNCS)])
def test_linalg_random_npx_catalogs(space, names):
    mod = mx.npx if space == "npx" else getattr(mx.np, space)
    missing = [n for n in names if not callable(getattr(mod, n, None))]
    assert not missing, missing


def test_total_surface_size():
    total = (len(set(NP_FUNCS)) + len(set(NP_CONSTANTS)) +
             len(set(NP_DTYPES)) + len(set(LINALG_FUNCS)) +
             len(set(RANDOM_FUNCS)) + len(set(NPX_FUNCS)))
    assert total >= 400, total
    assert len([n for n in dir(mx.np) if not n.startswith("_")]) >= 380


def test_ndarray_method_surface():
    methods = """
    item tolist tobytes astype copy all any argsort argmax argmin cumsum
    cumprod std var dot diagonal trace nonzero searchsorted ptp conj
    conjugate compress repeat take clip round mean sum prod max min sort
    fill flatten ravel reshape transpose squeeze expand_dims swapaxes
    broadcast_to tile as_nd_ndarray attach_grad backward detach asnumpy
    """.split()
    with mx.cpu():
        x = mx.np.array([[1.0, 2.0], [3.0, 4.0]])
    missing = [m for m in methods if not callable(getattr(x, m, None))]
    assert not missing, missing
    props = ["T", "shape", "dtype", "size", "ndim", "itemsize", "nbytes",
             "real", "imag", "flat", "context", "grad"]
    missing = [p for p in props if not hasattr(type(x), p)]
    assert not missing, missing


def test_util_np_names():
    for n in ("set_np", "reset_np", "is_np_array", "is_np_shape",
              "np_array", "np_shape", "use_np", "default_array"):
        assert callable(getattr(mx.util, n)), n
        assert callable(getattr(jmx.util, n)), n
