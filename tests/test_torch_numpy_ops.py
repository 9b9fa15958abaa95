"""The port's `_np_*` ops against the reference's, op by op.

One shared table of cases covers the reference's 275 `_np_<name>` ops and
16 `_np_linalg_<name>` ops: the same seeded numpy inputs go through
`mxnet_tpu.np` (jax.numpy under the reference's `invoke`) and
`mxnet_tpu_torch.np` (torch on the CPU).

- Forward: float32 results within 1e-6 of the reference relative to the
  result's largest magnitude, integer and bool results exact, and the
  dtypes equal. A case may be looser where it says why (FORWARD_TOL).
- Gradients: for each differentiable op, the gradient of
  sum(out * cot) with respect to every float input, the port's through
  its autograd and the reference's through its own, within 1e-5.
- The port registers exactly the reference's 291 `_np_*` names, with its
  `differentiable` flags.
- The conventions at kinks and ties are jax.vjp's (one test each).
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as ref_registry
from mxnet_tpu_torch.ops import registry as port_registry
from mxnet_tpu_torch.ops.numpy_ops import FUNCS, LINALG_FUNCS

from _torch_numpy_cases import (A, B, CASES, FORWARD_TOL, GRAD_TOL,
                                GRAD_TOL_LOOSE, LINALG, SEQ_UNPACKED,
                                VECTOR_OUTPUTS)


# callables: the port's take tensors, the reference's jax arrays; the
# helpers above work on both. mask_indices takes the namespace's triu.
ALL = [(n, i, False) for n, cs in CASES.items() for i in range(len(cs))] + \
    [(n, i, True) for n, cs in LINALG.items() for i in range(len(cs))]


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _conv(pkg, a, name=None):
    if isinstance(a, onp.ndarray):
        return pkg.np.array(a)
    if isinstance(a, list) and a and isinstance(a[0], onp.ndarray) and \
            name in SEQ_UNPACKED:
        return [pkg.np.array(x) for x in a]
    return a


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flat(o)]
    return [out]


def _host(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _fn(pkg, name, linalg):
    return getattr(pkg.np.linalg if linalg else pkg.np, name)


def _forward(pkg, name, args, kw, linalg):
    # keyword arrays stay numpy: the reference hands keywords to jax.numpy
    # as they are
    args = [_conv(pkg, a, name) for a in args]
    return _flat(_fn(pkg, name, linalg)(*args, **kw))


def _case(name, i, linalg):
    return (LINALG if linalg else CASES)[name][i]


def _close(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "fc":
        scale = max(1.0, float(onp.nanmax(onp.abs(want)))
                    if want.size else 1.0)
        onp.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                                    equal_nan=True, err_msg=what)
    else:
        onp.testing.assert_array_equal(got, want, err_msg=what)


def _check_vectors(name, args, port_outs, ref_outs, tol):
    a = args[0]
    p = [_host(o) for o in port_outs]
    r = [_host(o) for o in ref_outs]
    if name == "svd":
        u, s, vh = p
        _close(s, r[1], tol, "singular values")
        _close((u * s) @ vh, a, tol, "reconstruction")
    elif name == "qr":
        q, rr = p
        _close(onp.abs(rr), onp.abs(r[1]), tol, "|R|")
        _close(q @ rr, a, tol, "reconstruction")
    elif name == "eigh":
        w, v = p
        _close(w, r[0], tol, "eigenvalues")
        _close((a @ v), v * w, tol, "A v = w v")
    elif name == "eig":
        w, v = p
        _close(onp.sort_complex(w), onp.sort_complex(r[0]), tol,
               "eigenvalues")
        _close(a @ v, v * w, tol, "A v = w v")


@pytest.mark.parametrize("name,i,linalg", ALL,
                         ids=["%s%s-%d" % ("linalg." if la else "", n, i)
                              for n, i, la in ALL])
def test_forward_matches_reference(name, i, linalg):
    args, kw = _case(name, i, linalg)
    got = _forward(mx, name, args, kw, linalg)
    want = _forward(jmx, name, args, kw, linalg)
    assert len(got) == len(want), (len(got), len(want))
    tol = FORWARD_TOL.get(name, 1e-6)
    for k, (g, w) in enumerate(zip(got, want)):
        # the reference's histogramdd edges are an array over a list of
        # jax arrays, whose type shows only on the host
        gd = onp.dtype(g.dtype)
        wd = onp.dtype(w.dtype) if hasattr(w, "dtype") else _host(w).dtype
        assert gd == wd, "output %d: dtype %s, reference %s" % (k, gd, wd)
        assert type(g) is mx.np.ndarray, type(g)
    if name in VECTOR_OUTPUTS:
        _check_vectors(name, args, got, want, tol)
        return
    for k, (g, w) in enumerate(zip(got, want)):
        _close(_host(g), _host(w), tol, "%s output %d" % (name, k))


def _diff_names():
    return {n for n, d in FUNCS if d} | {"fix"}


def _leaves(pkg, name, args):
    conv = [_conv(pkg, a, name) for a in args]
    leaves = []

    def mark(x):
        if isinstance(x, pkg.nd.NDArray) and onp.dtype(x.dtype).kind == "f":
            x.attach_grad()
            leaves.append(x)
    for a in conv:
        mark(a)
    return conv, leaves


# outputs a gradient is taken through, where not all: an eigenvector's
# sign differs between LAPACK calls, so its cotangent is not comparable
GRAD_OUTPUTS = {"eigh": (0,)}


def _grads(pkg, name, args, kw, linalg):
    conv, leaves = _leaves(pkg, name, args)
    with pkg.autograd.record():
        outs = _flat(_fn(pkg, name, linalg)(*conv, **kw))
        total = None
        for k, o in enumerate(outs):
            if onp.dtype(o.dtype).kind != "f" or k not in GRAD_OUTPUTS.get(
                    name, (k,)):
                continue
            cot = onp.random.RandomState(100 + k).uniform(
                0.5, 1.5, o.shape).astype("float32")
            term = (o * pkg.np.array(cot)).sum()
            total = term if total is None else total + term
    total.backward()
    return [_host(x.grad) for x in leaves]


# differentiable ops and the case their gradient is held on: the first
# case whose array inputs are float (sequences are unpacked by both
# packages' surfaces, so their arrays are top-level inputs of the op)
def _grad_case(name, linalg):
    cases = (LINALG if linalg else CASES)[name]
    for args, kw in cases:
        if any(isinstance(a, onp.ndarray) and a.dtype.kind == "f"
               for a in args):
            return args, kw
    return None


# the reference records only its ops' top-level array arguments; these
# take their float arrays inside a list, or take callables
GRAD_SKIP = {"select", "choose", "concatenate", "concat", "stack", "vstack",
             "hstack", "dstack", "column_stack", "multi_dot"}
GRAD_ALL = [(n, False) for n in sorted(_diff_names())
            if n in CASES and n not in GRAD_SKIP and _grad_case(n, False)] \
    + [(n, True) for n, d, _ in LINALG_FUNCS
       if d and n not in GRAD_SKIP and _grad_case(n, True)]


@pytest.mark.parametrize("name,linalg", GRAD_ALL,
                         ids=["%s%s" % ("linalg." if la else "", n)
                              for n, la in GRAD_ALL])
def test_gradient_matches_reference(name, linalg):
    args, kw = _grad_case(name, linalg)
    got = _grads(mx, name, args, kw, linalg)
    want = _grads(jmx, name, args, kw, linalg)
    tol = GRAD_TOL_LOOSE.get(name, GRAD_TOL)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, tol, "%s grad %d" % (name, k))


@pytest.mark.parametrize("name", sorted(GRAD_SKIP))
def test_sequence_gradient_matches_reference(name):
    """Ops whose arrays come in a list: the gradients with respect to each
    array (the reference's through jax.grad of the same function)."""
    import jax
    import jax.numpy as jnp
    cases = (LINALG if name == "multi_dot" else CASES)[name]
    args, kw = cases[0]
    seq = args[1] if name in ("select", "choose") else args[0]
    conv = [mx.np.array(a) for a in seq]
    for x in conv:
        x.attach_grad()
    other = [_conv(mx, a) for a in args if not isinstance(a, list)]
    fn = _fn(mx, name, name == "multi_dot")
    with mx.autograd.record():
        if name == "select":
            out = fn([mx.np.array(A > 0.5), mx.np.array(A < -0.5)], conv,
                     **kw)
        elif name == "choose":
            out = fn(mx.np.array(args[0]), conv)
        else:
            out = fn(conv, *other, **kw)
        cot = onp.random.RandomState(100).uniform(0.5, 1.5, out.shape)
        loss = (out * mx.np.array(cot.astype("float32"))).sum()
    loss.backward()
    got = [_host(x.grad) for x in conv]

    jfn = jnp.linalg.multi_dot if name == "multi_dot" else getattr(jnp, name)

    def f(*xs):
        if name == "select":
            o = jfn([jnp.asarray(A > 0.5), jnp.asarray(A < -0.5)], list(xs),
                    **kw)
        elif name == "choose":
            o = jfn(jnp.asarray(args[0]), list(xs))
        else:
            o = jfn(list(xs), **kw)
        return jnp.sum(o * jnp.asarray(cot.astype("float32")))
    want = jax.grad(f, argnums=tuple(range(len(seq))))(
        *[jnp.asarray(a) for a in seq])
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, onp.asarray(w), GRAD_TOL_LOOSE.get(name, GRAD_TOL),
               "%s grad %d" % (name, k))


def test_registry_holds_the_reference_numpy_ops():
    ref = {n for n in ref_registry.list_ops() if n.startswith("_np_")}
    port = {n for n in port_registry.list_ops() if n.startswith("_np_")}
    assert len(ref) == 291
    assert port == ref
    flags = {n: port_registry.get(n).differentiable for n in port}
    want = {n: ref_registry.get(n).differentiable for n in ref}
    assert flags == want


def test_every_op_has_a_case():
    names = {n for n, _ in FUNCS} | {"fix"}
    assert names <= set(CASES), sorted(names - set(CASES))
    assert {n for n, _, _ in LINALG_FUNCS} <= set(LINALG)


def test_mask_indices_and_creation_match_reference():
    got = mx.np.mask_indices(4, mx.np.triu, 1)
    import jax.numpy as jnp
    want = jmx.np.mask_indices(4, jnp.triu, 1)
    for g, w in zip(got, want):
        _close(_host(g), _host(w), 0, "mask_indices")
        assert onp.dtype(g.dtype) == onp.dtype(w.dtype)


CREATION = [
    ("zeros", ((2, 3),), {}), ("ones", ((2,),), {"dtype": "int32"}),
    ("empty", ((3,),), {}), ("full", ((2, 2), 7), {}),
    ("full", ((2,), 1.5), {}), ("arange", (5,), {}),
    ("arange", (0.0, 1.0, 0.1), {}), ("arange", (2, 11, 3), {}),
    ("linspace", (0.0, 1.0, 7), {}), ("linspace", (-2, 5, 4),
                                      {"endpoint": False}),
    ("logspace", (0.0, 2.0, 5), {}), ("geomspace", (1.0, 64.0, 7), {}),
    ("eye", (3,), {}), ("eye", (3, 4), {"k": 1}), ("identity", (3,), {}),
    ("tri", (3,), {}), ("tri", (3, 5), {"k": -1}),
    ("indices", ((2, 3),), {}), ("bartlett", (8,), {}),
    ("blackman", (8,), {}), ("hamming", (8,), {}), ("hanning", (8,), {}),
    ("kaiser", (8, 3.0), {}), ("tril_indices", (3,), {}),
    ("triu_indices", (4,), {"k": 1}), ("diag_indices", (3,), {}),
]


@pytest.mark.parametrize("name,args,kw", CREATION,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(CREATION)])
def test_creation_matches_reference(name, args, kw):
    got = _flat(getattr(mx.np, name)(*args, **kw))
    want = _flat(getattr(jmx.np, name)(*args, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert onp.dtype(g.dtype) == onp.dtype(w.dtype), (g.dtype, w.dtype)
        _close(_host(g), _host(w), 1e-6, name)


# ---------------------------------------------------------------------------
# conventions at kinks and ties: jax.vjp's
# ---------------------------------------------------------------------------
TIES = [
    ("abs", (onp.array([0.0, -1.0, 2.0], "float32"),), {}),
    ("amax", (onp.array([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0]], "float32"),),
     {"axis": 1}),
    ("max", (onp.array([3.0, 1.0, 3.0], "float32"),), {}),
    ("min", (onp.array([1.0, 1.0, 3.0], "float32"),), {}),
    ("ptp", (onp.array([1.0, 5.0, 5.0, 1.0], "float32"),), {}),
    ("median", (onp.array([2.0, 1.0, 2.0, 2.0], "float32"),), {}),
    ("maximum", (onp.array([1.0, 2.0], "float32"),
                 onp.array([1.0, 0.0], "float32")), {}),
    ("fmax", (onp.array([1.0, 2.0], "float32"),
              onp.array([1.0, 0.0], "float32")), {}),
    ("clip", (onp.array([-0.5, 0.0, 0.5, 1.0], "float32"), 0.0, 0.5), {}),
    ("sort", (onp.array([2.0, 1.0, 2.0, 0.0], "float32"),), {}),
    ("where", (onp.array([True, False]), onp.array([1.0, 1.0], "float32"),
               onp.array([1.0, 1.0], "float32")), {}),
]


@pytest.mark.parametrize("name,args,kw", TIES, ids=[t[0] for t in TIES])
def test_gradient_at_kinks_and_ties_follows_jax(name, args, kw):
    got = _grads(mx, name, args, kw, False)
    want = _grads(jmx, name, args, kw, False)
    for g, w in zip(got, want):
        _close(g, w, 1e-6, name)
