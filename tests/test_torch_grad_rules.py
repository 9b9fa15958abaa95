"""The port's gradients of `dot`, `FullyConnected` and ops with an integer
input, held to closed forms and numpy finite differences.

The reference's hand-written rules (mxnet_tpu/ops/grad_rules.py) are not
the yardstick here: `_dot_grad` and `_fc_grad` return a cotangent for
every operand whatever was recorded, and `_per_arg`/`_unary` cast
cotangents to an integer input's dtype. The port's gradients come from
torch.autograd; these tests hold them where those rules go wrong: one
operand not recorded, and an integer operand beside a float one. Closed
forms agree within 1e-6 (fp32); finite differences (float64, step 1e-6)
within 1e-6.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mx

TOL = 1e-6


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu():
        yield


def _rand(*shape, seed=0, dtype="float32"):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _grads(fn, arrays, recorded, cot):
    """fn(*NDArrays) under record with only `recorded` attached; the
    gradients of sum(out * cot) (None where not recorded)."""
    nds = [mx.nd.array(a, dtype=a.dtype) for a in arrays]
    for i in recorded:
        nds[i].attach_grad()
    with mx.autograd.record():
        out = fn(*nds)
        loss = (out * mx.nd.array(cot, dtype=cot.dtype)).sum()
    loss.backward()
    return out.asnumpy(), [nds[i].grad.asnumpy() if i in recorded else None
                           for i in range(len(nds))]


@pytest.mark.parametrize("recorded", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_dot_gradients_with_one_operand_not_recorded(recorded, ta, tb):
    a = _rand(*((4, 3) if ta else (3, 4)), seed=1)
    b = _rand(*((5, 4) if tb else (4, 5)), seed=2)
    cot = _rand(3, 5, seed=3)
    out, (ga, gb) = _grads(lambda x, y: mx.nd.dot(x, y, transpose_a=ta,
                                                  transpose_b=tb),
                           [a, b], recorded, cot)
    A = a.T if ta else a
    Bm = b.T if tb else b
    np.testing.assert_allclose(out, A @ Bm, rtol=TOL, atol=TOL)
    dA, dB = cot @ Bm.T, A.T @ cot
    want = {0: dA.T if ta else dA, 1: dB.T if tb else dB}
    for i, g in enumerate((ga, gb)):
        if i in recorded:
            np.testing.assert_allclose(g, want[i], rtol=TOL, atol=TOL)
        else:
            assert g is None


@pytest.mark.parametrize("recorded", [(0,), (1,), (2,), (1, 2), (0, 1, 2)])
@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected_gradients_with_operands_not_recorded(recorded,
                                                              flatten):
    x = _rand(2, 3, 4, seed=4)
    in_units = 12 if flatten else 4
    w = _rand(6, in_units, seed=5)
    b = _rand(6, seed=6)
    out_shape = (2, 6) if flatten else (2, 3, 6)
    cot = _rand(*out_shape, seed=7)
    out, (gx, gw, gb) = _grads(
        lambda d, wt, bs: mx.nd.FullyConnected(d, wt, bs, num_hidden=6,
                                               flatten=flatten),
        [x, w, b], recorded, cot)
    X = x.reshape(2, 12) if flatten else x
    np.testing.assert_allclose(out, X @ w.T + b, rtol=TOL, atol=TOL)
    c2 = cot.reshape(-1, 6)
    want = {0: (cot @ w).reshape(x.shape),
            1: c2.T @ X.reshape(-1, in_units),
            2: c2.sum(axis=0)}
    for i, g in enumerate((gx, gw, gb)):
        if i in recorded:
            np.testing.assert_allclose(g, want[i], rtol=TOL, atol=TOL,
                                       err_msg=str(i))
        else:
            assert g is None


@pytest.mark.parametrize("op", ["broadcast_add", "broadcast_sub",
                                "broadcast_mul", "broadcast_div"])
def test_float_gradient_beside_an_integer_operand(op):
    """d/dx of x (op) k with k int32: the float cotangent, not one cast to
    the integer's dtype (k = 3 makes x / k's gradient 1/3, which an int
    cast would zero)."""
    x = _rand(3, 4, seed=8)
    k = np.full((3, 4), 3, "int32")
    cot = _rand(3, 4, seed=9)
    _, (gx, _) = _grads(lambda a, b: mx.nd.invoke(op, a, b), [x, k], (0,),
                        cot)
    want = {"broadcast_add": cot, "broadcast_sub": cot,
            "broadcast_mul": cot * 3, "broadcast_div": cot / 3}[op]
    np.testing.assert_allclose(gx, want, rtol=TOL, atol=TOL)


def test_integer_index_inputs_take_no_gradient():
    """Embedding and pick with int32 indices: the float operand's gradient
    is the scattered cotangent; the indices get none."""
    ids = np.array([[1, 3, 1], [0, 3, 3]], "int32")
    table = _rand(5, 2, seed=10)
    cot = _rand(2, 3, 2, seed=11)
    _, (_, gt) = _grads(lambda i, w: mx.nd.Embedding(i, w, input_dim=5,
                                                     output_dim=2),
                        [ids, table], (1,), cot)
    want = np.zeros_like(table)
    np.add.at(want, ids.reshape(-1), cot.reshape(-1, 2))
    np.testing.assert_allclose(gt, want, rtol=TOL, atol=TOL)
    x = _rand(4, 3, seed=12)
    idx = np.array([2, 0, 1, 2], "int32")
    cot = _rand(4, seed=13)
    _, (gx, _) = _grads(lambda a, i: mx.nd.pick(a, i, axis=1), [x, idx],
                        (0,), cot)
    want = np.zeros_like(x)
    want[np.arange(4), idx] = cot
    np.testing.assert_allclose(gx, want, rtol=TOL, atol=TOL)


def test_composite_against_finite_differences():
    """tanh(FC(dot(a, b))) in float64, only a and the FC weight recorded:
    each gradient entry against a central difference of numpy's value."""
    a = _rand(3, 4, seed=14, dtype="float64")
    b = _rand(4, 5, seed=15, dtype="float64")
    w = _rand(2, 5, seed=16, dtype="float64")
    cot = _rand(3, 2, seed=17, dtype="float64")

    def f(*t):
        return mx.nd.tanh(mx.nd.FullyConnected(mx.nd.dot(t[0], t[1]), t[2],
                                               None, no_bias=True,
                                               num_hidden=2))
    _, (ga, gb, gw) = _grads(f, [a, b, w], (0, 2), cot)
    assert gb is None

    def value(a_, w_):
        return float((np.tanh((a_ @ b) @ w_.T) * cot).sum())
    eps = 1e-6
    for arr, g, which in ((a, ga, 0), (w, gw, 1)):
        fd = np.zeros_like(arr)
        for idx in np.ndindex(arr.shape):
            up, dn = arr.copy(), arr.copy()
            up[idx] += eps
            dn[idx] -= eps
            args_up = (up, w) if which == 0 else (a, up)
            args_dn = (dn, w) if which == 0 else (a, dn)
            fd[idx] = (value(*args_up) - value(*args_dn)) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=TOL, atol=TOL)
