"""The port's autograd (a tape over torch.autograd) against the JAX
package's.

Small compositions of registered ops run under `autograd.record()` on
both sides from the same numpy inputs (seeded), and the gradients that
`backward` writes into `.grad` (with grad_req "write", "add" and "null")
and that `autograd.grad` returns must agree: fp32 within 1e-5 relative
(the summation order only). For dot and FullyConnected with inputs of
which only some are variables, the reference's gradient rules ignore the
positions of the variables (ROADMAP Queue C), so those are held to
torch.autograd on plain tensors and to numpy instead.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from _torch_seed import _seed_torch  # noqa: F401

REL = 1e-5


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * max(
        np.abs(want).max(), 1.0))


def _arrays(pkg, ctx, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 6).astype(np.float32)
    w = (rng.randn(5, 6) * 0.3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    y = np.array([0, 3, 1, 4], np.float32)
    return [pkg.nd.array(a, ctx=ctx) for a in (x, w, b, y)]


def _ctx(pkg):
    return pkg.cpu()


COMPOSITIONS = {
    # name: f(pkg, x, w, b, y) -> head NDArray
    "arith": lambda pkg, x, w, b, y: (x * x + 2.0 * x - x / 3.0).sum(),
    "unary": lambda pkg, x, w, b, y: (
        pkg.nd.exp(x * 0.1) + pkg.nd.square(x) - pkg.nd.abs(x)
        + pkg.nd.tanh(x)).mean(),
    "fc_relu_softmax_ce": lambda pkg, x, w, b, y: -pkg.nd.pick(
        pkg.nd.log_softmax(pkg.nd.relu(pkg.nd.FullyConnected(
            x, w, b, num_hidden=5))), y).sum(),
    "sigmoid_mean_axis": lambda pkg, x, w, b, y: pkg.nd.sigmoid(
        pkg.nd.FullyConnected(x, w, b, num_hidden=5)).mean(axis=1),
}


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_backward_writes_the_reference_gradients(name):
    f = COMPOSITIONS[name]
    grads = []
    for pkg in (jmx, mx):
        x, w, b, y = _arrays(pkg, _ctx(pkg))
        for a in (x, w, b):
            a.attach_grad()
        with pkg.autograd.record():
            head = f(pkg, x, w, b, y)
        head.backward()
        grads.append([a.grad.asnumpy() for a in (x, w, b)])
    if name in ("arith", "unary"):
        grads = [g[:1] for g in grads]          # only x takes part
    for got, want in zip(grads[1], grads[0]):
        _close(got, want)


def test_grad_req_add_accumulates_and_write_overwrites():
    results = []
    for pkg in (jmx, mx):
        x, w, b, y = _arrays(pkg, _ctx(pkg))
        x.attach_grad(grad_req="add")
        w.attach_grad(grad_req="write")
        for _ in range(3):
            with pkg.autograd.record():
                head = pkg.nd.FullyConnected(x, w, b, num_hidden=5).sum()
            head.backward()
        results.append((x.grad.asnumpy(), w.grad.asnumpy()))
    _close(results[1][0], results[0][0])
    _close(results[1][1], results[0][1])


def test_grad_req_add_is_three_times_write():
    x, w, b, _ = _arrays(mx, mx.cpu())
    xa, xw = x.copy(), x.copy()
    xa.attach_grad(grad_req="add")
    xw.attach_grad(grad_req="write")
    for _ in range(3):
        for v in (xa, xw):
            with mx.autograd.record():
                head = mx.nd.FullyConnected(v, w, b, num_hidden=5).sum()
            head.backward()
    _close(xa.grad.asnumpy(), 3 * xw.grad.asnumpy())


def test_grad_req_null_leaves_no_gradient():
    x, w, b, _ = _arrays(mx, mx.cpu())
    x.attach_grad(grad_req="null")
    w.attach_grad()
    with mx.autograd.record():
        head = mx.nd.FullyConnected(x, w, b, num_hidden=5).sum()
    head.backward()
    assert not x._data.requires_grad
    assert np.abs(x.grad.asnumpy()).max() == 0.0
    assert np.abs(w.grad.asnumpy()).max() > 0.0


def test_autograd_grad_returns_without_touching_buffers():
    got = []
    for pkg in (jmx, mx):
        x, w, b, y = _arrays(pkg, _ctx(pkg))
        x.attach_grad()
        w.attach_grad()
        with pkg.autograd.record():
            head = COMPOSITIONS["fc_relu_softmax_ce"](pkg, x, w, b, y)
        gx, gw = pkg.autograd.grad(head, [x, w])
        assert np.abs(x.grad.asnumpy()).max() == 0.0
        got.append((gx.asnumpy(), gw.asnumpy()))
    for a, b in zip(got[1], got[0]):
        _close(a, b)


def test_autograd_grad_create_graph_second_order():
    x = mx.nd.array(np.array([0.5, -1.0, 2.0], np.float32), ctx=mx.cpu())
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x * x).sum()
        (gx,) = mx.autograd.grad(y, [x], create_graph=True)
        z = gx.sum()
    z.backward()
    np.testing.assert_allclose(gx.asnumpy(), 3 * x.asnumpy() ** 2,
                               rtol=1e-6)
    np.testing.assert_allclose(x.grad.asnumpy(), 6 * x.asnumpy(), rtol=1e-6)


def test_nothing_is_recorded_outside_record_and_under_pause():
    x, w, b, _ = _arrays(mx, mx.cpu())
    w.attach_grad()
    out = mx.nd.FullyConnected(x, w, b, num_hidden=5)
    assert not out._data.requires_grad
    with mx.autograd.record():
        with mx.autograd.pause():
            paused = mx.nd.FullyConnected(x, w, b, num_hidden=5)
        live = mx.nd.FullyConnected(x, w, b, num_hidden=5)
    assert not paused._data.requires_grad
    assert live._data.requires_grad
    assert not live.detach()._data.requires_grad
    assert mx.autograd.is_training() is False


def test_backward_of_an_unrecorded_head_is_a_no_op():
    x, w, b, _ = _arrays(mx, mx.cpu())
    w.attach_grad()
    mx.nd.FullyConnected(x, w, b, num_hidden=5).sum().backward()
    assert np.abs(w.grad.asnumpy()).max() == 0.0


@pytest.mark.parametrize("which", ["x", "w", "both"])
def test_dot_and_fc_with_some_variables_match_torch(which):
    """dot and FullyConnected where only some inputs are variables,
    against torch.autograd on plain tensors and the numpy formulas."""
    rng = np.random.RandomState(4)
    xa = rng.randn(3, 4).astype(np.float32)
    wa = rng.randn(5, 4).astype(np.float32)
    ba = rng.randn(5).astype(np.float32)
    cot = rng.randn(3, 5).astype(np.float32)
    x, w, b = (mx.nd.array(a, ctx=mx.cpu()) for a in (xa, wa, ba))
    variables = {"x": [x], "w": [w], "both": [x, w]}[which]
    for v in variables:
        v.attach_grad()
    with mx.autograd.record():
        fc = mx.nd.FullyConnected(x, w, b, num_hidden=5)
        dt = mx.nd.dot(x, w, transpose_b=True)
        head = fc + dt
    head.backward(mx.nd.array(cot, ctx=mx.cpu()))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (xa, wa))
    out = torch.nn.functional.linear(tx, tw, torch.from_numpy(ba)) + \
        tx @ tw.t()
    gx, gw = torch.autograd.grad(out, [tx, tw], torch.from_numpy(cot))
    if which in ("x", "both"):
        _close(x.grad.asnumpy(), gx.numpy())
        _close(x.grad.asnumpy(), 2 * cot @ wa)
    if which in ("w", "both"):
        _close(w.grad.asnumpy(), gw.numpy())
        _close(w.grad.asnumpy(), 2 * cot.T @ xa)


def test_parameter_gradient_buffers_follow_grad_req():
    p = mx.gluon.Parameter("fc_weight", shape=(3, 2))
    p.initialize(mx.init.One(), ctx=mx.cpu())
    assert p.grad().shape == (3, 2) and p.grad().dtype == np.float32
    assert p.data()._data.requires_grad
    with mx.autograd.record():
        head = (p.data() * 3.0).sum()
    head.backward()
    np.testing.assert_array_equal(p.grad().asnumpy(), np.full((3, 2), 3.0))
    p.zero_grad()
    assert np.abs(p.grad().asnumpy()).max() == 0.0
    p.grad_req = "null"
    assert not p.data()._data.requires_grad
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        p.grad()
    p.grad_req = "add"
    assert p.list_grad()[0].shape == (3, 2)
    p.cast("bfloat16")
    assert p.grad().dtype == "bfloat16"
    assert p.data()._data.requires_grad


def test_set_data_and_setitem_do_not_break_marked_leaves():
    p = mx.gluon.Parameter("w", shape=(4,))
    p.initialize(mx.init.Zero(), ctx=mx.cpu())
    p.set_data(mx.nd.array(np.arange(4), ctx=mx.cpu()))
    d = p.data()
    d[1:3] = 7.0
    np.testing.assert_array_equal(d.asnumpy(), [0, 7, 7, 3])
    assert d._data.is_leaf and d._data.requires_grad
