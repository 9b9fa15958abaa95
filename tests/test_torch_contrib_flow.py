"""`nd.contrib.foreach/while_loop/cond` (`ndarray/contrib_flow.py`) and
custom ops (`operator.py`, `nd.Custom`) against the JAX package's.

The same bodies, branches and CustomOp classes, written once against a
package argument, run in both packages on the same seeded inputs under
`autograd.record()`. Outputs, final states and the gradients reaching the
arrays the bodies read agree within 1e-5 (fp32)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = 1e-5


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _both(fn):
    """fn(pkg) in each package on the CPU -> (reference, port)."""
    out = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            out.append(fn(pkg))
    return out


X = np.random.RandomState(0).randn(5, 3, 4).astype(np.float32)
W = np.random.RandomState(1).randn(4, 4).astype(np.float32) * 0.5
H0 = np.random.RandomState(2).randn(3, 4).astype(np.float32)


def _foreach(pkg):
    x, w, h0 = pkg.nd.array(X), pkg.nd.array(W), pkg.nd.array(H0)
    for a in (x, w, h0):
        a.attach_grad()
    with pkg.autograd.record():
        def body(xt, states):
            h = pkg.nd.tanh(pkg.nd.dot(xt, w) + states[0])
            return h * 2, [h]
        outs, final = pkg.nd.contrib.foreach(body, x, [h0])
        loss = (outs * outs).sum() + final[0].sum()
    loss.backward()
    return [outs.asnumpy(), final[0].asnumpy(), x.grad.asnumpy(),
            w.grad.asnumpy(), h0.grad.asnumpy()]


def test_foreach_outputs_states_and_gradients():
    ref, port = _both(_foreach)
    assert port[0].shape == (5, 3, 4)
    for a, b in zip(port, ref):
        _close(a, b)


def _foreach_lists(pkg):
    xs = [pkg.nd.array(X), pkg.nd.array(X[:, :, :2] * 3)]
    outs, final = pkg.nd.contrib.foreach(
        lambda d, st: ([d[0].sum(axis=1), d[1] + st[0]],
                       [st[0] + d[1], st[1] * 2]),
        xs, [pkg.nd.zeros((3, 2)), pkg.nd.ones((1,))])
    empty, kept = pkg.nd.contrib.foreach(
        lambda d, st: (d * 2, st), pkg.nd.zeros((0, 3)),
        pkg.nd.ones((2,)))
    return [o.asnumpy() for o in outs] + [s.asnumpy() for s in final] + [
        empty.asnumpy(), kept.asnumpy()]


def test_foreach_over_lists_and_zero_steps():
    ref, port = _both(_foreach_lists)
    assert port[-2].shape == (0, 3)
    for a, b in zip(port, ref):
        _close(a, b)


def _while(pkg, limit):
    w = pkg.nd.array(W[0])
    w.attach_grad()
    with pkg.autograd.record():
        outs, (i, s) = pkg.nd.contrib.while_loop(
            lambda i, s: i < limit,
            lambda i, s: (s * w, (i + 1, s + w * i)),
            (pkg.nd.array([0.0]), pkg.nd.zeros((4,))), max_iterations=6)
        loss = (outs * outs).sum() + s.sum()
    loss.backward()
    return [outs.asnumpy(), i.asnumpy(), s.asnumpy(), w.grad.asnumpy()]


@pytest.mark.parametrize("limit", [0, 3, 6, 9])
def test_while_loop_pads_to_max_iterations(limit):
    ref, port = _both(lambda pkg: _while(pkg, limit))
    assert port[0].shape == (6, 4)
    assert float(port[1][0]) == min(limit, 6)
    for a, b in zip(port, ref):
        _close(a, b)


def _cond(pkg, flag):
    a, b = pkg.nd.array(W[0]), pkg.nd.array(W[1])
    a.attach_grad()
    b.attach_grad()
    with pkg.autograd.record():
        out = pkg.nd.contrib.cond(pkg.nd.array([flag]),
                                  lambda x, y: x * y + x,
                                  lambda x, y: pkg.nd.exp(y),
                                  (a, b))
        loss = (out * out).sum()
    loss.backward()
    return [out.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()]


@pytest.mark.parametrize("flag", [0.0, 1.0])
def test_cond_runs_the_taken_branch(flag):
    ref, port = _both(lambda pkg: _cond(pkg, flag))
    for a, b in zip(port, ref):
        _close(a, b)
    if not flag:
        assert not np.any(port[1])      # the untaken branch's input


def _custom_ops(pkg, tag):
    class Softsign(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], x / (1 + pkg.nd.abs(x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0]
            d = 1 + pkg.nd.abs(x)
            self.assign(in_grad[0], req[0], out_grad[0] / (d * d))

    class SoftsignProp(pkg.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Softsign()

    class ScaleAdd(pkg.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            self.assign(out_data[0], req[0], a * self.scale + b)
            self.assign(out_data[1], req[1], a * b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = in_data
            g0, g1 = out_grad
            self.assign(in_grad[0], req[0], g0 * self.scale + g1 * b)
            self.assign(in_grad[1], req[1], g0 + g1 * a)

    class ScaleAddProp(pkg.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "prod"]

        def create_operator(self, ctx, shapes, dtypes):
            return ScaleAdd(self.scale)

    pkg.operator.register("softsign_" + tag)(SoftsignProp)
    pkg.operator.register("scale_add_" + tag)(ScaleAddProp)


def _custom(pkg):
    _custom_ops(pkg, "flow_test")
    x, y = pkg.nd.array(W), pkg.nd.array(W.T * 2)
    x.attach_grad()
    y.attach_grad()
    with pkg.autograd.record():
        s = pkg.nd.Custom(x, op_type="softsign_flow_test")
        p, q = pkg.nd.Custom(s, y, op_type="scale_add_flow_test", scale=3)
        loss = (p * q).sum() + (s * s).sum()
    loss.backward()
    plain = pkg.nd.Custom(x, op_type="softsign_flow_test")
    return [s.asnumpy(), p.asnumpy(), q.asnumpy(), x.grad.asnumpy(),
            y.grad.asnumpy(), plain.asnumpy()]


def test_custom_ops_forward_and_backward():
    ref, port = _both(_custom)
    for a, b in zip(port, ref):
        _close(a, b)
    np.testing.assert_allclose(port[0], W / (1 + np.abs(W)), rtol=1e-6)


def test_custom_op_errors():
    with mx.cpu():
        with pytest.raises(mx.base.MXNetError):
            mx.nd.Custom(mx.nd.ones((2,)), op_type="no_such_op")
        with pytest.raises(mx.base.MXNetError):
            mx.operator.register("not_a_prop")(object)
