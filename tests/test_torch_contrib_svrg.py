"""The port's `contrib.svrg_optimization` against the JAX package's, on the
data of the reference's tests/test_svrg.py (a 4-feature linear regression,
32 rows in batches of 8).

From the same initial parameters: the full gradient mu of the first
snapshot, the variance-reduced gradients of the first step (equal to mu at
the snapshot) and after one update, and the parameters, mu and the MSE
after 3 epochs of `SVRGModule.fit` (update_freq 2: snapshots at epochs 0
and 2), all within 1e-6 (relative, and absolute on values near 0). The
optimizer's dispatch (assignment of full-gradient keys, the default
optimizer for the rest) is the same, and it is in the optimizer registry.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import svrg_optimization as jsvrg
from mxnet_tpu_torch.contrib import svrg_optimization as svrg

from _torch_seed import _seed_torch  # noqa: F401

TOL = 1e-6
INIT = {"fc_weight": np.array([[0.03, -0.02, 0.04, 0.01]], np.float32),
        "fc_bias": np.array([0.02], np.float32)}


def _data():
    rng = np.random.RandomState(0)
    X = rng.rand(32, 4).astype("float32")
    y = (X @ np.array([1.5, -2.0, 0.5, 3.0], "float32")
         + 0.8).astype("float32")
    return X, y


def _module(pkg, mod, update_freq=2):
    s = pkg.sym
    fc = s.FullyConnected(s.var("data"), name="fc", num_hidden=1)
    out = s.LinearRegressionOutput(fc, name="lro")
    X, y = _data()
    it = pkg.io.NDArrayIter(X, y, batch_size=8, label_name="lro_label")
    m = mod.SVRGModule(out, data_names=("data",), label_names=("lro_label",),
                       update_freq=update_freq, context=pkg.cpu())
    return m, it


def _grads(m):
    return {n: g[0].asnumpy() for n, g in zip(m._exec_group.param_names,
                                              m._exec_group.grad_arrays)}


def _mu(m):
    return {n: v.asnumpy() for n, v in m._full_grads.items()}


def _steps(pkg, mod):
    with pkg.cpu():
        m, it = _module(pkg, mod)
        m.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        m.init_params(arg_params={k: pkg.nd.array(v)
                                  for k, v in INIT.items()},
                      aux_params={})
        m.init_optimizer(optimizer="sgd",
                         optimizer_params=(("learning_rate", 0.05),))
        m.update_full_grads(it)
        mu = _mu(m)
        it.reset()
        batch = next(iter(it))
        m.forward_backward(batch)
        at_snapshot = _grads(m)
        m.update()
        it.reset()
        m.forward_backward(next(iter(it)))
        off_snapshot = _grads(m)
    return mu, at_snapshot, off_snapshot


def _close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_snapshot_and_variance_reduced_gradients():
    want = _steps(jmx, jsvrg)
    got = _steps(mx, svrg)
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[1], got[0])            # at w == w0 the batch terms cancel
    assert any(not np.allclose(got[2][k], got[0][k], atol=1e-7)
               for k in got[0])


def _fit(pkg, mod):
    with pkg.cpu():
        m, it = _module(pkg, mod)
        losses = []
        m.fit(it, num_epoch=3, eval_metric="mse", optimizer="sgd",
              optimizer_params=(("learning_rate", 0.2),),
              arg_params={k: pkg.nd.array(v) for k, v in INIT.items()},
              aux_params={},
              epoch_end_callback=lambda e, s, a, x: losses.append(
                  {k: v.asnumpy() for k, v in a.items()}))
        it.reset()
        mse = dict(m.score(it, pkg.metric.create("mse")))["mse"]
        args, _ = m.get_params()
        return ({k: v.asnumpy() for k, v in args.items()}, _mu(m), mse,
                losses)


def test_fit_three_epochs_matches_reference():
    jp, jmu, jmse, jep = _fit(jmx, jsvrg)
    tp, tmu, tmse, tep = _fit(mx, svrg)
    _close(tp, jp)
    _close(tmu, jmu)
    assert len(tep) == len(jep) == 3
    for a, b in zip(tep, jep):
        _close(a, b)
    assert abs(tmse - jmse) <= TOL * max(1.0, abs(jmse))
    assert tmse < 1.0


def test_update_freq_must_be_positive():
    for bad in (0, 1.5):
        with mx.cpu(), pytest.raises(ValueError):
            _module(mx, svrg, update_freq=bad)


def _dispatch(pkg, mod):
    opt = mod.SVRGOptimizer(default_optimizer="sgd", learning_rate=0.5,
                            full_idx_offset=10,
                            param_idx2name={3: "w_full", 4: "w"})
    out = []
    with pkg.cpu():
        for idx in (0, 11, 3, 4):
            w = pkg.nd.array(np.ones((3,), "float32"))
            g = pkg.nd.array(np.full((3,), 2.0, "float32"))
            state = opt.create_state(idx, w)
            opt.update(idx, w, g, state)
            out.append((state is None, w.asnumpy()))
    return out


def test_optimizer_dispatch_matches_reference():
    got, want = _dispatch(mx, svrg), _dispatch(jmx, jsvrg)
    for (gs, gw), (ws, ww) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(gw, ww)
    np.testing.assert_array_equal(got[0][1], np.zeros(3, np.float32))
    np.testing.assert_array_equal(got[1][1], np.full(3, 2.0, np.float32))
    np.testing.assert_array_equal(got[2][1], np.full(3, 2.0, np.float32))
    o = mx.optimizer.create("svrgoptimizer", default_optimizer="sgd",
                            learning_rate=0.1)
    assert isinstance(o, svrg.SVRGOptimizer)
