"""The port's `mx.compiler` (passes and the whole-graph route) and its
`Executor`, against the JAX package's (modelled on the reference's
tests/test_compiler.py; the reference's AOT-cache tests have no
counterpart: the port has no compiled artifact to store).

The pass statistics and `graph_hash` must equal the reference's for the
same symbol. The executor's forward and gradients are held against the
reference's executor within rtol 1e-5 and atol 1e-5 * max|want|, and the
two routes of the port against each other within rtol 2e-4 / atol 1e-6.
The fixture graphs carry no BatchNorm where the reference's executor is
the yardstick: its executor normalizes by the batch's statistics in
inference and never moves the moving ones (ROADMAP, Queue C); the port's
BatchNorm is held to numpy's upstream semantics instead.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compiler, telemetry
from mxnet_tpu_torch.compiler import lower as lower_mod

from test_torch_symbol import mlp, resnetish


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_WHOLE_GRAPH", raising=False)
    telemetry.reset()
    lower_mod._MEMO.clear()
    yield
    lower_mod._MEMO.clear()
    telemetry.reset()


def _counters():
    return telemetry.snapshot()["counters"]


def convnet(S):
    """A small conv graph without BatchNorm: conv, relu, max pooling,
    a residual add, global average pooling, FC and SoftmaxOutput."""
    x = S.var("data")
    h = S.Convolution(x, name="c1", num_filter=6, kernel=(3, 3), pad=(1, 1))
    h = S.Activation(h, name="r1", act_type="relu")
    h = S.Pooling(h, name="p1", kernel=(2, 2), stride=(2, 2),
                  pool_type="max")
    s = S.Convolution(h, name="c2", num_filter=6, kernel=(3, 3), pad=(1, 1))
    h = S.Activation(S.broadcast_add(h, s, name="add"), name="r2",
                     act_type="relu")
    h = S.Pooling(h, name="gap", global_pool=True, pool_type="avg",
                  kernel=(1, 1))
    h = S.FullyConnected(h, name="fc", num_hidden=3)
    return S.SoftmaxOutput(h, name="softmax")


SHAPES = {"mlp": (mlp, (4, 5)), "convnet": (convnet, (2, 3, 8, 8)),
          "resnetish": (resnetish, (2, 3, 8, 8))}


def _values(net, data_shape, seed=0):
    rng = np.random.RandomState(seed)
    vals = {}
    shapes = net.infer_shape(data=data_shape)
    names = net.list_arguments() + net.list_auxiliary_states()
    for name, shape in zip(names, shapes[0] + shapes[2]):
        if name == "data":
            vals[name] = rng.normal(size=shape)
        elif name == "softmax_label":
            vals[name] = rng.randint(0, 3, size=shape)
        elif name.endswith(("gamma", "moving_var")):
            vals[name] = rng.uniform(0.5, 1.5, shape)
        else:
            vals[name] = rng.normal(size=shape) * 0.3
    return {k: np.asarray(v, np.float32) for k, v in vals.items()}


def _run(pkg, net, vals, data_shape, compile_graph, steps=1, lr=0.0,
         grad_req="write", out_grads=None, **bind):
    kw = {"data": data_shape}
    if "softmax_label" in net.list_arguments():
        kw["softmax_label"] = (data_shape[0],)
    if pkg is mx:
        bind["compile_graph"] = compile_graph
    ex = net.simple_bind(pkg.cpu(), grad_req=grad_req, **bind, **kw)
    for k, v in vals.items():
        (ex.arg_dict if k in ex.arg_dict else ex.aux_dict)[k][:] = v
    outs = grads = None
    for _ in range(steps):
        outs = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=None if out_grads is None else
                    pkg.nd.array(out_grads, ctx=pkg.cpu()))
        grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()
                 if g is not None}
        if lr:
            for k, g in ex.grad_dict.items():
                if g is None or k in ("data", "softmax_label"):
                    continue
                ex.arg_dict[k][:] = ex.arg_dict[k].asnumpy() - \
                    lr * g.asnumpy()
    return outs, grads, ex


def _close_to_reference(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# passes and hashes against the reference
# ---------------------------------------------------------------------------
def _folding_graph(S):
    z = S.zeros((2, 3))
    one = S.ones((2, 3))
    return S.var("a") + (z + one * 2.0)


def _cse_graph(S):
    a, b = S.var("a"), S.var("b")
    return a * b + a * b


def _constant_graphs(S):
    a = S.var("a")
    return a * (S.ones((4,)) * 2.0), a * (S.ones((4,)) * 3.0)


@pytest.mark.parametrize("graph", ["folding", "cse", "mlp", "resnetish",
                                   "convnet"])
def test_pipeline_stats_and_graph_hash_match_reference(graph):
    make = {"folding": _folding_graph, "cse": _cse_graph, "mlp": mlp,
            "resnetish": resnetish, "convnet": convnet}[graph]
    mine_ir = compiler.from_symbol(make(mx.sym))
    ref_ir = jmx.compiler.from_symbol(make(jmx.sym))
    assert mine_ir.n_ops() == ref_ir.n_ops()
    mine_ir, mine = compiler.run_pipeline(mine_ir)
    ref_ir, ref = jmx.compiler.run_pipeline(ref_ir)
    assert mine == ref
    assert compiler.graph_hash(mine_ir) == jmx.compiler.graph_hash(ref_ir)


def test_pass_constant_folding_and_dce():
    net = _folding_graph(mx.sym)
    ir, stats = compiler.run_pipeline(compiler.from_symbol(net))
    assert stats["folded"] >= 2 and stats["dce_removed"] >= 2, stats
    x = np.arange(6, dtype="float32").reshape(2, 3)
    ex = net.bind(mx.cpu(), {"a": mx.nd.array(x, ctx=mx.cpu())},
                  compile_graph=True)
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(), x + 2.0)


def test_pass_cse_merges_duplicate_subgraphs():
    net = _cse_graph(mx.sym)
    _, stats = compiler.run_pipeline(compiler.from_symbol(net))
    assert stats["cse_merged"] == 1, stats
    x, y = np.full((2, 2), 3.0, "float32"), np.full((2, 2), 5.0, "float32")
    ex = net.bind(mx.cpu(), {"a": mx.nd.array(x, ctx=mx.cpu()),
                             "b": mx.nd.array(y, ctx=mx.cpu())},
                  compile_graph=True)
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(), 2 * x * y)


def test_graph_hash_value_exact_for_constants():
    nets = _constant_graphs(mx.sym)
    irs = [compiler.run_pipeline(compiler.from_symbol(n))[0] for n in nets]
    assert compiler.graph_hash(irs[0]) != compiler.graph_hash(irs[1])
    ref = [jmx.compiler.graph_hash(jmx.compiler.run_pipeline(
        jmx.compiler.from_symbol(n))[0]) for n in _constant_graphs(jmx.sym)]
    assert [compiler.graph_hash(ir) for ir in irs] == ref
    for net, want in zip(nets, (2.0, 3.0)):
        ex = net.bind(mx.cpu(), {"a": mx.nd.ones((4,), ctx=mx.cpu())},
                      compile_graph=True)
        np.testing.assert_array_equal(ex.forward()[0].asnumpy(),
                                      np.full(4, want))


def test_unsupported_random_op_reason():
    net = mx.sym.Dropout(mx.sym.var("data"), name="drop", p=0.5)
    with pytest.raises(compiler.UnsupportedGraphError) as ei:
        compiler.from_symbol(net)
    assert ei.value.reason == "random_op:Dropout"


# ---------------------------------------------------------------------------
# the executor against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graph", ["mlp", "convnet"])
@pytest.mark.parametrize("route", ["whole_graph", "op_by_op"])
def test_executor_forward_and_gradients_match_reference(graph, route):
    make, shape = SHAPES[graph]
    vals = _values(make(mx.sym), shape, seed=3)
    o, g, _ = _run(mx, make(mx.sym), vals, shape, route == "whole_graph")
    ro, rg, _ = _run(jmx, make(jmx.sym), vals, shape, None)
    _close_to_reference(o, ro)
    assert sorted(g) == sorted(rg)
    for k in rg:
        _close_to_reference(g[k], rg[k])


@pytest.mark.parametrize("route", ["whole_graph", "op_by_op"])
def test_grad_req_add_and_out_grads_match_reference(route):
    net_m, net_r = mlp(mx.sym), mlp(jmx.sym)
    vals = _values(net_m, (4, 5), seed=4)
    _, g1, ex = _run(mx, net_m, vals, (4, 5), route == "whole_graph",
                     grad_req="add")
    ex.forward(is_train=True)
    ex.backward()
    _, rg1, rex = _run(jmx, net_r, vals, (4, 5), None, grad_req="add")
    rex.forward(is_train=True)
    rex.backward()
    for k in rg1:
        _close_to_reference(ex.grad_dict[k].asnumpy(),
                            rex.grad_dict[k].asnumpy())
        np.testing.assert_allclose(ex.grad_dict[k].asnumpy(), 2 * g1[k],
                                   rtol=1e-6)
    # the caller's head gradients (a regression head passes nothing back
    # through the head, so use a graph whose gradient reads them)
    a_m, a_r = mx.sym.var("a"), jmx.sym.var("a")
    cot = np.arange(6, dtype="float32").reshape(2, 3)
    got = []
    for pkg, a in ((mx, a_m), (jmx, a_r)):
        net = pkg.sym.Activation(a * 3.0 + 1.0, act_type="tanh", name="t")
        kw = {"compile_graph": route == "whole_graph"} if pkg is mx else {}
        ex = net.bind(pkg.cpu(), {"a": pkg.nd.array(cot / 10,
                                                    ctx=pkg.cpu())},
                      {"a": pkg.nd.zeros((2, 3), ctx=pkg.cpu())}, **kw)
        ex.forward(is_train=True)
        ex.backward(out_grads=pkg.nd.array(cot, ctx=pkg.cpu()))
        got.append(ex.grad_dict["a"].asnumpy())
    _close_to_reference(got[0], got[1])


# ---------------------------------------------------------------------------
# the two routes against each other
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graph", ["mlp", "convnet", "resnetish"])
def test_whole_graph_and_op_by_op_agree_over_steps(graph):
    make, shape = SHAPES[graph]
    net = make(mx.sym)
    vals = _values(net, shape, seed=7)
    o_wg, g_wg, ex_wg = _run(mx, net, vals, shape, True, steps=3, lr=0.05)
    assert _counters().get("compiler.compile") == 1, \
        "training must build exactly one program"
    o_op, g_op, ex_op = _run(mx, net, vals, shape, False, steps=3, lr=0.05)
    np.testing.assert_allclose(o_wg, o_op, rtol=2e-4, atol=1e-6)
    for k in g_op:
        np.testing.assert_allclose(g_wg[k], g_op[k], rtol=2e-4, atol=1e-6,
                                   err_msg="grad %s" % k)
    for k in ex_op.aux_dict:
        np.testing.assert_allclose(ex_wg.aux_dict[k].asnumpy(),
                                   ex_op.aux_dict[k].asnumpy(), rtol=2e-4,
                                   atol=1e-6, err_msg="aux %s" % k)
    assert _counters().get("compiler.fallback", 0) == 0


def test_executors_of_one_graph_share_one_program():
    net = mlp(mx.sym)
    vals = _values(net, (4, 5))
    exes = [_run(mx, net, vals, (4, 5), True)[2] for _ in range(2)]
    assert _counters().get("compiler.compile") == 1
    assert _counters().get("compiler.lower") == 2
    fns = list(lower_mod._MEMO.values())
    assert len(fns) == 1 and callable(fns[0])
    assert exes[0]._wg_program.graph_hash == exes[1]._wg_program.graph_hash


def test_random_graph_falls_back_counted():
    net = mx.sym.Dropout(mx.sym.var("data"), name="drop", p=0.0)
    ex = net.bind(mx.cpu(), {"data": mx.nd.ones((2, 2), ctx=mx.cpu())},
                  compile_graph=True)
    np.testing.assert_array_equal(ex.forward(is_train=False)[0].asnumpy(),
                                  np.ones((2, 2)))
    c = _counters()
    assert c.get("compiler.fallback") == 1
    assert c.get("compiler.fallback.random_op:Dropout") == 1
    ex.forward(is_train=False)
    assert _counters().get("compiler.fallback") == 1


def test_only_unsupported_graphs_fall_back():
    """An error inside the program is raised, not hidden behind the
    op-by-op route (the reference counts it and falls back)."""
    a = mx.sym.var("a")
    net = mx.sym.FullyConnected(a, name="fc", num_hidden=3)
    ex = net.bind(mx.cpu(), {"a": mx.nd.ones((2, 4), ctx=mx.cpu()),
                             "fc_weight": mx.nd.ones((3, 5), ctx=mx.cpu()),
                             "fc_bias": mx.nd.ones((3,), ctx=mx.cpu())},
                  compile_graph=True)
    with pytest.raises(RuntimeError):
        ex.forward()
    assert _counters().get("compiler.fallback", 0) == 0


def test_gate_off_keeps_op_by_op(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_WHOLE_GRAPH", "0")
    net = mlp(mx.sym)
    o, _, _ = _run(mx, net, _values(net, (4, 5)), (4, 5), None)
    assert o.shape == (4, 3)
    assert _counters().get("compiler.lower", 0) == 0


# ---------------------------------------------------------------------------
# BatchNorm: upstream MXNet's semantics on both routes
# ---------------------------------------------------------------------------
def _bn_graph(use_global_stats=False):
    x = mx.sym.var("data")
    kw = {"use_global_stats": True} if use_global_stats else {}
    return mx.sym.BatchNorm(x, name="bn", fix_gamma=False, momentum=0.8,
                            eps=1e-5, **kw)


def _bn_numpy(x, gamma, beta, mean, var):
    shape = (1, -1, 1, 1)
    return (x - mean.reshape(shape)) / np.sqrt(var.reshape(shape) + 1e-5) \
        * gamma.reshape(shape) + beta.reshape(shape)


@pytest.mark.parametrize("route", ["whole_graph", "op_by_op"])
@pytest.mark.parametrize("use_global_stats", [False, True])
def test_batchnorm_statistics_follow_upstream(route, use_global_stats):
    rng = np.random.RandomState(5)
    x = rng.normal(size=(4, 3, 5, 5)).astype(np.float32) * 2 + 1
    gamma = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    beta = rng.normal(size=3).astype(np.float32)
    mean0 = rng.normal(size=3).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    net = _bn_graph(use_global_stats)
    ex = net.simple_bind(mx.cpu(), compile_graph=route == "whole_graph",
                         data=x.shape)
    for k, v in (("data", x), ("bn_gamma", gamma), ("bn_beta", beta)):
        ex.arg_dict[k][:] = v
    ex.aux_dict["bn_moving_mean"][:] = mean0
    ex.aux_dict["bn_moving_var"][:] = var0
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    bm = x.mean(axis=(0, 2, 3))
    bv = x.var(axis=(0, 2, 3))
    if use_global_stats:
        want, mean1, var1 = _bn_numpy(x, gamma, beta, mean0, var0), mean0, \
            var0
    else:
        want = _bn_numpy(x, gamma, beta, bm, bv)
        mean1, var1 = mean0 * 0.8 + bm * 0.2, var0 * 0.8 + bv * 0.2
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ex.aux_dict["bn_moving_mean"].asnumpy(),
                               mean1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ex.aux_dict["bn_moving_var"].asnumpy(),
                               var1, rtol=1e-5, atol=1e-6)
    # inference: the moving statistics, which stay where they are
    out = ex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(out, _bn_numpy(x, gamma, beta, mean1, var1),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ex.aux_dict["bn_moving_mean"].asnumpy(),
                               mean1, rtol=1e-5, atol=1e-6)
