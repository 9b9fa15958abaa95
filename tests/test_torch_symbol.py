"""The port's `mx.sym` against the JAX package's (modelled on the
reference's tests/test_symbol_module.py).

The same graphs are built through both packages' APIs with explicit names.
Argument, output and auxiliary lists, inferred shapes and types, and the
JSON text must be equal; each package loads the other's ``-symbol.json``
and ``.params``; `eval` agrees within rtol 1e-5 on seeded numpy inputs.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def mlp(S):
    data = S.var("data")
    fc1 = S.FullyConnected(data, name="fc1", num_hidden=16)
    act1 = S.Activation(fc1, name="relu1", act_type="relu")
    fc2 = S.FullyConnected(act1, name="fc2", num_hidden=3)
    return S.SoftmaxOutput(fc2, name="softmax")


def resnetish(S, n_blocks=2, channels=8):
    """conv stem, residual conv + BatchNorm blocks, global pooling, an FC
    head and SoftmaxOutput (the reference's compiler-test topology)."""
    x = S.var("data")
    h = S.Convolution(x, name="stem", num_filter=channels, kernel=(3, 3),
                      pad=(1, 1), no_bias=True)
    h = S.BatchNorm(h, name="stem_bn", fix_gamma=False)
    h = S.Activation(h, name="stem_relu", act_type="relu")
    for i in range(n_blocks):
        s = S.Convolution(h, name="b%d_c1" % i, num_filter=channels,
                          kernel=(3, 3), pad=(1, 1), no_bias=True)
        s = S.BatchNorm(s, name="b%d_bn1" % i, fix_gamma=False)
        s = S.Activation(s, name="b%d_relu1" % i, act_type="relu")
        s = S.Convolution(s, name="b%d_c2" % i, num_filter=channels,
                          kernel=(3, 3), pad=(1, 1), no_bias=True)
        s = S.BatchNorm(s, name="b%d_bn2" % i, fix_gamma=False)
        h = S.Activation(S.broadcast_add(h, s, name="b%d_add" % i),
                         name="b%d_out" % i, act_type="relu")
    h = S.Pooling(h, name="gap", global_pool=True, pool_type="avg",
                  kernel=(1, 1))
    h = S.Flatten(h, name="flat")
    h = S.FullyConnected(h, name="head", num_hidden=4)
    return S.SoftmaxOutput(h, name="softmax")


GRAPHS = {"mlp": (mlp, {"data": (4, 5)}),
          "resnetish": (resnetish, {"data": (2, 3, 8, 8)})}


def test_symbol_compose_and_lists():
    for S in (mx.sym, jmx.sym):
        data = S.var("data")
        net1 = S.FullyConnected(data, name="fc1", num_hidden=10)
        net1 = S.FullyConnected(net1, name="fc2", num_hidden=100)
        assert net1.list_arguments() == \
            ["data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]
    nets = []
    for S in (mx.sym, jmx.sym):
        net1 = S.FullyConnected(S.var("data"), name="fc1", num_hidden=10)
        net2 = S.FullyConnected(S.var("data2"), name="fc3", num_hidden=10)
        net2 = S.Activation(net2, act_type="relu", name="act")
        net2 = S.FullyConnected(net2, name="fc4", num_hidden=20)
        nets.append(net2(data2=net1, name="composed"))
    assert nets[0].list_arguments() == nets[1].list_arguments()
    assert "data2" not in nets[0].list_arguments()
    assert nets[0].tojson() == nets[1].tojson()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_lists_shapes_types_and_json_match_reference(graph):
    make, shapes = GRAPHS[graph]
    mine, ref = make(mx.sym), make(jmx.sym)
    assert mine.list_arguments() == ref.list_arguments()
    assert mine.list_outputs() == ref.list_outputs()
    assert mine.list_auxiliary_states() == ref.list_auxiliary_states()
    assert mine.list_inputs() == ref.list_inputs()
    assert mine.infer_shape(**shapes) == ref.infer_shape(**shapes)
    assert mine.infer_type(data="float32") == ref.infer_type(data="float32")
    assert mine.tojson() == ref.tojson()
    assert mine.attr_dict() == ref.attr_dict()
    assert mine.get_internals().list_outputs() == \
        ref.get_internals().list_outputs()


@pytest.mark.parametrize("pkg", [mx, jmx], ids=["port", "reference"])
def test_infer_shape_partial_and_errors(pkg):
    S = pkg.sym
    net = S.FullyConnected(S.var("data"), name="fc", num_hidden=3)
    net = S.broadcast_add(net, S.var("extra"), name="add")
    args, outs, _ = net.infer_shape_partial(data=(2, 4))
    assert args == [(2, 4), (3, 4), (3,), None]
    assert outs == [None]
    with pytest.raises(pkg.MXNetError, match="extra"):
        net.infer_shape(data=(2, 4))


def test_shape_hints_fill_parameters_from_data():
    """Convolution (NCHW and NHWC), BatchNorm, Embedding and the output
    heads fill their parameter shapes; NHWC convolution weights are OHWI
    in the port (the reference's hint writes OIHW for every layout)."""
    S = mx.sym
    x = S.var("data")
    c = S.Convolution(x, name="c", num_filter=6, kernel=(3, 3),
                      layout="NHWC")
    args, outs, _ = c.infer_shape(data=(2, 9, 9, 4))
    assert args == [(2, 9, 9, 4), (6, 3, 3, 4), (6,)]
    assert outs == [(2, 7, 7, 6)]
    for make in (lambda S: S.Embedding(S.var("data"), name="e",
                                       input_dim=11, output_dim=5),
                 lambda S: S.LinearRegressionOutput(
                     S.FullyConnected(S.var("data"), name="f",
                                      num_hidden=2), name="lro"),
                 lambda S: S.BatchNorm(S.var("data"), name="bn")):
        mine, ref = make(mx.sym), make(jmx.sym)
        assert mine.infer_shape(data=(3, 4)) == ref.infer_shape(data=(3, 4))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_each_package_loads_the_others_symbol_and_params(graph, tmp_path):
    make, _ = GRAPHS[graph]
    rng = np.random.RandomState(0)
    for src, dst in ((mx, jmx), (jmx, mx)):
        net = make(src.sym)
        prefix = str(tmp_path / ("%s_%s" % (graph, src.__name__)))
        net.save(prefix + "-symbol.json")
        loaded = dst.sym.load(prefix + "-symbol.json")
        assert loaded.tojson() == net.tojson()
        assert loaded.list_auxiliary_states() == net.list_auxiliary_states()
        vals = {"arg:w": rng.standard_normal((3, 4)).astype(np.float32),
                "aux:m": rng.standard_normal(5).astype(np.float32)}
        with src.cpu():
            src.nd.save(prefix + ".params",
                        {k: src.nd.array(v) for k, v in vals.items()})
        back = dst.nd.load(prefix + ".params")
        assert sorted(back) == sorted(vals)
        for k, v in vals.items():
            np.testing.assert_array_equal(back[k].asnumpy(), v)


def test_load_json_of_a_group():
    """A group's JSON lists its members as the heads; both packages load
    it (the reference writes the group itself as a node, which neither
    loads, so its JSON is not compared here)."""
    a = mx.sym.var("a")
    g = mx.sym.Group([mx.sym.relu(a, name="r"), mx.sym.sigmoid(a, name="s")])
    for S in (mx.sym, jmx.sym):
        loaded = S.load_json(g.tojson())
        assert loaded.list_outputs() == g.list_outputs()
        assert len(loaded) == 2


def test_symbol_eval_matches_reference():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 3)).astype(np.float32)
    y = rng.standard_normal((2, 3)).astype(np.float32)
    outs = []
    for pkg in (mx, jmx):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        c = (a + b * 2.0 - 1.0) / 3.0
        c = pkg.sym.Activation(c, act_type="tanh", name="t")
        c = pkg.sym.concat(c, a, dim=1, name="cat")
        with pkg.cpu():
            outs.append(c.eval(ctx=pkg.cpu(), a=pkg.nd.array(x),
                               b=pkg.nd.array(y))[0].asnumpy())
    assert outs[0].shape == (2, 6)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_literals_and_scalar_operands():
    outs = []
    for pkg in (mx, jmx):
        a = pkg.sym.var("a")
        net = 2.0 - a * (pkg.sym.ones((2, 3)) + pkg.sym.zeros((2, 3))) \
            + pkg.sym.arange(3)
        with pkg.cpu():
            outs.append(net.eval(ctx=pkg.cpu(),
                                 a=pkg.nd.array(np.full((2, 3), 0.5,
                                                        "f")))[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_attr_scope_variable_attrs_and_multipliers():
    with mx.AttrScope(ctx_group="dev1", lr_mult="0.5"):
        v = mx.sym.var("w", shape=(2, 3), lr_mult=2.0, wd_mult=0.0,
                       dtype="float32", init=mx.init.Xavier())
    with jmx.AttrScope(ctx_group="dev1", lr_mult="0.5"):
        jv = jmx.sym.var("w", shape=(2, 3), lr_mult=2.0, wd_mult=0.0,
                         dtype="float32", init=jmx.init.Xavier())
    assert v.list_attr() == jv.list_attr()
    assert v.attr("ctx_group") == "dev1"
    assert mx.attribute.current() == {}


def test_sub_namespaces_hold_the_registry():
    assert hasattr(mx.sym.contrib, "interleaved_matmul_selfatt_qk")
    assert hasattr(mx.sym.contrib, "conv_bn_relu")
    assert hasattr(mx.sym.sparse, "dot")
    for ns in ("random", "contrib", "image", "linalg", "sparse"):
        assert getattr(mx.sym, ns).__name__ == "mxnet_tpu_torch.symbol." + ns
    qkv = mx.sym.var("qkv")
    att = mx.sym.contrib.interleaved_matmul_selfatt_qk(qkv, heads=2,
                                                       name="qk")
    assert att.list_arguments() == ["qkv"]
    _, outs, _ = att.infer_shape(qkv=(5, 3, 2 * 3 * 4))
    assert outs == [(6, 5, 5)]


def test_output_heads_forward_like_reference():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    lab = rng.randint(0, 5, 4).astype(np.float32)
    reg = rng.standard_normal((4, 5)).astype(np.float32)
    for op, label in (("SoftmaxOutput", lab), ("Softmax", lab),
                      ("LinearRegressionOutput", reg),
                      ("LogisticRegressionOutput", reg),
                      ("MAERegressionOutput", reg), ("BlockGrad", None),
                      ("MakeLoss", None)):
        outs = []
        for pkg in (mx, jmx):
            d = pkg.sym.var("d")
            args = [d] if label is None else [d, pkg.sym.var("l")]
            net = getattr(pkg.sym, op)(*args, name="h")
            feed = {"d": pkg.nd.array(x, ctx=pkg.cpu())}
            if label is not None:
                feed["l"] = pkg.nd.array(label, ctx=pkg.cpu())
            outs.append(net.eval(ctx=pkg.cpu(), **feed)[0].asnumpy())
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-7,
                                   err_msg=op)


def test_tojson_is_the_nnvm_layout():
    g = json.loads(mlp(mx.sym).tojson())
    assert sorted(g) == ["arg_nodes", "attrs", "heads", "node_row_ptr",
                         "nodes"]
    assert g["attrs"] == {"mxnet_version": ["int", 10900]}
    assert [n["op"] for n in g["nodes"] if n["op"] != "null"] == \
        ["FullyConnected", "Activation", "FullyConnected", "SoftmaxOutput"]
