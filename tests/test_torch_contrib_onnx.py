"""The port's `contrib.onnx` against the JAX package's (the cases of the
reference's tests/test_onnx.py).

For each graph, built the same way in both packages from the same seeded
parameters, `export_model` writes the same bytes as the reference, and
`import_model` of the reference's file gives a graph whose forward on the
CPU is within 1e-6 of the reference's forward of the original (of the
port's where the graph holds a BatchNorm, whose inference forward follows
upstream MXNet's moving statistics in the port only; the CNN,
the MLP, the structural ops, global pooling with LeakyReLU, a GELU at
float32 and at bfloat16 with its bf16 constants, a bf16 initializer, and
the reference API's list of input shapes). A stock-exporter Gemm imports
to alpha A B + beta C. Unsupported ops and forms raise
NotImplementedError in both.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import onnx as jonnx
from mxnet_tpu_torch.contrib import onnx as tonnx
from mxnet_tpu_torch.contrib.onnx import proto as P

from _torch_seed import _seed_torch  # noqa: F401

TOL = 1e-6


def _cnn(s):
    data = s.Variable("data")
    c1 = s.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                       name="conv1")
    b1 = s.BatchNorm(c1, name="bn1")
    a1 = s.Activation(b1, act_type="relu", name="act1")
    p1 = s.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                   name="pool1")
    f1 = s.Flatten(p1, name="flat")
    fc = s.FullyConnected(f1, num_hidden=10, name="fc1")
    return s.softmax(fc, name="sm")


def _mlp(s):
    data = s.Variable("data")
    fc1 = s.FullyConnected(data, num_hidden=16, name="fc1")
    t = s.Activation(fc1, act_type="tanh", name="t1")
    sg = s.sigmoid(fc1, name="s1")
    mixed = s.broadcast_add(t, sg, name="mix")
    fc2 = s.FullyConnected(mixed, num_hidden=4, no_bias=True, name="fc2")
    return s.log_softmax(fc2, name="out")


def _structural(s):
    data = s.Variable("data")
    r = s.reshape(data, shape=(2, 12), name="rsh")
    tr = s.transpose(r, axes=(1, 0), name="tr")
    e = s.expand_dims(tr, axis=0, name="ex")
    sq = s.squeeze(e, axis=0, name="sq")
    return s.concat(sq, sq, dim=1, name="cat")


def _gpool_leaky(s):
    data = s.Variable("data")
    c = s.Convolution(data, kernel=(1, 1), num_filter=4, name="c")
    lk = s.LeakyReLU(c, act_type="leaky", slope=0.1, name="lk")
    return s.Pooling(lk, kernel=(1, 1), pool_type="avg", global_pool=True,
                     name="gp")


def _gelu(s):
    return s.Activation(s.Variable("data"), act_type="gelu", name="g")


def _fc_bias_free(s):
    return s.FullyConnected(s.Variable("data"), num_hidden=3, no_bias=True,
                            name="fcb")


CASES = {
    "cnn": (_cnn, (2, 3, 8, 8), True),
    "mlp": (_mlp, (3, 6), False),
    "structural": (_structural, (4, 6), False),
    "gpool_leaky": (_gpool_leaky, (2, 3, 5, 5), False),
    "gelu": (_gelu, (2, 4), False),
}


def _params(pkg, sym, shape, bn):
    shapes, _, _ = sym.infer_shape(data=shape)
    rng = np.random.RandomState(0)
    args = {n: (rng.randn(*shp) * 0.1).astype(np.float32)
            for n, shp in zip(sym.list_arguments(), shapes) if n != "data"}
    aux = {}
    if bn:
        aux = {"bn1_moving_mean": rng.randn(8).astype(np.float32) * 0.1,
               "bn1_moving_var": rng.rand(8).astype(np.float32) + 0.5}
    return args, aux


def _forward(pkg, sym, args, aux, x):
    with pkg.cpu():
        nd = pkg.nd
        ex = sym.bind(pkg.cpu(), dict({k: nd.array(v) if isinstance(
            v, np.ndarray) else v for k, v in args.items()},
            data=nd.array(x)),
            aux_states={k: nd.array(v) if isinstance(v, np.ndarray) else v
                        for k, v in aux.items()} or None)
        return ex.forward(is_train=False)[0].asnumpy()


def _export(pkg, mod, sym, params, shapes, path, **kw):
    with pkg.cpu():
        nd_params = {k: pkg.nd.array(v) for k, v in params.items()}
        mod.export_model(sym, nd_params, shapes, onnx_file_path=path, **kw)
    return open(path, "rb").read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_bytes_and_import_of_the_reference_file(case, tmp_path):
    build, shape, bn = CASES[case]
    jsym, tsym = build(jmx.sym), build(mx.sym)
    assert tsym.tojson() == jsym.tojson()
    args, aux = _params(jmx, jsym, shape, bn)
    params = dict(args, **aux)
    jpath, tpath = str(tmp_path / "ref.onnx"), str(tmp_path / "port.onnx")
    want = _export(jmx, jonnx, jsym, params, {"data": shape}, jpath)
    got = _export(mx, tonnx, tsym, params, {"data": shape}, tpath)
    assert got == want
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    # with BatchNorm, the port's original graph is the yardstick: the
    # reference's Executor normalizes by the batch's statistics in an
    # inference forward, the port by the moving ones, as upstream MXNet
    ref = _forward(mx if bn else jmx, tsym if bn else jsym, args, aux, x)
    with mx.cpu():
        sym2, a2, x2 = tonnx.import_model(jpath)
    out = _forward(mx, sym2, a2, x2, x)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_bf16_model_bytes_equal(tmp_path):
    """A bf16 GELU (its constants in bf16) and a bf16 initializer."""
    paths = {}
    for pkg, mod, tag in ((jmx, jonnx, "ref"), (mx, tonnx, "port")):
        w = np.random.RandomState(5).randn(3, 4).astype(np.float32)
        with pkg.cpu():
            wb = pkg.nd.array(w).astype("bfloat16")
            g = str(tmp_path / ("g_%s.onnx" % tag))
            mod.export_model(_gelu(pkg.sym), {}, {"data": (2, 4)},
                             input_dtype="bfloat16", onnx_file_path=g)
            f = str(tmp_path / ("f_%s.onnx" % tag))
            mod.export_model(_fc_bias_free(pkg.sym), {"fcb_weight": wb},
                             {"data": (2, 4)}, onnx_file_path=f)
        paths[tag] = (g, f)
    for a, b in zip(paths["port"], paths["ref"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    with mx.cpu():
        sym2, a2, _ = tonnx.import_model(paths["ref"][1])
        w2 = a2["fcb_weight"]
        assert str(w2.dtype) == "bfloat16"
        wb = mx.nd.array(np.random.RandomState(5).randn(3, 4).astype(
            np.float32)).astype("bfloat16")
        np.testing.assert_array_equal(w2.astype("float32").asnumpy(),
                                      wb.astype("float32").asnumpy())


def test_input_shape_list_form(tmp_path):
    files = []
    for pkg, mod in ((jmx, jonnx), (mx, tonnx)):
        s = pkg.sym
        out = s.FullyConnected(s.Variable("data"), num_hidden=3, name="fc")
        rng = np.random.RandomState(2)
        params = {"fc_weight": rng.randn(3, 5).astype(np.float32),
                  "fc_bias": rng.randn(3).astype(np.float32)}
        files.append(_export(pkg, mod, out, params, [(2, 5)],
                             str(tmp_path / ("%d.onnx" % len(files)))))
    assert files[0] == files[1]
    with pytest.raises(ValueError):
        tonnx.export_model(mx.sym.Variable("a") + mx.sym.Variable("b"), {},
                           (2, 2), onnx_file_path=str(tmp_path / "x.onnx"))


def test_gemm_general_form_imports(tmp_path):
    rng = np.random.RandomState(3)
    A = rng.randn(2, 4).astype("float32")
    B = rng.randn(4, 3).astype("float32")
    C = rng.randn(3).astype("float32")
    g = P.GraphProto(
        name="g",
        node=[P.NodeProto(op_type="Gemm", name="gm", input=["A", "B", "C"],
                          output=["Y"],
                          attribute=[
                              P.AttributeProto(name="alpha", type=P.AT.FLOAT,
                                               f=2.0),
                              P.AttributeProto(name="beta", type=P.AT.FLOAT,
                                               f=0.5),
                              P.AttributeProto(name="transB", type=P.AT.INT,
                                               i=0)])],
        initializer=[],
        input=[P.ValueInfoProto(name=n) for n in ("A", "B", "C")],
        output=[P.ValueInfoProto(name="Y")])
    m = P.ModelProto(ir_version=8, graph=g,
                     opset_import=[P.OperatorSetIdProto(domain="",
                                                        version=13)])
    path = str(tmp_path / "gemm.onnx")
    open(path, "wb").write(m.encode())
    with mx.cpu():
        sym, _, _ = tonnx.import_model(path)
        ex = sym.bind(mx.cpu(), {"A": mx.nd.array(A), "B": mx.nd.array(B),
                                 "C": mx.nd.array(C)})
        got = ex.forward()[0].asnumpy()
    np.testing.assert_allclose(got, 2.0 * (A @ B) + 0.5 * C, rtol=1e-5,
                               atol=1e-6)


def _refused(s, kind):
    if kind == "selu":
        return s.LeakyReLU(s.Variable("data"), act_type="selu", name="s"), \
            {"data": (2, 4)}
    if kind == "dot_tb":
        return s.dot(s.Variable("a"), s.Variable("b"), transpose_b=True,
                     name="d"), {"a": (2, 3), "b": (4, 3)}
    return s.topk(s.Variable("data"), k=2, name="t"), {"data": (2, 4)}


@pytest.mark.parametrize("kind", ["selu", "dot_tb", "no_converter"])
def test_unsupported_raises_in_both(kind, tmp_path):
    for pkg, mod in ((jmx, jonnx), (mx, tonnx)):
        sym, shapes = _refused(pkg.sym, kind)
        with pytest.raises(NotImplementedError):
            mod.export_model(sym, {}, shapes,
                             onnx_file_path=str(tmp_path / "x.onnx"))


def test_unsupported_import_raises(tmp_path):
    g = P.GraphProto(name="g", node=[P.NodeProto(
        op_type="NonMaxSuppression", name="n", input=["x"], output=["y"])],
        input=[P.ValueInfoProto(name="x")],
        output=[P.ValueInfoProto(name="y")])
    m = P.ModelProto(ir_version=8, graph=g, opset_import=[
        P.OperatorSetIdProto(domain="", version=13)])
    path = str(tmp_path / "nms.onnx")
    open(path, "wb").write(m.encode())
    for mod in (jonnx, tonnx):
        with pytest.raises(NotImplementedError):
            mod.import_model(path)
