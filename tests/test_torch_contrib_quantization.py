"""The port's `contrib.quantization` against the JAX package's (modelled
on the reference's tests/test_quantization.py).

* `_quantize_weight`: int8 weights and thresholds bit-equal (ties at half
  steps round to even in both).
* `calib_thresholds`: naive and entropy thresholds of the same collected
  statistics within 1e-6 (relative).
* `QuantizedDense` / `QuantizedConv2D`: the int32 accumulator bit-equal to
  the reference's ``preferred_element_type=int32`` dot and convolution
  (stride, padding, dilation, groups; calibrated and per-batch ranges),
  outputs within 1e-6.
* `quantize_net` on `resnet18_v1(classes=10)` at 4x3x32x32 from the
  reference's weights: logits within 1e-5 of the reference's quantized
  net, and the reference's bar against fp32 (cosine > 0.99, top-1 agreement
  >= 0.75); `exclude_layers`; a hybridized net still calibrates; a
  channels-last convolution is refused.
* `quantize_model`: the rewritten graph's nodes, attributes and heads
  equal to the reference's, its int8 parameters bit-equal, and its Module
  outputs within 1e-5.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import quantization as jqz
from mxnet_tpu_torch.contrib import quantization as qz
from mxnet_tpu_torch.models.convert import gluon_params_from_jax

from _torch_seed import _seed_torch  # noqa: F401

THRESH_REL = 1e-6
OUT_TOL = 1e-6
NET_TOL = 1e-5


def _pair_params(jnet, tnet):
    arrays = {k: v.data().asnumpy()
              for k, v in jnet._collect_params_with_prefix().items()}
    with mx.cpu():
        gluon_params_from_jax(arrays, tnet, ctx=mx.cpu())


def test_quantize_weight_bit_equal():
    rng = np.random.RandomState(0)
    w = rng.normal(size=(6, 3, 3, 3)).astype(np.float32)
    # ties: w * 127 / t lands on x.5 for these entries
    w[0] = np.clip(w[0], -0.9, 0.9)
    w[0, 0, 0, :] = [1.0, 0.5 / 127, 1.5 / 127]
    w[0, 0, 1, 0] = -2.5 / 127
    w[1] = 0.0                                    # an all-zero channel
    for axis in (0, 1):
        q, t = qz._quantize_weight(w, axis=axis)
        jq, jt = jqz._quantize_weight(w, axis=axis)
        assert q.dtype == jq.dtype == np.int8 and t.dtype == jt.dtype
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(t, jt)


def test_calib_thresholds_agree():
    rng = np.random.RandomState(1)
    batches = [rng.standard_t(3, size=(8, 64)).astype(np.float32)
               for _ in range(3)]
    batches[2][0, 0] = 40.0                      # widen: re-bin the histogram
    a, b = qz._Collector(), jqz._Collector()
    for i, x in enumerate(batches):
        a.update("l%d" % (i % 2), x)
        b.update("l%d" % (i % 2), x)
    for mode in ("naive", "entropy"):
        got = qz.calib_thresholds(a, mode)
        want = jqz.calib_thresholds(b, mode)
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= THRESH_REL * abs(want[k]), \
                (mode, k, got[k], want[k])
    zero = qz._Collector()
    zero.update("z", np.zeros((4,), np.float32))
    assert qz._entropy_threshold(*zero.hist["z"]) == \
        jqz._entropy_threshold(*zero.hist["z"])


def _ref_dense_acc(layer, x32):
    import jax.numpy as jnp
    from jax import lax
    x = jnp.asarray(x32)
    if layer._flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    xq, _ = layer._quant_input(x)
    return np.asarray(lax.dot_general(xq, layer._wq,
                                      (((x.ndim - 1,), (1,)), ((), ())),
                                      preferred_element_type=jnp.int32))


def _ref_conv_acc(layer, x32):
    import jax.numpy as jnp
    from jax import lax
    xq, _ = layer._quant_input(jnp.asarray(x32))
    dn = lax.conv_dimension_numbers(xq.shape, layer._wq.shape,
                                    ("NCHW", "OIHW", "NCHW"))
    return np.asarray(lax.conv_general_dilated(
        xq, layer._wq, window_strides=tuple(layer._stride),
        padding=[(p, p) for p in layer._pad],
        rhs_dilation=tuple(layer._dilate), dimension_numbers=dn,
        feature_group_count=layer._groups,
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("act_max", [None, 1.7])
def test_quantized_dense_accumulator_bit_equal(flatten, act_max):
    rng = np.random.RandomState(2)
    x = rng.normal(size=(3, 2, 5)).astype(np.float32)
    layers = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            d = pkg.gluon.nn.Dense(7, flatten=flatten, activation="relu")
            d.initialize(pkg.init.Xavier())
            d(pkg.nd.array(x))
            layers.append(d)
    _pair_params(*layers)
    jq = jqz.QuantizedDense(layers[0], act_max)
    tq = qz.QuantizedDense(layers[1], act_max)
    acc, _ = tq.accumulate(torch.from_numpy(x))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), _ref_dense_acc(jq, x))
    with mx.cpu():
        got = tq(mx.nd.array(x)).asnumpy()
    with jmx.cpu():
        want = jq(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)


CONVS = [dict(channels=6, kernel_size=3, padding=1),
         dict(channels=6, kernel_size=3, strides=2, padding=(1, 2)),
         dict(channels=4, kernel_size=3, dilation=(2, 1), padding=2,
              use_bias=False),
         dict(channels=6, kernel_size=(3, 1), groups=2, strides=(1, 2),
              activation="relu")]


@pytest.mark.parametrize("conf", CONVS, ids=["pad", "stride", "dilate",
                                              "groups"])
@pytest.mark.parametrize("act_max", [None, 2.5])
def test_quantized_conv_accumulator_bit_equal(conf, act_max):
    rng = np.random.RandomState(3)
    x = rng.normal(size=(2, 4, 9, 8)).astype(np.float32)
    layers = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            c = pkg.gluon.nn.Conv2D(**conf)
            c.initialize(pkg.init.Xavier())
            c(pkg.nd.array(x))
            layers.append(c)
    if conf.get("use_bias", True):
        with jmx.cpu():
            layers[0].bias.set_data(jmx.nd.array(
                rng.normal(size=(conf["channels"],)).astype(np.float32)))
    _pair_params(*layers)
    jq = jqz.QuantizedConv2D(layers[0], act_max)
    tq = qz.QuantizedConv2D(layers[1], act_max)
    acc, _ = tq.accumulate(torch.from_numpy(x))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), _ref_conv_acc(jq, x))
    with mx.cpu():
        got = tq(mx.nd.array(x)).asnumpy()
    with jmx.cpu():
        want = jq(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)


def test_channels_last_conv_is_refused():
    with mx.cpu():
        c = mx.gluon.nn.Conv2D(4, 3, layout="NHWC", in_channels=3)
        c.initialize()
    with pytest.raises(NotImplementedError):
        qz.QuantizedConv2D(c, None)


@pytest.fixture(scope="module")
def resnet18_pair():
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon.model_zoo import vision
    jmx.random.seed(6)
    rng = np.random.RandomState(1)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    calib = [rng.randn(4, 3, 32, 32).astype(np.float32) for _ in range(2)]
    jnet = jvision.resnet18_v1(classes=10)
    with jmx.cpu():
        jnet.initialize(jmx.init.Xavier())
        ref32 = jnet(jmx.nd.array(x)).asnumpy()
    tnet = vision.resnet18_v1(classes=10)
    with mx.cpu():
        tnet.initialize()
        tnet(mx.nd.array(x))
    _pair_params(jnet, tnet)
    return jnet, tnet, x, calib, ref32


def test_quantize_net_resnet18_matches_reference(resnet18_pair):
    jnet, tnet, x, calib, ref32 = resnet18_pair
    with mx.cpu():
        got32 = tnet(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got32, ref32, rtol=NET_TOL, atol=NET_TOL)
    with jmx.cpu():
        jq = jqz.quantize_net(jnet, calib_mode="naive",
                              calib_data=[jmx.nd.array(c) for c in calib])
        want = jq(jmx.nd.array(x)).asnumpy()
    with mx.cpu():
        tq = qz.quantize_net(tnet, calib_mode="naive",
                             calib_data=[mx.nd.array(c) for c in calib])
        got = tq(mx.nd.array(x)).asnumpy()
    n_q = sum(isinstance(b, (qz.QuantizedDense, qz.QuantizedConv2D))
              for _, _, _, b in qz._walk(tq))
    assert n_q == 21      # 20 convolutions and the output Dense
    np.testing.assert_allclose(got, want, rtol=NET_TOL, atol=NET_TOL)
    cos = (ref32 * got).sum() / (np.linalg.norm(ref32) *
                                 np.linalg.norm(got))
    assert cos > 0.99, cos
    assert (ref32.argmax(1) == got.argmax(1)).mean() >= 0.75


def test_quantize_net_excludes_layers():
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(16), mx.gluon.nn.Dense(8),
                    mx.gluon.nn.Dense(4))
        net.initialize()
        net(mx.nd.array(np.random.randn(4, 10).astype(np.float32)))
        kids = list(net._children.values())
        qnet = qz.quantize_net(net, calib_mode="none",
                               exclude_layers=[kids[0].name],
                               exclude_layers_match=["2"])
    kids = list(qnet._children.values())
    assert [type(k).__name__ for k in kids] == ["Dense", "QuantizedDense",
                                                "Dense"]


def test_quantize_net_hybridized_calibrates():
    rng = np.random.RandomState(2)
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(16, activation="relu"),
                    mx.gluon.nn.Dense(4))
        net.initialize(mx.init.Xavier())
        net.hybridize()
        x = mx.nd.array(rng.randn(8, 6).astype(np.float32))
        ref = net(x).asnumpy()
        qnet = qz.quantize_net(net, calib_mode="entropy",
                               calib_data=rng.randn(8, 6).astype(np.float32))
        kids = list(qnet._children.values())
        assert all(isinstance(k, qz.QuantizedDense) for k in kids)
        assert all(k._act_max is not None and k._active for k in kids)
        assert all(k.forward.__func__ is type(k).forward for k in kids)
        out = qnet(x).asnumpy()
    assert np.isfinite(out).all()
    cos = (ref * out).sum() / (np.linalg.norm(ref) * np.linalg.norm(out))
    assert cos > 0.95, cos


def _sym_model(pkg):
    sym = pkg.sym
    data = sym.Variable("data")
    c1 = sym.Convolution(data, sym.Variable("c1_w"), sym.Variable("c1_b"),
                         kernel=(3, 3), num_filter=8, pad=(1, 1), name="c1")
    a1 = sym.Activation(c1, act_type="relu")
    f1 = sym.FullyConnected(a1, sym.Variable("f1_w"), sym.Variable("f1_b"),
                            num_hidden=10, name="f1")
    return sym.softmax(f1, name="sm")


def _quantize_model(pkg, qmod, calib_mode, x, params):
    out = _sym_model(pkg)
    with pkg.cpu():
        arg_params = {k: pkg.nd.array(v) for k, v in params.items()}
        qsym, qarg, _ = qmod.quantize_model(
            out, arg_params, {}, calib_mode=calib_mode, ctx=pkg.cpu(),
            calib_data=pkg.nd.array(x) if calib_mode != "none" else None)
        mod = pkg.mod.Module(qsym, data_names=("data",), label_names=None,
                             context=pkg.cpu())
        mod.bind(data_shapes=[("data", x.shape)], for_training=False)
        mod.init_params(arg_params=qarg, aux_params={})
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x)]), is_train=False)
        res = mod.get_outputs()[0].asnumpy()
    return json.loads(qsym.tojson()), {k: v.asnumpy() for k, v in
                                       qarg.items()}, res


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_model_graph_and_outputs(calib_mode):
    rng = np.random.RandomState(0)
    params = {"c1_w": rng.randn(8, 3, 3, 3) * 0.1, "c1_b": rng.randn(8) * 0.1,
              "f1_w": rng.randn(10, 512) * 0.1, "f1_b": rng.randn(10) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.rand(4, 3, 8, 8).astype(np.float32)
    jg, jarg, jout = _quantize_model(jmx, jqz, calib_mode, x, params)
    tg, targ, tout = _quantize_model(mx, qz, calib_mode, x, params)
    strip = [{k: n[k] for k in ("op", "name", "inputs")} for n in tg["nodes"]]
    assert strip == [{k: n[k] for k in ("op", "name", "inputs")}
                     for n in jg["nodes"]]
    for a, b in zip(tg["nodes"], jg["nodes"]):
        attrs_a, attrs_b = a.get("attrs", {}), b.get("attrs", {})
        assert sorted(attrs_a) == sorted(attrs_b), a["name"]
        for k in attrs_b:
            if k.endswith("calib_range"):
                assert abs(float(attrs_a[k]) - float(attrs_b[k])) <= \
                    THRESH_REL * abs(float(attrs_b[k])), (a["name"], k)
            else:
                assert attrs_a[k] == attrs_b[k], (a["name"], k)
    assert tg["heads"] == jg["heads"] and tg["arg_nodes"] == jg["arg_nodes"]
    assert sorted(targ) == sorted(jarg)
    assert "c1_w" not in targ and targ["c1_w_quantize"].dtype == np.int8
    for k in jarg:
        np.testing.assert_array_equal(targ[k], jarg[k], err_msg=k)
    np.testing.assert_allclose(tout, jout, rtol=NET_TOL, atol=NET_TOL)


def test_quantize_model_excludes():
    rng = np.random.RandomState(0)
    out = _sym_model(mx)
    with mx.cpu():
        args = {"c1_w": mx.nd.array(rng.randn(8, 3, 3, 3)),
                "c1_b": mx.nd.array(rng.randn(8)),
                "f1_w": mx.nd.array(rng.randn(10, 512)),
                "f1_b": mx.nd.array(rng.randn(10))}
        qsym, qarg, _ = qz.quantize_model(out, args, {},
                                          excluded_sym_names=["c1"],
                                          calib_mode="none")
    assert "c1_w" in qarg and "c1_w_quantize" not in qarg
    assert "f1_w_quantize" in qarg


@pytest.mark.cuda
def test_quantized_conv_accumulator_card_equals_cpu():
    """The first quantized convolution's int32 accumulator on the card is
    bit-equal to the CPU's (the float64 route sums integers exactly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(4)
    x = rng.normal(size=(8, 3, 32, 32)).astype(np.float32)
    accs = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx:
            c = mx.gluon.nn.Conv2D(64, 7, strides=2, padding=3,
                                   in_channels=3)
            c.initialize(mx.init.Xavier())
            c.weight.set_data(mx.nd.array(
                np.random.RandomState(5).normal(
                    size=(64, 3, 7, 7)).astype(np.float32)))
            for act_max in (None, 2.0):
                q = qz.QuantizedConv2D(c, act_max)
                acc, _ = q.accumulate(torch.from_numpy(x).to(
                    c.weight.data()._data.device))
                accs.append(acc.cpu().numpy())
    np.testing.assert_array_equal(accs[2], accs[0])
    np.testing.assert_array_equal(accs[3], accs[1])
