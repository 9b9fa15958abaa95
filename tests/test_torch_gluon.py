"""The port's Gluon inference path against the JAX package's.

Narrow ResNets are built on both sides under the same name scope, so their
parameters carry the same names. The reference net gets random weights and
random running statistics (numpy, from a seed) through `set_data` and
writes them with `save_parameters`; the port loads the file. Predict-mode
logits then agree: fp32 within 1e-4 relative (summation order only), and
after `cast("bfloat16")` on both sides within 2e-2 relative with the same
top-1 (bf16 rounds at each layer's output on both sides). With
MXNET_TPU_FUSED_CONVBN=1 the bottleneck 3x3 convs are the fused blocks,
whose op runs its plain version here (the kernel needs a card). The ops
the layers call are also held one by one against the reference's.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from _torch_seed import _seed_torch  # noqa: F401

FP32_REL = 1e-4
BF16_REL = 2e-2

NETS = {
    # name: (net, block, layers, channels, layout, input shape, fused gate)
    "fused_bottleneck_nhwc": ("ResNetV1", "BottleneckV1", [1, 1],
                              [16, 32, 64], "NHWC", (4, 8, 8, 3), True),
    "bottleneck_nhwc": ("ResNetV1", "BottleneckV1", [1, 1], [16, 32, 64],
                        "NHWC", (4, 8, 8, 3), False),
    "basic_nchw": ("ResNetV1", "BasicBlockV1", [1, 1], [8, 8, 16], "NCHW",
                   (4, 3, 8, 8), False),
    "v2_bottleneck_nhwc": ("ResNetV2", "BottleneckV2", [1, 1],
                           [16, 32, 64], "NHWC", (4, 8, 8, 3), False),
    "v2_basic_nchw": ("ResNetV2", "BasicBlockV2", [1, 1], [8, 8, 16], "NCHW",
                      (4, 3, 8, 8), False),
}


def _make(pkg, monkeypatch, name):
    net, block, layers, channels, layout, _, fused = NETS[name]
    monkeypatch.setenv("MXNET_TPU_FUSED_CONVBN", "1" if fused else "0")
    res = pkg.gluon.model_zoo.vision.resnet
    with pkg.name.NameManager():
        return getattr(res, net)(getattr(res, block), layers, channels,
                                 classes=10, thumbnail=True, layout=layout)


def _input(name, seed=1):
    return np.random.RandomState(seed).randn(*NETS[name][5]).astype(
        np.float32)


def _random_params(jnet, seed=0):
    """{structural name: numpy array}: weights N(0, 1/fan_in), gamma and
    running_var in [0.5, 1.5), beta, running_mean and biases N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in jnet._collect_params_with_prefix().items():
        shape = p.shape
        if name.endswith(("gamma", "running_var")):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith(("beta", "running_mean", "bias")):
            a = rng.randn(*shape) * 0.1
        else:
            fan_out = shape[-1] if "fusedconvbnrelutrain" in p.name \
                else shape[0]
            a = rng.randn(*shape) / np.sqrt(np.prod(shape) / fan_out)
        out[name] = a.astype(np.float32)
    return out


def _reference(monkeypatch, name, tmp_path):
    """The reference net with random parameters, and its .params file."""
    jnet = _make(jmx, monkeypatch, name)
    jnet.initialize(ctx=jmx.cpu())
    with jmx.autograd.predict_mode():
        jnet(jmx.nd.array(_input(name)))       # resolve deferred shapes
    arrays = _random_params(jnet)
    params = jnet._collect_params_with_prefix()
    for k, a in arrays.items():
        params[k].set_data(jmx.nd.array(a))
    f = str(tmp_path / "ref.params")
    jnet.save_parameters(f)
    return jnet, arrays, f


def _logits(pkg, net, x, dtype="float32"):
    ctx = pkg.cpu()
    with pkg.autograd.predict_mode():
        out = net(pkg.nd.array(x, ctx=ctx, dtype=dtype))
    return np.asarray(out.asnumpy(), dtype=np.float32)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(NETS))
def test_resnet_logits_match_reference(monkeypatch, tmp_path, name, dtype):
    jnet, _, f = _reference(monkeypatch, name, tmp_path)
    pnet = _make(mx, monkeypatch, name)
    pnet.load_parameters(f, ctx=mx.cpu())
    if dtype == "bfloat16":
        jnet.cast(dtype)
        pnet.cast(dtype)
    x = _input(name)
    want = _logits(jmx, jnet, x, dtype)
    got = _logits(mx, pnet, x, dtype)
    assert got.shape == (x.shape[0], 10) and np.isfinite(got).all()
    if dtype == "float32":
        assert _rel(got, want) <= FP32_REL
    else:
        assert _rel(got, want) <= BF16_REL
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_gluon_params_from_jax_matches_file_route(monkeypatch, tmp_path):
    name = "fused_bottleneck_nhwc"
    jnet, arrays, f = _reference(monkeypatch, name, tmp_path)
    by_file = _make(mx, monkeypatch, name)
    by_file.load_parameters(f, ctx=mx.cpu())
    by_convert = _make(mx, monkeypatch, name)
    mx.models.gluon_params_from_jax(
        {k: v.data().asnumpy()
         for k, v in jnet._collect_params_with_prefix().items()},
        by_convert, ctx=mx.cpu())
    x = _input(name)
    np.testing.assert_array_equal(_logits(mx, by_convert, x),
                                  _logits(mx, by_file, x))


@pytest.mark.parametrize("bad", ["missing", "extra", "shape"])
def test_gluon_params_from_jax_rejects_mismatches(monkeypatch, tmp_path,
                                                  bad):
    name = "basic_nchw"
    _, arrays, _ = _reference(monkeypatch, name, tmp_path)
    key = sorted(arrays)[0]
    if bad == "missing":
        del arrays[key]
    elif bad == "extra":
        arrays["features.99.weight"] = arrays[key]
    else:
        arrays[key] = arrays[key][:1]
    with pytest.raises(ValueError, match=bad if bad != "shape" else "shape"):
        mx.models.gluon_params_from_jax(arrays, _make(mx, monkeypatch, name),
                                        ctx=mx.cpu())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_files_cross_bit_exactly(monkeypatch, tmp_path, dtype):
    """The port reads the reference's file, and the reference reads the
    port's, bit for bit (bf16 records as raw bits on the port's side)."""
    name = "fused_bottleneck_nhwc"
    jnet, _, f = _reference(monkeypatch, name, tmp_path)
    jnet.cast(dtype)
    jnet.save_parameters(f)
    pnet = _make(mx, monkeypatch, name)
    pnet.cast(dtype)
    pnet.load_parameters(f, ctx=mx.cpu())
    g = str(tmp_path / "port.params")
    pnet.save_parameters(g)
    ref, back = jmx.nd.load(f), jmx.nd.load(g)
    assert sorted(ref) == sorted(back)
    for k in ref:
        a, b = ref[k].asnumpy(), back[k].asnumpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    params = pnet._collect_params_with_prefix()
    for k, a in ref.items():
        t = params[k].data().data_torch
        want = a.asnumpy()
        if want.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)


def test_load_parameterdict_save_format(monkeypatch, tmp_path):
    """load_parameters also takes a file saved under full names."""
    name = "basic_nchw"
    jnet, _, _ = _reference(monkeypatch, name, tmp_path)
    f = str(tmp_path / "full.params")
    jnet.collect_params().save(f, strip_prefix=jnet.prefix)
    pnet = _make(mx, monkeypatch, name)
    pnet.load_parameters(f, ctx=mx.cpu())
    x = _input(name)
    assert _rel(_logits(mx, pnet, x), _logits(jmx, jnet, x)) <= FP32_REL


@pytest.mark.parametrize("name", ["fused_bottleneck_nhwc", "basic_nchw"])
def test_parameter_names_match_reference(monkeypatch, name):
    jnet = _make(jmx, monkeypatch, name)
    pnet = _make(mx, monkeypatch, name)
    assert list(pnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    assert list(pnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())
    if name.startswith("fused"):
        assert any("fusedconvbnrelutrain" in k
                   for k in pnet.collect_params().keys())


def test_resnet50_v1_fused_structure(monkeypatch):
    """resnet50_v1(layout="NHWC") under the gate: 16 fused blocks (every
    bottleneck 3x3 conv is stride 1), with the reference's names."""
    monkeypatch.setenv("MXNET_TPU_FUSED_CONVBN", "1")
    with mx.name.NameManager():
        pnet = mx.gluon.model_zoo.vision.resnet50_v1(layout="NHWC")
    with jmx.name.NameManager():
        jnet = jmx.gluon.model_zoo.vision.resnet50_v1(layout="NHWC")
    fused = []
    pnet.apply(lambda b: fused.append(b) if isinstance(
        b, mx.gluon.contrib.cnn.FusedConvBNReLUTrain) else None)
    assert len(fused) == 16
    assert list(pnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    assert mx.gluon.model_zoo.get_model("resnet50_v1").name.startswith(
        "resnetv1")


def test_bf16_cast_keeps_batchnorm_fp32(monkeypatch):
    pnet = _make(mx, monkeypatch, "fused_bottleneck_nhwc")
    pnet.initialize(ctx=mx.cpu())
    with mx.autograd.predict_mode():
        pnet(mx.nd.array(_input("fused_bottleneck_nhwc"), ctx=mx.cpu()))
    pnet.cast("bfloat16")
    for k, p in pnet.collect_params().items():
        want = "float32" if k.endswith(("gamma", "beta", "running_mean",
                                        "running_var")) else "bfloat16"
        assert p.dtype == want, k
        assert p.data().dtype == want, k


def test_deferred_init_resolves_from_first_input():
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(6, 3, padding=1, layout="NHWC"))
        net.add(mx.gluon.nn.BatchNorm(axis=-1))
        net.add(mx.gluon.nn.Dense(5))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    conv, _, dense = net[0], net[1], net[2]
    assert conv.weight.shape == (6, 3, 3, 0)
    with pytest.raises(mx.gluon.DeferredInitializationError):
        conv.weight.data()
    with mx.autograd.predict_mode():
        out = net(mx.nd.ones((2, 4, 4, 7), ctx=mx.cpu()))
    assert out.shape == (2, 5)
    assert conv.weight.shape == (6, 3, 3, 7)
    assert dense.weight.shape == (5, 4 * 4 * 6)
    assert net[1].gamma.data().shape == (6,)


def test_fused_block_training_mode_raises():
    """Training mode no longer raises: the fused block's training output
    (batch statistics) and its running-statistics update match the
    reference's; predict mode still folds the running statistics."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 4, 4, 8).astype(np.float32)
    res = rng.randn(2, 4, 4, 8).astype(np.float32)
    w = (rng.randn(3, 3, 8, 8) / np.sqrt(72)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    outs = []
    for pkg in (jmx, mx):
        ctx = pkg.cpu()
        blk = pkg.gluon.contrib.cnn.FusedConvBNReLUTrain(8, in_channels=8)
        blk.initialize(ctx=ctx)
        blk.weight.set_data(pkg.nd.array(w, ctx=ctx))
        blk.gamma.set_data(pkg.nd.array(gamma, ctx=ctx))
        with pkg.autograd.train_mode():
            y = blk(pkg.nd.array(x, ctx=ctx), pkg.nd.array(res, ctx=ctx))
        with pkg.autograd.predict_mode():
            z = blk(pkg.nd.array(x, ctx=ctx))
        outs.append([y.asnumpy(), blk.running_mean.data().asnumpy(),
                     blk.running_var.data().asnumpy(), z.asnumpy()])
    assert outs[1][0].shape == (2, 4, 4, 8)
    assert np.abs(outs[1][1]).max() > 0.0        # the statistics moved
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fused_convbnrelu_from_layers_matches_reference():
    rng = np.random.RandomState(7)
    w = rng.randn(8, 3, 3, 4).astype(np.float32) * 0.2      # OHWI (NHWC)
    stats = [rng.uniform(0.5, 1.5, 8), rng.randn(8) * 0.1,
             rng.randn(8) * 0.1, rng.uniform(0.5, 1.5, 8)]
    x = rng.randn(2, 5, 5, 4).astype(np.float32)
    res = rng.randn(2, 5, 5, 8).astype(np.float32)
    outs = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        conv = pkg.gluon.nn.Conv2D(8, 3, padding=1, use_bias=False,
                                   in_channels=4, layout="NHWC")
        bn = pkg.gluon.nn.BatchNorm(axis=-1, in_channels=8)
        for blk in (conv, bn):
            blk.initialize(ctx=ctx)
        conv.weight.set_data(pkg.nd.array(w, ctx=ctx))
        for p, a in zip((bn.gamma, bn.beta, bn.running_mean,
                         bn.running_var), stats):
            p.set_data(pkg.nd.array(a, ctx=ctx))
        fused = pkg.gluon.contrib.cnn.FusedConvBNReLU.from_layers(conv, bn)
        with pkg.autograd.predict_mode():
            outs.append(fused(pkg.nd.array(x, ctx=ctx),
                              pkg.nd.array(res, ctx=ctx)).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5)
    with pytest.raises(ValueError, match="NHWC"):
        mx.gluon.contrib.cnn.FusedConvBNReLU.from_layers(
            mx.gluon.nn.Conv2D(8, 3, padding=1, use_bias=False), bn)


def test_default_context_is_the_card(monkeypatch):
    assert mx.current_context() == mx.gpu(0)
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        assert mx.nd.zeros((2,)).context == mx.cpu()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="ctx=mx.cpu()"):
        mx.nd.array([1.0, 2.0])
    blk = mx.gluon.contrib.cnn.FusedConvBNReLUTrain(8, in_channels=8)
    with pytest.raises(MXNetError):
        blk.initialize()


def test_asnumpy_of_bf16_is_float32():
    a = mx.nd.array([1.0, 1.00390625, -3.5], ctx=mx.cpu(), dtype="bfloat16")
    assert a.dtype == "bfloat16"
    out = a.asnumpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, [1.0, 1.0, -3.5])   # rounded on entry


def test_ndarray_basics_and_save_load(tmp_path):
    ctx = mx.cpu()
    a = mx.nd.array(np.arange(6).reshape(2, 3), ctx=ctx)
    b = mx.nd.ones((2, 3), ctx=ctx)
    np.testing.assert_array_equal((a + b).asnumpy(), np.arange(1, 7)
                                  .reshape(2, 3))
    np.testing.assert_array_equal((2.0 - a).asnumpy(), 2.0 - a.asnumpy())
    assert a.dtype == np.float32 and a.astype("int32").dtype == np.int32
    assert mx.nd.Flatten(mx.nd.zeros((2, 3, 4), ctx=ctx)).shape == (2, 12)
    f = str(tmp_path / "a.params")
    data = {"a": a, "b": a.astype("bfloat16"), "c": a.astype("int64")}
    mx.nd.save(f, data)
    back = mx.nd.load(f)
    for k in data:
        assert back[k].dtype == data[k].dtype
        assert torch.equal(back[k].data_torch, data[k].data_torch)
    ref = jmx.nd.load(f)                     # the reference reads it too
    np.testing.assert_array_equal(ref["a"].asnumpy(), a.asnumpy())
    assert ref["b"].asnumpy().dtype.name == "bfloat16"
    mx.nd.save(f, [a])
    assert isinstance(mx.nd.load(f), list)


def test_random_seed_is_deterministic():
    ctx = mx.cpu()
    mx.random.seed(3)
    a = mx.random.normal(0, 1, shape=(4,), ctx=ctx).asnumpy()
    mx.random.seed(3)
    b = mx.random.normal(0, 1, shape=(4,), ctx=ctx).asnumpy()
    np.testing.assert_array_equal(a, b)
    net = mx.gluon.nn.Dense(64, in_units=32)
    net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=ctx)
    w = net.weight.data().asnumpy()
    assert abs(w.std() - np.sqrt(3.0 / 48.0)) < 0.02


@pytest.mark.parametrize("case", [
    ("Pooling", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="max", layout="NHWC")),
    ("Pooling", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="avg", layout="NCHW",
                     pooling_convention="full")),
    ("Pooling", dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1),
                     pool_type="avg", count_include_pad=False,
                     layout="NCHW")),
    ("Pooling", dict(kernel=(1, 1), global_pool=True, pool_type="max",
                     layout="NHWC")),
    ("Convolution", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         num_filter=8, num_group=2, layout="NHWC")),
    ("Convolution", dict(kernel=(3, 3), stride=(1, 2), pad=(0, 1),
                         dilate=(2, 1), num_filter=6, layout="NCHW")),
    ("BatchNorm", dict(axis=-1, fix_gamma=False, use_global_stats=True,
                       eps=1e-5)),
    ("BatchNorm", dict(axis=1, fix_gamma=True, eps=1e-3)),
    ("FullyConnected", dict(num_hidden=5)),
], ids=lambda c: c[0] + "-" + "-".join(
    "%s=%s" % (k, v) for k, v in sorted(c[1].items())
    if k in ("pool_type", "layout", "num_group", "fix_gamma",
             "pooling_convention", "count_include_pad", "axis")))
def test_ops_match_reference(case):
    """The op set of the ResNet layers against the reference's, fp32."""
    op, kw = case
    rng = np.random.RandomState(11)
    x = rng.randn(2, 7, 9, 8).astype(np.float32)
    if op == "Convolution":
        k = kw["kernel"]
        last = kw["layout"] == "NHWC"
        cin = x.shape[-1 if last else 1] // kw.get("num_group", 1)
        wshape = (kw["num_filter"],) + k + (cin,) if last \
            else (kw["num_filter"], cin) + k
        args = [x, rng.randn(*wshape).astype(np.float32),
                rng.randn(kw["num_filter"]).astype(np.float32)]
    elif op == "BatchNorm":
        c = x.shape[kw["axis"]]
        args = [x, rng.uniform(0.5, 1.5, c), rng.randn(c),
                rng.randn(c) * 0.1, rng.uniform(0.5, 1.5, c)]
        args = [a.astype(np.float32) for a in args]
    elif op == "FullyConnected":
        args = [x, rng.randn(5, 7 * 9 * 8).astype(np.float32),
                rng.randn(5).astype(np.float32)]
    else:
        args = [x]
    want = getattr(jmx.nd, op)(*(jmx.nd.array(a) for a in args), **kw)
    got = getattr(mx.nd, op)(*(mx.nd.array(a, ctx=mx.cpu()) for a in args),
                             **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                               atol=1e-5)
