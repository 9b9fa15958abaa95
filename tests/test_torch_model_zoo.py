"""The vision model zoo of the port against the reference's: all 34
`get_model` names build with the reference's structural parameter names,
full names and shapes; one forward of each family at batch 1 and the
smallest input its fixed pools accept; and each family's distinctive block
(Inception's mixed blocks A-E, DenseNet's dense layer, block and
transition, the SqueezeNet fire module, MobileNet's depthwise separable
pair and MobileNetV2's LinearBottleneck) in training mode, forward and
gradients.

Weights: the reference's initializer (Xavier), BatchNorm's four vectors
drawn from a seeded numpy generator near their defaults, all carried into
the port by `gluon_params_from_jax`. The whole-model forwards run in
predict mode; their outputs agree within FWD_TOL of the largest logit
(fp32 through up to 121 layers, only the summation order differs). The
reference marks its full-size forwards of the larger models `slow`
(tests/test_model_zoo.py); so do these."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision as pvision
from mxnet_tpu_torch.models import gluon_params_from_jax

FWD_TOL = 1e-4
BLOCK_TOL = 1e-4

NAMES = ["resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
         "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
         "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16", "vgg19",
         "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet",
         "densenet121", "densenet161", "densenet169", "densenet201",
         "squeezenet1.0", "squeezenet1.1", "inceptionv3", "mobilenet1.0",
         "mobilenet0.75", "mobilenet0.5", "mobilenet0.25", "mobilenetv2_1.0",
         "mobilenetv2_0.75", "mobilenetv2_0.5", "mobilenetv2_0.25"]


def _close(got, want, what, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _table(net):
    return {k: (p.shape, p.name)
            for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("name", NAMES)
def test_get_model_builds_with_the_reference_names(name):
    want = _table(jvision.get_model(name))
    with mx.cpu():
        got = _table(pvision.get_model(name))
    assert got == want


def test_get_model_accepts_every_reference_name():
    with pytest.raises(ValueError) as jerr:
        jvision.get_model("resnet999_v9")
    with pytest.raises(ValueError) as perr:
        pvision.get_model("resnet999_v9")
    assert str(perr.value) == str(jerr.value)
    assert sorted(NAMES) == sorted(pvision._MODELS)
    assert mx.gluon.model_zoo.get_model is pvision.get_model


@pytest.mark.parametrize("name", ["alexnet", "vgg16", "squeezenet1.0",
                                  "densenet121", "inceptionv3",
                                  "mobilenet0.5", "mobilenetv2_0.5"])
def test_pretrained_raises(name):
    with pytest.raises(ValueError, match="pretrained"):
        pvision.get_model(name, pretrained=True)


def _carry(jnet, x, seed):
    """Initialize the reference net (Xavier), resolve its shapes with one
    forward, draw BatchNorm's vectors near their defaults, and return its
    parameters by structural name."""
    jmx.random.seed(seed)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.cpu(), jmx.autograd.predict_mode():
        jnet(jmx.nd.array(x))
    rng = np.random.RandomState(seed)
    arrays = {}
    for k, p in jnet._collect_params_with_prefix().items():
        v = p.data().asnumpy()
        if k.endswith(("gamma", "running_var")):
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k.endswith(("beta", "running_mean")):
            v = rng.randn(*v.shape) * 0.1
        elif k.endswith("bias"):
            v = rng.randn(*v.shape) * 0.05
        v = v.astype(np.float32)
        p.set_data(jmx.nd.array(v))
        arrays[k] = v
    return arrays


def check_model(name, hw, seed=0):
    x = np.random.RandomState(seed + 1).rand(1, 3, hw, hw).astype(np.float32)
    jnet = jvision.get_model(name, classes=10)
    arrays = _carry(jnet, x, seed)
    with jmx.cpu(), jmx.autograd.predict_mode():
        want = jnet(jmx.nd.array(x)).asnumpy()
    with mx.cpu():
        net = pvision.get_model(name, classes=10)
        net.initialize(ctx=mx.cpu())
        gluon_params_from_jax(arrays, net, ctx=mx.cpu())
        net.hybridize()
        with mx.autograd.predict_mode():
            got = net(mx.nd.array(x)).asnumpy()
    assert want.shape == (1, 10) and np.isfinite(want).all()
    assert np.abs(want).max() > 1e-3
    _close(got, want, name, FWD_TOL)


# batch 1 at the smallest input each family's fixed pools accept: AlexNet
# and VGG (no fixed pool: their flatten + Dense takes any map) at their
# smallest, MobileNet's global pool at 32, SqueezeNet's 13x13 head pool at
# 224. The larger families' only size is full size (below, slow).
FAST = [("alexnet", 63), ("vgg11_bn", 32), ("squeezenet1.1", 224),
        ("mobilenet1.0", 32), ("mobilenetv2_1.0", 32)]
SLOW = [("inceptionv3", 299), ("densenet121", 224), ("squeezenet1.0", 224),
        ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224), ("vgg11", 224),
        ("vgg11_bn", 224), ("alexnet", 224)]


@pytest.mark.parametrize("name,hw", FAST)
def test_model_forward_matches_reference(name, hw):
    check_model(name, hw)


@pytest.mark.slow
@pytest.mark.parametrize("name,hw", SLOW)
def test_full_size_model_forward_matches_reference(name, hw):
    check_model(name, hw)


# -- the families' distinctive blocks ----------------------------------------

def _run(pkg, blk, x):
    with pkg.cpu():
        xa = pkg.nd.array(x)
        xa.attach_grad()
        with pkg.autograd.record():
            y = blk(xa)
            cot = np.random.RandomState(5).randn(*y.shape).astype(np.float32)
            (y * pkg.nd.array(cot)).sum().backward()
        grads = {k: p.grad().asnumpy()
                 for k, p in blk._collect_params_with_prefix().items()
                 if p.grad_req != "null"}
        return y.asnumpy(), xa.grad.asnumpy(), grads


def check_block(make, shape, seed=0):
    """make(vision module of a package) -> block; training mode."""
    x = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    jb = make(jvision)
    arrays = _carry(jb, x, seed)
    with mx.cpu():
        pb = make(pvision)
        pb.initialize(ctx=mx.cpu())
        gluon_params_from_jax(arrays, pb, ctx=mx.cpu())
    assert _table(pb) == _table(jb)
    want, got = _run(jmx, jb, x), _run(mx, pb, x)
    _close(got[0], want[0], "output", BLOCK_TOL)
    _close(got[1], want[1], "input gradient", BLOCK_TOL)
    assert sorted(got[2]) == sorted(want[2])
    for k, g in want[2].items():
        _close(got[2][k], g, k, BLOCK_TOL)


BLOCKS = {
    "inception_A": (lambda v: v.inception._make_A(32, "A1_"), (2, 8, 7, 7)),
    "inception_B": (lambda v: v.inception._make_B("B_"), (2, 8, 9, 9)),
    "inception_C": (lambda v: v.inception._make_C(128, "C1_"),
                    (2, 8, 5, 5)),
    "inception_D": (lambda v: v.inception._make_D("D_"), (2, 8, 9, 9)),
    "inception_E": (lambda v: v.inception._make_E("E1_"), (2, 8, 4, 4)),
    "densenet_layer": (lambda v: v.densenet._DenseLayer(8, 4, 0),
                       (2, 6, 5, 5)),
    "densenet_block": (lambda v: v.densenet._make_dense_block(
        3, 4, 8, 0, 1), (2, 6, 5, 5)),
    "densenet_transition": (lambda v: v.densenet._make_transition(5),
                            (2, 6, 6, 6)),
    "squeezenet_fire": (lambda v: v.squeezenet._make_fire(16, 64, 64),
                        (2, 24, 7, 7)),
    "mobilenet_conv_dw": (lambda v: _conv_dw(v, 16, 32, 2), (2, 16, 8, 8)),
    "mobilenetv2_bottleneck": (lambda v: v.mobilenet.LinearBottleneck(
        16, 16, 6, 1), (2, 16, 6, 6)),
    "mobilenetv2_bottleneck_stride2": (lambda v: v.mobilenet.LinearBottleneck(
        16, 24, 6, 2), (2, 16, 7, 7)),
}


def _conv_dw(v, dw_channels, channels, stride):
    """MobileNet's depthwise 3x3 (groups = channels) + pointwise 1x1."""
    out = v.mobilenet.nn.HybridSequential(prefix="dw_")
    with out.name_scope():
        v.mobilenet._add_conv_dw(out, dw_channels, channels, stride)
    return out


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_family_block_matches_reference(block):
    make, shape = BLOCKS[block]
    check_block(make, shape)
