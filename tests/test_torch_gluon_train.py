"""The port's Gluon training path against the JAX package's.

Narrow ResNets are built on both sides under the same name scope (the
fused bottleneck in NHWC with MXNET_TPU_FUSED_CONVBN=1, the composed
bottleneck in NHWC, the basic block in NCHW). The reference net gets
random weights and running statistics (numpy, from a seed) and writes
them with `save_parameters`; the port loads the file. Both then train
from that state on one seeded batch: the imperative loop (record ->
backward -> trainer.step) with SGD-momentum and with Adam, and
`FusedTrainStep`, 3 steps each. The per-step loss, the parameters and the
running statistics after must agree: fp32 within 1e-4 relative (the
summation order only; the port's fused block runs its kernels' plain
versions here), bf16 within 2e-2 (each layer rounds to bf16 at other
places on the two sides). The ops and blocks the path adds (BatchNorm's
training form, the losses) are held one by one against the reference's.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from _torch_seed import _seed_torch  # noqa: F401

FP32_REL = 1e-4
BF16_REL = 2e-2
STEPS = 3

NETS = {
    # name: (net, block, layers, channels, layout, input shape, fused gate)
    "fused_bottleneck_nhwc": ("ResNetV1", "BottleneckV1", [1, 1],
                              [16, 32, 64], "NHWC", (4, 8, 8, 3), True),
    "bottleneck_nhwc": ("ResNetV1", "BottleneckV1", [1, 1], [16, 32, 64],
                        "NHWC", (4, 8, 8, 3), False),
    "basic_nchw": ("ResNetV1", "BasicBlockV1", [1, 1], [8, 8, 16], "NCHW",
                   (4, 3, 8, 8), False),
}
OPTIMIZERS = {
    "sgd": ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    "adam": ("adam", {"learning_rate": 1e-3, "wd": 1e-4}),
}


def _make(pkg, monkeypatch, name):
    net, block, layers, channels, layout, _, fused = NETS[name]
    monkeypatch.setenv("MXNET_TPU_FUSED_CONVBN", "1" if fused else "0")
    res = pkg.gluon.model_zoo.vision.resnet
    with pkg.name.NameManager():
        return getattr(res, net)(getattr(res, block), layers, channels,
                                 classes=10, thumbnail=True, layout=layout)


def _batch(name, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(*NETS[name][5]).astype(np.float32)
    y = rng.randint(0, 10, NETS[name][5][0]).astype(np.float32)
    return x, y


def _random_params(jnet, seed=0):
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


def _pair(monkeypatch, tmp_path, name, dtype):
    """(reference net, port net) with the same random state, cast to
    `dtype` (BatchNorm stays fp32 on both sides)."""
    jnet = _make(jmx, monkeypatch, name)
    jnet.initialize(ctx=jmx.cpu())
    with jmx.autograd.predict_mode():
        jnet(jmx.nd.array(_batch(name)[0]))
    params = jnet._collect_params_with_prefix()
    for k, a in _random_params(jnet).items():
        params[k].set_data(jmx.nd.array(a))
    f = str(tmp_path / "ref.params")
    jnet.save_parameters(f)
    pnet = _make(mx, monkeypatch, name)
    pnet.load_parameters(f, ctx=mx.cpu())
    if dtype != "float32":
        jnet.cast(dtype)
        pnet.cast(dtype)
    return jnet, pnet


def _state(net):
    return {k: np.asarray(p.data().asnumpy(), np.float32)
            for k, p in net._collect_params_with_prefix().items()}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _zero_gradient(name):
    """A conv bias of these ResNets feeds a batch-statistics BatchNorm, so
    its gradient is zero in exact arithmetic and rounding noise in
    practice (the Dense layer's is real)."""
    return name.endswith(".bias") and not name.startswith("output.")


def _assert_states_close(got, want, tol, opt):
    assert sorted(got) == sorted(want)
    for k in want:
        if opt == "adam" and _zero_gradient(k):
            # Adam divides by the gradient's own magnitude, which turns
            # the rounding noise into full steps of random sign; the bias
            # has no effect on the output (BatchNorm removes it)
            continue
        assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))


def _imperative(pkg, net, trainer, x, y):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return float(np.asarray(loss.asnumpy(), np.float32).mean())


def _run(pkg, net, route, opt, dtype, name):
    x, y = _batch(name)
    ctx = pkg.cpu()
    xs = pkg.nd.array(x, ctx=ctx, dtype=dtype)
    ys = pkg.nd.array(y, ctx=ctx)
    kind, kw = OPTIMIZERS[opt]
    trainer = pkg.gluon.Trainer(net.collect_params(), kind, dict(kw))
    losses = []
    if route == "fused":
        step = pkg.gluon.FusedTrainStep(
            net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), trainer)
        for _ in range(STEPS):
            losses.append(float(np.asarray(step(xs, ys).asnumpy(),
                                           np.float32)))
    else:
        for _ in range(STEPS):
            losses.append(_imperative(pkg, net, trainer, xs, ys))
    return np.array(losses), _state(net)


FUSED, COMPOSED, BASIC = NETS
CASES = [
    # net, dtype, optimizer, route
    (FUSED, "float32", "sgd", "imperative"),
    (FUSED, "bfloat16", "sgd", "imperative"),
    (FUSED, "float32", "adam", "imperative"),
    (FUSED, "bfloat16", "adam", "imperative"),
    (COMPOSED, "float32", "sgd", "imperative"),
    (COMPOSED, "bfloat16", "adam", "imperative"),
    (BASIC, "float32", "adam", "imperative"),
    (BASIC, "bfloat16", "sgd", "imperative"),
    (FUSED, "float32", "sgd", "fused"),
    (FUSED, "bfloat16", "sgd", "fused"),
    (FUSED, "float32", "adam", "fused"),
    (COMPOSED, "bfloat16", "sgd", "fused"),
    (BASIC, "float32", "sgd", "fused"),
]


@pytest.mark.parametrize("name,dtype,opt,route", CASES,
                         ids=["-".join(c) for c in CASES])
def test_training_matches_reference(monkeypatch, tmp_path, name, dtype, opt,
                                    route):
    jnet, pnet = _pair(monkeypatch, tmp_path, name, dtype)
    want_loss, want = _run(jmx, jnet, route, opt, dtype, name)
    got_loss, got = _run(mx, pnet, route, opt, dtype, name)
    tol = FP32_REL if dtype == "float32" else BF16_REL
    assert np.isfinite(got_loss).all()
    assert _rel(got_loss, want_loss) <= tol, (got_loss, want_loss)
    _assert_states_close(got, want, tol, opt)
    for k, p in pnet._collect_params_with_prefix().items():
        want_dt = "float32" if dtype == "float32" or k.endswith(
            ("gamma", "beta", "running_mean", "running_var")) else dtype
        assert p.dtype == want_dt and p.data().dtype == want_dt, k


@pytest.mark.parametrize("name", ["fused_bottleneck_nhwc", "basic_nchw"])
def test_fused_step_and_imperative_loop_agree(monkeypatch, tmp_path, name):
    """From one state, FusedTrainStep and the imperative loop leave the
    same parameters and running statistics, bit for bit, on the plain
    paths (the aux updates collected by the fused step are the values the
    imperative forward writes at once)."""
    states = []
    for route in ("fused", "imperative"):
        _, pnet = _pair(monkeypatch, tmp_path, name, "float32")
        states.append(_run(mx, pnet, route, "sgd", "float32", name))
    np.testing.assert_array_equal(states[0][0], states[1][0])
    for k in states[0][1]:
        np.testing.assert_array_equal(states[0][1][k], states[1][1][k], k)


@pytest.mark.parametrize("kw", [
    dict(axis=1, fix_gamma=False, eps=1e-5),
    dict(axis=-1, fix_gamma=True, eps=1e-3),
], ids=["axis1", "axis-1_fixgamma"])
def test_batchnorm_training_op_matches_reference(kw):
    """BatchNorm with batch statistics (output_mean_var): the output, mean
    and var, and the gradients of data, gamma and beta."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 5, 3, 6).astype(np.float32) * 2 + 0.5
    c = x.shape[kw["axis"]]
    g, b = rng.uniform(0.5, 1.5, c), rng.randn(c) * 0.1
    mm, mv = np.zeros(c), np.ones(c)
    cot = rng.randn(*x.shape).astype(np.float32)
    res = []
    for pkg in (jmx, mx):
        ctx = pkg.cpu()
        arrs = [pkg.nd.array(a, ctx=ctx) for a in (x, g, b, mm, mv)]
        for a in arrs[:3]:
            a.attach_grad()
        with pkg.autograd.record():
            out, mean, var = pkg.nd.BatchNorm(*arrs, output_mean_var=True,
                                              **kw)
        out.backward(pkg.nd.array(cot, ctx=ctx))
        res.append([a.asnumpy() for a in (out, mean, var)]
                   + [a.grad.asnumpy() for a in arrs[:3]])
    for i, (got, want) in enumerate(zip(res[1], res[0])):
        if i == 4 and kw["fix_gamma"]:
            continue        # gamma is not used
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_batchnorm_block_moves_running_stats_like_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 5, 5).astype(np.float32) * 3 + 1
    outs = []
    for pkg in (jmx, mx):
        bn = pkg.gluon.nn.BatchNorm(momentum=0.8, in_channels=6)
        bn.initialize(ctx=pkg.cpu())
        with pkg.autograd.record():
            y = bn(pkg.nd.array(x, ctx=pkg.cpu()))
        outs.append([y.asnumpy(), bn.running_mean.data().asnumpy(),
                     bn.running_var.data().asnumpy()])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(outs[1][1]).max() > 0.1


@pytest.mark.parametrize("loss,kw,dense", [
    ("SoftmaxCrossEntropyLoss", {}, False),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False, "weight": 0.5},
     True),
    ("L2Loss", {"weight": 2.0}, True),
    ("L1Loss", {}, True),
])
def test_losses_match_reference(loss, kw, dense):
    """One loss per sample, and its gradient with respect to pred, with a
    per-sample weight."""
    rng = np.random.RandomState(6)
    pred = rng.randn(5, 7).astype(np.float32)
    label = rng.rand(5, 7).astype(np.float32) if dense else \
        rng.randint(0, 7, 5).astype(np.float32)
    sw = rng.rand(5, 1).astype(np.float32)
    res = []
    for pkg in (jmx, mx):
        ctx = pkg.cpu()
        p = pkg.nd.array(pred, ctx=ctx)
        p.attach_grad()
        fn = getattr(pkg.gluon.loss, loss)(**kw)
        with pkg.autograd.record():
            out = fn(p, pkg.nd.array(label, ctx=ctx),
                     pkg.nd.array(sw, ctx=ctx))
        out.backward()
        res.append((out.asnumpy(), p.grad.asnumpy()))
    assert res[1][0].shape == (5,)
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_trainer_states_round_trip(monkeypatch, tmp_path):
    """save_states after 2 steps, load into a fresh Trainer: the third
    step is the same as without the round trip."""
    name = "basic_nchw"
    x, y = _batch(name)
    results = []
    for reload in (False, True):
        _, net = _pair(monkeypatch, tmp_path, name, "float32")
        xs, ys = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
        kind, kw = OPTIMIZERS["adam"]
        tr = mx.gluon.Trainer(net.collect_params(), kind, dict(kw))
        for _ in range(2):
            _imperative(mx, net, tr, xs, ys)
        if reload:
            f = str(tmp_path / "trainer.states")
            tr.save_states(f)
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 5.0})
            tr.load_states(f)
            assert isinstance(tr.optimizer, mx.optimizer.Adam)
        _imperative(mx, net, tr, xs, ys)
        results.append(_state(net))
    for k in results[0]:
        np.testing.assert_array_equal(results[1][k], results[0][k])


def test_rescale_grad_and_mean_loss(monkeypatch, tmp_path):
    """Trainer.step(batch) scales the gradient of the loss sum by
    1/batch, and FusedTrainStep returns the mean loss."""
    name = "basic_nchw"
    x, y = _batch(name)
    _, net = _pair(monkeypatch, tmp_path, name, "float32")
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "rescale_grad": 2.0})
    step = mx.gluon.FusedTrainStep(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    with mx.autograd.predict_mode():
        before = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(mx.nd.array(x, ctx=mx.cpu())), mx.nd.array(y, ctx=mx.cpu()))
    del before
    loss = step(mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu()))
    assert tr.optimizer.rescale_grad == 2.0 / x.shape[0]
    assert loss.shape == () and np.isfinite(loss.asnumpy())
    tr.step(2)
    assert tr.optimizer.rescale_grad == 1.0


def test_trainer_and_step_refuse_what_comes_with_later_slices():
    """The multi-rank slice brought comm_ready, compression, the dist
    stores and meshes, the tensor-parallel slice rules that split
    parameters (ROADMAP Queue A 5b: FusedTrainStep accepts them and keeps
    each parameter whole, so one step over a data=1, model=2 mesh of
    ranks is the single-card step); what still refuses: a mesh of several
    devices in one process (one process a card)."""
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu())
    params = net.collect_params()
    for kw in ({"comm_ready": True},
               {"compression_params": {"type": "2bit"}}):
        mx.gluon.Trainer(params, "sgd", **kw)
    for kw in ({"kvstore": "dist_sync"}, {"kvstore": "dist_device_sync",
                                          "zero": True}):
        tr = mx.gluon.Trainer(params, "sgd", **kw)
        with mx.autograd.record():
            loss = net(mx.nd.ones((2, 4), ctx=mx.cpu())).sum()
        loss.backward()
        tr.step(1)
    tr = mx.gluon.Trainer(params, "sgd")
    with pytest.raises(NotImplementedError, match="one process per card"):
        mx.gluon.FusedTrainStep(net, mx.gluon.loss.L2Loss(), tr,
                                mesh=[mx.cpu(0), mx.cpu(1)])
    from mxnet_tpu_torch.parallel import P
    from mxnet_tpu_torch.parallel.mesh import Mesh
    x, y = mx.nd.ones((2, 4), ctx=mx.cpu()), mx.nd.ones((2, 3),
                                                          ctx=mx.cpu())
    twin = mx.gluon.nn.Dense(3, in_units=4)
    twin.initialize(ctx=mx.cpu())
    for a, b in zip(twin.collect_params().values(), params.values()):
        a.set_data(b.data())
    split = mx.gluon.FusedTrainStep(net, mx.gluon.loss.L2Loss(), tr,
                                    mesh=Mesh([[0, 1]], ("data", "model")),
                                    rules=[("weight", P("model"))])
    one = mx.gluon.FusedTrainStep(twin, mx.gluon.loss.L2Loss(),
                                  mx.gluon.Trainer(twin.collect_params(),
                                                   "sgd"))
    assert split(x, y).asnumpy() == one(x, y).asnumpy()
    for a, b in zip(params.values(), twin.collect_params().values()):
        assert np.array_equal(a.data().asnumpy(), b.data().asnumpy())

    class Custom(mx.optimizer.SGD):
        pass

    step = mx.gluon.FusedTrainStep(net, mx.gluon.loss.L2Loss(),
                                   mx.gluon.Trainer(params, Custom()))
    with pytest.raises(NotImplementedError, match="supports optimizers"):
        step(mx.nd.ones((2, 4), ctx=mx.cpu()),
             mx.nd.ones((2, 3), ctx=mx.cpu()))


def test_training_on_the_cpu_launches_no_kernel(monkeypatch, tmp_path):
    from mxnet_tpu_torch.ops import launch_counts
    before = launch_counts()
    _, net = _pair(monkeypatch, tmp_path, "fused_bottleneck_nhwc", "float32")
    _run(mx, net, "fused", "sgd", "float32", "fused_bottleneck_nhwc")
    assert launch_counts() == before
    assert torch.is_grad_enabled()
