"""The Gluon layers of the port that the model zoo and the examples need,
against the reference's: activations, InstanceNorm/GroupNorm, the lambdas,
Concurrent/HybridConcurrent/Identity, 1-D/3-D convolutions, transposed
convolutions, the pools and ReflectionPad2D; then the Block features
(forward hooks, `summary`, `zero_grad`), `autograd.Function` and
`gluon.contrib.nn`.

Each layer case builds the block in both packages, runs the reference once
to resolve deferred shapes, draws every parameter from a seeded numpy
generator (running variances positive) and carries them into the port with
`gluon_params_from_jax` (which flips a transposed convolution's kernel:
the reference's correlates with it unflipped). Both then run the same
seeded input under `autograd.record()` in training mode and back-propagate
the same seeded cotangent: the output, the input gradient and every
parameter gradient within TOL of the largest reference value (fp32; only
the summation order differs)."""
import contextlib
import io

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import gluon_params_from_jax
from _torch_seed import _seed_torch  # noqa: F401

TOL = 2e-5


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _random_params(jb, rng):
    """Every parameter of the reference block drawn from `rng` and set;
    returns {structural name: array}."""
    arrays = {}
    for k, p in jb._collect_params_with_prefix().items():
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, p.shape)
        else:
            v = rng.randn(*p.shape) * 0.5
        v = v.astype(np.float32)
        p.set_data(jmx.nd.array(v))
        arrays[k] = v
    return arrays


def _flip(a):
    return np.flip(a, axis=tuple(range(2, a.ndim)))


def _run(pkg, blk, x, train=True):
    """(output, input gradient, {name: parameter gradient}) of the
    output against a seeded cotangent."""
    with pkg.cpu():
        xa = pkg.nd.array(x)
        xa.attach_grad()
        with pkg.autograd.record(train_mode=train):
            y = blk(xa)
            cot = np.random.RandomState(7).randn(*y.shape).astype(np.float32)
            loss = (y * pkg.nd.array(cot)).sum()
        loss.backward()
        grads = {k: p.grad().asnumpy()
                 for k, p in blk._collect_params_with_prefix().items()
                 if p.grad_req != "null"}
        return y.asnumpy(), xa.grad.asnumpy(), grads


def pair(make, x, seed=0):
    """The reference block and the port's, the same random parameters."""
    jb = make(jmx)
    jb.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.cpu():
        jb(jmx.nd.array(x))
    arrays = _random_params(jb, np.random.RandomState(seed))
    with mx.cpu():
        pb = make(mx)
        pb.initialize(ctx=mx.cpu())
        gluon_params_from_jax(arrays, pb, ctx=mx.cpu())
    return jb, pb


def check_layer(make, shape, flip=(), train=True, seed=0):
    x = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    jb, pb = pair(make, x, seed)
    want = _run(jmx, jb, x, train)
    got = _run(mx, pb, x, train)
    _close(got[0], want[0], "output")
    _close(got[1], want[1], "input gradient")
    assert sorted(got[2]) == sorted(want[2])
    for k, g in want[2].items():
        _close(got[2][k], _flip(g) if k in flip else g, k)
    return got


def nn(pkg):
    return pkg.gluon.nn


LAYERS = {
    # activations
    "leaky_relu": (lambda p: nn(p).LeakyReLU(0.1), (2, 3, 4, 5)),
    "elu": (lambda p: nn(p).ELU(0.7), (2, 3, 4, 5)),
    "selu": (lambda p: nn(p).SELU(), (2, 3, 4, 5)),
    "swish": (lambda p: nn(p).Swish(1.5), (2, 3, 4, 5)),
    "gelu": (lambda p: nn(p).GELU(), (2, 3, 4, 5)),
    # normalization
    "instance_norm": (lambda p: nn(p).InstanceNorm(scale=True),
                      (2, 3, 5, 6)),
    "instance_norm_no_scale": (lambda p: nn(p).InstanceNorm(),
                               (2, 4, 7)),
    "group_norm": (lambda p: nn(p).GroupNorm(num_groups=2), (2, 4, 3, 5)),
    "group_norm_no_center": (lambda p: nn(p).GroupNorm(
        num_groups=3, center=False, epsilon=1e-3), (3, 6, 4)),
    # lambdas and containers
    "lambda_name": (lambda p: nn(p).Lambda("tanh"), (2, 5)),
    "hybrid_lambda_name": (lambda p: nn(p).HybridLambda("sigmoid"), (2, 5)),
    "hybrid_lambda_fn": (lambda p: nn(p).HybridLambda(
        lambda F, x: F.relu(x) * 2), (2, 5)),
    "identity": (lambda p: nn(p).Identity(), (2, 5)),
    # convolutions
    "conv1d": (lambda p: nn(p).Conv1D(4, 3, strides=2, padding=1),
               (2, 6, 11)),
    "conv1d_groups_dilated": (lambda p: nn(p).Conv1D(
        4, 3, dilation=2, groups=2, activation="relu"), (2, 6, 11)),
    "conv1d_nwc": (lambda p: nn(p).Conv1D(4, 3, padding=1, layout="NWC"),
                   (2, 11, 6)),
    "conv3d": (lambda p: nn(p).Conv3D(4, (2, 3, 3), strides=(1, 2, 1),
                                      padding=1), (2, 3, 5, 6, 7)),
    "conv3d_ndhwc": (lambda p: nn(p).Conv3D(3, 2, use_bias=False,
                                            layout="NDHWC"), (1, 4, 5, 6, 2)),
    # pools: ceil_mode on and off, count_include_pad on and off
    "max_pool1d": (lambda p: nn(p).MaxPool1D(3, 2), (2, 3, 10)),
    "max_pool1d_ceil": (lambda p: nn(p).MaxPool1D(3, 2, ceil_mode=True),
                        (2, 3, 10)),
    "max_pool2d_nhwc_ceil": (lambda p: nn(p).MaxPool2D(
        3, 2, 1, layout="NHWC", ceil_mode=True), (2, 8, 9, 3)),
    "max_pool3d": (lambda p: nn(p).MaxPool3D((2, 2, 2)), (1, 2, 4, 5, 6)),
    "avg_pool1d_exclude_pad": (lambda p: nn(p).AvgPool1D(
        3, 2, 1, count_include_pad=False), (2, 3, 10)),
    "avg_pool2d_inception": (lambda p: nn(p).AvgPool2D(3, 1, 1),
                             (2, 3, 6, 7)),
    "avg_pool2d_ceil": (lambda p: nn(p).AvgPool2D(3, 2, 1, ceil_mode=True),
                        (2, 3, 8, 9)),
    "avg_pool2d_ceil_exclude_pad": (lambda p: nn(p).AvgPool2D(
        3, 2, 1, ceil_mode=True, count_include_pad=False), (2, 3, 8, 9)),
    "avg_pool3d_ceil": (lambda p: nn(p).AvgPool3D(2, ceil_mode=True),
                        (1, 2, 5, 4, 3)),
    "global_max_pool1d": (lambda p: nn(p).GlobalMaxPool1D(), (2, 3, 7)),
    "global_max_pool2d": (lambda p: nn(p).GlobalMaxPool2D(), (2, 3, 5, 4)),
    "global_max_pool3d": (lambda p: nn(p).GlobalMaxPool3D(),
                          (1, 2, 3, 4, 5)),
    "global_avg_pool1d": (lambda p: nn(p).GlobalAvgPool1D(), (2, 3, 7)),
    "global_avg_pool2d_nhwc": (lambda p: nn(p).GlobalAvgPool2D(
        layout="NHWC"), (2, 5, 4, 3)),
    "global_avg_pool3d": (lambda p: nn(p).GlobalAvgPool3D(),
                          (1, 2, 3, 4, 5)),
    "reflection_pad2d": (lambda p: nn(p).ReflectionPad2D(2), (2, 3, 5, 6)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_reference(case):
    make, shape = LAYERS[case]
    check_layer(make, shape)


TRANSPOSED = {
    "conv1d_transpose": (lambda p: nn(p).Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), (2, 6, 7)),
    "conv2d_transpose": (lambda p: nn(p).Conv2DTranspose(
        5, 4, strides=2, padding=1), (2, 6, 5, 7)),
    "conv2d_transpose_adj_relu": (lambda p: nn(p).Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, activation="relu",
        use_bias=False), (2, 6, 5, 4)),
    "conv3d_transpose": (lambda p: nn(p).Conv3DTranspose(
        3, (2, 3, 3), strides=2, padding=(0, 1, 1)), (1, 4, 3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(TRANSPOSED))
def test_transposed_conv_matches_reference_through_the_flip(case):
    """The port's block on the spatially flipped kernel (what
    gluon_params_from_jax loads) is the reference's on the kernel as it
    is; so the port's weight gradient is the reference's flipped."""
    make, shape = TRANSPOSED[case]
    check_layer(make, shape, flip={"weight"})


# the reference's Deconvolution reads neither groups nor dilation: these
# are held to the definition alone
GROUPED = {
    "conv2d_transpose_groups_dilated": (lambda p: nn(p).Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, dilation=2, groups=2,
        activation="relu"), (2, 6, 5, 4)),
    "conv1d_transpose_dilated": (lambda p: nn(p).Conv1DTranspose(
        3, 3, strides=3, dilation=3, use_bias=False), (2, 4, 6)),
}


@pytest.mark.parametrize("case", sorted(TRANSPOSED) + sorted(GROUPED))
def test_transposed_conv_is_the_gradient_of_conv(case):
    """Conv*DTranspose(x) with weight W is the gradient with respect to
    the data of <Conv*D(data, W), x> (no bias), the data of the transposed
    block's output shape, with the same stride, padding, dilation and
    groups."""
    make, shape = {**TRANSPOSED, **GROUPED}[case]
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    with mx.cpu():
        blk = make(mx)
        blk.initialize(mx.init.Normal(0.5), ctx=mx.cpu())
        xa = mx.nd.array(x)
        y = blk(xa)
        kw = dict(blk._kwargs)
        kw.pop("adj", None)
        kw["no_bias"] = True
        groups = kw["num_group"]
        w = blk.weight.data()
        kw["num_filter"] = w.shape[0]       # the conv's output: x's channels
        data = mx.nd.zeros(y.shape)
        data.attach_grad()
        with mx.autograd.record():
            out = mx.nd.Convolution(data, w, **kw)
            assert out.shape == x.shape and groups == blk._kwargs["num_group"]
            (out * xa).sum().backward()
        want = data.grad.asnumpy()
        if blk.act is not None:
            want = np.maximum(want, 0)
        if blk.bias is not None:
            b = blk.bias.data().asnumpy()
            want = want + b.reshape((1, -1) + (1,) * (want.ndim - 2))
    _close(y.asnumpy(), want, case, tol=1e-5)


def test_converter_flips_only_transposed_kernels():
    jb = jmx.gluon.nn.HybridSequential()
    with jb.name_scope():
        jb.add(jmx.gluon.nn.Conv2D(3, 3), jmx.gluon.nn.Conv2DTranspose(2, 3))
    x = np.random.RandomState(0).randn(1, 2, 6, 6).astype(np.float32)
    jb.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.cpu():
        jb(jmx.nd.array(x))
    arrays = {k: p.data().asnumpy()
              for k, p in jb._collect_params_with_prefix().items()}
    with mx.cpu():
        pb = mx.gluon.nn.HybridSequential()
        with pb.name_scope():
            pb.add(mx.gluon.nn.Conv2D(3, 3), mx.gluon.nn.Conv2DTranspose(2, 3))
        pb.initialize(ctx=mx.cpu())
        gluon_params_from_jax(arrays, pb, ctx=mx.cpu())
        got = {k: p.data().asnumpy()
               for k, p in pb._collect_params_with_prefix().items()}
    for k, a in arrays.items():
        np.testing.assert_array_equal(
            got[k], _flip(a) if k == "1.weight" else a, err_msg=k)


def _concurrent(p, hybrid):
    """A two-level concurrent block as the zoo nests them: a conv branch,
    a branch that is itself a HybridConcurrent, and an Identity."""
    n = p.gluon.nn
    out = (n.HybridConcurrent if hybrid else n.Concurrent)(axis=1,
                                                           prefix="cc_")
    with out.name_scope():
        out.add(n.Conv2D(2, 3, padding=1))
        inner = n.HybridConcurrent(axis=1, prefix="")
        inner.add(n.Conv2D(3, 1), n.MaxPool2D(3, 1, 1))
        out.add(inner)
        out.add(n.Identity())
    return out


@pytest.mark.parametrize("hybrid", [True, False])
def test_concurrent_matches_reference(hybrid):
    check_layer(lambda p: _concurrent(p, hybrid), (2, 3, 6, 6))


def test_hybrid_concurrent_traced_route(tmp_path):
    """The hybridized block traced to a graph (export) and run back
    through SymbolBlock gives the eager output: the concatenations along
    axis 1 survive the trace, nested ones included."""
    x = np.random.RandomState(1).randn(2, 3, 6, 6).astype(np.float32)
    jb, pb = pair(lambda p: _concurrent(p, True), x)
    with mx.cpu():
        pb.hybridize()
        eager = pb(mx.nd.array(x)).asnumpy()
        sym_file, params_file = pb.export(str(tmp_path / "cc"))
        back = mx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                            ctx=mx.cpu())
        traced = back(mx.nd.array(x)).asnumpy()
    with jmx.cpu():
        jb.hybridize()
        want = jb(jmx.nd.array(x)).asnumpy()
    _close(traced, eager, "traced vs eager", tol=1e-6)
    _close(eager, want, "vs reference")


def test_gluon_nn_has_every_reference_class():
    assert sorted(mx.gluon.nn.__all__) == sorted(jmx.gluon.nn.__all__)
    for name in jmx.gluon.nn.__all__:
        assert hasattr(mx.gluon.nn, name), name
    assert sorted(mx.gluon.contrib.nn.__all__) == \
        sorted(jmx.gluon.contrib.nn.__all__)


def test_prelu_matches_the_reference_op():
    """PReLU's learned slope, its output and its input and slope
    gradients, against the reference's LeakyReLU op in "prelu" mode (the
    reference's PReLU block hands its slope to the op as a keyword array,
    which its op does not take)."""
    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
    cot = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    with jmx.cpu():
        a, xa = jmx.nd.array([0.3]), jmx.nd.array(x)
        a.attach_grad()
        xa.attach_grad()
        with jmx.autograd.record():
            y = jmx.nd.LeakyReLU(xa, a, act_type="prelu")
            (y * jmx.nd.array(cot)).sum().backward()
        want = [y.asnumpy(), xa.grad.asnumpy(), a.grad.asnumpy()]
    with mx.cpu():
        blk = mx.gluon.nn.PReLU(mx.init.Constant(0.3))
        blk.initialize(ctx=mx.cpu())
        assert blk.alpha.name.endswith("alpha") and blk.alpha.shape == (1,)
        xa = mx.nd.array(x)
        xa.attach_grad()
        with mx.autograd.record():
            y = blk(xa)
            (y * mx.nd.array(cot)).sum().backward()
        got = [y.asnumpy(), xa.grad.asnumpy(), blk.alpha.grad().asnumpy()]
    for name, g, w in zip(("output", "input gradient", "alpha gradient"),
                          got, want):
        _close(g, w, name)


# -- Block features ---------------------------------------------------------

def _hooked_net(p):
    n = p.gluon.nn
    net = n.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(n.Dense(4, activation="relu"), n.Dense(3))
    return net


def _hook_logs(hybridize):
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    logs = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            net = _hooked_net(pkg)
            net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
            if hybridize:
                net.hybridize()
            log = []
            pre = net[0].register_forward_pre_hook(
                lambda b, a, log=log: log.append(("pre", b.name,
                                                  [i.shape for i in a])))
            post = net[1].register_forward_hook(
                lambda b, a, o, log=log: log.append(("post", b.name,
                                                     a[0].shape, o.shape)))
            top = net.register_forward_hook(
                lambda b, a, o, log=log: log.append(("top", b.name,
                                                     o.shape)))
            net(pkg.nd.array(x))
            pre.detach()
            post.detach()
            net(pkg.nd.array(x))
            top.detach()
            net(pkg.nd.array(x))
            logs.append(log)
    return logs


def test_forward_hooks_match_reference():
    """Pre-hooks see the inputs, hooks the inputs and outputs, in the
    reference's order; a detached hook no longer runs."""
    want, got = _hook_logs(False)
    assert got == want
    assert [e[0] for e in got] == ["pre", "post", "top", "top"]


def test_forward_hooks_fire_when_hybridized():
    """Hybridized, the top block's hooks run on every call in both
    packages. The reference's children run their hooks only while its
    program is traced (twice, on the first call); the port's hybridized
    forward stays eager, so they run on every call, as on the eager
    route."""
    want, got = _hook_logs(True)
    assert [e for e in got if e[0] == "top"] == \
        [e for e in want if e[0] == "top"]
    assert want[:2] == want[2:4] and want[4:] == got[2:]
    assert got == _hook_logs(False)[1]


def _summary_net(p):
    n = p.gluon.nn
    net = n.HybridSequential(prefix="sum_")
    with net.name_scope():
        net.add(n.Conv2D(4, 3, padding=1), n.BatchNorm(), n.LeakyReLU(0.1),
                n.MaxPool2D(), n.Flatten(), n.Dense(8))
        shared = n.Dense(8, in_units=8)
        net.add(shared, n.Dense(8, params=shared.params), n.Dense(2))
    return net


def test_summary_matches_reference():
    """The printed table, rows and counts (total, trainable, shared,
    unique), equal to the reference's; the deferred shapes are counted
    after the forward that summary runs."""
    x = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
    texts = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            net = _summary_net(pkg)
            net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                net.summary(pkg.nd.array(x))
            texts.append(buf.getvalue())
    assert texts[1] == texts[0]
    # conv 112, BN 16 (8 trainable), Dense 520, Dense 72 twice (shared),
    # Dense 18
    assert "Total params: 810" in texts[1]
    assert "Non-trainable params: 8" in texts[1]
    assert "Shared params in forward computation graph: 72" in texts[1]
    with mx.cpu():
        net.hybridize()
        with pytest.raises(AssertionError):
            net.summary(mx.nd.array(x))


def test_zero_grad():
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    for pkg in (jmx, mx):
        with pkg.cpu():
            net = _hooked_net(pkg)
            net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
            with pkg.autograd.record():
                loss = net(pkg.nd.array(x)).sum()
            loss.backward()
            grads = [p.grad().asnumpy() for p in
                     net.collect_params().values()]
            assert any(np.abs(g).max() > 0 for g in grads)
            net.zero_grad()
            for p in net.collect_params().values():
                assert not p.grad().asnumpy().any(), (pkg.__name__, p.name)


# -- autograd.Function ------------------------------------------------------

def _functions(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + pkg.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    class ScaleShift(pkg.autograd.Function):
        """(x * y, x + 2 y): two inputs, two outputs."""

        def forward(self, x, y):
            self.save_for_backward(x, y)
            return x * y, x + 2 * y

        def backward(self, d1, d2):
            x, y = self.saved_tensors
            return d1 * y + d2, d1 * x + 2 * d2
    return Sigmoid, ScaleShift


@pytest.mark.parametrize("outputs", [1, 2])
def test_autograd_function_matches_reference(outputs):
    rng = np.random.RandomState(outputs)
    xs = [rng.randn(3, 4).astype(np.float32) for _ in range(2)]
    res = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            sig, two = _functions(pkg)
            a, b = [pkg.nd.array(v) for v in xs]
            a.attach_grad()
            b.attach_grad()
            with pkg.autograd.record():
                if outputs == 1:
                    out = [sig()(a * b)]
                else:
                    out = two()(a, b)
                    assert isinstance(out, (list, tuple)) and len(out) == 2
                loss = sum(((o * o).sum() for o in out), pkg.nd.zeros((1,)))
            loss.backward()
            res.append([o.asnumpy() for o in out]
                       + [a.grad.asnumpy(), b.grad.asnumpy()])
            # outside record: forward only, same values
            plain = sig()(a * b) if outputs == 1 else two()(a, b)[0]
            res[-1].append(plain.asnumpy())
    for i, (g, w) in enumerate(zip(*res)):
        _close(g, w, "item %d" % i, tol=1e-6)


# -- gluon.contrib.nn -------------------------------------------------------

def test_sparse_embedding_row_sparse_gradient():
    """The weight gradient is row-sparse: the looked-up rows, sorted and
    each once, duplicates summed, equal to the reference's."""
    ids = np.array([[3, 1, 3], [7, 1, 0]], np.float32)
    w = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    cot = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    res = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            emb = pkg.gluon.contrib.nn.SparseEmbedding(10, 4)
            emb.initialize(ctx=pkg.cpu())
            emb.weight.set_data(pkg.nd.array(w))
            with pkg.autograd.record():
                y = emb(pkg.nd.array(ids))
                (y * pkg.nd.array(cot)).sum().backward()
            g = emb.weight.grad()
            assert g.stype == "row_sparse", pkg.__name__
            res.append((y.asnumpy(), g.indices.asnumpy(), g.data.asnumpy(),
                        g.tostype("default").asnumpy()))
    (y1, i1, d1, g1), (y0, i0, d0, g0) = res[1], res[0]
    _close(y1, y0, "output", tol=0)
    _close(g1, g0, "dense", tol=1e-6)
    # the port's rows are the looked-up ones; the reference's block keeps
    # every row of the table (its lookup takes a dense gradient)
    np.testing.assert_array_equal(i1, [0, 1, 3, 7])
    _close(d1, g0[i1], "rows", tol=1e-6)


def test_sync_batch_norm_is_batch_norm():
    """SyncBatchNorm on one rank: BatchNorm over axis 1 in both modes
    (outputs, gradients, running statistics), and the reference's
    SyncBatchNorm; num_devices and key are not read."""
    x = np.random.RandomState(0).randn(4, 3, 5, 5).astype(np.float32)
    got = check_layer(lambda p: p.gluon.contrib.nn.SyncBatchNorm(
        num_devices=4, momentum=0.8), x.shape)
    with mx.cpu():
        outs = []
        for blk in (mx.gluon.contrib.nn.SyncBatchNorm(num_devices=2,
                                                       key="k", prefix="s_"),
                    mx.gluon.nn.BatchNorm(prefix="s_")):
            blk.initialize(ctx=mx.cpu())
            xa = mx.nd.array(x)
            with mx.autograd.record():
                y = blk(xa)
            with mx.autograd.predict_mode():
                y2 = blk(xa)
            outs.append([y.asnumpy(), y2.asnumpy(),
                         blk.running_mean.data().asnumpy(),
                         blk.running_var.data().asnumpy()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == x.shape


def test_contrib_containers_are_the_nn_ones():
    for name in ("Concurrent", "HybridConcurrent", "Identity"):
        assert getattr(mx.gluon.contrib.nn, name) is getattr(mx.gluon.nn,
                                                             name)


def test_layers_have_no_cuda_state():
    """Building every layer above touches no CUDA state (the tests import
    the port on a host without a card)."""
    with mx.cpu():
        for make, _ in list(LAYERS.values()) + list(TRANSPOSED.values()):
            make(mx)
    assert not torch.cuda.is_initialized()
