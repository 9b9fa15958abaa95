"""The data-and-evaluation slice as a whole: a narrow copy of the Gluon MLP
on MNIST (BASELINE config 1; the repo's examples/mnist_mlp.py through
`gluon.data.vision.MNIST`) in both packages.

2,048 seeded digits written as MNIST's idx files, `transform_first(
ToTensor())`, `DataLoader(batch_size=128, shuffle=True)` under one
`np.random.seed`, Dense 128-64-10 with ReLU, `SoftmaxCrossEntropyLoss`,
`Trainer("sgd", lr 0.05, momentum 0.9)` and `metric.Accuracy`: 16 steps
from the same seeded weights (the port's, read by the reference from a
`.params` file). The losses match within 1e-6 relative, the parameters
within 1e-6 of each leaf's max abs (the matmuls sum in another order),
the accuracy exactly; a failure names the step that diverged. On a card,
one step's update is one `multi` launch of flat_sgd, held against the
same step on the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.test_utils import synthetic_mnist, write_mnist
from _torch_seed import _seed_torch  # noqa: F401

REL = 1e-6


def _net(pkg, ctx):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(128, activation="relu"),
            pkg.gluon.nn.Dense(64, activation="relu"),
            pkg.gluon.nn.Dense(10))
    net.initialize(ctx=ctx)
    net.hybridize()
    return net


def _loop(pkg, net, loader, ctx, steps=None, trace=None):
    """Train over `loader`; returns (losses, accuracy). `trace`, a list,
    receives the parameters after each step."""
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9})
    metric = pkg.metric.Accuracy()
    losses = []
    for i, (data, label) in enumerate(loader):
        if steps is not None and i == steps:
            break
        data = data.as_in_context(ctx)
        label = label.as_in_context(ctx)
        with pkg.autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(data.shape[0])
        metric.update([label], [out])
        losses.append(float(loss.mean().asnumpy()))
        if trace is not None:
            trace.append(_params(net))
    return losses, metric.get()


def _mnist_loader(pkg, root):
    ds = pkg.gluon.data.vision.MNIST(root=root, train=True).transform_first(
        pkg.gluon.data.vision.transforms.ToTensor())
    return pkg.gluon.data.DataLoader(ds, batch_size=128, shuffle=True)


def _params(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def _first_diverging_step(trace_m, trace_r):
    """The first step whose parameters differ by more than REL of a
    leaf's max abs, or None."""
    for step, (pm, pr) in enumerate(zip(trace_m, trace_r)):
        if any(np.abs(a - b).max() > REL * np.abs(b).max()
               for a, b in zip(pm, pr)):
            return step
    return None


def test_narrow_mlp_mnist_matches_reference(tmp_path):
    """The port's initial weights come from its random generator, which
    every earlier draw in the process advances (the conftest reseeds numpy
    and the JAX package before each test, not the port), so the test seeds
    it with 0, where a fresh process starts. Without that the weights
    depend on what ran before in the same worker, and about 3% of them (9
    of 288 seeds scanned) put a first-layer pre-activation within fp32
    rounding of zero (1.5e-7 at seed 165): the two packages' matmuls sum in
    different orders, can set that ReLU's mask differently, and the runs
    part by far more than 1e-6."""
    xtr, ytr, _, _ = synthetic_mnist(2048, 1, seed=7)
    write_mnist(str(tmp_path), xtr, ytr)
    mx.random.seed(0)
    with mx.cpu():
        mine = _net(mx, mx.cpu())
        with mx.autograd.predict_mode():
            mine(mx.nd.zeros((1, 1, 28, 28)))
        path = str(tmp_path / "mlp.params")
        mine.save_parameters(path)
        ref = _net(jmx, jmx.cpu())
        ref.load_parameters(path, ctx=jmx.cpu())
        for a, b in zip(_params(mine), _params(ref)):
            np.testing.assert_array_equal(a, b)
        runs, traces = [], []
        for pkg, net, ctx in ((mx, mine, mx.cpu()), (jmx, ref, jmx.cpu())):
            np.random.seed(13)
            loader = _mnist_loader(pkg, str(tmp_path))
            assert len(loader) == 16
            traces.append([])
            runs.append(_loop(pkg, net, loader, ctx, trace=traces[-1])
                        + (_params(net),))
    (lm, am, pm), (lr, ar, pr) = runs
    assert len(lm) == 16
    assert all(np.isfinite(lm)) and lm[-1] < lm[0]
    for step, (a, b) in enumerate(zip(lm, lr)):
        assert abs(a - b) <= REL * abs(b), \
            "loss diverged at step %d: %r vs the reference's %r" % (step, a, b)
    assert am == ar, "accuracy after 16 steps: %r vs %r" % (am, ar)
    for leaf, (a, b) in enumerate(zip(pm, pr)):
        assert np.abs(a - b).max() <= REL * np.abs(b).max(), \
            "parameter %d differs after 16 steps by %g (limit %g); the " \
            "parameters first diverged at step %s" % (
                leaf, np.abs(a - b).max(), REL * np.abs(b).max(),
                _first_diverging_step(*traces))


@pytest.mark.cuda
def test_mlp_step_is_one_multi_flat_sgd_launch_on_the_card(tmp_path):
    """One step of the MLP on the card: one flat_sgd launch of variant
    "multi" over the six tensors; loss and parameters within 1e-5 of the
    same step on the CPU (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    xtr, ytr, _, _ = synthetic_mnist(256, 1, seed=3)
    write_mnist(str(tmp_path), xtr, ytr)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        results = []
        path = str(tmp_path / "mlp.params")
        for ctx in (mx.cpu(), mx.gpu(0)):
            with ctx:
                net = _net(mx, ctx)
                if ctx == mx.cpu():
                    with mx.autograd.predict_mode():
                        net(mx.nd.zeros((1, 1, 28, 28)))
                    net.save_parameters(path)
                else:
                    net.load_parameters(path, ctx=ctx)
                np.random.seed(2)
                loader = _mnist_loader(mx, str(tmp_path))
                reset_launch_counts()
                losses, _ = _loop(mx, net, loader, ctx, steps=1)
                torch.cuda.synchronize()
                results.append((losses, _params(net), variant_counts()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (lc, pc, vc), (lg, pg, vg) = results
    assert vc == {} and vg == {("flat_sgd", "multi"): 1}, vg
    assert abs(lg[0] - lc[0]) <= 1e-5 * abs(lc[0])
    for a, b in zip(pg, pc):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_fused_step_keeps_the_last_outputs_for_a_metric():
    """`FusedTrainStep.outputs` is the net's output of the step's forward
    (before the update), cut from the tape; a metric reads it as it reads
    a hand loop's output."""
    with mx.cpu():
        net = _net(mx, mx.cpu())
        rng = np.random.RandomState(0)
        x = mx.nd.array(rng.rand(16, 1, 28, 28))
        y = mx.nd.array(rng.randint(0, 10, 16), dtype="int32")
        want = net(x).asnumpy()
        step = mx.gluon.FusedTrainStep(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.05, "momentum": 0.9}))
        assert step.outputs is None
        step(x, y)
        np.testing.assert_array_equal(step.outputs.asnumpy(), want)
        assert not step.outputs.data_torch.requires_grad
        metric = mx.metric.Accuracy()
        metric.update([y], [step.outputs])
        assert metric.num_inst == 16
