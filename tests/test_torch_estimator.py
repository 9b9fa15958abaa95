"""The port's `gluon.contrib.estimator` against the JAX package's.

The five cases of the reference's tests/test_estimator.py, run on the
port, and a narrow MNIST `Estimator.fit` (one epoch, SGD with momentum)
from the same weights in both packages, carried across by a `.params`
file: the parameters after the epoch match within 1e-6 of each leaf's max
abs (the matmuls sum in another order), the accuracy equally.
"""
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.contrib.estimator import (
    CheckpointHandler, EarlyStoppingHandler, EpochEnd, Estimator)
from mxnet_tpu_torch.test_utils import synthetic_mnist, write_mnist
from _torch_seed import _seed_torch  # noqa: F401

_W_TRUE = np.random.RandomState(99).randn(8, 3).astype("float32")


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _data(n=64, d=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype("float32")
    y = (x @ _W_TRUE).argmax(axis=1).astype("float32")
    return gluon.data.DataLoader(gluon.data.ArrayDataset(x, y),
                                 batch_size=16)


def _estimator(lr=0.05):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(3))
    net.initialize(mx.init.Xavier())
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": lr})
    return Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     metrics=mx.metric.Accuracy(), trainer=tr,
                     logger=logging.getLogger("test-est"))


def test_fit_improves_and_validates():
    est = _estimator()
    train, val = _data(seed=0), _data(seed=1)
    est.fit(train, val_data=val, epochs=4)
    name, acc = est.train_metrics[0].get()
    assert name == "accuracy" and acc > 0.5, (name, acc)
    scores = est.evaluate(val)
    assert "accuracy" in scores and "val_loss" in scores
    assert scores["accuracy"] > 0.4


def test_loss_only_estimator_requires_gluon_loss():
    with pytest.raises(ValueError):
        Estimator(nn.Dense(2), loss="not-a-loss")


def test_early_stopping_stops():
    class ConstantMetric(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("const")

        def update(self, labels, preds):
            self.sum_metric += 1.0
            self.num_inst += 1

    est = _estimator()
    monitor = ConstantMetric()

    class FeedMonitor(EpochEnd):
        def epoch_end(self, estimator, *args, **kwargs):
            monitor.update(None, None)

    stopper = EarlyStoppingHandler(monitor, mode="min", patience=2)
    est.fit(_data(), epochs=50,
            event_handlers=est._default_handlers(None, 50) +
            [FeedMonitor(), stopper])
    assert stopper.stop_training
    assert stopper.stopped_epoch <= 4


def test_checkpoint_handler_saves(tmp_path):
    est = _estimator()
    ck = CheckpointHandler(str(tmp_path), model_prefix="m",
                           monitor=est.train_loss_metric, save_best=True)
    est.fit(_data(), epochs=2,
            event_handlers=est._default_handlers(None, 2) + [ck])
    files = sorted(os.listdir(tmp_path))
    assert "m-epoch1.params" in files and "m-epoch2.params" in files
    assert "m-best.params" in files
    net2 = nn.HybridSequential()
    net2.add(nn.Dense(16, activation="relu"), nn.Dense(3))
    net2.load_parameters(str(tmp_path / "m-best.params"))
    for a, b in zip(net2.collect_params().values(),
                    est.net.collect_params().values()):
        assert a.shape == b.shape


def test_fit_twice_with_reused_handlers_and_loss_metric_correct():
    est = _estimator()
    data = _data()
    handlers = est._default_handlers(None, 1)
    est.fit(data, event_handlers=handlers)
    assert est.train_loss_metric.num_inst > 0
    est.fit(data, event_handlers=handlers)
    assert est.train_loss_metric.num_inst > 0
    name, val = est.train_loss_metric.get()
    manual, count = 0.0, 0
    for x, y in data:
        l = est.loss(est.net(x), y).asnumpy()
        manual += float(l.sum())
        count += l.size
    assert abs(val - manual / count) < 0.25 * max(1.0, manual / count), \
        (val, manual / count)


def _mlp(pkg, ctx):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(32, activation="relu", in_units=784),
            pkg.gluon.nn.Dense(16, activation="relu", in_units=32),
            pkg.gluon.nn.Dense(10, in_units=16))
    net.initialize(ctx=ctx)
    return net


def test_narrow_mnist_fit_matches_reference(tmp_path):
    xtr, ytr, _, _ = synthetic_mnist(512, 1, seed=5)
    write_mnist(str(tmp_path), xtr, ytr)
    mine = _mlp(mx, mx.cpu())
    path = str(tmp_path / "init.params")
    mine.save_parameters(path)
    ref = _mlp(jmx, jmx.cpu())
    ref.load_parameters(path, ctx=jmx.cpu())
    results = []
    for pkg, net, ctx in ((mx, mine, mx.cpu()), (jmx, ref, jmx.cpu())):
        ds = pkg.gluon.data.vision.MNIST(root=str(tmp_path)).transform_first(
            pkg.gluon.data.vision.transforms.ToTensor())
        np.random.seed(21)
        loader = pkg.gluon.data.DataLoader(ds, batch_size=64, shuffle=True)
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.05, "momentum": 0.9})
        est = pkg.gluon.contrib.estimator.Estimator(
            net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
            metrics=pkg.metric.Accuracy(), trainer=trainer, context=ctx)
        est.fit(loader, epochs=1)
        results.append(([p.data().asnumpy()
                         for p in net.collect_params().values()],
                        est.train_metrics[0].get(),
                        est.train_loss_metric.get()[1]))
    (pm, am, lm), (pr, ar, lr) = results
    for a, b in zip(pm, pr):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    assert am == ar
    assert abs(lm - lr) <= 1e-6 * abs(lr)
