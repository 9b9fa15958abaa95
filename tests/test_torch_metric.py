"""The port's `mx.metric` against the JAX package's.

Every case feeds both packages the same labels and predictions, made with
numpy from a seed, as each package's own NDArrays. Counts (`num_inst`, and
the correct-prediction sums of the accuracy metrics) are held exactly;
means within 1e-6 relative.
"""
import math

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

REL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _probs(rng, n, c):
    x = rng.rand(n, c).astype(np.float32) + 1e-3
    return x / x.sum(axis=1, keepdims=True)


def _inputs(kind, seed):
    """[(labels, preds)] batches of numpy arrays for a metric kind."""
    rng = np.random.RandomState(seed)
    out = []
    for n in (16, 9):
        if kind == "class":
            out.append((rng.randint(0, 5, n).astype(np.float32),
                        _probs(rng, n, 5)))
        elif kind == "ties":
            # three values only: many ties among the classes
            out.append((rng.randint(0, 6, n).astype(np.float32),
                        rng.randint(0, 3, (n, 6)).astype(np.float32)))
        elif kind == "binary":
            out.append((rng.randint(0, 2, n).astype(np.float32),
                        _probs(rng, n, 2)))
        elif kind == "regression":
            out.append((rng.randn(n).astype(np.float32),
                        rng.randn(n, 1).astype(np.float32)))
        elif kind == "loss":
            out.append((None, rng.rand(n, 3).astype(np.float32)))
    return out


def _feed(pkg, metric, batches):
    for labels, preds in batches:
        p = [pkg.nd.array(preds)]
        lab = [pkg.nd.array(labels)] if labels is not None else None
        metric.update(lab, p)


def _close(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    if isinstance(a, float) and math.isnan(a):
        assert math.isnan(b)
        return
    assert abs(float(a) - float(b)) <= REL * max(abs(float(b)), 1e-30), \
        (a, b)


CASES = [
    ("Accuracy", {}, "class"),
    ("TopKAccuracy", {"top_k": 3}, "class"),
    ("TopKAccuracy", {"top_k": 2}, "ties"),
    ("F1", {}, "binary"),
    ("F1", {"average": "micro"}, "binary"),
    ("MCC", {}, "binary"),
    ("MCC", {"average": "micro"}, "binary"),
    ("Perplexity", {}, "class"),
    ("Perplexity", {"ignore_label": 2}, "class"),
    ("MAE", {}, "regression"),
    ("MSE", {}, "regression"),
    ("RMSE", {}, "regression"),
    ("CrossEntropy", {}, "class"),
    ("NegativeLogLikelihood", {}, "class"),
    ("PearsonCorrelation", {}, "regression"),
    ("Loss", {}, "loss"),
    ("Torch", {}, "loss"),
    ("Caffe", {}, "loss"),
    ("PCC", {}, "class"),
    ("PCC", {}, "binary"),
]


@pytest.mark.parametrize("name,kwargs,kind", CASES,
                         ids=["%s-%s-%s" % (c[0], "-".join(
                             "%s%s" % kv for kv in c[1].items()), c[2])
                             for c in CASES])
def test_metric_matches_reference(name, kwargs, kind):
    mine = getattr(mx.metric, name)(**kwargs)
    ref = getattr(jmx.metric, name)(**kwargs)
    batches = _inputs(kind, seed=len(name) + len(kwargs))
    if name == "PearsonCorrelation":
        batches = [(lab, pred.reshape(-1)) for lab, pred in batches]
    _feed(mx, mine, batches)
    _feed(jmx, ref, batches)
    assert mine.num_inst == ref.num_inst
    if name in ("Accuracy", "TopKAccuracy"):
        assert mine.sum_metric == ref.sum_metric
    assert mine.get()[0] == ref.get()[0]
    _close(mine.get()[1], ref.get()[1])
    _close(mine.get_global()[1], ref.get_global()[1])


@pytest.mark.parametrize("name", ["Accuracy", "MAE", "Perplexity", "F1"])
def test_local_and_global_stats(name):
    """reset_local clears the local statistics only; get_global keeps the
    whole run's."""
    kind = {"Accuracy": "class", "MAE": "regression", "Perplexity": "class",
            "F1": "binary"}[name]
    batches = _inputs(kind, seed=3)
    mine, ref = getattr(mx.metric, name)(), getattr(jmx.metric, name)()
    for pkg, m in ((mx, mine), (jmx, ref)):
        _feed(pkg, m, batches[:1])
        m.reset_local()
        _feed(pkg, m, batches[1:])
    assert mine.num_inst == ref.num_inst
    assert mine.global_num_inst == ref.global_num_inst
    _close(mine.get()[1], ref.get()[1])
    _close(mine.get_global()[1], ref.get_global()[1])
    assert mine.get_name_value()[0][0] == ref.get_name_value()[0][0]


@pytest.mark.parametrize("spec,kwargs", [
    ("acc", {}), ("accuracy", {}), ("top_k_accuracy", {"top_k": 3}),
    ("top_k_acc", {"top_k": 2}), ("ce", {}), ("nll_loss", {}),
    ("pearsonr", {}), ("mae", {}), ("rmse", {}), ("f1", {}), ("mcc", {}),
    ("perplexity", {}), ("pcc", {}), ("loss", {})])
def test_create_by_name_and_alias(spec, kwargs):
    mine = mx.metric.create(spec, **kwargs)
    ref = jmx.metric.create(spec, **kwargs)
    assert type(mine).__name__ == type(ref).__name__
    assert mine.name == ref.name
    if spec != "loss":
        assert mine.get_config() == ref.get_config()


def test_create_rejects_unknown_names_and_types():
    with pytest.raises(ValueError):
        mx.metric.create("no-such-metric")
    with pytest.raises(TypeError):
        mx.metric.create(3)


def test_composite_metric():
    batches = _inputs("class", seed=5)
    mine = mx.metric.create(["acc", "ce", mx.metric.TopKAccuracy(top_k=3)])
    ref = jmx.metric.create(["acc", "ce", jmx.metric.TopKAccuracy(top_k=3)])
    assert isinstance(mine, mx.metric.CompositeEvalMetric)
    _feed(mx, mine, batches)
    _feed(jmx, ref, batches)
    names, values = mine.get()
    rnames, rvalues = ref.get()
    assert names == rnames
    _close(values, rvalues)
    _close(mine.get_global()[1], ref.get_global()[1])
    assert mine.get_config() == ref.get_config()
    mine.reset_local()
    assert all(m.num_inst == 0 for m in mine.metrics)
    assert mine.metrics[0].global_num_inst == 25
    mine.reset()
    assert all(m.global_num_inst == 0 for m in mine.metrics)


def test_update_dict_honours_names():
    rng = np.random.RandomState(7)
    lab, pred = rng.randint(0, 4, 8).astype(np.float32), _probs(rng, 8, 4)
    got = []
    for pkg in (mx, jmx):
        m = pkg.metric.Accuracy(output_names=["out"], label_names=["y"])
        m.update_dict({"y": pkg.nd.array(lab), "z": pkg.nd.array(lab * 0)},
                      {"out": pkg.nd.array(pred),
                       "other": pkg.nd.array(pred[:, ::-1].copy())})
        got.append(m.get())
    assert got[0] == got[1]


def _feval(label, pred):
    return float(np.abs(label - pred.argmax(axis=1)).sum()), label.size


def _feval_scalar(label, pred):
    return float((label == pred.argmax(axis=1)).mean())


@pytest.mark.parametrize("feval", [_feval, _feval_scalar])
def test_custom_metric_and_np(feval):
    batches = _inputs("class", seed=11)
    made = []
    for pkg in (mx, jmx):
        made.append((pkg.metric.CustomMetric(feval), pkg.metric.np(feval),
                     pkg.metric.create(feval)))
    for mine, ref in zip(made[0], made[1]):
        _feed(mx, mine, batches)
        _feed(jmx, ref, batches)
        assert mine.name == ref.name
        assert mine.num_inst == ref.num_inst
        _close(mine.get()[1], ref.get()[1])
    with pytest.raises(NotImplementedError):
        made[0][0].get_config()


def test_label_shape_mismatch_raises():
    m = mx.metric.Accuracy()
    with pytest.raises(ValueError):
        m.update([mx.nd.array([1, 2])], [mx.nd.array([[0.1, 0.9]] * 2),
                                         mx.nd.array([[0.1, 0.9]] * 2)])


def test_cpu_updates_count_no_host_sync():
    from mxnet_tpu_torch import telemetry
    before = telemetry.counter_value("metric.host_syncs")
    m = mx.metric.Accuracy()
    _feed(mx, m, _inputs("class", seed=1))
    assert telemetry.counter_value("metric.host_syncs") == before
