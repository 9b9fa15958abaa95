"""The port's `mx.callback` and `gluon.utils` against the JAX package's.

The callbacks' log lines are compared with the measured speed masked out;
`split_data`/`split_and_load` move values without arithmetic (exact);
`clip_global_norm`'s norm and scaled arrays are held within 1e-6 relative.
"""
import collections
import hashlib
import logging
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

Param = collections.namedtuple("Param", ["epoch", "nbatch", "eval_metric"])


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _metric(pkg):
    m = pkg.metric.Accuracy()
    rng = np.random.RandomState(0)
    m.update([pkg.nd.array(rng.randint(0, 3, 12))],
             [pkg.nd.array(rng.rand(12, 3))])
    return m


def _lines(caplog, pkg, make, params):
    caplog.clear()
    cb = make(pkg)
    with caplog.at_level(logging.INFO):
        for p in params(pkg):
            cb(p)
    return [re.sub(r"Speed: [0-9.inf]+", "Speed: S", r.getMessage())
            for r in caplog.records]


def _batches(with_metric):
    def params(pkg):
        m = _metric(pkg) if with_metric else None
        return [Param(2, i, m) for i in range(0, 13)]
    return params


@pytest.mark.parametrize("case", [
    "speedometer", "speedometer_no_reset", "speedometer_no_metric",
    "progress_bar", "log_train_metric", "log_train_metric_reset",
    "log_validation"])
def test_callback_log_lines(caplog, case):
    make, params = {
        "speedometer": (lambda p: p.callback.Speedometer(32, frequent=4),
                        _batches(True)),
        "speedometer_no_reset": (lambda p: p.callback.Speedometer(
            32, frequent=3, auto_reset=False), _batches(True)),
        "speedometer_no_metric": (lambda p: p.callback.Speedometer(
            16, frequent=5), _batches(False)),
        "progress_bar": (lambda p: p.callback.ProgressBar(12, length=20),
                         _batches(True)),
        "log_train_metric": (lambda p: p.callback.log_train_metric(5),
                             _batches(True)),
        "log_train_metric_reset": (lambda p: p.callback.log_train_metric(
            4, auto_reset=True), _batches(True)),
        "log_validation": (lambda p: p.callback.LogValidationMetricsCallback(),
                           _batches(True)),
    }[case]
    mine = _lines(caplog, mx, make, params)
    ref = _lines(caplog, jmx, make, params)
    assert mine == ref
    assert mine, "no line was logged"


def test_checkpoint_callbacks_wait_for_queue_a7(tmp_path):
    """The checkpoint callbacks (ported with Module and model.py): every
    `period` epochs, do_checkpoint writes files the reference loads and
    module_checkpoint calls the module's save_checkpoint."""
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    rng = np.random.RandomState(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    args = {"fc_weight": mx.nd.array(w, ctx=mx.cpu()),
            "fc_bias": mx.nd.array(b, ctx=mx.cpu())}
    prefix = str(tmp_path / "cb")
    cb = mx.callback.do_checkpoint(prefix, period=2)
    cb(0, net, args, {})
    assert not (tmp_path / "cb-0001.params").exists()
    cb(1, net, args, {})
    sym, arg, aux = jmx.model.load_checkpoint(prefix, 2)
    assert sym.list_arguments() == ["data", "fc_weight", "fc_bias"]
    np.testing.assert_array_equal(arg["fc_weight"].asnumpy(), w)
    np.testing.assert_array_equal(arg["fc_bias"].asnumpy(), b)
    assert aux == {}

    saved = []

    class _Mod:
        def save_checkpoint(self, prefix, epoch, save_optimizer_states):
            saved.append((prefix, epoch, save_optimizer_states))
    mcb = mx.callback.module_checkpoint(_Mod(), "p", period=3,
                                        save_optimizer_states=True)
    for epoch in range(6):
        mcb(epoch)
    assert saved == [("p", 3, True), ("p", 6, True)]


@pytest.mark.parametrize("num_slice,even", [(1, True), (2, True), (3, True),
                                            (4, False), (5, False)])
@pytest.mark.parametrize("axis", [0, 1])
def test_split_data(num_slice, even, axis):
    x = np.arange(12 * 6 * 2, dtype=np.float32).reshape(12, 6, 2)
    if axis == 1:
        x = x.transpose(1, 0, 2).copy()
    mine = mx.gluon.utils.split_data(mx.nd.array(x), num_slice, axis, even)
    ref = jmx.gluon.utils.split_data(jmx.nd.array(x), num_slice, axis, even)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_split_data_uneven_raises():
    with pytest.raises(ValueError):
        mx.gluon.utils.split_data(mx.nd.zeros((10, 2)), 3)


def test_split_and_load():
    x = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    ctxs = [mx.cpu(0), mx.cpu(1)]
    out = mx.gluon.utils.split_and_load(x, ctxs)
    ref = jmx.gluon.utils.split_and_load(x, [jmx.cpu(0), jmx.cpu(1)])
    assert [o.context for o in out] == ctxs
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    one = mx.gluon.utils.split_and_load(mx.nd.array(x), [mx.cpu()])
    np.testing.assert_array_equal(one[0].asnumpy(), x)


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 100.0])
@pytest.mark.parametrize("check_isfinite", [True, False])
def test_clip_global_norm(max_norm, check_isfinite):
    rng = np.random.RandomState(2)
    arrays = [rng.randn(*s).astype(np.float32)
              for s in [(3, 4), (7,), (2, 2, 2)]]
    mine = [mx.nd.array(a) for a in arrays]
    ref = [jmx.nd.array(a) for a in arrays]
    n1 = mx.gluon.utils.clip_global_norm(mine, max_norm, check_isfinite)
    n2 = jmx.gluon.utils.clip_global_norm(ref, max_norm, check_isfinite)
    n1 = n1 if check_isfinite else float(n1.asscalar())
    n2 = n2 if check_isfinite else float(n2.asscalar())
    assert abs(n1 - n2) <= 1e-6 * n2
    for a, b in zip(mine, ref):
        a, b = a.asnumpy(), b.asnumpy()
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def test_clip_global_norm_warns_on_nan():
    arrs = [mx.nd.array([1.0, float("nan")])]
    with pytest.warns(UserWarning):
        mx.gluon.utils.clip_global_norm(arrs, 1.0)


def test_check_sha1_and_download_of_local_files(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"mxnet" * 1000)
    sha = hashlib.sha1(src.read_bytes()).hexdigest()
    assert mx.gluon.utils.check_sha1(str(src), sha)
    assert not mx.gluon.utils.check_sha1(str(src), "0" * 40)
    dst = tmp_path / "out"
    dst.mkdir()
    got = mx.gluon.utils.download(str(src), path=str(dst))
    assert got == str(dst / "src.bin") and open(got, "rb").read() == \
        src.read_bytes()
    got2 = mx.gluon.utils.download("file://" + str(src),
                                   path=str(tmp_path / "copy.bin"),
                                   sha1_hash=sha)
    assert mx.gluon.utils.check_sha1(got2, sha)
    # an existing file with the right hash is not fetched again
    assert mx.gluon.utils.download("http://example.invalid/copy.bin",
                                   path=got2, sha1_hash=sha) == got2
    with pytest.raises(RuntimeError):
        mx.gluon.utils.download("http://example.invalid/x.bin",
                                path=str(tmp_path / "x.bin"))


@pytest.mark.parametrize("shape", [None, (), (2, 3), (2, 0), (None, 4)])
def test_shape_is_known(shape):
    assert mx.gluon.utils.shape_is_known(shape) == \
        jmx.gluon.utils.shape_is_known(shape)
