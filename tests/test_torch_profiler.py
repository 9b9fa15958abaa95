"""The port's `mx.profiler` against the JAX package's (modelled on the
reference's tests/test_utils_amp_profiler.py::test_profiler_aggregate).

The op table's row names and call counts of one program are equal in
both packages (the times differ): an imperative sequence, and a
hybridized block, one ``CachedOp:<name>`` row a call. Also `Scope`
nested and as a decorator, `pause`/`resume`, `reset_stats`, the
telemetry snapshot embedded in both formats, `dump`, the device trace of
``profile_all`` written as a chrome trace, and a trace that fails to
start raising (the JAX package carries on without one).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import profiler

from _torch_seed import _seed_torch  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_profilers():
    for pkg in (jmx, mx):
        pkg.profiler.set_state("stop")
        pkg.profiler.set_config(profile_all=False, profile_symbolic=True,
                                profile_imperative=True)
        pkg.profiler.reset()
    yield
    for pkg in (jmx, mx):
        pkg.profiler.set_state("stop")
        pkg.profiler.reset()


def _rows(pkg):
    table = json.loads(pkg.profiler.dumps(format="json"))
    return {k: v["count"] for k, v in table.items() if k != "telemetry"}


def _imperative(pkg):
    nd = pkg.nd
    with pkg.cpu():
        x = nd.array(np.ones((2, 3), np.float32))
        dense = pkg.gluon.nn.Dense(4)
        dense.initialize()
        dense(x)
        pkg.profiler.set_state("run")
        y = dense(x)
        y.sum()
        nd.relu(y) - y
        y.reshape((4, 2))
        nd.concat(y, y, dim=1)
        y.T
        a = nd.ones((8, 8))
        c = nd.dot(a, a) * 2
        nd.softmax(c)
        a + 1
        a * a
        1 / a
        nd.exp(a)
        nd.mean(a, axis=0)
        a.astype("float16")
        -a
        a > 0
        a.sum(axis=1)
        pkg.profiler.set_state("stop")
    return _rows(pkg)


def test_imperative_rows_equal_the_reference():
    want = _imperative(jmx)
    got = _imperative(mx)
    assert got == want
    assert want["broadcast_mul"] == 2 and want["sum"] == 2


def test_indexing_is_a_row_of_its_own():
    """Kept deviation: the port's indexing dispatches `_getitem` through
    `invoke`, so it is a row; the reference indexes outside its op table."""
    with mx.cpu():
        y = mx.nd.ones((4, 2))
        profiler.set_state("run")
        y[0]
        profiler.set_state("stop")
    assert _rows(mx) == {"_getitem": 1}


def _hybridized(pkg):
    gluon, nd = pkg.gluon, pkg.nd
    with pkg.cpu():
        net = gluon.nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(gluon.nn.Dense(8, activation="relu"), gluon.nn.Dense(4))
        net.initialize()
        net.hybridize()
        x = nd.array(np.ones((2, 3), np.float32))
        net(x).asnumpy()
        pkg.profiler.set_state("run")
        for _ in range(3):
            y = net(x)
        y = y * 2
        pkg.profiler.pause()
        y + 1
        net(x)
        pkg.profiler.resume()
        y - 1
        pkg.profiler.set_state("stop")
    return net.name, _rows(pkg)


def test_hybridized_block_is_one_cached_op_row():
    name_j, want = _hybridized(jmx)
    name_t, got = _hybridized(mx)
    assert name_j == name_t == "mlp"
    assert got == want == {"CachedOp:" + name_j: 3, "broadcast_mul": 1,
                           "broadcast_sub": 1}


def test_nested_scope_and_decorator():
    timed = profiler.Scope("hot")

    @profiler.scope("deco")
    def f(v):
        return v + 1

    with mx.cpu():
        profiler.set_state("run")
        with timed:
            with timed:
                assert f(1) == 2
        f(2)
        profiler.set_state("stop")
    rows = _rows(mx)
    assert rows == {"scope:hot": 2, "scope:deco": 2}
    # a range is timed whatever the profiler's state, as in the reference
    with profiler.Scope("outside"):
        pass
    assert "scope:outside" in profiler.dumps()


def test_reset_stats_and_reset():
    with mx.cpu():
        profiler.set_state("run")
        mx.nd.ones((2, 2)) + 1
        profiler.set_state("stop")
    assert "broadcast_add" in profiler.dumps(format="json",
                                             reset_stats=True)
    assert _rows(mx) == {}
    with profiler.Scope("x"):
        pass
    profiler.reset()
    assert _rows(mx) == {}
    with pytest.raises(ValueError):
        profiler.dumps(format="csv")
    with pytest.raises(ValueError):
        profiler.set_config(no_such_key=1)


def test_telemetry_is_embedded(tmp_path):
    from mxnet_tpu_torch import telemetry
    telemetry.reset()
    telemetry.inc("amp.syncs_saved", 3)
    try:
        with profiler.Scope("s"):
            pass
        table = profiler.dumps()
        assert "Telemetry" in table and "amp.syncs_saved" in table
        js = json.loads(profiler.dumps(format="json"))
        assert js["telemetry"]["counters"]["amp.syncs_saved"] == 3
        assert json.loads(telemetry.dumps(format="json"))["counters"][
            "amp.syncs_saved"] == 3
        path = telemetry.dump(str(tmp_path / "t.json"))
        assert json.load(open(path))["counters"]["amp.syncs_saved"] == 3
        profiler.set_config(filename=str(tmp_path / "p.json"))
        profiler.dump()
        assert "scope:s" in json.load(open(tmp_path / "p.json"))
        profiler.dump(format="table")
        assert "Telemetry" in open(tmp_path / "p.json").read()
    finally:
        telemetry.reset()
        profiler.set_config(filename="profile.json")


def test_device_trace_survives_pause(tmp_path):
    """profile_all: one torch.profiler session from run to stop, through
    a pause; its chrome trace holds the ops of both halves."""
    profiler.set_config(profile_all=True,
                        filename=str(tmp_path / "prof.json"))
    try:
        with mx.cpu():
            a = mx.nd.ones((16, 16))
            profiler.set_state("run")
            mx.nd.dot(a, a)
            profiler.pause()
            assert profiler.is_paused() and profiler._session is not None
            mx.nd.exp(a)
            profiler.resume()
            mx.nd.dot(a, a)
            profiler.set_state("stop")
        path = profiler.last_trace()
        assert path == str(tmp_path / "prof_trace.json")
        names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
        assert "aten::exp" in names and "aten::mm" in names
        assert _rows(mx) == {"dot": 2}
    finally:
        profiler.set_config(profile_all=False, filename="profile.json")


def test_failing_trace_start_raises(monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("profiler unavailable")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    profiler.set_config(profile_all=True)
    try:
        with pytest.raises(RuntimeError, match="profiler unavailable"):
            profiler.set_state("run")
        assert profiler.state() == "stop"
        from mxnet_tpu_torch.ndarray import ndarray as nd_mod
        assert nd_mod._PROFILE_IMPERATIVE is False
    finally:
        profiler.set_config(profile_all=False)


def test_profile_flags_follow_the_config():
    from mxnet_tpu_torch.ndarray import ndarray as nd_mod
    with mx.cpu():
        net = mx.gluon.nn.Dense(2)
        net.initialize()
        net.hybridize()
        x = mx.nd.ones((1, 3))
        net(x)
        profiler.set_config(profile_imperative=False, profile_symbolic=False)
        profiler.set_state("run")
        assert nd_mod._PROFILE_IMPERATIVE is False
        net(x) + 1
        profiler.set_state("stop")
    profiler.set_config(profile_imperative=True, profile_symbolic=True)
    assert _rows(mx) == {}
    assert nd_mod._PROFILE_IMPERATIVE is False
