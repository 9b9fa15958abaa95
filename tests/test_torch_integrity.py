"""The port's integrity plane (`resilience.integrity` and the runner's
rollback-to-last-good) against the JAX package, on the CPU.

The reference's `tests/test_integrity.py` cases, ported: the sentinel's
errors and loss-spike detector fed the same losses on both packages;
rollback past a poisoned batch through `FusedTrainStep` (site
``fused_step``), the bucketed `Trainer` (``kvstore.bucket``) and
`Trainer(zero=True)` (``zero.bucket``), each bit-identical to a clean run
fed the skip-adjusted data indices and with the reference's `RunReport`
counts under the same plan; resume after a rollback, the rollback budget,
the skip policy; and the checksummed snapshots' corruption matrix. The
wire checksum of the dist kvstore runs at gloo world 2
(`_torch_resilience_worker.py`).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import resilience as jrz
from mxnet_tpu.resilience import integrity as jintegrity

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, engine, telemetry
from mxnet_tpu_torch import resilience as rz
from mxnet_tpu_torch.resilience import faults, integrity
from mxnet_tpu_torch.resilience.errors import (CheckpointCorruptError,
                                               DivergenceError,
                                               FatalTrainingError)
from mxnet_tpu_torch.resilience.run import SnapshotCheckpointer
from mxnet_tpu_torch.util import write_latest_marker

from _torch_seed import _seed_torch  # noqa: F401
from test_torch_resilience import COUNTS, _counts, _mlp, weights  # noqa: F401
from test_torch_resilience_dist import spawn


def _counter(name):
    return telemetry.counter_value(name)


@pytest.fixture(autouse=True)
def _clean_integrity():
    telemetry.enable()
    integrity.reset()
    jintegrity.reset()
    faults.deactivate()
    jrz.faults.deactivate()
    yield
    integrity.reset()
    jintegrity.reset()
    faults.deactivate()
    jrz.faults.deactivate()


def _batches(n=8, poison=None):
    rng = np.random.RandomState(0)
    X = rng.rand(n, 32, 8).astype(np.float32)
    Y = rng.randint(0, 3, (n, 32)).astype(np.float32)
    if poison is not None:
        X[poison, 0, 0] = np.nan
    return X, Y


def _batch_fn(pkg, X, Y):
    return lambda i: (pkg.nd.array(X[i], ctx=pkg.cpu()),
                      pkg.nd.array(Y[i], ctx=pkg.cpu()))


def _fused(pkg, weights):
    net = _mlp(pkg)
    net.load_parameters(weights, ctx=pkg.cpu())
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    return net, pkg.gluon.FusedTrainStep(
        net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), tr)


def _params(net):
    return [(k, p.data().asnumpy())
            for k, p in sorted(net._collect_params_with_prefix().items())]


def _bit_identical(net_a, net_b):
    for (k, a), (_, b) in zip(_params(net_a), _params(net_b)):
        assert a.tobytes() == b.tobytes(), k


# ----------------------------------------------------------- the sentinel
def test_divergence_error_carries_context():
    integrity.set_step(17)
    before = _counter("integrity.divergences.kvstore.bucket")
    with pytest.raises(DivergenceError) as ei:
        integrity.check_finite([torch.tensor([1.0, float("nan")])],
                               site="kvstore.bucket", keys=["3", "4"])
    err = ei.value
    assert err.step == 17 and err.site == "kvstore.bucket"
    assert err.keys == ["3", "4"]
    assert "kvstore.bucket" in err.format_report()
    assert _counter("integrity.divergences.kvstore.bucket") == before + 1


def test_finite_scalar_is_one_flag_over_every_tensor():
    ok = [torch.ones(3, 2), torch.zeros(5)]
    assert bool(integrity.finite_scalar(ok))
    assert not bool(integrity.finite_scalar(ok + [torch.tensor([
        float("inf")])]))
    assert integrity.finite_scalar(ok).dim() == 0


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_loss_sentinel_nonfinite_always_trips(bad):
    for mod in (integrity, jintegrity):
        with pytest.raises((DivergenceError, jrz.DivergenceError)):
            mod.observe_loss(bad, step=3)


def _spikes(mod, losses):
    """Which of `losses` trip the sentinel."""
    out = []
    for i, l in enumerate(losses):
        try:
            mod.observe_loss(l, step=i)
            out.append(False)
        except (DivergenceError, jrz.DivergenceError):
            out.append(True)
    return out


@pytest.mark.parametrize("losses", [
    [1.0 + 0.01 * i for i in range(9)] + [500.0, 400.0, 1.05],
    [1.0] * 12 + [5.0, 9.9, 10.5],
    [2.0, 30.0] * 6 + [100.0]], ids=["spike", "within", "alternating"])
def test_loss_spike_detector_matches_the_reference(monkeypatch, losses):
    monkeypatch.setenv("MXNET_TPU_LOSS_SPIKE_FACTOR", "10")
    before = _counter("integrity.loss_spikes")
    got = _spikes(integrity, losses)
    assert got == _spikes(jintegrity, losses)
    assert _counter("integrity.loss_spikes") == before + sum(got)


def test_sentinel_off_by_default_lets_nan_through(weights):
    X, Y = _batches(poison=2)
    net, fused = _fused(mx, weights)
    batch = _batch_fn(mx, X, Y)
    for i in range(4):
        fused(*batch(i))
    assert not all(np.isfinite(a).all() for _, a in _params(net))


# ------------------------------------------------------- rollback parity
def test_fused_step_nan_rollback_bit_identical(tmp_path, monkeypatch,
                                               weights):
    """A `train.batch` corrupt poisons batch 3: the fused step's sentinel
    raises, the runner rolls back and skips the index; the weights
    bit-equal a clean run over the final indices, and the counts equal
    the reference's under the same plan."""
    monkeypatch.setenv("MXNET_TPU_INTEGRITY", "1")
    X, Y = _batches()
    net_b, fused_b = _fused(mx, weights)
    before = _counter("integrity.divergences.fused_step")
    with faults.inject("train.batch:corrupt:4"):
        runner = rz.ResilientRunner.for_fused_step(
            fused_b, _batch_fn(mx, X, Y), ckpt_dir=str(tmp_path / "ck"),
            ckpt_every=2, max_restarts=3)
        report = runner.run(6)
    assert _counter("integrity.divergences.fused_step") == before + 1
    _, jfused = _fused(jmx, weights)
    with jrz.faults.inject("train.batch:corrupt:4"):
        jrunner = jrz.ResilientRunner.for_fused_step(
            jfused, _batch_fn(jmx, X, Y), ckpt_dir=str(tmp_path / "jck"),
            ckpt_every=2, max_restarts=3)
        want = jrunner.run(6)
    assert report.rollbacks == 1 and report.skipped_batches == 1
    assert report.restarts == 0
    assert _counts(report) == _counts(want)
    final_idx = [runner.data_index(s) for s in range(6)]
    assert final_idx == [jrunner.data_index(s) for s in range(6)] \
        == [0, 1, 2, 4, 5, 6]
    net_a, fused_a = _fused(mx, weights)
    batch = _batch_fn(mx, X, Y)
    for i in final_idx:
        fused_a(*batch(i))
    _bit_identical(net_a, net_b)


def _trainer_state_io(net, tr, tmp_path):
    sfile = str(tmp_path / "trainer.states")

    def state_get():
        tr.save_states(sfile)
        with open(sfile, "rb") as f:
            blob = f.read()
        return {"params": {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()},
                "opt": blob}

    def state_set(tree):
        for k, p in net.collect_params().items():
            p.set_data(mx.nd.array(tree["params"][k], ctx=mx.cpu()))
        # the weights live on the store: make it again from the restored
        # parameters, then load the optimizer states
        tr._reset_kvstore()
        with open(sfile, "wb") as f:
            f.write(tree["opt"])
        tr.load_states(sfile)

    return state_get, state_set


@pytest.mark.parametrize("zero", [None, True], ids=["bucketed", "zero"])
def test_trainer_nan_rollback_bit_identical(tmp_path, monkeypatch,
                                            weights, zero):
    """Poisoned batch 3 trips the push's sentinel inside `tr.step`
    (``kvstore.bucket``; ``zero.bucket`` for the ZeRO updater's packed
    buckets); rollback and skip give the clean run over the final
    indices bit for bit."""
    monkeypatch.setenv("MXNET_TPU_INTEGRITY", "1")
    steps, poison = 6, 3
    X, Y = _batches(poison=poison)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    site = "zero.bucket" if zero else "kvstore.bucket"

    def build():
        net = _mlp(mx)
        net.load_parameters(weights, ctx=mx.cpu())
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9},
                              kvstore="device", update_on_kvstore=True,
                              zero=zero)
        return net, tr

    def one_step(net, tr, i):
        x = mx.nd.array(X[i], ctx=mx.cpu())
        y = mx.nd.array(Y[i], ctx=mx.cpu())
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(x.shape[0])
        return float(loss.mean().asnumpy())

    before = _counter("integrity.divergences.%s" % site)
    with engine.bucket_mb_scope(0.001):
        net_b, tr_b = build()
        state_get, state_set = _trainer_state_io(net_b, tr_b, tmp_path)
        runner = rz.ResilientRunner(
            lambda i: one_step(net_b, tr_b, i), state_get=state_get,
            state_set=state_set, ckpt_dir=str(tmp_path / "ck"),
            ckpt_every=2, max_restarts=3)
        report = runner.run(steps)
        assert report.rollbacks == 1 and report.skipped_batches == 1
        final_idx = [runner.data_index(s) for s in range(steps)]
        assert poison not in final_idx
        net_a, tr_a = build()
        for i in final_idx:
            one_step(net_a, tr_a, i)
    assert _counter("integrity.divergences.%s" % site) == before + 1
    _bit_identical(net_a, net_b)
    assert all(np.isfinite(a).all() for _, a in _params(net_b))


def test_resume_after_rollback_roundtrip(tmp_path, monkeypatch, weights):
    """The skip windows ride the checkpoint: a resume after a rollback
    still skips the poisoned index."""
    monkeypatch.setenv("MXNET_TPU_INTEGRITY", "1")
    X, Y = _batches(n=12)
    batch = _batch_fn(mx, X, Y)
    net_b, fused_b = _fused(mx, weights)
    with faults.inject("train.batch:corrupt:4"):
        runner = rz.ResilientRunner.for_fused_step(
            fused_b, batch, ckpt_dir=str(tmp_path / "ck"), ckpt_every=1,
            max_restarts=3)
        runner.run(6)
    assert runner.data_index(5) == 6
    for p in net_b.collect_params().values():
        p.set_data(p.data() * 0.0)
    fused_b2 = mx.gluon.FusedTrainStep(
        net_b, mx.gluon.loss.SoftmaxCrossEntropyLoss(), fused_b._trainer)
    runner2 = rz.ResilientRunner.for_fused_step(
        fused_b2, batch, ckpt_dir=str(tmp_path / "ck"), ckpt_every=1,
        max_restarts=3)
    runner2.run(10, resume=True)
    final_idx = [runner2.data_index(s) for s in range(10)]
    assert final_idx == [0, 1, 2, 4, 5, 6, 7, 8, 9, 10]
    net_a, fused_a = _fused(mx, weights)
    for i in final_idx:
        fused_a(*batch(i))
    _bit_identical(net_a, net_b)


def test_rollback_budget_escalates_fatal(tmp_path, monkeypatch, weights):
    monkeypatch.setenv("MXNET_TPU_INTEGRITY", "1")
    monkeypatch.setenv("MXNET_TPU_ROLLBACK_BUDGET", "2")
    X, Y = _batches(n=16)
    _, fused = _fused(mx, weights)
    with faults.inject("train.batch:corrupt:4+"):
        runner = rz.ResilientRunner.for_fused_step(
            fused, _batch_fn(mx, X, Y), ckpt_dir=str(tmp_path / "ck"),
            ckpt_every=1, max_restarts=10)
        with pytest.raises(FatalTrainingError, match="rollback"):
            runner.run(8)


def test_divergence_without_checkpointer_surfaces(monkeypatch, weights):
    monkeypatch.setenv("MXNET_TPU_INTEGRITY", "1")
    X, Y = _batches()
    _, fused = _fused(mx, weights)
    with faults.inject("train.batch:corrupt:2"):
        runner = rz.ResilientRunner.for_fused_step(
            fused, _batch_fn(mx, X, Y), ckpt_dir=None, max_restarts=3)
        with pytest.raises(DivergenceError):
            runner.run(6)


def test_skip_policy_pluggable(tmp_path, monkeypatch, weights):
    monkeypatch.setenv("MXNET_TPU_INTEGRITY", "1")
    X, Y = _batches(n=10)
    _, fused = _fused(mx, weights)
    with faults.inject("train.batch:corrupt:4"):
        runner = rz.ResilientRunner.for_fused_step(
            fused, _batch_fn(mx, X, Y), ckpt_dir=str(tmp_path / "ck"),
            ckpt_every=2, max_restarts=3, skip_policy=lambda step, exc: 3)
        report = runner.run(6)
    assert report.skipped_batches == 3
    assert [runner.data_index(s) for s in range(6)] == [0, 1, 2, 6, 7, 8]


def test_sharded_step_loss_sentinel_rollback(tmp_path, monkeypatch):
    """A `ShardedTrainStep` has no bucket site: the poisoned batch's
    non-finite loss trips the loss sentinel after the step, and the
    rollback restores the last snapshot and skips the batch, bit-equal to
    a clean run over the final indices."""
    from test_torch_resilience import _linear_data, _port_linear
    monkeypatch.setenv("MXNET_TPU_INTEGRITY", "1")
    X, Y = _linear_data(steps=8)
    step_b, batch = _port_linear(X, Y)
    pb, ob = step_b.init()
    with faults.inject("train.batch:corrupt:3"):
        runner = rz.ResilientRunner.for_sharded_step(
            step_b, pb, ob, batch, ckpt_dir=str(tmp_path / "ck"),
            ckpt_every=2, max_restarts=3)
        report = runner.run(6)
    assert report.rollbacks == 1 and report.skipped_batches == 1
    final_idx = [runner.data_index(s) for s in range(6)]
    assert final_idx == [0, 1, 3, 4, 5, 6]
    step_a, _ = _port_linear(X, Y)
    pa, oa = step_a.init()
    for s, i in enumerate(final_idx):
        pa, oa, _ = step_a(pa, oa, batch(i), i)
    assert torch.equal(runner.holder["params"]["w"], pa["w"])


# ------------------------------------------------ checksummed snapshots
def _ck_with_two_steps(tmp_path):
    ck = SnapshotCheckpointer(str(tmp_path / "ck"), keep=4)
    ck.save(1, {"w": torch.arange(4.0), "step": 1})
    ck.save(2, {"w": torch.arange(4.0) * 2, "step": 2})
    return ck


def test_snapshot_truncated_payload_falls_back(tmp_path):
    ck = _ck_with_two_steps(tmp_path)
    with open(ck._file(2), "r+b") as f:
        f.truncate(10)
    before = _counter("checkpoint.corrupt")
    step, tree = ck.restore()
    assert step == 1 and tree["step"] == 1
    assert _counter("checkpoint.corrupt") == before + 1
    assert _counter("checkpoint.corrupt_fallbacks") >= 1


def test_snapshot_flipped_bytes_falls_back(tmp_path):
    ck = _ck_with_two_steps(tmp_path)
    with open(ck._file(2), "r+b") as f:
        blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0xFF
        f.seek(0)
        f.write(bytes(blob))
    step, tree = ck.restore()
    assert step == 1 and tree["step"] == 1


def test_snapshot_stale_latest_marker_never_crashes(tmp_path):
    ck = _ck_with_two_steps(tmp_path)
    with open(os.path.join(ck.path, "LATEST"), "wb") as f:
        f.write(b"\xff\x13garbage")
    assert ck.latest_step() == 2
    assert ck.restore()[0] == 2


def test_snapshot_marker_names_missing_step_falls_back(tmp_path):
    ck = _ck_with_two_steps(tmp_path)
    write_latest_marker(ck.path, 9)
    assert ck.latest_step() == 2
    assert ck.restore()[0] == 2


def test_snapshot_injected_corruption_between_prepare_and_commit(tmp_path):
    ck = SnapshotCheckpointer(str(tmp_path / "ck"), keep=4)
    ck.save(1, {"w": torch.arange(4.0)})
    with faults.inject("checkpoint.corrupt:corrupt:1"):
        ck.prepare(2, {"w": torch.arange(4.0) * 2})
        ck.commit(2)
    assert ck.latest_step() == 2
    before = _counter("checkpoint.corrupt")
    assert ck.restore()[0] == 1
    assert _counter("checkpoint.corrupt") == before + 1


def test_snapshot_all_corrupt_raises(tmp_path):
    ck = _ck_with_two_steps(tmp_path)
    for s in (1, 2):
        with open(ck._file(s), "r+b") as f:
            f.truncate(8)
    with pytest.raises(CheckpointCorruptError) as ei:
        ck.restore()
    assert ei.value.steps_tried == [2, 1]


def test_snapshot_missing_sidecar_still_loads(tmp_path):
    ck = _ck_with_two_steps(tmp_path)
    os.remove(ck._digest_file(2))
    assert ck.restore()[0] == 2


def test_runner_restores_past_corrupt_snapshot(tmp_path, weights):
    """The newest snapshot corrupted on disk, then a preemption: the
    runner falls back to the older snapshot, replays, and ends bit-equal
    to the clean run."""
    X, Y = _batches()
    batch = _batch_fn(mx, X, Y)
    net_b, fused_b = _fused(mx, weights)
    with faults.inject("checkpoint.corrupt:corrupt:2;run.step:preempt:5"):
        runner = rz.ResilientRunner.for_fused_step(
            fused_b, batch, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
            max_restarts=3)
        report = runner.run(6)
    assert report.restarts == 1
    assert _counter("checkpoint.corrupt_fallbacks") >= 1
    net_a, fused_a = _fused(mx, weights)
    for i in range(6):
        fused_a(*batch(i))
    _bit_identical(net_a, net_b)


# --------------------------------------------------------- wire checksum
def test_comm_checksum_counts_and_trips_at_world_two(tmp_path):
    """Each bucket of a dist push is digested and counted; a NaN pushed
    by one rank makes both ranks raise at ``kvstore_dist.bucket`` before
    any write (the store keeps the first push's sum)."""
    res = spawn("checksum", 2, tmp_path)
    for r in res:
        assert int(r["checksum/buckets"]) >= 1
        np.testing.assert_array_equal(r["checksum/summed"], [7.0] * 3)
        assert str(r["checksum/site"]) == "kvstore_dist.bucket"
        np.testing.assert_array_equal(r["checksum/after"], [7.0] * 3)
