"""The port's resumable training (`resilience.run`, `commit`, `preempt`)
against the JAX package, on the CPU, in one process.

The reference's `tests/test_resilience.py` runner, checkpointer, commit
and preemption cases, ported. The Gluon cases train the reference test's
MLP (Dense 16 relu, Dense 3, SGD-momentum) with its weights written by
the reference to a `.params` file the port loads; the functional cases a
linear model through `ShardedTrainStep` on one device. Each fault plan
runs on both packages: the `RunReport` counts must be equal, the port's
per-step losses within 1e-6 of the reference's for the functional step
(the same fp32 arithmetic) and within the reference's own bar between its
Gluon routes (rtol 2e-5, atol 2e-6) for the fused step, and an
interrupted port run's final parameters bit-equal to the port's
uninterrupted run. The cases across ranks (restore elections over gloo,
a coordinated mid-commit crash, elastic shrink and grow-back) are in
`test_torch_resilience_dist.py`.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import resilience as jrz

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import resilience as rz
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.resilience import commit, faults, retry
from mxnet_tpu_torch.resilience.errors import PreemptionError
from mxnet_tpu_torch.resilience.preempt import PreemptionListener

from _torch_seed import _seed_torch  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, LOSS_ATOL = 2e-5, 2e-6     # the reference's Gluon-route bar
FUNC_RTOL = 1e-6
COUNTS = ("restarts", "retries", "steps_executed", "replayed_steps",
          "checkpoints", "proactive_ckpts", "mesh_shrinks", "mesh_grows",
          "rollbacks", "skipped_batches")


def _counter(name):
    return telemetry.counter_value(name)


def _counts(report):
    return {k: getattr(report, k) for k in COUNTS}


@pytest.fixture(autouse=True)
def _no_plan():
    faults.deactivate()
    jrz.faults.deactivate()
    yield
    faults.deactivate()
    jrz.faults.deactivate()


# ---------------------------------------------------------------- the MLP
def _six():
    rng = np.random.RandomState(0)
    return (rng.rand(6, 32, 8).astype(np.float32),
            rng.randint(0, 3, (6, 32)).astype(np.float32))


def _mlp(pkg, dropout=False):
    nn = pkg.gluon.nn
    with pkg.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu", in_units=8))
            net.add(nn.Dense(3, in_units=16))
            if dropout:
                # after the weights, so the reference's file still fits
                net.add(nn.Dropout(0.4))
    return net


@pytest.fixture
def weights(tmp_path):
    """The reference's Xavier MLP written to a `.params` file."""
    jmx.random.seed(42)
    net = _mlp(jmx)
    net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    path = str(tmp_path / "mlp.params")
    net.save_parameters(path)
    return path


def _build(pkg, weights, optimizer="sgd", dropout=False):
    net = _mlp(pkg, dropout)
    net.load_parameters(weights, ctx=pkg.cpu())
    args = {"learning_rate": 0.1, "momentum": 0.9} if optimizer == "sgd" \
        else {"learning_rate": 0.01}
    tr = pkg.gluon.Trainer(net.collect_params(), optimizer, args)
    fused = pkg.gluon.FusedTrainStep(
        net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    return net, fused


def _batch_fn(pkg, n=6):
    X, Y = _six() if n == 6 else _batches(n)
    return lambda i: (pkg.nd.array(X[i], ctx=pkg.cpu()),
                      pkg.nd.array(Y[i], ctx=pkg.cpu()))


def _batches(n):
    rng = np.random.RandomState(0)
    return (rng.rand(n, 32, 8).astype(np.float32),
            rng.randint(0, 3, (n, 32)).astype(np.float32))


def _params(net):
    return [(k, p.data().asnumpy())
            for k, p in sorted(net._collect_params_with_prefix().items())]


def _bit_equal(net_a, net_b):
    for (k, a), (_, b) in zip(_params(net_a), _params(net_b)):
        assert a.tobytes() == b.tobytes(), k


def _clean(weights, steps=6, **kw):
    net, fused = _build(mx, weights, **kw)
    batch = _batch_fn(mx)
    return net, [float(fused(*batch(i)).asnumpy()) for i in range(steps)]


def _ref_run(weights, plan, ckpt, steps=6, **runner_kw):
    """The reference's for_fused_step under `plan` (its RunReport)."""
    _, fused = _build(jmx, weights)
    with jrz.faults.inject(plan):
        runner = jrz.ResilientRunner.for_fused_step(
            fused, _batch_fn(jmx), ckpt_dir=ckpt, **runner_kw)
        return runner.run(steps)


def _port_run(weights, plan, ckpt, steps=6, **runner_kw):
    net, fused = _build(mx, weights)
    with faults.inject(plan):
        runner = rz.ResilientRunner.for_fused_step(
            fused, _batch_fn(mx), ckpt_dir=ckpt, **runner_kw)
        return net, runner.run(steps)


# ------------------------------------------------------- the checkpointer
def test_snapshot_checkpointer_roundtrip_retention_atomicity(tmp_path):
    ck = rz.SnapshotCheckpointer(str(tmp_path / "ck"), keep=2)
    for step in range(5):
        ck.save(step, {"w": torch.full((3,), float(step)), "step": step})
    assert ck.steps() == [3, 4]
    assert ck.latest_step() == 4
    step, tree = ck.restore()
    assert step == 4 and tree["step"] == 4
    assert torch.equal(tree["w"], torch.full((3,), 4.0))
    # a stray temporary file and a corrupt marker lose nothing
    (tmp_path / "ck" / "step_9.ckpt.tmp").write_bytes(b"torn")
    (tmp_path / "ck" / "LATEST").write_text("not a number")
    assert ck.latest_step() == 4
    assert ck.restore()[0] == 4


def test_checkpointer_two_phase_prepare_commit(tmp_path):
    ck = rz.SnapshotCheckpointer(str(tmp_path / "ck"), keep=None)
    ck.save(2, {"w": 2})
    ck.prepare(3, {"w": 3})
    assert ck.latest_step() == 2
    assert 3 in ck.prepared_steps()
    assert ck.commit(9) is False
    assert ck.latest_step() == 2
    assert ck.commit(3) is True
    assert ck.latest_step() == 3


# ------------------------------------------------------------- the runner
def test_kill_and_resume_matches_fault_free_run(tmp_path, weights):
    """A transport fault at the boundary (retried in place) and a
    preemption (restore and replay): the run reproduces the fault-free
    one bit for bit, with the reference's counts and losses."""
    net_a, clean = _clean(weights)
    plan = "run.step:error:2;run.step:preempt:5"
    kw = dict(ckpt_every=2, max_restarts=3,
              retry_policy=None)
    retries0 = _counter("resilience.retries")
    restores0 = _counter("resilience.restores")
    net_b, report = _port_run(
        weights, plan, str(tmp_path / "ck"),
        **dict(kw, retry_policy=retry.RetryPolicy(max_attempts=3,
                                                  base_delay_s=0.001)))
    want = _ref_run(weights, plan, str(tmp_path / "jck"),
                    **dict(kw, retry_policy=jrz.retry.RetryPolicy(
                        max_attempts=3, base_delay_s=0.001)))
    assert report.restarts >= 1 and report.retries >= 1
    assert _counts(report) == _counts(want)
    assert report.losses == clean
    np.testing.assert_allclose(report.losses, want.losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    _bit_equal(net_a, net_b)
    assert _counter("resilience.retries") > retries0
    assert _counter("resilience.restores") > restores0


def test_kill_and_resume_with_dropout_rng_state(tmp_path, weights):
    """The random generators ride the snapshot: a net that draws every
    step (Dropout) replays the uninterrupted run."""
    mx.random.seed(9)
    net_a, fused_a = _build(mx, weights, optimizer="adam", dropout=True)
    batch = _batch_fn(mx)
    clean = [float(fused_a(*batch(i)).asnumpy()) for i in range(6)]
    mx.random.seed(9)
    net_b, fused_b = _build(mx, weights, optimizer="adam", dropout=True)
    with faults.inject("run.step:preempt:3"):
        runner = rz.ResilientRunner.for_fused_step(
            fused_b, batch, ckpt_dir=str(tmp_path / "ck"), ckpt_every=1,
            max_restarts=2)
        report = runner.run(6)
    assert report.restarts == 1
    assert report.losses == clean
    _bit_equal(net_a, net_b)


def test_runner_fault_before_first_checkpoint_surfaces_cause(tmp_path):
    def step_fn(i):
        faults.check("bare.step")
        return 0.0

    state = {"w": 1.0}
    with faults.inject("bare.step:preempt:1"):
        runner = rz.ResilientRunner(
            step_fn, state_get=lambda: dict(state),
            state_set=lambda t: state.update(t),
            ckpt_dir=str(tmp_path / "ck"), ckpt_every=5, max_restarts=3)
        with pytest.raises(PreemptionError):
            runner.run(6, start_step=2)


def test_runner_restart_budget_exhausts(weights):
    _, fused = _build(mx, weights)
    with faults.inject("run.step:preempt:1+"):
        runner = rz.ResilientRunner.for_fused_step(
            fused, _batch_fn(mx), ckpt_dir=None, max_restarts=2)
        with pytest.raises(PreemptionError):
            runner.run(6)


def test_runner_recovers_from_stall(tmp_path, weights):
    """A hang inside the step: the watchdog's StallError, restore and
    replay, the run completes (a 1 s deadline: a loaded machine's slow
    step must not read as a stall)."""
    net_a, clean = _clean(weights, steps=4)
    stalls0 = _counter("resilience.stalls")
    net, fused = _build(mx, weights)
    with faults.inject("train.step:hang:3:30"):
        runner = rz.ResilientRunner.for_fused_step(
            fused, _batch_fn(mx), ckpt_dir=str(tmp_path / "ck"),
            ckpt_every=1, max_restarts=2, step_deadline_s=1.0)
        report = runner.run(4)
    assert report.restarts == 1
    assert _counter("resilience.stalls") > stalls0
    assert report.losses == clean
    _bit_equal(net_a, net)


def test_runner_step_deadline_env_knob(tmp_path, monkeypatch, weights):
    monkeypatch.setenv("MXNET_TPU_STEP_DEADLINE_S", "0.4")
    _, fused = _build(mx, weights)
    runner = rz.ResilientRunner.for_fused_step(
        fused, _batch_fn(mx), ckpt_dir=str(tmp_path / "ck"))
    assert runner.step_deadline_s == pytest.approx(0.4)


def test_runner_auto_resume_after_process_kill(tmp_path, weights):
    """resume=True restores the newest checkpoint (the relaunch after a
    kill, same ckpt_dir, fresh state)."""
    net_a, clean = _clean(weights)
    net_b, fused_b = _build(mx, weights)
    runner = rz.ResilientRunner.for_fused_step(
        fused_b, _batch_fn(mx), ckpt_dir=str(tmp_path / "ck"),
        ckpt_every=1, max_restarts=0)
    with faults.inject("run.step:preempt:4"):
        with pytest.raises(PreemptionError):
            runner.run(6)
    for p in net_b.collect_params().values():
        p.set_data(p.data() * 0.0)
    runner2 = rz.ResilientRunner.for_fused_step(
        fused_b, _batch_fn(mx), ckpt_dir=str(tmp_path / "ck"), ckpt_every=1)
    report = runner2.run(6, resume=True)
    assert report.restarts == 0
    _bit_equal(net_a, net_b)
    tail = [l for l in report.losses if l is not None]
    assert tail == clean[-len(tail):]


_CHILD = r"""
import os, sys, time
import numpy as np
import torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import resilience as rz
from mxnet_tpu_torch.resilience.preempt import PreemptionListener
mode, ck, out, weights = sys.argv[1:5]
with mx.name.NameManager():
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8))
        net.add(mx.gluon.nn.Dense(3, in_units=16))
net.load_parameters(weights, ctx=mx.cpu())
tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                      {{"learning_rate": 0.1, "momentum": 0.9}})
fused = mx.gluon.FusedTrainStep(
    net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), tr)
rng = np.random.RandomState(0)
X = rng.rand(6, 32, 8).astype(np.float32)
Y = rng.randint(0, 3, (6, 32)).astype(np.float32)
ready = out + ".ready"
def batch(i):
    if mode == "sigterm" and i == 2 and not os.path.exists(ready):
        open(ready, "w").close()
        # the parent's SIGTERM lands while this step runs
        deadline = time.time() + 60
        while time.time() < deadline and not getattr(batch, "hit", False):
            time.sleep(0.01)
            batch.hit = listener.pending() is not None
    if mode == "kill" and i == 3:
        os.kill(os.getpid(), 9)
    return mx.nd.array(X[i], ctx=mx.cpu()), mx.nd.array(Y[i], ctx=mx.cpu())
listener = PreemptionListener(poll_fn=False)
runner = rz.ResilientRunner.for_fused_step(
    fused, batch, ckpt_dir=ck, ckpt_every=(5 if mode == "sigterm" else 1),
    max_restarts=2, preempt_listener=listener)
with listener:
    rep = runner.run(6, resume=(mode == "resume"))
np.savez(out, losses=np.array([np.nan if l is None else l
                               for l in rep.losses]),
         proactive=rep.proactive_ckpts, replayed=rep.replayed_steps,
         restarts=rep.restarts,
         **{{k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}})
"""


def _child(tmp_path, mode, ck, out, weights):
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(root=ROOT))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(script), mode, ck, out,
                             weights], env=env)


def test_runner_resumes_after_a_real_process_kill(tmp_path, weights):
    """A child process killed (SIGKILL) mid-run, then started again with
    resume=True: the final parameters bit-equal the uninterrupted run's."""
    net_a, clean = _clean(weights)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out.npz")
    proc = _child(tmp_path, "kill", ck, out, weights)
    assert proc.wait(timeout=120) == -signal.SIGKILL
    assert not os.path.exists(out)
    proc = _child(tmp_path, "resume", ck, out, weights)
    assert proc.wait(timeout=120) == 0
    got = np.load(out)
    for k, a in _params(net_a):
        assert got[k].tobytes() == a.tobytes(), k
    tail = [l for l in got["losses"] if not np.isnan(l)]
    assert tail == clean[-len(tail):]


def test_preempt_listener_sigterm_to_a_child(tmp_path, weights):
    """SIGTERM sent to a child process mid-run: its listener (installed on
    the child's main thread) turns it into a proactive checkpoint, the run
    goes on with no step replayed and ends as the uninterrupted one."""
    net_a, clean = _clean(weights)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out.npz")
    proc = _child(tmp_path, "sigterm", ck, out, weights)
    deadline = time.monotonic() + 120
    while not os.path.exists(out + ".ready"):
        assert proc.poll() is None and time.monotonic() < deadline
        time.sleep(0.02)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=120) == 0
    got = np.load(out)
    assert int(got["proactive"]) == 1 and int(got["replayed"]) == 0
    assert int(got["restarts"]) == 1
    assert list(got["losses"]) == clean
    for k, a in _params(net_a):
        assert got[k].tobytes() == a.tobytes(), k


def test_runner_mesh_shrink_degrades_gracefully(tmp_path):
    class FakeDevices:
        def __init__(self, size):
            self.size = size

    class FakeMesh:
        def __init__(self, size):
            self.devices = FakeDevices(size)

    sizes = {"n": 8}
    state = {"w": 0.0, "rebuilt_for": None}

    def step_fn(i):
        faults.check("fake.step")
        state["w"] += 1.0
        return state["w"]

    def on_shrink(mesh):
        state["rebuilt_for"] = mesh.devices.size
        return step_fn

    shrinks0 = _counter("resilience.mesh_shrinks")
    with faults.inject("fake.step:preempt:3"):
        runner = rz.ResilientRunner(
            step_fn, state_get=lambda: dict(state),
            state_set=lambda t: state.update(t),
            ckpt_dir=str(tmp_path / "ck"), ckpt_every=1, max_restarts=2,
            mesh_factory=lambda: FakeMesh(sizes["n"]), on_shrink=on_shrink)
        sizes["n"] = 4
        report = runner.run(5)
    assert report.restarts == 1 and report.mesh_shrinks == 1
    assert state["rebuilt_for"] == 4
    assert _counter("resilience.mesh_shrinks") == shrinks0 + 1


# ---------------------------------------------------- the functional step
def _linear_data(steps=6, binary=False):
    rng = np.random.RandomState(3)
    if binary:
        return (rng.randint(0, 2, (steps, 16, 4)).astype(np.float32),
                rng.randint(0, 2, (steps, 16, 2)).astype(np.float32))
    return (rng.rand(steps, 16, 4).astype(np.float32),
            rng.rand(steps, 16, 2).astype(np.float32))


def _port_linear(X, Y, lr=0.1, momentum=0.9):
    from mxnet_tpu_torch.parallel import ShardedTrainStep

    def loss_fn(params, batch):
        return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean()

    step = ShardedTrainStep(loss_fn, {"w": torch.zeros(4, 2)},
                            optimizer="sgd", lr=lr, momentum=momentum)
    batch = lambda i: {"x": torch.from_numpy(X[i]),  # noqa: E731
                       "y": torch.from_numpy(Y[i])}
    return step, batch


def _ref_linear(X, Y, plan, ckpt, steps, **kw):
    import jax.numpy as jnp
    from mxnet_tpu.parallel import ShardedTrainStep, create_mesh

    def loss_fn(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    step = ShardedTrainStep(loss_fn, {"w": jnp.zeros((4, 2))},
                            create_mesh(data=1), optimizer="sgd", lr=0.1,
                            momentum=0.9, donate=False)
    p, o = step.init()
    with jrz.faults.inject(plan):
        runner = jrz.ResilientRunner.for_sharded_step(
            step, p, o, lambda i: {"x": jnp.asarray(X[i]),
                                   "y": jnp.asarray(Y[i])},
            ckpt_dir=ckpt, **kw)
        return runner.run(steps)


@pytest.mark.parametrize("plan", ["run.step:preempt:4",
                                  "run.step:error:2;train.step:preempt:5",
                                  "train.step:preempt:2;run.step:preempt:6"],
                         ids=["preempt", "retry_then_step_fault",
                              "two_restores"])
def test_sharded_train_step_resilient_run(tmp_path, plan):
    """ShardedTrainStep under the runner: the same plan on both packages
    gives equal counts and per-step losses within 1e-6; the port's final
    parameters bit-equal its uninterrupted run's."""
    X, Y = _linear_data()
    step_a, batch = _port_linear(X, Y)
    pa, oa = step_a.init()
    clean = []
    for i in range(6):
        pa, oa, l = step_a(pa, oa, batch(i), i)
        clean.append(l.item())
    step_b, _ = _port_linear(X, Y)
    pb, ob = step_b.init()
    kw = dict(ckpt_every=2, max_restarts=3,
              retry_policy=None)
    with faults.inject(plan):
        runner = rz.ResilientRunner.for_sharded_step(
            step_b, pb, ob, batch, ckpt_dir=str(tmp_path / "ck"),
            **dict(kw, retry_policy=retry.RetryPolicy(base_delay_s=0.001)))
        report = runner.run(6)
    want = _ref_linear(X, Y, plan, str(tmp_path / "jck"), 6,
                       **dict(kw, retry_policy=jrz.retry.RetryPolicy(
                           base_delay_s=0.001)))
    assert report.restarts >= 1
    assert _counts(report) == _counts(want)
    np.testing.assert_allclose(report.losses, want.losses, rtol=FUNC_RTOL)
    assert report.losses == clean
    assert torch.equal(runner.holder["params"]["w"], pa["w"])


def test_sharded_step_place_and_rebuild_unit():
    """place lays whole trees out as the step's (on one rank: as they
    are, copied); rebuild_for_mesh keeps the settings."""
    from mxnet_tpu_torch.parallel import ShardedTrainStep, create_mesh
    step = ShardedTrainStep(lambda p, b: (b["x"] @ p["w"]).pow(2).mean(),
                            {"w": torch.zeros(4, 2)}, optimizer="sgd",
                            lr=0.5, momentum=0.5, grad_accum=1)
    rebuilt = step.rebuild_for_mesh(create_mesh(data=1))
    assert rebuilt.lr == step.lr and rebuilt.opt_kwargs == step.opt_kwargs
    assert rebuilt.rules is step.rules and rebuilt.zero == step.zero
    w = torch.ones(4, 2)
    p2, o2 = rebuilt.place({"w": w}, {"mom": {"w": torch.zeros(4, 2)}})
    assert torch.equal(p2["w"], w)
    assert p2["w"].device == torch.device("cpu")
    assert torch.equal(o2["mom"]["w"], torch.zeros(4, 2))


# --------------------------------------------------------------- commit
def test_commit_election_min_and_rank_ahead_counter():
    ahead0 = _counter("resilience.commit.rank_ahead")
    coord = commit.CommitCoordinator(gather=lambda step, rnd: [step,
                                                               step - 1])
    assert coord.elect(5) == 4
    assert _counter("resilience.commit.rank_ahead") == ahead0 + 1
    assert _counter("resilience.commit.elections") >= 1
    gauge = telemetry.snapshot()["gauges"]["resilience.commit.elected_step"]
    assert gauge["value"] == 4


def test_commit_election_single_process_identity_and_none():
    assert commit.elect_step(7) == 7
    assert commit.CommitCoordinator().elect(None) is None
    coord = commit.CommitCoordinator(gather=lambda step, rnd: [step, None,
                                                               3])
    assert coord.elect(5) == 3


def test_commit_restore_election_agrees_across_simulated_ranks(tmp_path):
    cks = [rz.SnapshotCheckpointer(str(tmp_path / ("rank%d" % r)))
           for r in range(2)]
    for step in (1, 2, 3, 4):
        for ck in cks:
            ck.save(step, {"w": np.full((2,), float(step)), "step": step})
    cks[1].prepare(5, {"w": np.full((2,), 5.0), "step": 5})
    durable = [max(ck.prepared_steps()) for ck in cks]
    assert durable == [4, 5]
    restored = []
    for rank, ck in enumerate(cks):
        coord = commit.CommitCoordinator(gather=lambda s, r: list(durable))
        step, tree = ck.restore(coord.elect(durable[rank], kind="restore"))
        restored.append((step, tree["step"]))
    assert restored == [(4, 4), (4, 4)]


def test_runner_coordinated_save_commits_elected_step(tmp_path):
    state = {"w": 0.0}
    runner = rz.ResilientRunner(
        lambda i: 0.0, state_get=lambda: dict(state),
        state_set=lambda t: state.update(t),
        ckpt_dir=str(tmp_path / "ck"), ckpt_every=1,
        commit=commit.CommitCoordinator(
            gather=lambda step, rnd: [step, max(0, step - 1)]))
    report = runner.run(3)
    assert 2 in runner.ckpt.prepared_steps()
    assert runner.ckpt.latest_step() == 1
    assert report.checkpoints == 3


def test_mid_commit_crash_resumes_at_committed_step(tmp_path, weights):
    """The checkpoint.save site: a crash after the payload is durable and
    before the marker moves resumes at the last committed step."""
    net_a, clean = _clean(weights)
    net_b, fused_b = _build(mx, weights)
    with faults.inject("checkpoint.save:preempt:3"):
        runner = rz.ResilientRunner.for_fused_step(
            fused_b, _batch_fn(mx), ckpt_dir=str(tmp_path / "ck"),
            ckpt_every=2)
        with pytest.raises(PreemptionError):
            runner.run(6)
    ck = rz.SnapshotCheckpointer(str(tmp_path / "ck"))
    assert 4 in ck.prepared_steps()
    assert ck.latest_step() == 2
    runner2 = rz.ResilientRunner.for_fused_step(
        fused_b, _batch_fn(mx), ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    report = runner2.run(6, resume=True)
    tail = [l for l in report.losses if l is not None]
    assert tail == clean[-len(tail):]
    _bit_equal(net_a, net_b)


# ------------------------------------------------------------- preemption
def test_preempt_listener_poll_notice_via_fault_plan():
    notices0 = _counter("resilience.preempt.notices")
    with faults.inject("preempt.poll:preempt:1"):
        listener = PreemptionListener(poll_interval_s=0.01)
        listener.start()
        try:
            deadline = time.monotonic() + 5.0
            while listener.pending() is None and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            notice = listener.pending()
        finally:
            listener.stop()
    assert notice is not None and notice.source == "poll"
    assert "preemption" in notice.reason
    assert _counter("resilience.preempt.notices") == notices0 + 1
    assert _counter("resilience.preempt.notices.poll") >= 1


def test_preempt_listener_sigterm_notice():
    seen = []
    listener = PreemptionListener(poll_fn=False,
                                  on_notice=lambda n: seen.append(n))
    listener.start()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while listener.pending() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        notice = listener.pending()
    finally:
        listener.stop()
    assert notice is not None and notice.source == "sigterm"
    assert seen and seen[0] is notice
    assert signal.getsignal(signal.SIGTERM) != listener._handle_sigterm


def _noticed(listener):
    deadline = time.monotonic() + 5.0
    while listener.pending() is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert listener.pending() is not None


def test_runner_proactive_checkpoint_zero_replay(tmp_path, weights):
    """A preemption notice gives a proactive checkpoint: the resume
    replays no step, and the run matches the fault-free one and the
    reference's counts."""
    net_a, clean = _clean(weights)
    net_b, fused_b = _build(mx, weights)
    proactive0 = _counter("resilience.proactive_checkpoints")
    kw = dict(ckpt_every=5, max_restarts=2)
    with faults.inject("preempt.poll:preempt:1"):
        listener = PreemptionListener(poll_interval_s=0.01).start()
        try:
            _noticed(listener)
            runner = rz.ResilientRunner.for_fused_step(
                fused_b, _batch_fn(mx), ckpt_dir=str(tmp_path / "ck"),
                preempt_listener=listener, **kw)
            report = runner.run(6)
        finally:
            listener.stop()
    _, jfused = _build(jmx, weights)
    with jrz.faults.inject("preempt.poll:preempt:1"):
        jl = jrz.preempt.PreemptionListener(poll_interval_s=0.01).start()
        try:
            _noticed(jl)
            want = jrz.ResilientRunner.for_fused_step(
                jfused, _batch_fn(jmx), ckpt_dir=str(tmp_path / "jck"),
                preempt_listener=jl, **kw).run(6)
        finally:
            jl.stop()
    assert report.proactive_ckpts == 1 and report.replayed_steps == 0
    assert report.restarts == 1
    assert _counts(report) == _counts(want)
    assert _counter("resilience.proactive_checkpoints") == proactive0 + 1
    assert report.losses == clean
    np.testing.assert_allclose(report.losses, want.losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    _bit_equal(net_a, net_b)


def test_runner_reactive_preemption_replays_for_contrast(tmp_path, weights):
    """A hard preemption off the checkpoint cadence replays the steps
    since the snapshot (here one), as the reference's run does."""
    plan = "run.step:preempt:5"
    kw = dict(ckpt_every=3, max_restarts=2)
    _, report = _port_run(weights, plan, str(tmp_path / "ck"), **kw)
    want = _ref_run(weights, plan, str(tmp_path / "jck"), **kw)
    assert report.replayed_steps == 1
    assert report.recovery_time_s > 0.0
    assert _counts(report) == _counts(want)


def test_on_shrink_hook_overrides_the_relayout(tmp_path):
    class FakeMesh:
        def __init__(self, n):
            self.devices = np.arange(n)

    sizes = {"n": 2}
    called = []
    X, Y = _linear_data(binary=True)
    step, batch = _port_linear(X, Y, lr=0.5, momentum=0.5)
    p, o = step.init()
    with faults.inject("run.step:preempt:3"):
        runner = rz.ResilientRunner.for_sharded_step(
            step, p, o, batch, ckpt_dir=str(tmp_path / "ck"), ckpt_every=1,
            max_restarts=2, mesh_factory=lambda: FakeMesh(sizes["n"]),
            on_shrink=lambda mesh: called.append(mesh.devices.size) or None)
        sizes["n"] = 1
        report = runner.run(4)
    assert called == [1]
    assert report.mesh_shrinks == 1
    assert runner.active["step"] is step
