"""Readiness-ordered communication of the port, in one process, against
the JAX package.

* `engine.ReadyScheduler` dispatches the buckets the reference's does (the
  same keys, flush reasons and order) in free and frozen mode.
* `autograd.add_grad_ready_hook` fires once a leaf, during backward.
* A Trainer over two contexts (the local ``device`` store) and the ZeRO
  updater run readiness rounds that equal registration order bit for bit;
  the multi-context result also matches the reference's Trainer over
  cpu(0), cpu(1) within 1e-6 (replicas added in the same order, the
  reference's XLA and torch round apart by an ulp).
* An interrupted round (a parameter backward never reaches, a second
  backward before the step) is dropped and the step takes the
  registration path, with registration's bits.
* The comm schedule: payloads in the reference's format, the autotuner's
  sweep, the environment switches.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine, telemetry

import _torch_dist_worker as W
from _torch_seed import _seed_torch  # noqa: F401

CTXS = 2


# --------------------------------------------------------------- scheduler
def _feed(pkg, raws, make, **kw):
    got = []
    sched = pkg.engine.ReadyScheduler(
        lambda b, spec: got.append((list(b.keys), b.reason,
                                    None if spec is None else spec.index)),
        **kw)
    for k, r in raws:
        sched.add(k, make(r))
    sched.drain()
    return got


def _entries():
    rng = np.random.RandomState(0)
    out = []
    for i, (n, dt) in enumerate([(10, np.float32), (40, np.float32),
                                 (6, np.float16), (3, np.float32),
                                 (70, np.float32), (5, np.float16),
                                 (1, np.float32)]):
        out.append((str(i), rng.randn(n).astype(dt)))
    return out


@pytest.mark.parametrize("cap", [0, 64, 160, 1 << 20])
def test_free_mode_dispatches_the_reference_buckets(cap):
    raws = _entries()
    mine = _feed(mx, raws, torch.from_numpy, cap_bytes=cap)
    ref = _feed(jmx, raws, jnp.asarray, cap_bytes=cap)
    assert mine == ref


def test_frozen_mode_dispatches_in_layout_order_whatever_the_arrival():
    raws = [(k, r.astype(np.float32)) for k, r in _entries()]
    mine_layout = engine.BucketLayout.from_entries(
        ((k, torch.from_numpy(r)) for k, r in raws), 2, 200)
    ref_layout = jmx.engine.BucketLayout.from_entries(
        ((k, jnp.asarray(r)) for k, r in raws), 2, 200)
    arrival = list(reversed(raws))
    mine = _feed(mx, arrival, torch.from_numpy, layout=mine_layout)
    ref = _feed(jmx, arrival, jnp.asarray, layout=ref_layout)
    assert mine == ref and len(mine) == len(mine_layout) > 1
    sched = engine.ReadyScheduler(lambda b, s: None, layout=mine_layout)
    sched.add(raws[0][0], torch.from_numpy(raws[0][1]))
    with pytest.raises(ValueError, match="missing"):
        sched.drain()
    with pytest.raises(ValueError, match="not in the frozen"):
        sched.add("nope", torch.ones(2))


# ------------------------------------------------------------------ hooks
def test_grad_ready_hook_fires_once_a_leaf_during_backward():
    a, b, c = (mx.nd.array(np.arange(3.0) + i, ctx=mx.cpu())
               for i in range(3))
    for x in (a, b, c):
        x.attach_grad()
    seen = []

    def hook(nd):
        seen.append((id(nd), mx.autograd.in_backward()))

    mx.autograd.add_grad_ready_hook(hook)
    try:
        r0 = mx.autograd.backward_round()
        with mx.autograd.record():
            y = (a * b).sum() + (b * 2).sum()
        y.backward()
        assert mx.autograd.backward_round() == r0 + 1
    finally:
        mx.autograd.remove_grad_ready_hook(hook)
    assert sorted(seen) == sorted([(id(a), True), (id(b), True)])
    assert not mx.autograd.in_backward()
    np.testing.assert_array_equal(a.grad.asnumpy(), b.asnumpy())
    np.testing.assert_array_equal(b.grad.asnumpy(), a.asnumpy() + 2)
    np.testing.assert_array_equal(c.grad.asnumpy(), np.zeros(3))
    mx.autograd.remove_grad_ready_hook(hook)      # a no-op now


# ----------------------------------------------------------------- trainer
def _run(pkg, opt, opt_kw, comm_ready=None, unused=False, twice=False,
         zero=False, steps=W.STEPS):
    """`steps` of the narrow MLP over CTXS contexts (ZeRO: one), the batch
    split between them. `unused` adds a parameter the graph never reaches;
    `twice` runs backward twice before each step."""
    ctxs = [pkg.cpu(i) for i in range(1 if zero else CTXS)]
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(W.HID, in_units=W.IN, activation="relu"),
            pkg.gluon.nn.Dense(W.OUT, in_units=W.HID))
    net.initialize(ctx=ctxs)
    for p, w in zip(net.collect_params().values(), W.mlp_weights()):
        p.set_data(pkg.nd.array(w, ctx=pkg.cpu()))
    params = net.collect_params()
    if unused:
        extra = pkg.gluon.Parameter("extra", shape=(3,))
        extra.initialize(ctx=ctxs)
        params = list(params.values()) + [extra]
    kw = {} if pkg is jmx else {"comm_ready": comm_ready}
    tr = pkg.gluon.Trainer(params, opt, dict(opt_kw), kvstore="device",
                           zero=zero, **kw)
    loss_fn = pkg.gluon.loss.L2Loss()
    per = W.GLOBAL_BATCH // len(ctxs)
    for s in range(steps):
        x, y = W.mlp_batch(s)
        for _ in range(2 if twice else 1):
            with pkg.autograd.record():
                losses = [loss_fn(net(pkg.nd.array(x[i * per:(i + 1) * per],
                                                   ctx=c)),
                                  pkg.nd.array(y[i * per:(i + 1) * per],
                                               ctx=c))
                          for i, c in enumerate(ctxs)]
            pkg.autograd.backward(losses)
        tr.step(W.GLOBAL_BATCH)
    return [p.data(ctxs[0]).asnumpy() for p in net.collect_params().values()]


def _rounds():
    c = telemetry.snapshot()["counters"]
    return c.get("comm.ready.rounds", 0), c.get("comm.ready.aborted", 0)


@pytest.mark.parametrize("opt,kw", [("sgd", W.SGD_KW), ("adam", W.ADAM_KW)])
def test_multi_context_readiness_equals_registration(opt, kw):
    reg = _run(mx, opt, kw, comm_ready=False)
    r0, _ = _rounds()
    rdy = _run(mx, opt, kw, comm_ready=True)
    r1, _ = _rounds()
    # the first step initializes the store, so it takes registration order
    assert r1 - r0 == W.STEPS - 1
    for a, b in zip(rdy, reg):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(reg, _run(jmx, opt, kw)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_unreached_parameter_drops_the_round():
    reg = _run(mx, "sgd", W.SGD_KW, comm_ready=False, unused=True)
    r0, a0 = _rounds()
    rdy = _run(mx, "sgd", W.SGD_KW, comm_ready=True, unused=True)
    r1, a1 = _rounds()
    assert r1 == r0 and a1 - a0 == W.STEPS - 1
    for a, b in zip(rdy, reg):
        np.testing.assert_array_equal(a, b)


def test_second_backward_before_the_step_drops_the_round():
    reg = _run(mx, "sgd", W.SGD_KW, comm_ready=False, twice=True)
    r0, a0 = _rounds()
    rdy = _run(mx, "sgd", W.SGD_KW, comm_ready=True, twice=True)
    r1, a1 = _rounds()
    assert r1 == r0 and a1 > a0
    for a, b in zip(rdy, reg):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("opt,kw", [("sgd", W.SGD_KW), ("lamb", W.LAMB_KW)])
def test_zero_readiness_equals_registration(opt, kw):
    with engine.bucket_mb_scope(64 / 2 ** 20):
        reg = _run(mx, opt, kw, comm_ready=False, zero=True)
        r0, _ = _rounds()
        rdy = _run(mx, opt, kw, comm_ready=True, zero=True)
        r1, _ = _rounds()
    assert r1 - r0 == W.STEPS - 1
    for a, b in zip(rdy, reg):
        np.testing.assert_array_equal(a, b)


def test_zero_ready_entry_points_check_their_round():
    from mxnet_tpu_torch.optimizer.zero import ZeroUpdater
    zu = ZeroUpdater(mx.optimizer.create("sgd", **W.SGD_KW))
    with pytest.raises(RuntimeError, match="frozen layout"):
        zu.finish_ready([], {})
    keys = ["0", "1"]
    ws = [mx.nd.ones((4,), ctx=mx.cpu()), mx.nd.ones((3,), ctx=mx.cpu())]
    zu.step(keys, [torch.ones(4), torch.ones(3)], ws)
    spec = zu.layout.buckets[0]
    by_key = dict(zip(keys, ws))
    shard = zu.scatter_ready(spec, engine.pack_flat(
        spec, [torch.ones(4), torch.ones(3)]), by_key)
    with pytest.raises(ValueError, match="frozen layout holds"):
        zu.finish_ready([], by_key)
    zu.finish_ready([(spec, shard)], by_key)
    np.testing.assert_allclose(ws[0].asnumpy(), 1 - 0.125 * (1 + 1.5))


# ---------------------------------------------------------------- schedule
def test_comm_schedule_payloads_are_the_reference_format():
    from mxnet_tpu.engine import autotune as jat
    mine = engine.CommSchedule(4, "ready", score=1.5, source="sweep")
    ref = jat.CommSchedule(4, "ready", score=1.5, source="sweep")
    assert mine.to_payload() == ref.to_payload()
    assert engine.CommSchedule.from_payload(ref.to_payload()) == mine
    with pytest.raises(ValueError, match="flush policy"):
        engine.CommSchedule(4, "eager")
    try:
        got = engine.restore_schedule(mine.to_payload())
        assert got.source == "checkpoint"
        assert engine.current_schedule() is got
        assert engine.schedule_payload()["bucket_mb"] == 4.0
        assert engine.bucket_bytes() == 4 * 1024 * 1024
    finally:
        engine.set_schedule(None)
    assert engine.current_schedule() is None
    assert engine.restore_schedule(None) is None


def test_autotuner_sweeps_and_pins_a_schedule(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_COMM_AUTOTUNE", "1")
    monkeypatch.setenv("MXNET_TPU_COMM_AUTOTUNE_STEPS", "1")
    monkeypatch.setenv("MXNET_TPU_COMM_AUTOTUNE_CAPS", "0,1")
    try:
        swept = _run(mx, "sgd", W.SGD_KW, steps=5)
        sched = engine.current_schedule()
        assert sched is not None and sched.source == "autotune"
        assert sched.policy in engine.autotune.POLICIES
    finally:
        engine.set_schedule(None)
    monkeypatch.delenv("MXNET_TPU_COMM_AUTOTUNE")
    plain = _run(mx, "sgd", W.SGD_KW, comm_ready=False, steps=5)
    for a, b in zip(swept, plain):
        np.testing.assert_array_equal(a, b)
    tuner = engine.ScheduleAutotuner.restored(
        engine.CommSchedule(25, "ready"))
    assert tuner.done and tuner.on_step_end().policy == "ready"
    assert engine.ScheduleAutotuner.score(
        {"collective_ms": 10.0, "exposed_ms": 4.0}) == pytest.approx(4.01)


def test_ready_switch_installs_the_hook(monkeypatch):
    from mxnet_tpu_torch import autograd
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    monkeypatch.delenv("MXNET_TPU_COMM_READY", raising=False)
    n0 = len(autograd._GRAD_READY_HOOKS)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd")
    assert tr._ready_hook is None and tr._comm_policy() == "registration"
    monkeypatch.setenv("MXNET_TPU_COMM_READY", "1")
    tr2 = mx.gluon.Trainer(net.collect_params(), "sgd")
    assert tr2._ready_hook is not None and tr2._comm_policy() == "ready"
    assert len(autograd._GRAD_READY_HOOKS) == n0 + 1
    tr3 = mx.gluon.Trainer(net.collect_params(), "sgd", comm_ready=False)
    assert tr3._ready_hook is None
    autograd.remove_grad_ready_hook(tr2._ready_hook)
