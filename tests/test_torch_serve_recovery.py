"""The port's fault plan, watchdog, retry, drain recovery, ReplicaGroup,
request traces, flight ring and memory ledger against the JAX package's.

- Fault-plan parsing and firing, `RetryPolicy` and `classify` give the
  reference's answers on the same plan strings and exceptions.
- Killed, hung and mid-admission-faulted servers finish every stream with
  the JAX server's tokens (greedy and sampled): no token lost, none
  duplicated, refcounts exact.
- Request traces tile >= 95% of each request's wall clock, across replica
  boundaries; flight records name the in-flight requests; the ledger
  accounts the pool.

Deadlines are short (a 1 s step deadline, 10-20 ms latency faults), so
the file stays quick, and long enough that a loaded machine's slow step is
not taken for a stall.
"""
import functools
import json
import os
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.models.llama import LlamaConfig as JLlamaConfig
from mxnet_tpu.models.llama import llama_init as jllama_init
from mxnet_tpu.resilience import errors as jerrors
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.resilience import retry as jretry
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.models.convert import params_from_jax
from mxnet_tpu_torch.models.llama import LlamaConfig
from mxnet_tpu_torch.resilience import errors, faults, retry, watchdog
from mxnet_tpu_torch.resilience.errors import (InjectedFault,
                                               RetryExhausted, StallError,
                                               is_retriable)
from mxnet_tpu_torch.serve import (DeadlineExceeded, InferenceServer,
                                   KVBlockPool, Overloaded, ReplicaGroup,
                                   Request)
from mxnet_tpu_torch.telemetry import flight, ledger, request_trace

JCFG = JLlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, hidden_dim=128, rope_theta=10000.0,
                    max_seq_len=64, dtype=jnp.float32)
CFG = LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, hidden_dim=128, rope_theta=10000.0,
                  max_seq_len=64, dtype=torch.float32)
JPARAMS = jllama_init(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_jax(jax.tree_util.tree_map(np.asarray, JPARAMS),
                         device="cpu")


@pytest.fixture(autouse=True)
def _clean():
    telemetry.enable()
    telemetry.reset()
    faults.deactivate()
    yield
    faults.deactivate()
    telemetry.reset()


def make_server(**kw):
    kw.setdefault("kv_blocks", 48)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_context", 32)
    return InferenceServer(PARAMS, CFG, device="cpu", **kw)


def prompts_for(n, lo=3, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 255, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _key(prompts, budgets, sampled=()):
    return (tuple(map(tuple, prompts)), tuple(budgets), tuple(sampled))


@functools.lru_cache(maxsize=None)
def jax_serve(key):
    """The JAX InferenceServer's streams for (prompts, budgets, indices of
    sampled requests: temperature 0.7, top_p 0.9, seed 40 + i)."""
    prompts, budgets, sampled = key
    server = mx.serve.InferenceServer(
        JPARAMS, JCFG, kv_blocks=64, block_size=8, max_batch=4,
        max_context=32).warmup()
    handles = [server.submit(mx.serve.Request(list(p), max_new_tokens=b,
                                              **_sampling(i, sampled)))
               for i, (p, b) in enumerate(zip(prompts, budgets))]
    server.run()
    jtelemetry.reset()
    return [h.result(timeout=30) for h in handles]


def _sampling(i, sampled):
    return (dict(temperature=0.7, top_p=0.9, seed=40 + i) if i in sampled
            else {})


def serve_all(server, prompts, budgets, sampled=()):
    handles = [server.submit(Request(p, max_new_tokens=b,
                                     **_sampling(i, sampled)))
               for i, (p, b) in enumerate(zip(prompts, budgets))]
    server.run()
    return [h.result(timeout=30) for h in handles], handles


# ---------------------------------------------------------------------------
# the fault plan, RetryPolicy and classify against the reference's
# ---------------------------------------------------------------------------
PLANS = ["serve.step:error:3", "serve.step:error:3;serve.step:error:6",
         "serve.admit:latency:1:0.01", "serve.step:hang:2:0.05",
         "serve.step:preempt:4;serve.step:latency:*:0.001",
         "serve.step:error:2+", "x:corrupt:1;y:error:*"]


@pytest.mark.parametrize("plan", PLANS)
def test_fault_plan_parses_and_fires_like_reference(plan):
    mine, ref = faults.FaultPlan.parse(plan), jfaults.FaultPlan.parse(plan)
    assert repr(mine) == repr(ref)
    fired = {"mine": [], "ref": []}
    for label, mod, plan_obj in (("mine", faults, mine),
                                 ("ref", jfaults, ref)):
        with mod.inject(plan_obj):
            for site in ["serve.step"] * 7 + ["serve.admit", "x", "y"]:
                try:
                    mod.check(site)
                    fired[label].append("ok")
                except Exception as exc:  # noqa: BLE001 - compared by name
                    fired[label].append(type(exc).__name__)
            assert mod.call_count("serve.step") == 7
    assert fired["mine"] == fired["ref"]


@pytest.mark.parametrize("bad", ["a:b", "s:explode:1", "s:error:0",
                                 "s:error:x"])
def test_fault_plan_rejects_like_reference(bad):
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(bad)


def test_fault_plan_from_env_and_corrupt_transform(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FAULT_PLAN", "serve.step:error:1")
    plan = faults.activate()
    assert repr(plan) == "FaultPlan(serve.step:error:1)"
    with pytest.raises(InjectedFault, match="serve.step"):
        faults.check("serve.step", context="replica=r0")
    faults.deactivate()
    assert faults.active_plan() is None
    with faults.inject("t:corrupt:1;t:corrupt:2;t:corrupt:3"):
        x = torch.ones(2, 3)
        y = faults.transform("t", (torch.arange(3), x))
        assert torch.isnan(y[1][0, 0]) and not torch.isnan(x).any()
        assert faults.transform("t", b"abcd") == b"ab\x9c\x9b"
        arr = faults.transform("t", [np.ones(2, np.float32)])[0]
        assert np.isnan(arr[0]) and arr[1] == 1
    assert telemetry.counter_value("resilience.faults_injected.corrupt") == 3


EXCEPTIONS = [InjectedFault("x"), ConnectionResetError("x"),
              TimeoutError("x"), ValueError("x"), KeyError("x"),
              RuntimeError("UNAVAILABLE: socket closed"),
              RuntimeError("CUDA error: an illegal memory access"),
              RuntimeError("invalid argument: connection reset"),
              RuntimeError("CUDA out of memory. Tried to allocate"),
              RuntimeError("heartbeat timed out"), OSError("weird")]


@pytest.mark.parametrize("i", range(len(EXCEPTIONS)))
def test_classify_like_reference(i):
    exc = EXCEPTIONS[i]
    ref = exc
    if isinstance(exc, InjectedFault):
        ref = jerrors.InjectedFault("x")
    assert errors.classify(exc) == jerrors.classify(ref)
    assert is_retriable(exc) == jerrors.is_retriable(ref)


def test_error_hierarchy_like_reference():
    for name in jerrors.__all__:
        if name in ("classify", "is_retriable"):
            continue
        mine, ref = getattr(errors, name), getattr(jerrors, name)
        assert [c.__name__ for c in mine.__mro__
                if c.__name__ in jerrors.__all__] == \
            [c.__name__ for c in ref.__mro__ if c.__name__ in jerrors.__all__]
    assert not is_retriable(Overloaded("full", reason="queue_full"))


def test_retry_policy_like_reference(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_RETRIES", "5")
    monkeypatch.setenv("MXNET_TPU_RETRY_BASE_S", "0.01")
    mine, ref = retry.RetryPolicy(jitter=0), jretry.RetryPolicy(jitter=0)
    assert repr(mine) == repr(ref)
    assert [mine.delay(a) for a in range(1, 12)] == \
        [ref.delay(a) for a in range(1, 12)]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise InjectedFault("flaky", site="op")
        return "done"

    assert retry.call_with_retry(flaky, site="op",
                                 policy=retry.RetryPolicy(
                                     base_delay_s=0.001)) == "done"
    assert telemetry.counter_value("resilience.retries") == 2
    with pytest.raises(RetryExhausted) as ei:
        retry.call_with_retry(lambda: (_ for _ in ()).throw(
            InjectedFault("always")), site="op",
            policy=retry.RetryPolicy(max_attempts=2, base_delay_s=0.001))
    assert ei.value.attempts == 2 and isinstance(ei.value.last_error,
                                                 InjectedFault)
    with pytest.raises(ValueError):     # fatal: no retry
        retry.call_with_retry(lambda: int("x"))


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------
def test_watchdog_stall_post_mortem_and_heartbeat():
    telemetry.step_event("serve.step", 1.0, info={"active_requests": ["q"]})
    with pytest.raises(StallError) as ei:
        with watchdog.guard("unit", deadline_s=0.2):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                time.sleep(0.005)
    err = ei.value
    assert err.site == "unit" and err.deadline_s == 0.2
    report = err.format_report()
    assert "unit" in report and "active=[q]" in report
    assert telemetry.counter_value("resilience.stalls.unit") == 1
    # heartbeats keep a live step alive past its deadline
    with watchdog.guard("alive", deadline_s=1.0):
        for _ in range(6):
            time.sleep(0.3)
            watchdog.heartbeat()
    # no deadline: transparent
    with watchdog.guard("none", deadline_s=None):
        pass
    assert telemetry.counter_value("resilience.stalls") == 1


# ---------------------------------------------------------------------------
# drain recovery against the JAX server
# ---------------------------------------------------------------------------
def test_kill_serve_step_mid_stream_identical_to_jax():
    """MXNET_TPU_FAULT_PLAN kills serve.step twice mid-stream; every
    in-flight stream drains, requeues and resumes by re-prefill, and the
    output equals the JAX server's."""
    prompts = prompts_for(8, seed=4)
    budgets = [5 + i % 4 for i in range(8)]
    server = make_server(kv_blocks=64).warmup()
    os.environ["MXNET_TPU_FAULT_PLAN"] = \
        "serve.step:error:3;serve.step:error:6"
    try:
        faults.activate()
        chaos, handles = serve_all(server, prompts, budgets)
    finally:
        del os.environ["MXNET_TPU_FAULT_PLAN"]
        faults.deactivate()
    assert chaos == jax_serve(_key(prompts, budgets))
    snap = telemetry.snapshot()["counters"]
    assert snap["serve.recoveries"] == 2
    assert snap["serve.requeued_streams"] >= 1
    assert snap["resilience.faults_injected"] >= 2
    assert sum(h.requeues for h in handles) == snap["serve.requeued_streams"]
    assert server.pool.reconcile() == 0


def test_sampled_stream_kill_recovery_identical_to_jax():
    prompts = prompts_for(4, seed=31)
    budgets = [6] * 4
    server = make_server(max_batch=2, kv_blocks=64).warmup()
    with faults.inject("serve.step:error:3"):
        out, _ = serve_all(server, prompts, budgets, sampled=(0, 1, 2, 3))
    assert out == jax_serve(_key(prompts, budgets, (0, 1, 2, 3)))
    snap = telemetry.snapshot()["counters"]
    assert snap["serve.recoveries"] == 1
    assert snap["serve.requeued_streams"] >= 1


def test_retry_budget_exhausted_fails_stream():
    server = make_server().warmup()
    doomed = server.submit(Request([1, 2, 3], max_new_tokens=8, retries=0))
    survivor = server.submit(Request([4, 5, 6], max_new_tokens=4))
    with faults.inject("serve.step:error:2"):
        server.run()
    with pytest.raises(RetryExhausted):
        doomed.result(timeout=10)
    assert survivor.result(timeout=10) == \
        jax_serve(_key([[4, 5, 6]], [4]))[0]
    assert telemetry.snapshot()["counters"]["serve.failed"] == 1
    outcomes = {t["request_id"]: t["outcome"]
                for t in telemetry.request_traces()}
    assert outcomes[doomed.id] == "failed"


def test_watchdog_converts_hang_to_recovery():
    """An injected hang inside serve.step becomes a StallError, not a
    frozen replica, and the scheduler recovers the stream."""
    server = make_server(step_deadline_s=1.0).warmup()
    h = server.submit(Request([7, 8, 9], max_new_tokens=4))
    with faults.inject("serve.step:hang:2:30"):
        server.run()
    assert h.result(timeout=10) == jax_serve(_key([[7, 8, 9]], [4]))[0]
    snap = telemetry.snapshot()["counters"]
    assert snap["resilience.stalls.serve.step"] == 1
    assert snap["serve.recoveries"] == 1
    assert any("serve_recover" in e for r in telemetry.flight_records()
               for e in r.get("events", ()))


def test_replica_group_survives_replica_death():
    """A replica killed with a spent restart budget drains its streams to
    the shared queue; the survivor finishes them, equal to the JAX
    server's output, greedy and sampled mixed."""
    prompts = prompts_for(8, seed=5)
    budgets = [6] * 8
    sampled = (1, 4, 6)
    group = ReplicaGroup(PARAMS, CFG, replicas=2, kv_blocks=48,
                         block_size=8, max_batch=4, max_context=32,
                         max_restarts=0, device="cpu").warmup()
    with faults.inject("serve.step:preempt:3"):
        group.start()
        handles = [group.submit(Request(p, max_new_tokens=b,
                                        **_sampling(i, sampled)))
                   for i, (p, b) in enumerate(zip(prompts, budgets))]
        out = [h.result(timeout=30) for h in handles]
        assert group.drain(timeout=10)
    assert group.stop()
    assert out == jax_serve(_key(prompts, budgets, sampled))
    assert group.alive_replicas == 1
    snap = telemetry.snapshot()
    assert snap["counters"]["serve.replica_deaths"] == 1
    assert snap["counters"]["serve.recoveries"] == 1
    assert snap["gauges"]["serve.replicas_alive"]["value"] == 1
    survivor = next(s for s in group.servers if not s.dead)
    assert survivor.pool.reconcile() == 0
    # events wait in the inbox for the next step record: flush it
    telemetry.step_event("probe", 0.0)
    events = [e for r in telemetry.flight_records()
              for e in r.get("events", ())]
    assert any(e.startswith("serve_replica_death replica") for e in events)
    assert any(e.startswith("serve_recover replica") for e in events)


def test_fault_mid_admission_loses_no_stream():
    """A fault inside _admit (after the pop, during the KV reservation)
    drains the half-admitted stream back to the queue."""
    server = make_server().warmup()
    real_admit = server.pool.admit
    state = {"fired": False}

    def flaky_admit(stream_id, n_tokens, context=None):
        if not state["fired"]:
            state["fired"] = True
            raise InjectedFault("mid-admission fault", site="serve.step")
        return real_admit(stream_id, n_tokens, context=context)

    server.pool.admit = flaky_admit
    h = server.submit(Request([5, 6, 7], max_new_tokens=4))
    server.run()
    assert h.result(timeout=10) == jax_serve(_key([[5, 6, 7]], [4]))[0]
    assert h.requeues == 1
    assert telemetry.snapshot()["counters"]["serve.requeued_streams"] == 1
    assert server.pool.blocks_in_use == server.pool.prefix_blocks
    assert server.pool.reconcile() == 0


def test_nonretriable_death_drains_streams():
    """A non-retriable escape kills the replica but drains its in-flight
    streams; a fresh replica on the same queue finishes them."""
    server = make_server().warmup()
    h = server.submit(Request([9, 8, 7], max_new_tokens=4))
    boom = {"armed": True}
    real_decode = server.programs.decode

    def bad_decode(*args):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated device loss")
        return real_decode(*args)

    server.programs.decode = bad_decode
    with pytest.raises(RuntimeError):
        server.run()
    assert server.dead and not h.done()
    make_server(queue=server.queue).warmup().run()
    assert h.result(timeout=10) == jax_serve(_key([[9, 8, 7]], [4]))[0]
    snap = telemetry.snapshot()["counters"]
    assert snap["serve.replica_deaths"] == 1
    assert snap["serve.requeued_streams"] == 1


def _drop_storage(pool):
    for layer in pool.pools.values():
        for t in layer.values():
            t.untyped_storage().resize_(0)


def test_recovery_async_windows():
    """White-box: (1) a stream in both _admitting and a slot drains once;
    (1b) one already handed back to the queue is not requeued again;
    (2) a requeued stream that emitted its whole budget retires without an
    extra token; (3) dropped pool storage is re-made; (4) a torn alloc is
    reconciled."""
    server = make_server().warmup()
    h = server.submit(Request([1, 2, 3], max_new_tokens=4))
    server.step()
    stream = server._slots[0]
    assert stream is not None
    server._admitting = stream
    server._recover(InjectedFault("window", site="serve.step"))
    assert len(server.queue) == 1 and h.requeues == 1
    server._admitting = stream          # still queue-owned
    server._recover(InjectedFault("window1b", site="serve.step"))
    assert len(server.queue) == 1 and h.requeues == 1
    h.tokens.extend([0] * (4 - len(h.tokens)))
    _drop_storage(server.pool)
    torn = [server.pool._free.pop() for _ in range(3)]
    assert torn and server.pool.free_blocks < server.pool.num_blocks
    server._recover(InjectedFault("window2", site="serve.step"))
    assert all(t.untyped_storage().nbytes() == t.nbytes
               for layer in server.pool.pools.values()
               for t in layer.values())
    assert server.pool.free_blocks == server.pool.num_blocks
    server.run()
    assert h.result(timeout=10) == h.tokens and len(h.tokens) == 4
    snap = telemetry.snapshot()["counters"]
    assert snap["serve.kv.storage_resets"] == 1
    assert snap["serve.kv.reconciled_blocks"] == 3
    assert snap["serve.completed"] == 1


def test_recovery_storage_reset_clears_prefix_cache():
    server = make_server(max_batch=1).warmup()
    p = prompts_for(1, lo=12, hi=13, seed=34)[0]
    h = server.submit(Request(p, max_new_tokens=3))
    server.run()
    h.result(timeout=10)
    assert server.pool.prefix_blocks >= 1
    _drop_storage(server.pool)
    server._recover(InjectedFault("window", site="serve.step"))
    assert server.pool.prefix_blocks == 0
    assert server.pool.blocks_in_use == 0
    h2 = server.submit(Request(p, max_new_tokens=3))
    server.run()
    assert h2.result(timeout=10) == h.result()
    assert server.pool.prefix_blocks >= 1
    assert server.pool.ensure_storage() is False


def test_admit_fault_site_wired():
    server = make_server().warmup()
    with faults.inject("serve.admit:error:1"):
        with pytest.raises(InjectedFault) as ei:
            server.submit(Request([1, 2], max_new_tokens=2))
    assert "serve.admit" in str(ei.value)


def test_deadline_mid_stream_under_latency_fault():
    server = make_server().warmup()
    h = server.submit(Request([1, 2, 3], max_new_tokens=24,
                              deadline_s=0.3))
    with faults.inject("serve.step:latency:*:0.02"):
        server.run()
    with pytest.raises(DeadlineExceeded) as ei:
        h.result(timeout=10)
    assert 0 < len(ei.value.tokens) < 24 and ei.value.tokens == h.tokens
    tr = ei.value.request_trace
    assert tr is not None and tr["outcome"] == "deadline"
    assert tr["request_id"] == h.id and tr["tokens"] == len(h.tokens)
    assert tr["accounted_ms"] >= 0.95 * tr["wall_ms"]
    ring = {t["request_id"]: t for t in telemetry.request_traces()}
    assert ring[h.id]["outcome"] == "deadline"


# ---------------------------------------------------------------------------
# request traces, the flight ring, chrome rows
# ---------------------------------------------------------------------------
def test_request_trace_accounts_wall_clock_single_replica():
    server = make_server(max_batch=2).warmup()
    handles = [server.submit(Request(p, max_new_tokens=4))
               for p in prompts_for(3, seed=9)]
    server.run()
    for h in handles:
        h.result(timeout=10)
    traces = {t["request_id"]: t for t in telemetry.request_traces()}
    assert set(traces) == {h.id for h in handles}
    for h in handles:
        t = traces[h.id]
        assert t["outcome"] == "completed" and t["tokens"] == 4
        assert t["ttft_ms"] == pytest.approx(h.ttft_ms, abs=5e-4)
        assert t["accounted_ms"] >= 0.95 * t["wall_ms"]
        assert set(t["phases_ms"]) == {"queue", "prefill", "decode"}
        assert len([s for s in t["spans"] if s["name"] == "decode"]) == 3
        assert t["replicas"] == ["replica0"]


def test_request_trace_survives_replica_kill_95pct_accounted():
    """A delayed request whose replica is killed mid-stream keeps ONE
    trace, continued on the survivor, accounting >= 95% of its wall
    clock, recovery spans included."""
    group = ReplicaGroup(PARAMS, CFG, replicas=2, kv_blocks=48,
                         block_size=8, max_batch=4, max_context=32,
                         max_restarts=0, device="cpu").warmup()
    with faults.inject("serve.step:preempt:4;serve.step:latency:*:0.01"):
        group.start()
        handles = [group.submit(Request(p, max_new_tokens=6))
                   for p in prompts_for(6, seed=10)]
        for h in handles:
            h.result(timeout=30)
        assert group.drain(timeout=10)
    assert group.stop()
    assert group.alive_replicas == 1
    traces = {t["request_id"]: t for t in telemetry.request_traces()}
    for h in handles:
        t = traces[h.id]
        assert t["outcome"] == "completed"
        assert t["accounted_ms"] >= 0.95 * t["wall_ms"], t
    recovered = [traces[h.id] for h in handles if h.requeues > 0]
    assert recovered, "the kill drained no in-flight stream"
    assert any("recovery" in t["phases_ms"] for t in recovered)
    assert any(len(set(t["replicas"])) == 2 for t in recovered)


def test_shed_requests_land_in_ring():
    server = make_server(queue_cap=1).warmup()
    with pytest.raises(Overloaded):
        server.submit(Request([1] * 8, max_new_tokens=1000))
    server.submit(Request([1, 2], max_new_tokens=2))
    with pytest.raises(Overloaded):
        server.submit(Request([3, 4], max_new_tokens=2))
    outcomes = [t["outcome"] for t in telemetry.request_traces()]
    assert "shed.too_large" in outcomes and "shed.queue_full" in outcomes
    server.run()
    events = [e for r in telemetry.flight_records()
              for e in r.get("events", ())]
    assert any(e.startswith("serve_shed too_large") for e in events)


def test_request_rows_in_chrome_dump(tmp_path):
    server = make_server(max_batch=2).warmup()
    handles = [server.submit(Request(p, max_new_tokens=3))
               for p in prompts_for(2, seed=12)]
    server.run()
    path = telemetry.dump_trace(str(tmp_path / "serve_trace.json"))
    with open(path) as f:
        obj = json.load(f)
    rows = [e for e in obj["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "request"]
    assert {e["tid"] for e in rows} == {
        zlib.crc32(h.id.encode()) & 0x3fffffff for h in handles}
    names = {e["name"] for e in rows}
    for h in handles:
        assert "req[%s].prefill" % h.id in names
        assert "req[%s].decode" % h.id in names
    cats = {e.get("cat") for e in obj["traceEvents"]}
    assert {"step", "serve", "counter"} <= cats


def test_flight_records_name_in_flight_requests():
    server = make_server(max_batch=2).warmup()
    handles = [server.submit(Request(p, max_new_tokens=4))
               for p in prompts_for(2, seed=13)]
    server.run()
    recs = [r for r in telemetry.flight_records()
            if r["site"] == "serve.step"]
    assert recs and all("active_requests" in r for r in recs)
    seen = {i for r in recs for i in (r["active_requests"]
                                      + r.get("completed_requests", []))}
    assert {h.id for h in handles} <= seen
    rendered = flight.format_records(recs)
    assert all(h.id in rendered for h in handles)
    assert sum(r.get("deltas", {}).get("serve.tokens", 0)
               for r in recs) == 8


def test_flight_dump_writes_the_ring(tmp_path, monkeypatch):
    telemetry.step_event("serve.step", 2.5, info={"active_requests": ["a"]})
    monkeypatch.setenv("MXNET_TPU_FLIGHT_DIR", str(tmp_path))
    path = flight.dump(reason="test")
    with open(path) as f:
        payload = json.load(f)
    assert payload["reason"] == "test" and payload["records"][0][
        "active_requests"] == ["a"]
    flight.reset()
    assert flight.dump() is None


def test_request_tracing_knob_inert(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SERVE_TRACE", "0")
    server = make_server().warmup()
    h = server.submit(Request([1, 2, 3], max_new_tokens=3))
    assert h.trace is request_trace.NULL_TRACE
    server.run()
    h.result(timeout=10)
    assert telemetry.request_traces() == []
    assert not any(n.startswith("req[") for n, *_ in telemetry.span_events())
    assert telemetry.snapshot()["counters"]["serve.completed"] == 1


def test_telemetry_disabled_is_inert():
    telemetry.disable()
    try:
        server = make_server().warmup()
        h = server.submit(Request([1, 2, 3], max_new_tokens=3))
        server.run()
        assert len(h.result(timeout=10)) == 3
        assert telemetry.snapshot() == {"counters": {}, "gauges": {},
                                        "histograms": {}}
        assert telemetry.flight_records() == []
        assert telemetry.request_traces() == []
        assert ledger.scopes() == {}
    finally:
        telemetry.enable()


def test_serving_telemetry_and_flight_records():
    server = make_server().warmup()
    for p in prompts_for(3, seed=6):
        server.submit(Request(p, max_new_tokens=4))
    server.run()
    snap = telemetry.snapshot()
    hists = snap["histograms"]
    assert hists["serve.ttft_ms"]["count"] == 3
    assert hists["serve.tpot_ms"]["count"] > 0
    assert hists["serve.step_ms"]["count"] > 0
    assert snap["gauges"]["serve.tokens_per_s"]["value"] > 0
    assert "serve.step" in {r["site"] for r in telemetry.flight_records()}
    names = {n for n, *_ in telemetry.span_events()}
    assert {"serve.step", "serve.decode", "serve.prefill[4x16]"} <= names


# ---------------------------------------------------------------------------
# the memory ledger
# ---------------------------------------------------------------------------
def test_ledger_accounts_pools_and_breaks_down_exhaustion():
    pool = KVBlockPool(CFG, num_blocks=4, block_size=4, device="cpu")
    per_block = 2 * CFG.n_layers * CFG.n_kv_heads * 4 * CFG.head_dim * 4
    assert pool.storage_bytes == ledger.tree_nbytes(pool.pools) == \
        4 * per_block
    assert pool.bytes_per_block == per_block
    draft = KVBlockPool(CFG, num_blocks=4, block_size=4, device="cpu",
                        scope="kv_draft")
    assert ledger.scopes() == {"kv_pool": 4 * per_block,
                               "kv_draft": 4 * per_block}
    base = list(range(100, 108))
    pool.admit("a", 12, context=base + [1])
    pool.register_prefix("a", base + [1])
    assert ledger.scopes()["prefix_cache"] == 2 * per_block
    draft.alloc("d", 4)
    gauges = telemetry.snapshot()["gauges"]
    assert gauges["serve.kv.blocks_in_use"]["value"] == 3
    assert gauges["serve.kv.bytes"]["value"] == 3 * per_block
    assert gauges["serve.kv.draft_blocks_in_use"]["value"] == 1
    assert gauges["serve.prefix.bytes"]["value"] == 2 * per_block
    assert gauges["memory.scope.kv_pool.bytes"]["value"] == 4 * per_block
    with pytest.raises(Overloaded) as ei:
        pool.alloc("b", 8)
    assert ei.value.ledger_breakdown["kv_pool"] == 4 * per_block
    assert "memory ledger: kv_pool=" in str(ei.value)
    # the overlay stays out of the scoped total
    rep = ledger.reconcile()
    assert rep["scoped_bytes"] == 8 * per_block
    assert rep["source"] == "none" and rep["residual_bytes"] == 0
    assert ledger.breakdown().endswith("(scoped %s)"
                                       % ledger._fmt_bytes(8 * per_block))


def test_replica_group_stress_no_lost_or_duplicated_tokens():
    """Three replicas on one shared queue under a short switch interval,
    two of them killed: every stream finishes exactly once with the JAX
    server's tokens."""
    import sys
    prompts = prompts_for(10, seed=50)
    budgets = [4 + i % 3 for i in range(10)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        group = ReplicaGroup(PARAMS, CFG, replicas=3, kv_blocks=48,
                             block_size=8, max_batch=2, max_context=32,
                             max_restarts=0, device="cpu").warmup()
        with faults.inject("serve.step:error:4;serve.step:error:9"):
            group.start()
            handles = [group.submit(Request(p, max_new_tokens=b))
                       for p, b in zip(prompts, budgets)]
            out = [h.result(timeout=60) for h in handles]
            assert group.drain(timeout=10)
        assert group.stop()
    finally:
        sys.setswitchinterval(old)
    assert out == jax_serve(_key(prompts, budgets))
    assert group.alive_replicas == 1
    assert telemetry.counter_value("serve.completed") == len(prompts)
    assert not any(t.is_alive() for t in threading.enumerate()
                   if t.name.startswith("mxnet_tpu_replica"))
