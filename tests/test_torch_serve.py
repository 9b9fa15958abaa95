"""The port's serving engine against the JAX package's.

The paged pool's accounting mirrors tests/test_serve.py; greedy serving
output must be token-identical to the JAX `InferenceServer` on the same
weights (carried over with `params_from_jax`) and traffic, across chunk
geometries. The sampled streams here are held to their own contract:
replayable per (seed, position), `top_k=1` equal to greedy, draws inside
the top-k set numpy computes; the port draws JAX's own threefry uniforms,
and tests/test_torch_sampling.py holds its sampled tokens to the JAX
server's.
"""
import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.models.llama import LlamaConfig as JLlamaConfig
from mxnet_tpu.models.llama import llama_init as jllama_init
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.models.convert import params_from_jax
from mxnet_tpu_torch.models.llama import LlamaConfig
from mxnet_tpu_torch.serve import (DeadlineExceeded, InferenceServer,
                                   KVBlockPool, Overloaded, Request,
                                   sample_tokens)

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
    telemetry.reset()
    yield
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


def traffic():
    """~2/3 of the requests share a 16-token system prompt (two blocks)."""
    sysp = prompts_for(1, lo=16, hi=17, seed=9)[0]
    tails = prompts_for(8, lo=2, hi=6, seed=10)
    prompts = [(sysp + t) if i % 3 else t for i, t in enumerate(tails)]
    return prompts, [4 + i % 4 for i in range(8)]


@functools.lru_cache(maxsize=None)
def jax_outputs(chunk, rows):
    prompts, budgets = traffic()
    server = mx.serve.InferenceServer(
        JPARAMS, JCFG, kv_blocks=48, block_size=8, max_batch=4,
        max_context=32, chunk_size=chunk, prefill_rows=rows).warmup()
    handles = [server.submit(mx.serve.Request(p, max_new_tokens=b))
               for p, b in zip(prompts, budgets)]
    server.run()
    jtelemetry.reset()
    return [h.result(timeout=30) for h in handles]


# ---------------------------------------------------------------------------
# paged KV allocator
# ---------------------------------------------------------------------------
def test_kv_pool_alloc_free_reuse():
    pool = KVBlockPool(CFG, num_blocks=8, block_size=4, device="cpu")
    t1 = pool.alloc("a", 10)
    assert len(t1) == 3 and pool.blocks_in_use == 3
    assert pool.alloc("a", 12) == t1
    assert pool.alloc("b", 4) and pool.blocks_in_use == 4
    assert pool.free("a") == 3
    assert pool.free("a") == 0
    assert pool.blocks_in_use == 1
    assert set(pool.alloc("c", 12)) <= set(t1)        # LIFO reuse
    snap = telemetry.snapshot()
    assert snap["gauges"]["serve.kv.blocks_in_use"]["max"] >= 4
    assert snap["counters"]["serve.kv.freed_blocks"] == 3


def test_kv_pool_exhaustion_structured_overloaded():
    pool = KVBlockPool(CFG, num_blocks=4, block_size=4, device="cpu")
    pool.alloc("a", 12)
    with pytest.raises(Overloaded) as ei:
        pool.alloc("b", 8)
    assert ei.value.reason == "kv_exhausted"
    assert ei.value.kv_free_blocks == 1 and ei.value.kv_needed_blocks == 2
    assert pool.blocks_in_use == 3 and pool.owned_blocks("b") == []
    assert telemetry.snapshot()["counters"]["serve.kv.exhausted"] == 1


def test_kv_pool_fragmentation_across_short_streams():
    pool = KVBlockPool(CFG, num_blocks=10, block_size=4, device="cpu")
    for wave in range(5):
        ids = ["s%d_%d" % (wave, i) for i in range(5)]
        for sid in ids:
            pool.alloc(sid, 5)
        for sid in ids[::2] + ids[1::2]:
            pool.free(sid)
    assert pool.blocks_in_use == 0 and pool.free_blocks == 10
    table = pool.alloc("long", 40)
    assert sorted(table) == list(range(10)) and table != sorted(table)


def test_kv_pool_prefix_share_refcount_and_cow():
    pool = KVBlockPool(CFG, num_blocks=8, block_size=4, device="cpu")
    base = list(range(100, 108))                    # two full blocks
    ta, fs, cow = pool.admit("a", 10, context=base + [1, 2])
    assert fs == 0 and cow is None
    pool.register_prefix("a", base + [1, 2])
    assert pool.prefix_blocks == 2
    # full match of both blocks: shared by refcount, prefill skips them
    tb, fs, cow = pool.admit("b", 10, context=base + [3])
    assert tb[:2] == ta[:2] and fs == 8 and cow is None
    # divergence inside block 1: block 0 shared, block 1 copied on write
    tc, fs, cow = pool.admit("c", 8, context=base[:6] + [7, 7])
    assert tc[0] == ta[0] and fs == 6 and cow == (ta[1], tc[1])
    counters = telemetry.snapshot()["counters"]
    assert counters["serve.prefix.hits"] == 2
    assert counters["serve.prefix.cow"] == 1
    assert counters["serve.prefix.blocks_shared"] == 3
    for sid in ("a", "b", "c"):
        pool.free(sid)
    assert pool.blocks_in_use == pool.prefix_blocks == 2
    assert pool.reconcile() == 0                    # refcounts exact
    assert pool.clear_prefix_cache() == 2 and pool.free_blocks == 8


def test_kv_pool_eviction_never_recycles_own_match():
    pool = KVBlockPool(CFG, num_blocks=5, block_size=4, device="cpu")
    base = list(range(100, 108))
    ta, _, _ = pool.admit("a", 8, context=base)
    pool.register_prefix("a", base)
    pool.free("a")
    pool.admit("live", 8)
    with pytest.raises(Overloaded):
        pool.admit("b", 16, context=base + [1] * 8)
    assert pool.owned_blocks("b") == [] and pool.prefix_blocks == 2
    assert pool.reconcile() == 0
    pool.free("live")
    tb, fs, _ = pool.admit("b", 16, context=base + [1] * 8)
    assert len(tb) == len(set(tb)) == 4 and fs == 8 and tb[:2] == ta[:2]


def test_kv_pool_eviction_under_pressure():
    pool = KVBlockPool(CFG, num_blocks=4, block_size=4, device="cpu")
    base = list(range(50, 58))
    pool.admit("a", 8, context=base)
    pool.register_prefix("a", base)
    pool.free("a")
    assert pool.free_blocks == 2
    assert len(pool.alloc("big", 16)) == 4          # evicts the cache
    assert telemetry.snapshot()["counters"]["serve.prefix.evictions"] == 2


# ---------------------------------------------------------------------------
# serving: token-identical to the JAX InferenceServer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk,rows", [(16, 4), (4, 2)])
def test_greedy_serving_token_identical_to_jax(chunk, rows):
    prompts, budgets = traffic()
    server = make_server(chunk_size=chunk, prefill_rows=rows).warmup()
    handles = [server.submit(Request(p, max_new_tokens=b))
               for p, b in zip(prompts, budgets)]
    server.run()
    assert [h.result(timeout=10) for h in handles] == \
        jax_outputs(chunk, rows)
    snap = telemetry.snapshot()
    assert snap["counters"]["serve.prefix.hits"] >= 1
    assert snap["counters"]["serve.prefill_chunks"] >= len(prompts)
    assert snap["counters"]["serve.tokens"] == sum(budgets)
    assert snap["gauges"]["serve.batch_occupancy"]["max"] == 4
    assert snap["histograms"]["serve.ttft_ms"]["count"] == len(prompts)
    assert server.pool.blocks_in_use == server.pool.prefix_blocks
    assert server.pool.reconcile() == 0


def test_oversized_request_shed_at_submit():
    server = make_server()
    with pytest.raises(Overloaded) as ei:
        server.submit(Request([1] * 8, max_new_tokens=1000))
    assert ei.value.reason == "too_large"
    tight = make_server(max_context=20)
    with pytest.raises(Overloaded) as ei:
        tight.submit(Request([1] * 5, max_new_tokens=18))
    assert ei.value.reason == "too_large"
    assert telemetry.snapshot()["counters"]["serve.shed.too_large"] == 2


def test_queue_full_sheds_with_overloaded():
    server = make_server(queue_cap=2).warmup()
    server.submit(Request([1, 2], max_new_tokens=2))
    server.submit(Request([1, 2], max_new_tokens=2))
    with pytest.raises(Overloaded) as ei:
        server.submit(Request([1, 2], max_new_tokens=2))
    assert ei.value.reason == "queue_full" and ei.value.queue_depth == 2
    server.run()
    assert telemetry.snapshot()["counters"]["serve.completed"] == 2


def test_kv_backpressure_defers_not_sheds():
    server = make_server(kv_blocks=5, block_size=8, max_batch=2).warmup()
    p1, p2 = prompts_for(2, lo=8, hi=9, seed=3)
    h1 = server.submit(Request(p1, max_new_tokens=16))   # 3 blocks
    h2 = server.submit(Request(p2, max_new_tokens=16))   # waits its turn
    server.run()
    assert len(h1.result(timeout=10)) == len(h2.result(timeout=10)) == 16
    counters = telemetry.snapshot()["counters"]
    assert "serve.shed" not in counters and counters["serve.completed"] == 2


def test_deadline_expires_in_queue():
    server = make_server(max_batch=1).warmup()
    slow = server.submit(Request([1, 2, 3], max_new_tokens=4))
    h = server.submit(Request([4, 5], max_new_tokens=2, deadline_s=0.001))
    time.sleep(0.01)
    server.run()
    slow.result(timeout=10)
    with pytest.raises(DeadlineExceeded) as ei:
        h.result(timeout=10)
    assert ei.value.tokens == []
    assert telemetry.snapshot()["counters"]["serve.shed.deadline"] == 1


def test_deadline_mid_stream_carries_partial_output():
    server = make_server().warmup()
    h = server.submit(Request([1, 2, 3], max_new_tokens=24,
                              deadline_s=0.05))
    real = server.programs.decode

    def slow_decode(*a):
        time.sleep(0.01)
        return real(*a)

    server.programs.decode = slow_decode
    server.run()
    with pytest.raises(DeadlineExceeded) as ei:
        h.result(timeout=10)
    assert 0 < len(ei.value.tokens) < 24 and ei.value.tokens == h.tokens
    assert server.pool.blocks_in_use == server.pool.prefix_blocks


def test_eos_stops_stream():
    prompt = prompts_for(1, seed=11)[0]
    server = make_server().warmup()
    full = server.submit(Request(prompt, max_new_tokens=6))
    server.run()
    out = full.result(timeout=10)
    h = server.submit(Request(prompt, max_new_tokens=6, eos_id=out[2]))
    server.run()
    assert h.result(timeout=10) == out[:out.index(out[2]) + 1]


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def _run_once(prompt, **kw):
    server = make_server(max_batch=1).warmup()
    h = server.submit(Request(prompt, max_new_tokens=6, request_id="fixed",
                              **kw))
    server.run()
    return h.result(timeout=10)


def test_sampling_replays_and_top_k_one_is_greedy():
    prompt = prompts_for(1, seed=30)[0]
    greedy = _run_once(prompt)
    a = _run_once(prompt, temperature=0.9, seed=11)
    assert a == _run_once(prompt, temperature=0.9, seed=11)
    assert a != _run_once(prompt, temperature=0.9, seed=12)
    assert _run_once(prompt, temperature=0.9, top_k=1, seed=11) == greedy
    assert _run_once(prompt, temperature=0.9) == \
        _run_once(prompt, temperature=0.9)          # id-derived seed
    with pytest.raises(ValueError):
        Request([1], top_p=0.0)
    with pytest.raises(ValueError):
        Request([1], top_k=-1)


def test_sampled_tokens_stay_in_numpy_top_k():
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 50).astype(np.float32)
    top_k = np.array([1, 3, 5, 5, 10, 0])
    temps = np.array([0.7, 1.0, 1.5, 0.0, 2.0, 1.0], np.float32)
    for trial in range(20):
        tok = sample_tokens(torch.from_numpy(logits), np.full(6, 7),
                            np.arange(6) + 100 * trial, temps, top_k,
                            np.ones(6, np.float32)).numpy()
        for r in range(6):
            if temps[r] <= 0:
                assert tok[r] == logits[r].argmax()
            elif top_k[r]:
                allowed = np.argsort(-logits[r])[:top_k[r]]
                assert tok[r] in allowed, (r, tok[r], allowed)


def test_top_p_keeps_the_nucleus():
    logits = np.log(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32))
    seen = set()
    for pos in range(200):
        seen.add(int(sample_tokens(torch.from_numpy(logits), [3], [pos],
                                   [1.0], [0], [0.7])[0]))
    assert seen == {0, 1}       # 0.5 + 0.3 reaches 0.7; the tail never


def test_sampled_stream_replays_across_batch_geometry():
    """A sampled server stream replays exactly under a re-run with a
    different batch geometry (the draws key on seed and position only)."""
    prompts = prompts_for(3, seed=31)
    kw = dict(max_new_tokens=5, temperature=0.7, top_p=0.9)

    def serve(max_batch, chunk):
        server = make_server(max_batch=max_batch, chunk_size=chunk).warmup()
        hs = [server.submit(Request(p, seed=40 + i, **kw))
              for i, p in enumerate(prompts)]
        server.run()
        return [h.result(timeout=10) for h in hs]

    assert serve(3, 16) == serve(1, 4)
