"""The port's speculative decoding against the JAX package's.

- `llama_draft_loop` drafts the reference's tokens on the same pools and
  writes the same KV (fp32, within 1e-5 absolute: two orders of
  summation); `llama_chunk_paged(logits_at="all")` gives the reference's
  verify logits within the same tolerance.
- A spec server (random tiny draft, and the identity draft) emits the
  plain greedy streams, which equal the JAX server's; the identity
  draft's accept rate is 1.0 and drafted == accepted + rejected.
- Sampled streams ride the plain path beside spec streams and draw the
  JAX package's tokens; the verify window stays inside the reserved
  range; spec with prefix sharing survives two kills with exact
  refcounts.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.models import llama as J
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.models import llama as T
from mxnet_tpu_torch.models.convert import params_from_jax
from mxnet_tpu_torch.resilience import faults
from mxnet_tpu_torch.serve import (InferenceServer, Request, default_spec_k)

ATOL = 1e-5

JCFG = J.LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, hidden_dim=128, rope_theta=10000.0,
                     max_seq_len=64, dtype=jnp.float32)
CFG = T.LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, hidden_dim=128, rope_theta=10000.0,
                    max_seq_len=64, dtype=torch.float32)
JDRAFT_CFG = dataclasses.replace(JCFG, dim=32, n_layers=1, n_heads=2,
                                 n_kv_heads=1, hidden_dim=64)
DRAFT_CFG = dataclasses.replace(CFG, dim=32, n_layers=1, n_heads=2,
                                n_kv_heads=1, hidden_dim=64)
JPARAMS = J.llama_init(jax.random.PRNGKey(0), JCFG)
JDRAFT = J.llama_init(jax.random.PRNGKey(7), JDRAFT_CFG)


def to_port(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


PARAMS, DRAFT = to_port(JPARAMS), to_port(JDRAFT)


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    faults.deactivate()
    yield
    faults.deactivate()
    telemetry.reset()


def prompts_for(n, lo=3, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 255, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def make_server(**kw):
    kw.setdefault("kv_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_context", 32)
    return InferenceServer(PARAMS, CFG, device="cpu", **kw)


def make_spec_server(identity=False, **kw):
    draft = (PARAMS, CFG) if identity else (DRAFT, DRAFT_CFG)
    kw.setdefault("spec_k", 3)
    return make_server(draft_params=draft[0], draft_cfg=draft[1], **kw)


def serve_all(server, prompts, budgets, **req):
    handles = [server.submit(Request(p, max_new_tokens=b, **req))
               for p, b in zip(prompts, budgets)]
    server.run()
    return [h.result(timeout=30) for h in handles], handles


@functools.lru_cache(maxsize=None)
def jax_greedy(prompts, budgets):
    server = mx.serve.InferenceServer(
        JPARAMS, JCFG, kv_blocks=64, block_size=8, max_batch=4,
        max_context=32).warmup()
    handles = [server.submit(mx.serve.Request(list(p), max_new_tokens=b))
               for p, b in zip(prompts, budgets)]
    server.run()
    jtelemetry.reset()
    return [h.result(timeout=30) for h in handles]


# ---------------------------------------------------------------------------
# the draft and verify programs against the reference's
# ---------------------------------------------------------------------------
def _pools(cfg, num_blocks, block_size, seed):
    rng = np.random.RandomState(seed)
    shape = (num_blocks, cfg.n_kv_heads, block_size, cfg.head_dim)
    return {str(i): {"k": rng.randn(*shape).astype(np.float32) * 0.5,
                     "v": rng.randn(*shape).astype(np.float32) * 0.5}
            for i in range(cfg.n_layers)}


def _to_torch(pools):
    return {i: {n: torch.from_numpy(a.copy()) for n, a in layer.items()}
            for i, layer in pools.items()}


@pytest.mark.parametrize("k", [1, 3])
def test_draft_loop_matches_reference(k):
    bs, nb = 4, 4
    pools = _pools(JCFG, 16, bs, seed=3)
    tables = np.array([[3, 7, 1, 16], [0, 2, 16, 16], [16] * 4], np.int32)
    tokens = np.array([5, 77, 9], np.int32)
    positions = np.array([6, 2, -1], np.int32)     # slot 2 inactive
    jd, jpools = J.llama_draft_loop(
        JPARAMS, jax.tree_util.tree_map(jnp.asarray, pools),
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(tables),
        JCFG, bs, k)
    tpools = _to_torch(pools)
    td, _ = T.llama_draft_loop(PARAMS, tpools, tokens, positions, tables,
                               CFG, bs, k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for i in tpools:
        for n in ("k", "v"):
            np.testing.assert_allclose(tpools[i][n].numpy(),
                                       np.asarray(jpools[i][n]), atol=ATOL)


def test_verify_logits_match_reference():
    bs = 4
    pools = _pools(JCFG, 16, bs, seed=4)
    tables = np.array([[3, 7, 1, 16], [0, 2, 5, 16]], np.int32)
    tokens = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    positions = np.array([[4, 5, 6, 7], [9, 10, -1, -1]], np.int32)
    jl, _ = J.llama_chunk_paged(
        JPARAMS, jax.tree_util.tree_map(jnp.asarray, pools),
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(tables),
        JCFG, bs, logits_at="all")
    tl, _ = T.llama_chunk_paged(PARAMS, _to_torch(pools), tokens, positions,
                                tables, CFG, bs, logits_at="all")
    assert tl.shape == (2, 4, CFG.vocab_size)
    valid = positions >= 0
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               atol=ATOL)


def test_chunk_writes_drop_past_table_range():
    server = make_spec_server(identity=True, max_batch=1).warmup()
    pool = server.pool
    table, _, _ = pool.admit("s", 32)           # all 4 blocks of a 32-ctx
    nb = server.programs.blocks_per_stream
    tables = np.full((1, nb), pool.num_blocks, np.int64)
    tables[0, :len(table)] = table
    before = {i: {n: t.clone() for n, t in layer.items()}
              for i, layer in pool.pools.items()}
    k = server.programs.spec_k
    vp = np.full((1, k + 1), -1)
    vp[0, 0] = 32                               # one past the table range
    server.programs.verify(np.full((1, k + 1), 5), vp, tables)
    for i, layer in pool.pools.items():
        for n, t in layer.items():
            assert torch.equal(t, before[i][n])
    pool.free("s")


def test_spec_geometry_defaults(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SERVE_SPEC_K", "2")
    assert default_spec_k() == 2
    monkeypatch.setenv("MXNET_TPU_SERVE_SPEC_K", "bogus")
    assert default_spec_k() == 4
    plain = make_server()
    assert "draft_k" not in plain.programs.program_names
    assert plain.programs.spec_k == 0 and plain.draft_pool is None
    spec = make_spec_server(spec_k=None)
    assert spec.programs.spec_k == 4
    assert spec.programs.program_names == [
        "chunk", "decode", "copy", "draft_chunk", "draft_k", "verify",
        "draft_copy"]
    assert spec.draft_pool.num_blocks == spec.pool.num_blocks
    assert telemetry.memory_scopes()["kv_draft"] == \
        spec.draft_pool.storage_bytes
    with pytest.raises(ValueError):
        make_server(draft_params=DRAFT)


# ---------------------------------------------------------------------------
# serving: spec equals plain greedy equals the JAX server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("identity", [False, True])
def test_spec_decode_identical_to_plain_greedy_and_jax(identity):
    prompts = prompts_for(6, seed=28)
    budgets = [5 + i % 3 for i in range(6)]
    want = jax_greedy(tuple(map(tuple, prompts)), tuple(budgets))
    out, _ = serve_all(make_spec_server(identity=identity).warmup(),
                       prompts, budgets)
    assert out == want, "spec output diverged (identity=%s)" % identity
    snap = telemetry.snapshot()["counters"]
    assert snap["serve.spec.rounds"] >= 1
    assert snap["serve.spec.drafted"] == (snap["serve.spec.accepted"]
                                          + snap["serve.spec.rejected"])
    rate = snap["serve.spec.accepted"] / snap["serve.spec.drafted"]
    if identity:
        # the draft IS the target: every draft verifies
        assert rate == 1.0, rate
        assert snap["serve.spec.rounds"] < sum(budgets) - len(budgets)
    plain, _ = serve_all(make_server().warmup(), prompts, budgets)
    assert plain == want


def test_spec_mixed_with_sampled_streams():
    """Sampled streams bypass the draft/verify round but decode beside
    spec streams, and their draws match the JAX server's exactly."""
    prompts = prompts_for(4, seed=29)

    def reqs(make):
        return [make(p, max_new_tokens=5, request_id="r%d" % i,
                     temperature=0.8 if i % 2 else 0.0)
                for i, p in enumerate(prompts)]

    jserver = mx.serve.InferenceServer(
        JPARAMS, JCFG, kv_blocks=64, block_size=8, max_batch=4,
        max_context=32).warmup()
    jh = [jserver.submit(r) for r in reqs(mx.serve.Request)]
    jserver.run()
    want = [h.result(timeout=30) for h in jh]
    jtelemetry.reset()
    server = make_spec_server(identity=True).warmup()
    sh = [server.submit(r) for r in reqs(Request)]
    server.run()
    assert [h.result(timeout=10) for h in sh] == want
    assert telemetry.snapshot()["counters"]["serve.spec.rounds"] >= 1


def test_spec_verify_window_respects_reserved_range():
    """Near the end of a budget the verify window p..p+k would overrun the
    stream's reserved positions; the overflow columns ride position -1.
    Held by parity on a stream whose worst-case context exactly fills
    max_context (a 13-token prompt misaligns the rounds so the last one
    would reach position 32)."""
    prompt = prompts_for(1, lo=13, hi=14, seed=35)[0]
    budget = 32 - len(prompt) + 1
    base, _ = serve_all(make_server(max_batch=1).warmup(), [prompt],
                        [budget])
    spec, _ = serve_all(make_spec_server(identity=True, max_batch=1)
                        .warmup(), [prompt], [budget])
    assert spec == base
    snap = telemetry.snapshot()["counters"]
    assert snap["serve.spec.discarded"] >= 1


def test_spec_and_prefix_survive_replica_kill_exact_refcounts():
    """Two kills mid-stream under spec decoding and shared prefixes: the
    output equals the unfaulted run (and the JAX server), the refcounts
    reconcile exactly and only the prefix index holds blocks."""
    sysp = prompts_for(1, lo=16, hi=17, seed=32)[0]
    prompts = [sysp + t for t in prompts_for(6, lo=2, hi=5, seed=33)]
    budgets = [6] * 6
    want = jax_greedy(tuple(map(tuple, prompts)), tuple(budgets))
    server = make_spec_server(identity=True).warmup()
    with faults.inject("serve.step:error:3;serve.step:error:6"):
        chaos, handles = serve_all(server, prompts, budgets)
    assert chaos == want
    snap = telemetry.snapshot()["counters"]
    assert snap["serve.recoveries"] == 2
    assert sum(h.requeues for h in handles) == snap["serve.requeued_streams"]
    assert server.pool.reconcile() == 0
    assert server.pool.blocks_in_use == server.pool.prefix_blocks
    assert snap.get("serve.prefix.hits", 0) >= 1
