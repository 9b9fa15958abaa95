"""The port's token sampling against the JAX package's draws.

`sample_tokens` computes jax's threefry bits with torch integer ops, so:

- its uniforms equal ``jax.random.uniform(fold_in(PRNGKey(seed), pos),
  (V,), minval=tiny, maxval=1)`` bit for bit (compared as uint32 words)
  over seeds including 0 and 2**32 - 1, positions and vocab sizes;
- its tokens equal `mxnet_tpu.serve.sampling.sample_tokens`' on the same
  seeded logits over temperature, top_k and top_p, except where the
  reference's perturbed logits have a top-two gap under NEAR_TIE (a
  one-ulp `log` difference can only flip such a row);
- a sampled server's streams equal the JAX `InferenceServer`'s token for
  token (the sampled twin of test_greedy_serving_token_identical_to_jax).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.models.llama import LlamaConfig as JLlamaConfig
from mxnet_tpu.models.llama import llama_init as jllama_init
from mxnet_tpu.serve.sampling import sample_tokens as jsample_tokens
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.models.convert import params_from_jax
from mxnet_tpu_torch.models.llama import LlamaConfig
from mxnet_tpu_torch.serve import InferenceServer, Request, sample_tokens
from mxnet_tpu_torch.serve.sampling import _uniforms

TINY = np.finfo(np.float32).tiny
NEAR_TIE = 1e-4     # top-two gap of (masked + gumbel) under which a token
                    # may differ: log() may round one ulp apart

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


def jax_uniforms(seed, pos, vocab):
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                             np.int32(pos))
    return np.asarray(jax.random.uniform(key, (vocab,), minval=TINY,
                                         maxval=1.0))


@pytest.mark.parametrize("vocab", [1, 7, 256, 1000, 32000])
@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31, 2 ** 32 - 1])
def test_uniforms_bit_equal_to_jax(seed, vocab):
    positions = [0, 1, 513, 2 ** 31 - 1]
    got = _uniforms([seed] * len(positions), positions, vocab, "cpu").numpy()
    for row, pos in zip(got, positions):
        want = jax_uniforms(seed, pos, vocab)
        np.testing.assert_array_equal(row.view(np.uint32),
                                      want.view(np.uint32))


def _reference_margin(logits, seeds, pos, temps, top_k, top_p):
    """Top-two gap of the reference's perturbed row (its filter through
    `mxnet_tpu.serve.sampling._sample`'s math plus the gumbel noise)."""
    from mxnet_tpu.serve import sampling as jsampling
    gaps = []
    for r in range(len(logits)):
        if temps[r] <= 0:
            top2 = np.sort(logits[r])[-2:]
        else:
            scaled = jnp.asarray(logits[r:r + 1]) / max(temps[r], 1e-6)
            order = jnp.sort(scaled, axis=-1)[:, ::-1]
            V = logits.shape[1]
            k = int(np.clip(top_k[r] if top_k[r] > 0 else V, 1, V))
            kth = order[:, k - 1:k]
            masked = jnp.where(scaled >= kth, scaled, jsampling._NEG_INF)
            order_m = jnp.where(order >= kth, order, jsampling._NEG_INF)
            probs = jax.nn.softmax(order_m, axis=-1)
            keep = (jnp.cumsum(probs, axis=-1) - probs) < min(top_p[r], 1.0)
            thresh = jnp.min(jnp.where(keep, order_m, jnp.inf), axis=-1)
            masked = jnp.where(scaled >= thresh[:, None], masked,
                               jsampling._NEG_INF)
            u = jax_uniforms(seeds[r], pos[r], V)
            row = np.asarray(masked[0]) - np.log(-np.log(u))
            top2 = np.sort(row)[-2:]
        gaps.append(float(top2[1] - top2[0]))
    return np.asarray(gaps)


@pytest.mark.parametrize("case", range(6))
def test_sample_tokens_equal_reference(case):
    rng = np.random.RandomState(100 + case)
    N, V = 12, [50, 256, 1000][case % 3]
    logits = (rng.randn(N, V) * (1 + case)).astype(np.float32)
    seeds = rng.randint(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    pos = rng.randint(0, 4096, N).astype(np.int32)
    temps = np.array([0.0, 0.5, 0.8, 1.0, 1.5, 2.0] * 2, np.float32)
    top_k = np.array([0, 0, 1, 5, 40, 0] * 2, np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.95, 0.3] * 2, np.float32)
    rng.shuffle(temps)
    want = np.asarray(jsample_tokens(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(pos),
        jnp.asarray(temps), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = sample_tokens(torch.from_numpy(logits), seeds, pos, temps, top_k,
                        top_p).numpy()
    differ = got != want
    if differ.any():
        margin = _reference_margin(logits, seeds, pos, temps, top_k, top_p)
        assert (margin[differ] < NEAR_TIE).all(), (got, want, margin)
    # greedy rows are exactly the argmax
    assert (got[temps <= 0] == logits[temps <= 0].argmax(-1)).all()


def test_all_greedy_batch_is_argmax_and_tensor_vectors():
    logits = torch.randn(5, 64, generator=torch.Generator().manual_seed(2))
    out = sample_tokens(logits, np.arange(5), np.arange(5), np.zeros(5),
                        np.zeros(5), np.ones(5))
    assert torch.equal(out, logits.argmax(-1))
    # tensors are read on the host like numpy vectors
    a = sample_tokens(logits, torch.arange(5), torch.arange(5) + 9,
                      torch.full((5,), 0.7), torch.zeros(5, dtype=torch.long),
                      torch.ones(5))
    b = sample_tokens(logits, np.arange(5), np.arange(5) + 9,
                      np.full(5, 0.7), np.zeros(5), np.ones(5))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# sampled serving: token for token against the JAX InferenceServer
# ---------------------------------------------------------------------------
def prompts_for(n, lo=3, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 255, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


SAMPLED = [dict(temperature=0.8), dict(temperature=1.0, top_k=20),
           dict(temperature=0.7, top_p=0.9), dict(),
           dict(temperature=1.3, top_k=50, top_p=0.95), dict(temperature=0.6)]


def requests(make):
    sysp = prompts_for(1, lo=16, hi=17, seed=40)[0]
    tails = prompts_for(6, lo=2, hi=6, seed=41)
    return [make([*(sysp if i % 2 else []), *t], max_new_tokens=4 + i % 3,
                 request_id="s%d" % i, seed=700 + i, **SAMPLED[i])
            for i, t in enumerate(tails)]


@functools.lru_cache(maxsize=None)
def jax_sampled(chunk, rows):
    server = mx.serve.InferenceServer(
        JPARAMS, JCFG, kv_blocks=48, block_size=8, max_batch=3,
        max_context=32, chunk_size=chunk, prefill_rows=rows).warmup()
    handles = [server.submit(r) for r in requests(mx.serve.Request)]
    server.run()
    jtelemetry.reset()
    return [h.result(timeout=30) for h in handles]


@pytest.mark.parametrize("chunk,rows", [(16, 4), (4, 2)])
def test_sampled_serving_token_identical_to_jax(chunk, rows):
    server = InferenceServer(PARAMS, CFG, kv_blocks=48, block_size=8,
                             max_batch=3, max_context=32, chunk_size=chunk,
                             prefill_rows=rows, device="cpu").warmup()
    handles = [server.submit(r) for r in requests(Request)]
    server.run()
    assert [h.result(timeout=10) for h in handles] == jax_sampled(chunk,
                                                                  rows)
    assert server.pool.reconcile() == 0
