"""The port's Llama functions against the JAX package's.

A tiny fp32 config (the one tests/test_serve.py uses); the JAX weights are
carried over with `params_from_jax`, inputs come from numpy with a seed,
and the JAX flash attention runs its Pallas kernels (forward and backward)
through the interpreter. Logits agree to 1e-4 (fp32, summation order
only); pool contents to 1e-5; `llama_loss` to 1e-5 and its gradients to
1e-4 per leaf.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import llama as J
from mxnet_tpu_torch.models import llama as T
from mxnet_tpu_torch.models.convert import params_from_jax

JCFG = J.LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, hidden_dim=128, rope_theta=10000.0,
                     max_seq_len=64, dtype=jnp.float32)
TCFG = T.LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, hidden_dim=128, rope_theta=10000.0,
                     max_seq_len=64, dtype=torch.float32)
JPARAMS = J.llama_init(jax.random.PRNGKey(0), JCFG)
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
TPARAMS = params_from_jax(NP_PARAMS, device="cpu")
ATOL = 1e-4
BS, NBLK = 4, 12


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, size=shape)


def _pools(seed):
    """Random pool contents (numpy), so untouched rows are checked too."""
    rng = np.random.RandomState(seed)
    shape = (NBLK, JCFG.n_kv_heads, BS, JCFG.head_dim)
    return {str(i): {"k": rng.randn(*shape).astype(np.float32),
                     "v": rng.randn(*shape).astype(np.float32)}
            for i in range(JCFG.n_layers)}


def _both(np_pools):
    jp = jax.tree_util.tree_map(jnp.asarray, np_pools)
    tp = {i: {n: torch.from_numpy(a.copy()) for n, a in d.items()}
          for i, d in copy.deepcopy(np_pools).items()}
    return jp, tp


def _assert_pools(jp, tp):
    for i in jp:
        for n in ("k", "v"):
            np.testing.assert_allclose(tp[i][n].numpy(),
                                       np.asarray(jp[i][n]), atol=1e-5,
                                       rtol=0)


def test_params_from_jax_round_trip():
    flat_j = jax.tree_util.tree_leaves_with_path(NP_PARAMS)
    assert len(flat_j) == 3 + 9 * JCFG.n_layers
    for path, a in flat_j:
        node = TPARAMS
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), a)
    bf = params_from_jax(NP_PARAMS, dtype=torch.bfloat16, device="cpu")
    assert bf["layers"]["0"]["attn"]["wq"].dtype == torch.bfloat16
    assert bf["norm"].dtype == torch.float32          # norms stay fp32
    assert bf["layers"]["1"]["ffn_norm"].dtype == torch.float32


def test_llama_init_layout_matches_jax():
    tp = T.llama_init(torch.Generator().manual_seed(0), TCFG, device="cpu")
    for path, a in jax.tree_util.tree_leaves_with_path(NP_PARAMS):
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == a.shape, path


@pytest.mark.parametrize("B,S", [(2, 11), (1, 37)])
def test_llama_forward_matches_jax(B, S):
    tok = _tokens((B, S), S)
    ref = np.asarray(J.llama_forward(JPARAMS, jnp.asarray(tok), JCFG))
    out = T.llama_forward(TPARAMS, tok, TCFG)
    assert out.dtype == torch.float32 and out.shape == (B, S, 256)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 64).astype(np.float32)
    sc = rng.rand(64).astype(np.float32)
    np.testing.assert_allclose(
        T.rms_norm(torch.from_numpy(x), torch.from_numpy(sc), 1e-5).numpy(),
        np.asarray(J.rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-5)),
        atol=1e-6)
    pos = np.array([[0, 3, 9], [1, 2, 40]], np.int32)
    cj, sj = J.rope_freqs(jnp.asarray(pos), 16, 10000.0)
    ct, st = T.rope_freqs(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    xr = rng.randn(2, 4, 3, 16).astype(np.float32)
    np.testing.assert_allclose(
        T.apply_rope(torch.from_numpy(xr), ct, st).numpy(),
        np.asarray(J.apply_rope(jnp.asarray(xr), cj, sj)), atol=1e-5)


def test_llama_prefill_paged_matches_jax():
    S, length = 16, 13
    tok = _tokens((S,), 1)
    table = np.array([5, 2, NBLK, 9], np.int32)   # one unallocated entry
    jp, tp = _both(_pools(1))
    lj, jp = J.llama_prefill_paged(JPARAMS, jp, jnp.asarray(tok),
                                   jnp.int32(length), jnp.asarray(table),
                                   JCFG, BS)
    lt, tp = T.llama_prefill_paged(TPARAMS, tp, tok, length, table, TCFG,
                                   BS)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=0)
    _assert_pools(jp, tp)


def test_llama_chunk_paged_matches_jax():
    tok = _tokens((3, 5), 2)
    positions = np.array([[0, 1, 2, 3, 4], [6, 7, 8, -1, -1],
                          [13, 14, 15, 16, 17]], np.int32)
    # row 2 runs past its 4-block table: those writes must drop
    tables = np.array([[0, 1, NBLK, NBLK], [2, 3, 4, NBLK],
                       [5, 6, 7, 8]], np.int32)
    jp, tp = _both(_pools(2))
    lj, jp = J.llama_chunk_paged(JPARAMS, jp, jnp.asarray(tok),
                                 jnp.asarray(positions), jnp.asarray(tables),
                                 JCFG, BS)
    lt, tp = T.llama_chunk_paged(TPARAMS, tp, tok, positions, tables, TCFG,
                                 BS)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    _assert_pools(jp, tp)


def test_llama_decode_paged_matches_jax():
    tok = _tokens((4,), 3)
    positions = np.array([5, -1, 11, 16], np.int32)  # inactive; past table
    tables = np.array([[0, 1, NBLK, NBLK], [2, 3, 4, NBLK],
                       [5, 6, 7, NBLK], [8, 9, 10, 11]], np.int32)
    jp, tp = _both(_pools(3))
    lj, jp = J.llama_decode_paged(JPARAMS, jp, jnp.asarray(tok),
                                  jnp.asarray(positions),
                                  jnp.asarray(tables), JCFG, BS)
    lt, tp = T.llama_decode_paged(TPARAMS, tp, tok, positions, tables,
                                  TCFG, BS)
    active = positions >= 0
    np.testing.assert_allclose(lt.numpy()[active], np.asarray(lj)[active],
                               atol=ATOL, rtol=0)
    _assert_pools(jp, tp)


def test_llama_decode_step_matches_jax():
    prompt = _tokens((1, 6), 4)[0]
    jc = J.init_kv_cache(JCFG, 1, max_len=16)
    tc = T.init_kv_cache(TCFG, 1, max_len=16, device="cpu")
    for p, t in enumerate(prompt):
        lj, jc = J.llama_decode_step(JPARAMS, jc, jnp.asarray([t]),
                                     jnp.asarray(p, jnp.int32), JCFG)
        lt, tc = T.llama_decode_step(TPARAMS, tc, [t], p, TCFG)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(tc["1"]["k"].numpy(), np.asarray(jc["1"]["k"]),
                               atol=1e-5, rtol=0)


def test_paged_chunked_equals_monolithic_forward():
    """The port's own invariant: prefilling a prompt chunk by chunk
    through the pool gives llama_forward's last-position logits."""
    prompt = _tokens((1, 14), 6)
    pools = T.init_kv_pools(TCFG, NBLK, BS, device="cpu")
    table = np.array([[3, 0, 7, 1]], np.int32)
    for start in range(0, 14, 5):
        n = min(5, 14 - start)
        tok = np.zeros((1, 5), np.int64)
        pos = np.full((1, 5), -1)
        tok[0, :n] = prompt[0, start:start + n]
        pos[0, :n] = np.arange(start, start + n)
        logits, pools = T.llama_chunk_paged(TPARAMS, pools, tok, pos, table,
                                            TCFG, BS)
    full = T.llama_forward(TPARAMS, prompt, TCFG)[0, -1]
    np.testing.assert_allclose(logits[0].numpy(), full.numpy(), atol=ATOL,
                               rtol=0)


def _jax_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(tp, jtree, atol):
    flat = jax.tree_util.tree_leaves_with_path(_jax_tree(jtree))
    for path, a in flat:
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.detach().numpy(), a, atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))
    return len(flat)


@pytest.mark.parametrize("name", sorted(T.CONFIGS))
def test_configs_copy_the_jax_values(name):
    want = {f.name: getattr(J.CONFIGS[name], f.name)
            for f in dataclasses.fields(J.CONFIGS[name]) if f.name != "dtype"}
    got = {f.name: getattr(T.CONFIGS[name], f.name)
           for f in dataclasses.fields(T.CONFIGS[name]) if f.name != "dtype"}
    assert got == want


def test_tied_embeddings_tree_from_jax_gives_the_jax_logits():
    jcfg = dataclasses.replace(JCFG, tie_embeddings=True)
    tcfg = dataclasses.replace(TCFG, tie_embeddings=True)
    jp = J.llama_init(jax.random.PRNGKey(3), jcfg)
    assert "lm_head" not in jp
    tp = params_from_jax(_jax_tree(jp), device="cpu")
    tok = _tokens((2, 9), 10)
    ref = np.asarray(J.llama_forward(jp, jnp.asarray(tok), jcfg))
    np.testing.assert_allclose(T.llama_forward(tp, tok, tcfg).numpy(), ref,
                               atol=ATOL, rtol=0)
    own = T.llama_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert "lm_head" not in own and set(own) == set(jp)


def test_embed_onehot_equals_the_gather_and_jax():
    tok = _tokens((2, 7), 11)
    tcfg = dataclasses.replace(TCFG, embed_onehot=True)
    out = T.llama_forward(TPARAMS, tok, tcfg)
    np.testing.assert_allclose(out.numpy(),
                               T.llama_forward(TPARAMS, tok, TCFG).numpy(),
                               atol=1e-6, rtol=0)
    ref = J.llama_forward(JPARAMS, jnp.asarray(tok),
                          dataclasses.replace(JCFG, embed_onehot=True))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_positions_match_jax():
    tok = _tokens((2, 6), 12)
    pos = np.array([3, 4, 5, 9, 10, 11], np.int32)
    ref = J.llama_forward(JPARAMS, jnp.asarray(tok), JCFG,
                          positions=jnp.asarray(pos))
    out = T.llama_forward(TPARAMS, tok, TCFG, positions=pos)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    # the default is 0..S-1
    np.testing.assert_allclose(
        T.llama_forward(TPARAMS, tok, TCFG, positions=np.arange(6)).numpy(),
        T.llama_forward(TPARAMS, tok, TCFG).numpy(), atol=0, rtol=0)


def _torch_value_and_grad(params, batch, cfg):
    tp = copy.deepcopy(params)
    leaves = [t for t in jax.tree_util.tree_leaves(tp)]
    for t in leaves:
        t.requires_grad_(True)
    loss = T.llama_loss(tp, batch, cfg)
    loss.backward()
    return loss.detach(), jax.tree_util.tree_map(lambda t: t.grad, tp)


@pytest.mark.parametrize("as_dict", [True, False], ids=["dict", "array"])
def test_llama_loss_and_grads_match_jax(as_dict):
    tok = _tokens((2, 13), 13)
    jb = {"tokens": jnp.asarray(tok)} if as_dict else jnp.asarray(tok)
    tb = {"tokens": tok} if as_dict else tok
    jl, jg = jax.value_and_grad(J.llama_loss)(JPARAMS, jb, JCFG)
    tl, tg = _torch_value_and_grad(TPARAMS, tb, TCFG)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=0)
    assert _assert_tree_close(tg, jg, atol=1e-4) == 3 + 9 * JCFG.n_layers


def test_remat_gives_the_same_loss_and_grads():
    tok = _tokens((2, 10), 14)
    l0, g0 = _torch_value_and_grad(TPARAMS, tok, TCFG)
    l1, g1 = _torch_value_and_grad(TPARAMS, tok,
                                   dataclasses.replace(TCFG, remat=True))
    assert l1.item() == pytest.approx(l0.item(), abs=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)


def test_llama_forward_follows_the_callers_grad_mode():
    tp = copy.deepcopy(TPARAMS)
    tp["norm"].requires_grad_(True)
    tok = _tokens((1, 5), 15)
    assert T.llama_forward(tp, tok, TCFG).requires_grad
    with torch.no_grad():
        assert not T.llama_forward(tp, tok, TCFG).requires_grad
    pools = T.init_kv_pools(TCFG, NBLK, BS, device="cpu")
    logits, _ = T.llama_prefill_paged(tp, pools, tok[0], 5,
                                      np.arange(2), TCFG, BS)
    assert not logits.requires_grad
