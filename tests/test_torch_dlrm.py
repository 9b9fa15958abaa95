"""The port's DLRM against the JAX package's.

A narrow config (four fields of 50-300 rows, embed_dim 8, towers 16/8):
the reference's parameter tree goes through `params_from_jax`, and
`dlrm_forward`/`dlrm_loss` on the same numpy batch are held within 1e-5
relative (fp32; the reductions run in another order). Then three steps of
the sharded-table loop on both packages (rows looked up from one
`ShardedEmbedding` per field, forward and loss with the rows as leaves,
the backward, `apply_grads` for each table, plain SGD on the towers: the
reference takes `jax.value_and_grad` over the towers and the rows): the
losses within 1e-5 relative, the towers and every table within 1e-5 of
their largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax

from mxnet_tpu.embedding import ShardedEmbedding as JShardedEmbedding
from mxnet_tpu.models import dlrm as jdlrm
from mxnet_tpu_torch.embedding import ShardedEmbedding
from mxnet_tpu_torch.models import (DLRMConfig, dlrm_forward, dlrm_init,
                                    dlrm_loss, params_from_jax)

REL = 1e-5
CFG = dict(vocab_sizes=(50, 300, 7, 120), embed_dim=8, dense_dim=13,
           bottom_dims=(16, 8), top_dims=(16, 8))
LR = 0.1


def _batch(batch=32, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.rand(batch, 13).astype(np.float32)
    ids = np.stack([rng.zipf(1.3, batch) % v for v in CFG["vocab_sizes"]],
                   axis=1).astype(np.int32)
    labels = (rng.rand(batch) < 0.3).astype(np.float32)
    return dense, ids, labels


def _jax_tree():
    cfg = jdlrm.DLRMConfig(**CFG)
    return cfg, jax.tree_util.tree_map(
        np.asarray, jdlrm.dlrm_init(cfg, jax.random.PRNGKey(3)))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_forward_and_loss_match_reference():
    jcfg, tree = _jax_tree()
    cfg = DLRMConfig(**CFG)
    params = params_from_jax(tree, device="cpu")
    assert [t.shape for t in params["tables"]] == \
        [(v, 8) for v in CFG["vocab_sizes"]]
    dense, ids, labels = _batch()
    want = np.asarray(jdlrm.dlrm_forward(tree, dense, ids, jcfg))
    got = dlrm_forward(params, torch.from_numpy(dense),
                       torch.from_numpy(ids), cfg)
    assert got.shape == (32,)
    _close(got.detach().numpy(), want)
    wl = jdlrm.dlrm_loss(tree, dense, ids, labels, jcfg)
    gl = dlrm_loss(params, torch.from_numpy(dense), torch.from_numpy(ids),
                   torch.from_numpy(labels), cfg)
    assert _rel(gl, wl) <= REL


def test_init_layout_matches_reference():
    jcfg, tree = _jax_tree()
    mine = dlrm_init(DLRMConfig(**CFG),
                     torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), mine,
                                  is_leaf=torch.is_tensor) == shapes
    assert "tables" not in dlrm_init(DLRMConfig(**CFG), with_tables=False,
                                     device="cpu")
    # the interaction is 8 + 5 * 4 / 2 wide
    assert mine["top"][0]["w"].shape == (18, 16)


def _port_steps(tree, cfg, batch, steps):
    dense, ids, labels = (torch.from_numpy(a) for a in batch)
    towers = params_from_jax({k: tree[k] for k in ("bottom", "top")},
                             device="cpu")
    tables = [ShardedEmbedding(v, cfg.embed_dim, optimizer="sgd",
                               learning_rate=LR, device="cpu", weight=w)
              for v, w in zip(cfg.vocab_sizes, tree["tables"])]
    leaves = [t for layer in towers["bottom"] + towers["top"]
              for t in layer.values()]
    losses = []
    for _ in range(steps):
        rows = [t.lookup(ids[:, f]).requires_grad_()
                for f, t in enumerate(tables)]
        for p in leaves:
            p.requires_grad_(True)
        loss = dlrm_loss(towers, dense, ids, labels, cfg,
                         embed_fn=lambda f, _ids: rows[f])
        loss.backward()
        for f, t in enumerate(tables):
            t.apply_grads(ids[:, f], rows[f].grad)
        with torch.no_grad():
            for p in leaves:
                p -= LR * p.grad
                p.grad = None
        losses.append(loss.item())
    return losses, towers, [t.gathered_weight() for t in tables]


def _jax_steps(tree, cfg, batch, steps):
    dense, ids, labels = batch
    towers = {k: tree[k] for k in ("bottom", "top")}
    tables = [JShardedEmbedding(v, cfg.embed_dim, optimizer="sgd",
                                learning_rate=LR, weight=w)
              for v, w in zip(cfg.vocab_sizes, tree["tables"])]

    def loss_fn(p, rows):
        return jdlrm.dlrm_loss(p, dense, ids, labels, cfg,
                               embed_fn=lambda f, _ids: rows[f])

    losses = []
    for _ in range(steps):
        rows = [t.lookup(ids[:, f]) for f, t in enumerate(tables)]
        loss, (gp, gr) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            towers, rows)
        for f, t in enumerate(tables):
            t.apply_grads(ids[:, f], gr[f])
        towers = jax.tree_util.tree_map(lambda p, g: p - LR * g, towers, gp)
        losses.append(float(loss))
    return losses, towers, [np.asarray(t.gathered_weight()) for t in tables]


@pytest.mark.parametrize("batch_seed", [0, 1])
def test_sharded_table_training_matches_reference(batch_seed):
    jcfg, tree = _jax_tree()
    batch = _batch(seed=batch_seed)
    losses, towers, tables = _port_steps(tree, DLRMConfig(**CFG), batch, 3)
    jlosses, jtowers, jtables = _jax_steps(tree, jcfg, batch, 3)
    for a, b in zip(losses, jlosses):
        assert _rel(a, b) <= REL
    assert losses[-1] < losses[0]
    for mine, theirs in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.detach().numpy(), towers,
                                   is_leaf=torch.is_tensor)),
            jax.tree_util.tree_leaves(jtowers)):
        _close(mine, theirs)
    for mine, theirs, w0 in zip(tables, jtables, tree["tables"]):
        _close(mine.numpy(), theirs)
        assert not np.array_equal(theirs, w0)
