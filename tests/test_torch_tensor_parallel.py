"""The port's tensor and FSDP parallelism against the JAX package, on the
CPU.

World 2 and world 4 run as real process groups: `mxnet_tpu_torch.launch`
starts one process per rank (gloo, a FileStore rendezvous under
tmp_path), each runs every check of `_torch_tp_worker.py` for its world
once and writes its arrays, and the tests here hold them against the JAX
package run in this process on conftest's CPU devices, fed the whole
batch that the ranks split:

* `ShardedTrainStep` under `LLAMA_RULES` (llama_tiny, fp32, AdamW, 4
  steps) on ``fsdp=2, model=2`` (world 4) and ``model=2`` (world 2), each
  also at ``n_kv_heads=1`` (``wk``/``wv`` split mid-head, gathered on
  use), with ``zero=True`` on ``data=2, model=2``, and under `BERT_RULES`
  on ``data=2, model=2``, against the reference's GSPMD step on the same
  mesh: per-step losses and the gathered parameters within 1e-5 relative
  + 1e-6 (the ranks add their partial products and gradients in another
  order than XLA); each rank holds only its blocks. AdamW runs at lr 1e-3
  with eps 1e-4: its early steps move an element by about
  lr * g / (|g| + eps), so with a small eps an element whose gradient is
  near 0 turns a rounding difference of g into a large one of the
  parameter (the reference's own steps on two meshes differ so); eps 1e-4
  bounds that gain at lr / eps;
* a sharded state saved (whole leaves) and restored onto the mesh by the
  rules: every block bit for bit;
* `MeshEmbeddingComm` over every rank against the world-1 table fed every
  rank's rows: lookups bit for bit, the table after `apply_grads` within
  1e-6 (the unique-row sums add in another order), the serving copy
  placed vocab-sharded;
* the data-mesh `FusedTrainStep` at world 2 (ROADMAP Queue C 1): a
  Dense-BatchNorm-Dense net and a conv-BN-ReLU net through the fused
  training op, the batch's halves 3 apart in mean, one SGD step against
  the reference's mesh step: parameters and running statistics within
  1e-6 relative + 1e-6, equal on both ranks.
"""
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.models import bert as JB
from mxnet_tpu.models import llama as JL
from mxnet_tpu.parallel import BERT_RULES as JBERT_RULES
from mxnet_tpu.parallel import LLAMA_RULES as JLLAMA_RULES
from mxnet_tpu.parallel import ShardedTrainStep as JStep
from mxnet_tpu_torch.embedding import ShardedEmbedding
from mxnet_tpu_torch.launch import launch_local

import _torch_tp_worker as W
from _torch_seed import _seed_torch  # noqa: F401

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
SPAWN_TIMEOUT_S = 240
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
BN_RTOL, BN_ATOL = 1e-6, 1e-6


def _spawn(world, tmp):
    """Run the worker at `world` ranks over gloo; the ranks' arrays."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("MXNET_TPU_COMM_BUCKET_MB", None)
    rc = launch_local([sys.executable, W.__file__, str(tmp)], world,
                      root_uri="file://%s" % (tmp / "store"),
                      backend="gloo", timeout=SPAWN_TIMEOUT_S, env=env)
    assert rc == 0, "worker group exited with %s" % rc
    return world, [dict(np.load(tmp / ("rank%d.npz" % r)))
                   for r in range(world)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("tp4"))


def _ranks(request, world):
    return request.getfixturevalue("world%d" % world)


def _same_on_every_rank(res, prefix):
    keys = sorted(k for k in res[0] if k.startswith(prefix))
    assert keys, prefix
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


def _flat(tree):
    return dict(W._flat(jax.tree_util.tree_map(np.asarray, tree)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _held(res, prefix, losses, params):
    _same_on_every_rank(res, prefix + "/p/")
    for r in res:
        np.testing.assert_allclose(r[prefix + "/losses"], losses,
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
    for k, v in _flat(params).items():
        np.testing.assert_allclose(res[0]["%s/p/%s" % (prefix, k)], v,
                                   rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=k)


def _blocks(res, prefix, params, axes, specs):
    """Each rank holds its block of every leaf: the leaf's shape with each
    dimension a spec splits divided by that split."""
    for k, v in _flat(params).items():
        spec = W._flat(specs)
        want = list(v.shape)
        for d, entry in enumerate(dict(spec)[k]):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    want[d] //= axes.get(a, 1)
        for r in res:
            assert tuple(r["%s/block/%s" % (prefix, k)]) == tuple(want), k


@pytest.mark.parametrize("run", W.LLAMA_RUNS, ids=[r[0] for r in
                                                   W.LLAMA_RUNS])
def test_llama_rules_match_the_gspmd_step(request, run):
    name, w, axes, kv, zero = run
    world, res = _ranks(request, w)
    cfg = JL.LlamaConfig(**dict(W.LLAMA, n_kv_heads=kv), dtype=jnp.float32)
    mesh = jmx.parallel.create_mesh(**axes)
    step = JStep(lambda p, b: JL.llama_loss(p, b, cfg),
                 _jnp(W.llama_weights(kv)), mesh, rules=JLLAMA_RULES,
                 optimizer="adamw", lr=W.LR, wd=W.WD, eps=W.EPS, donate=False,
                 zero=zero)
    p, s = step.init()
    losses = []
    for i in range(W.STEPS):
        p, s, loss = step(p, s, {"tokens": jnp.asarray(W.llama_tokens(i))})
        losses.append(float(loss))
    _held(res, name, losses, p)
    from mxnet_tpu_torch.parallel import LLAMA_RULES
    from mxnet_tpu_torch.parallel.mesh import Mesh
    tmesh = Mesh(np.arange(world).reshape(
        [axes.get(a, 1) for a in ("data", "fsdp", "seq", "model",
                                  "expert")]),
        ("data", "fsdp", "seq", "model", "expert"))
    specs = LLAMA_RULES.tree_specs(W.llama_weights(kv), tmesh)
    _blocks(res, name, p, axes, specs)
    # the head's vocab and the query heads are split over model
    assert res[0][name + "/block/lm_head"][0] == \
        W.LLAMA["vocab_size"] // axes["model"]


def test_sharded_state_round_trips_through_a_checkpoint(world4):
    world, res = world4
    for r in res:
        assert bool(r["fsdp2_model2/ckpt_round_trip"])


def test_bert_rules_match_the_gspmd_step(request):
    name, w, axes = W.BERT_RUNS[0]
    world, res = _ranks(request, w)
    cfg = JB.BertConfig(**W.BERT, dtype=jnp.float32)
    mesh = jmx.parallel.create_mesh(**axes)
    step = JStep(lambda p, b: JB.bert_mlm_loss(p, b, cfg),
                 _jnp(W.bert_weights()), mesh, rules=JBERT_RULES,
                 optimizer="adamw", lr=W.LR, wd=W.WD, eps=W.EPS, donate=False)
    p, s = step.init()
    losses = []
    for i in range(W.STEPS):
        p, s, loss = step(p, s, _jnp(W.bert_batch(i)))
        losses.append(float(loss))
    _held(res, "bert_" + name, losses, p)
    # the word embedding's vocab rows are split over model
    assert res[0]["bert_%s/block/word_embed" % name][0] == \
        W.BERT["vocab_size"] // axes["model"]


@pytest.mark.parametrize("world", [2, 4], ids=["world2", "world4"])
def test_mesh_embedding_comm_matches_one_table(request, world):
    world, res = _ranks(request, world)
    one = ShardedEmbedding(W.EMBED_VOCAB, W.EMBED_DIM, optimizer="adam",
                           learning_rate=0.05, weight=W.embed_table(),
                           device="cpu")
    for s in range(W.EMBED_STEPS):
        pushes = [W.embed_push(r, s) for r in range(world)]
        want = one.lookup(W.embed_push(world, s)[0]).numpy()
        for r in res:
            np.testing.assert_array_equal(r["embed_lookup_%d" % s], want)
        one.apply_grads(np.concatenate([i for i, _ in pushes]),
                        np.concatenate([g for _, g in pushes]))
    want = one.gathered_weight().numpy()
    for r in res:
        assert str(r["embed_spec"]) == "P('model', None)"
        assert tuple(r["embed_rows"]) == (W.EMBED_VOCAB // world,
                                          W.EMBED_DIM)
        np.testing.assert_allclose(r["embed_table"], want, rtol=0,
                                   atol=1e-6)
        assert tuple(r["embed_served_rows"]) == (W.EMBED_VOCAB // world,
                                                 W.EMBED_DIM)
        np.testing.assert_array_equal(
            r["embed_served"], r["embed_table"][r["embed_served_ids"]])


def _ref_fused(net, x, y, loss):
    mesh = jmx.parallel.create_mesh(data=2)
    tr = jmx.gluon.Trainer(net.collect_params(), "sgd", dict(W.BN_SGD))
    step = jmx.gluon.FusedTrainStep(net, loss, tr, mesh=mesh)
    return step(jmx.nd.array(x), jmx.nd.array(y))


def test_mesh_fused_step_normalizes_over_the_global_batch(world2):
    """ROADMAP Queue C 1: the data-mesh FusedTrainStep's BatchNorm takes
    the global batch's statistics, as the reference's GSPMD step does:
    parameters and running statistics after one step match it, equal on
    both ranks (a per-rank normalization, 3 apart in mean, would not)."""
    world, res = world2
    _same_on_every_rank(res, "bn/")
    _same_on_every_rank(res, "cbr/")
    # Dense - BatchNorm - Dense
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(W.BN_HID, in_units=W.BN_IN),
            jmx.gluon.nn.BatchNorm(in_channels=W.BN_HID),
            jmx.gluon.nn.Dense(W.BN_OUT, in_units=W.BN_HID))
    net.initialize()
    rng = np.random.RandomState(9)
    for prm in net.collect_params().values():
        if prm.name.endswith(("running_mean", "running_var")):
            continue
        prm.set_data(jmx.nd.array(
            (rng.randn(*prm.shape) * 0.5).astype(np.float32)))
    x, y = W.bn_batch()
    loss = _ref_fused(net, x, y, jmx.gluon.loss.L2Loss())
    for i, prm in enumerate(net.collect_params().values()):
        np.testing.assert_allclose(res[0]["bn/%d" % i],
                                   prm.data().asnumpy(), rtol=BN_RTOL,
                                   atol=BN_ATOL, err_msg=prm.name)
    np.testing.assert_allclose(res[0]["bn/loss"], loss.asnumpy(),
                               rtol=BN_RTOL)
    # conv3x3 - BatchNorm - ReLU through the fused training op
    cbr = jmx.gluon.contrib.cnn.FusedConvBNReLUTrain(W.CBR_C,
                                                     in_channels=W.CBR_C)
    cbr.initialize()
    for k, v in W.cbr_weights().items():
        getattr(cbr, k).set_data(jmx.nd.array(v))
    x, y = W.cbr_batch()
    loss = _ref_fused(cbr, x, y, jmx.gluon.loss.L2Loss())
    for k in ("weight", "gamma", "beta", "running_mean", "running_var"):
        np.testing.assert_allclose(res[0]["cbr/" + k],
                                   getattr(cbr, k).data().asnumpy(),
                                   rtol=BN_RTOL, atol=BN_ATOL, err_msg=k)
    np.testing.assert_allclose(res[0]["cbr/loss"], loss.asnumpy(),
                               rtol=BN_RTOL)
