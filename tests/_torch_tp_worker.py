"""Rank program of the port's tensor-parallel CPU tests.

Started by `mxnet_tpu_torch.launch.launch_local` (one process per rank,
the DMLC_* variables naming a FileStore under the test's tmp_path, gloo):

    python tests/_torch_tp_worker.py <out_dir>

It imports only the port (never JAX), runs on one thread, runs every check
of its world size once and writes this rank's arrays to
``<out_dir>/rank<r>.npz``; `tests/test_torch_tensor_parallel.py` holds
them against the JAX package. The weights and batches below are drawn with
numpy and shared with the tests, so both sides start from the same
numbers; the port takes them through `models.convert.params_from_jax`.
"""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

STEPS = 4
LR, WD, EPS = 1e-3, 0.1, 1e-4
LLAMA = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             hidden_dim=128, rope_theta=10000.0, max_seq_len=64)
BERT = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
            max_seq_len=64)
LLAMA_BATCH, LLAMA_SEQ = 8, 17
BERT_BATCH, BERT_SEQ = 4, 32
# (name, world, mesh axes, n_kv_heads, zero)
LLAMA_RUNS = [
    ("fsdp2_model2", 4, {"fsdp": 2, "model": 2}, 2, False),
    ("fsdp2_model2_kv1", 4, {"fsdp": 2, "model": 2}, 1, False),
    ("data2_model2_zero", 4, {"data": 2, "model": 2}, 2, True),
    ("model2", 2, {"model": 2}, 2, False),
    ("model2_kv1", 2, {"model": 2}, 1, False),
]
# (name, world, mesh axes, vocab, BERT_RULES or none): at model=4 neither
# the vocab of 258 nor token_type_embed's 2 rows divide, so those tables
# arrive whole; with no rules every leaf is replicated and each layer is
# computed whole on every model rank
BERT_RUNS = [("data2_model2", 4, {"data": 2, "model": 2}, 256, True),
             ("model4", 4, {"model": 4}, 258, True),
             ("model2_no_rules", 2, {"model": 2}, 256, False)]
# the gradients held against jax.grad: biases read in model slices beside
# column-parallel weights (summed over model), biases and LayerNorms after
# a row-parallel sum (not summed)
BERT_GRADS = ("layers/0/attn/bq", "layers/1/attn/bv", "layers/0/ffn/b1",
              "layers/0/attn/bo", "layers/1/ffn/b2",
              "layers/0/attn_norm/gamma", "layers/1/ffn_norm/beta",
              "embed_norm/gamma")
EMBED_VOCAB, EMBED_DIM, EMBED_IDS, EMBED_STEPS = 1000, 8, 64, 3
# the C1 nets: a batch of 8 whose two halves differ in mean by 3
BN_BATCH, BN_IN, BN_HID, BN_OUT = 8, 6, 5, 3
CBR_N, CBR_HW, CBR_C = 4, 6, 4
BN_SGD = {"learning_rate": 0.1, "momentum": 0.9}


# ---------------------------------------------------------------- inputs
def llama_weights(n_kv_heads, seed=0):
    """A Llama tree in `models.llama`'s layout, fp32, from numpy."""
    rng = np.random.RandomState(seed)
    c = dict(LLAMA, n_kv_heads=n_kv_heads)
    d, hd = c["dim"], c["dim"] // c["n_heads"]
    qd, kvd, hid = c["n_heads"] * hd, n_kv_heads * hd, c["hidden_dim"]

    def dense(shape, scale=None):
        scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
        return (rng.randn(*shape) * scale).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.randn(d)).astype(np.float32)

    tree = {"tok_embeddings": dense((c["vocab_size"], d), 0.02),
            "norm": norm(), "lm_head": dense((c["vocab_size"], d), 0.02),
            "layers": {}}
    for i in range(c["n_layers"]):
        tree["layers"][str(i)] = {
            "attn_norm": norm(),
            "attn": {"wq": dense((d, qd)), "wk": dense((d, kvd)),
                     "wv": dense((d, kvd)), "wo": dense((qd, d))},
            "ffn_norm": norm(),
            "mlp": {"w1": dense((d, hid)), "w2": dense((hid, d)),
                    "w3": dense((d, hid))}}
    return tree


def llama_tokens(step):
    return np.random.RandomState(100 + step).randint(
        0, LLAMA["vocab_size"], size=(LLAMA_BATCH, LLAMA_SEQ))


def bert_weights(seed=1, vocab=None):
    """A BERT tree in `models.bert`'s layout, fp32, from numpy."""
    rng = np.random.RandomState(seed)
    d, hid = BERT["dim"], BERT["hidden_dim"]
    vocab = vocab or BERT["vocab_size"]

    def dense(shape, scale=None):
        scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
        return (rng.randn(*shape) * scale).astype(np.float32)

    def vec(n):
        return (0.1 * rng.randn(n)).astype(np.float32)

    def norm():
        return {"gamma": (1.0 + vec(d)).astype(np.float32), "beta": vec(d)}

    tree = {"word_embed": dense((vocab, d), 0.02),
            "position_embed": dense((BERT["max_seq_len"], d), 0.02),
            "token_type_embed": dense((2, d), 0.02),
            "embed_norm": norm(), "layers": {}}
    for i in range(BERT["n_layers"]):
        tree["layers"][str(i)] = {
            "attn": {"wq": dense((d, d)), "wk": dense((d, d)),
                     "wv": dense((d, d)), "wo": dense((d, d)),
                     "bq": vec(d), "bk": vec(d), "bv": vec(d),
                     "bo": vec(d)},
            "attn_norm": norm(),
            "ffn": {"w1": dense((d, hid)), "b1": vec(hid),
                    "w2": dense((hid, d)), "b2": vec(d)},
            "ffn_norm": norm()}
    return tree


def bert_batch(step, vocab=None):
    rng = np.random.RandomState(200 + step)
    vocab = vocab or BERT["vocab_size"]
    tok = rng.randint(0, vocab, size=(BERT_BATCH, BERT_SEQ))
    return {"tokens": tok,
            "targets": rng.randint(0, vocab, size=(BERT_BATCH, BERT_SEQ)),
            "mask": (rng.rand(BERT_BATCH, BERT_SEQ) < 0.3).astype(
                np.float32)}


def embed_table():
    return (np.random.RandomState(7).randn(EMBED_VOCAB, EMBED_DIM)
            * 0.1).astype(np.float32)


def embed_push(rank, step):
    """This rank's ids (repeats included) and gradient rows of a step."""
    rng = np.random.RandomState(1000 * step + rank)
    return (rng.randint(0, EMBED_VOCAB, size=EMBED_IDS).astype(np.int32),
            rng.randn(EMBED_IDS, EMBED_DIM).astype(np.float32))


def bn_batch():
    """(x, y) of the Dense-BatchNorm-Dense net: the second half of the
    batch shifted by 3."""
    rng = np.random.RandomState(5)
    x = rng.randn(BN_BATCH, BN_IN).astype(np.float32)
    x[BN_BATCH // 2:] += 3.0
    return x, rng.randn(BN_BATCH, BN_OUT).astype(np.float32)


def cbr_batch():
    """(x NHWC, y) of the conv-BN-ReLU net: the second half shifted by 3."""
    rng = np.random.RandomState(6)
    x = rng.randn(CBR_N, CBR_HW, CBR_HW, CBR_C).astype(np.float32)
    x[CBR_N // 2:] += 3.0
    return x, rng.randn(CBR_N, CBR_HW, CBR_HW, CBR_C).astype(np.float32)


def cbr_weights():
    rng = np.random.RandomState(8)
    return {"weight": (rng.randn(3, 3, CBR_C, CBR_C) * 0.3).astype(
                np.float32),
            "gamma": (1.0 + 0.1 * rng.randn(CBR_C)).astype(np.float32),
            "beta": (0.1 * rng.randn(CBR_C)).astype(np.float32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, "%s/%s" % (prefix, k) if prefix else k)
    else:
        yield prefix, tree


# ---------------------------------------------------------------- checks
def _mesh(axes):
    from mxnet_tpu_torch.parallel import create_mesh
    return create_mesh(**axes)


def check_llama(mx, rank, world, tmp):
    from mxnet_tpu_torch.models import llama as T
    from mxnet_tpu_torch.models.convert import params_from_jax
    from mxnet_tpu_torch.parallel import LLAMA_RULES, ShardedTrainStep
    out = {}
    for name, w, axes, kv, zero in LLAMA_RUNS:
        if w != world:
            continue
        cfg = T.LlamaConfig(**dict(LLAMA, n_kv_heads=kv),
                            dtype=torch.float32)
        mesh = _mesh(axes)
        params = params_from_jax(llama_weights(kv), device="cpu")
        step = ShardedTrainStep(lambda p, b: T.llama_loss(p, b, cfg), params,
                                mesh, rules=LLAMA_RULES, optimizer="adamw",
                                lr=LR, wd=WD, eps=EPS, zero=zero)
        p, st = step.init()
        for k, v in _flat(p):
            out["%s/block/%s" % (name, k)] = np.array(v.shape)
        losses = []
        for s in range(STEPS):
            p, st, loss = step(p, st, step.shard_batch(
                {"tokens": torch.from_numpy(llama_tokens(s))}))
            losses.append(loss.item())
        out["%s/losses" % name] = np.array(losses)
        for k, v in _flat(step.gather(p)):
            out["%s/p/%s" % (name, k)] = v.numpy()
        if name == "fsdp2_model2":
            out.update(check_checkpoint(step, p, st, mesh, tmp, name))
    return out


def check_checkpoint(step, p, st, mesh, tmp, name):
    """Save the sharded state (whole leaves), restore it onto the mesh by
    the rules: each rank's blocks come back bit for bit."""
    from mxnet_tpu_torch.parallel import (LLAMA_RULES, collectives,
                                          restore_train_state,
                                          save_train_state)
    path = os.path.join(tmp, "ckpt_" + name)
    save_train_state(path, p, st, STEPS)
    whole, wst, wstep = restore_train_state(path, device="cpu")
    rp, rst, rstep = restore_train_state(path, device="cpu", mesh=mesh,
                                         rules=LLAMA_RULES)
    same = rstep == wstep == STEPS and rst["t"] == st["t"]
    for (_, a), (_, b) in zip(_flat(rp), _flat(p)):
        same = same and torch.equal(a, b)
    for slot in ("m", "v"):
        for (_, a), (_, b) in zip(_flat(rst[slot]), _flat(st[slot])):
            same = same and torch.equal(a, b)
    full = step.gather(p)
    for (_, a), (_, b) in zip(_flat(whole), _flat(full)):
        same = same and torch.equal(a, b)
    collectives.barrier()
    return {"%s/ckpt_round_trip" % name: np.array(bool(same))}


class _GatherLog:
    """Records the (leaf shape, group) of every gather-on-use while
    installed (a context manager around `collectives.gather_on_use`)."""

    def __init__(self):
        from mxnet_tpu_torch.parallel import collectives
        self._coll = collectives
        self.calls = []

    def __enter__(self):
        self._orig = self._coll.gather_on_use

        def logged(x, axis_name, dim, summed=True):
            group, world, _ = self._coll.resolve_group(axis_name)
            self.calls.append((tuple(x.shape), group, world))
            return self._orig(x, axis_name, dim, summed)
        self._coll.gather_on_use = logged
        return self

    def __exit__(self, *exc):
        self._coll.gather_on_use = self._orig

    def over(self, group):
        return [shape for shape, g, w in self.calls if g is group and w > 1]


def check_bert(mx, rank, world, tmp):
    from mxnet_tpu_torch.models import bert as T
    from mxnet_tpu_torch.models.convert import params_from_jax
    from mxnet_tpu_torch.parallel import (BERT_RULES, ShardedTrainStep,
                                          mesh_scope)
    out = {}
    for name, w, axes, vocab, ruled in BERT_RUNS:
        if w != world:
            continue
        cfg = T.BertConfig(**dict(BERT, vocab_size=vocab),
                           dtype=torch.float32)
        mesh = _mesh(axes)
        params = params_from_jax(bert_weights(vocab=vocab), device="cpu")

        def batch(s):
            return {k: torch.from_numpy(v)
                    for k, v in bert_batch(s, vocab).items()}

        step = ShardedTrainStep(lambda p, b: T.bert_mlm_loss(p, b, cfg),
                                params, mesh,
                                rules=BERT_RULES if ruled else None,
                                optimizer="adamw", lr=LR, wd=WD, eps=EPS)
        p, st = step.init()
        for k, v in _flat(p):
            out["bert_%s/block/%s" % (name, k)] = np.array(v.shape)
        # the reduced gradients of the first batch
        with mesh_scope(mesh):
            _, g = step._value_and_grad(p, step.shard_batch(batch(0)))
        g = dict(_flat(step._reduce(g)))
        for k in BERT_GRADS:
            out["bert_%s/grad/%s" % (name, k)] = g[k].numpy()
        losses = []
        with _GatherLog() as log:
            for s in range(STEPS):
                p, st, loss = step(p, st, step.shard_batch(batch(s)))
                losses.append(loss.item())
        # no leaf of the layers or the embeddings is gathered over model
        out["bert_%s/model_gathers" % name] = np.array(
            len(log.over(mesh.group("model"))))
        out["bert_%s/losses" % name] = np.array(losses)
        for k, v in _flat(step.gather(p)):
            out["bert_%s/p/%s" % (name, k)] = v.numpy()
        if name == "data2_model2":
            # the same rules with no leaf consumed in place gather every
            # split over model (the whole-model route) to the same numbers
            # fresh leaves: a step updates its replicated leaves in place
            params = params_from_jax(bert_weights(vocab=vocab), device="cpu")
            gstep = ShardedTrainStep(
                lambda p, b: T.bert_mlm_loss(p, b, cfg), params, mesh,
                rules=BERT_RULES.without_local(), optimizer="adamw", lr=LR,
                wd=WD, eps=EPS)
            gp, gst = gstep.init()
            glosses = []
            with _GatherLog() as log:
                for s in range(STEPS):
                    gp, gst, loss = gstep(gp, gst,
                                          gstep.shard_batch(batch(s)))
                    glosses.append(loss.item())
            out["bert_gathered/model_gathers"] = np.array(
                len(log.over(mesh.group("model"))))
            out["bert_gathered/losses"] = np.array(glosses)
            for k, v in _flat(gstep.gather(gp)):
                out["bert_gathered/p/%s" % k] = v.numpy()
    return out


def check_embedding(mx, rank, world, tmp):
    """MeshEmbeddingComm over a data axis of every rank against the
    world-1 table: lookups, apply_grads (every rank's rows), the serving
    copy placed on the mesh."""
    from mxnet_tpu_torch.embedding import (EmbeddingLookupService,
                                           MeshEmbeddingComm,
                                           ShardedEmbedding)
    from mxnet_tpu_torch.parallel import mesh_scope
    mesh = _mesh({"model": world})
    with mesh_scope(mesh):
        comm = MeshEmbeddingComm("model", world, rank)
        table = ShardedEmbedding(EMBED_VOCAB, EMBED_DIM, comm=comm,
                                 optimizer="adam", learning_rate=0.05,
                                 weight=embed_table(), device="cpu")
        spec = table.shard_spec(mesh)
        out = {"embed_spec": np.array(str(spec)),
               "embed_rows": np.array(table.weight.shape)}
        for s in range(EMBED_STEPS):
            # a lookup reads the same ids on every rank; each rank pushes
            # its own rows
            out["embed_lookup_%d" % s] = table.lookup(
                embed_push(world, s)[0]).numpy()
            table.apply_grads(*embed_push(rank, s))
        out["embed_table"] = table.gathered_weight().numpy()
        service = EmbeddingLookupService(table, max_batch=64, mesh=mesh)
        ids = np.arange(40) * 37 % EMBED_VOCAB
        out["embed_served"] = service.lookup(ids).numpy()
        out["embed_served_ids"] = ids
        out["embed_served_rows"] = np.array(service._weight.shape)
    return out


def _bn_net(mx, ctx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(BN_HID, in_units=BN_IN),
            mx.gluon.nn.BatchNorm(in_channels=BN_HID),
            mx.gluon.nn.Dense(BN_OUT, in_units=BN_HID))
    net.initialize(ctx=ctx)
    rng = np.random.RandomState(9)
    for prm in net.collect_params().values():
        if prm.name.endswith(("running_mean", "running_var")):
            continue
        prm.set_data(mx.nd.array(
            (rng.randn(*prm.shape) * 0.5).astype(np.float32), ctx=ctx))
    return net


def check_batchnorm(mx, rank, world, tmp):
    """C1: one SGD step of FusedTrainStep over a data mesh of the ranks,
    each on its half of the batch, for a Dense-BatchNorm-Dense net and a
    conv-BN-ReLU net through `_contrib_conv_bn_relu_train`."""
    if world != 2:
        return {}
    mesh = _mesh({"data": world})
    ctx = mx.cpu()
    out = {}
    per = BN_BATCH // world
    with ctx:
        net = _bn_net(mx, ctx)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(BN_SGD))
        step = mx.gluon.FusedTrainStep(net, mx.gluon.loss.L2Loss(), tr,
                                       mesh=mesh)
        x, y = bn_batch()
        loss = step(mx.nd.array(x[rank * per:(rank + 1) * per]),
                    mx.nd.array(y[rank * per:(rank + 1) * per]))
        for i, prm in enumerate(net.collect_params().values()):
            out["bn/%d" % i] = prm.data().asnumpy()
        out["bn/loss"] = loss.asnumpy()
        out.update(_cbr_step(mx, rank, world, mesh, ctx))
    return out


def _cbr_step(mx, rank, world, mesh, ctx):
    net = mx.gluon.contrib.cnn.FusedConvBNReLUTrain(CBR_C,
                                                    in_channels=CBR_C)
    net.initialize(ctx=ctx)
    for k, v in cbr_weights().items():
        getattr(net, k).set_data(mx.nd.array(v, ctx=ctx))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(BN_SGD))
    step = mx.gluon.FusedTrainStep(net, mx.gluon.loss.L2Loss(), tr,
                                   mesh=mesh)
    x, y = cbr_batch()
    per = CBR_N // world
    loss = step(mx.nd.array(x[rank * per:(rank + 1) * per]),
                mx.nd.array(y[rank * per:(rank + 1) * per]))
    out = {"cbr/" + k: getattr(net, k).data().asnumpy()
           for k in ("weight", "gamma", "beta", "running_mean",
                     "running_var")}
    out["cbr/loss"] = loss.asnumpy()
    return out


CHECKS = (check_llama, check_bert, check_embedding, check_batchnorm)


def main():
    out_dir = sys.argv[1]
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dist
    dist.initialize(backend="gloo")
    rank, world = dist.rank(), dist.num_workers()
    res = {}
    for fn in CHECKS:
        res.update(fn(mx, rank, world, out_dir))
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
    dist.shutdown()


if __name__ == "__main__":
    main()
