"""Rank program of the port's multi-rank CPU tests.

Started by `mxnet_tpu_torch.launch.launch_local` (one process per rank,
the DMLC_* variables naming a FileStore under the test's tmp_path, gloo):

    python tests/_torch_dist_worker.py <scenario> <out_dir>

It imports only the port (never JAX), runs on one thread, runs every
check of the scenario and writes this rank's arrays to
``<out_dir>/rank<r>.npz``; the tests compare them with the JAX package in
the parent process. The input generators below are shared with the tests,
so both sides draw the same numbers.
"""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

# the dims every scenario uses
IN, HID, OUT, GLOBAL_BATCH, STEPS = 6, 5, 3, 8, 3
ZERO_SHAPES = [(5, 3), (7,), (4, 4), (3,)]          # 41 elements
SPARSE_ROWS, SPARSE_DIM = 20, 4
RING = dict(B=2, H=4, Hkv=2, S=32, D=16)
SGD_KW = {"learning_rate": 0.125, "momentum": 0.5}
ADAM_KW = {"learning_rate": 0.125, "beta1": 0.5, "beta2": 0.5,
           "epsilon": 2.0 ** -8}
LAMB_KW = {"learning_rate": 0.01, "beta1": 0.9, "beta2": 0.999,
           "epsilon": 1e-6}
# ShardedTrainStep's data-parallel variants and FusedTrainStep's buckets
STEP_VARIANTS = (("plain", {}), ("bucket", {"bucket_mb": 1e-5}),
                 ("zero", {"zero": True, "bucket_mb": 1e-4}))
FUSED_BUCKET_MB = 1e-5
# the tensor-parallel MLP: w1's IN columns over ``model``
TP_RULES = [("w1", (None, "model"))]


# ---------------------------------------------------------------- inputs
def mlp_weights():
    rng = np.random.RandomState(0)
    return [(rng.randn(HID, IN) * 0.4).astype(np.float32),
            (rng.randn(HID) * 0.1).astype(np.float32),
            (rng.randn(OUT, HID) * 0.4).astype(np.float32),
            (rng.randn(OUT) * 0.1).astype(np.float32)]


def mlp_batch(step):
    rng = np.random.RandomState(100 + step)
    return (rng.randn(GLOBAL_BATCH, IN).astype(np.float32),
            rng.randn(GLOBAL_BATCH, OUT).astype(np.float32))


def comp_grads(rank, step):
    """Per-rank gradients of the compression checks, keys 3 and 5."""
    rng = np.random.RandomState(1000 * step + rank)
    return {"3": (rng.randn(10) * 0.6).astype(np.float32),
            "5": (rng.randn(3, 7) * 0.6).astype(np.float32)}


def sparse_push(rank):
    """(row ids, rows) of one rank's row-sparse push: overlapping rows."""
    rng = np.random.RandomState(50 + rank)
    ids = np.sort(rng.choice(SPARSE_ROWS, 6, replace=False)).astype(np.int64)
    return ids, rng.randn(6, SPARSE_DIM).astype(np.float32)


def zero_inputs(world):
    rng = np.random.RandomState(1)
    init_w = [rng.randn(*s).astype(np.float32) for s in ZERO_SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in ZERO_SHAPES]
             for _ in range(world)]
    return init_w, grads


def ring_inputs():
    c = RING
    rng = np.random.RandomState(7)
    q = rng.randn(c["B"], c["H"], c["S"], c["D"]).astype(np.float32)
    k = rng.randn(c["B"], c["Hkv"], c["S"], c["D"]).astype(np.float32)
    v = rng.randn(c["B"], c["Hkv"], c["S"], c["D"]).astype(np.float32)
    do = rng.randn(c["B"], c["H"], c["S"], c["D"]).astype(np.float32)
    return q, k, v, do


# ---------------------------------------------------------------- checks
def _mlp(mx, ctx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(HID, in_units=IN, activation="relu"),
            mx.gluon.nn.Dense(OUT, in_units=HID))
    net.initialize(ctx=ctx)
    for p, w in zip(net.collect_params().values(), mlp_weights()):
        p.set_data(mx.nd.array(w, ctx=ctx))
    return net


def _train(mx, rank, world, **trainer_kw):
    """STEPS of the MLP with SGD momentum through a dist_sync Trainer;
    this rank trains on its contiguous slice of each global batch."""
    ctx = mx.cpu()
    with ctx:
        net = _mlp(mx, ctx)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9},
                              kvstore="dist_sync", **trainer_kw)
        loss_fn = mx.gluon.loss.L2Loss()
        per = GLOBAL_BATCH // world
        for s in range(STEPS):
            x, y = mlp_batch(s)
            x = mx.nd.array(x[rank * per:(rank + 1) * per], ctx=ctx)
            y = mx.nd.array(y[rank * per:(rank + 1) * per], ctx=ctx)
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(GLOBAL_BATCH)
        return [p.data().asnumpy() for p in net.collect_params().values()]


def check_trainer(mx, rank, world):
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch import telemetry
    out = {}
    with engine.bucket_mb_scope(0):
        out["per_key"] = _train(mx, rank, world)
    out["bucketed"] = _train(mx, rank, world)
    with engine.bucket_mb_scope(0.0001):
        out["small_buckets"] = _train(mx, rank, world)
    before = telemetry.counter_value("comm.ready.rounds")
    out["ready"] = _train(mx, rank, world, comm_ready=True)
    out["ready_rounds"] = [np.array(
        telemetry.counter_value("comm.ready.rounds") - before)]
    out["local_update"] = _train(mx, rank, world, update_on_kvstore=False)
    return {"%s_%d" % (k, i): v for k, vs in out.items()
            for i, v in enumerate(vs)}


def check_kvstore(mx, rank, world):
    """Dense push/pull with the store's optimizer (Adam), per key."""
    ctx = mx.cpu()
    kv = mx.kv.create("dist_sync")
    assert kv.rank == rank and kv.num_workers == world
    kv.set_optimizer(mx.optimizer.create("adam", **ADAM_KW))
    init_w, grads = zero_inputs(world)
    keys = [str(i) for i in range(len(ZERO_SHAPES))]
    kv.init(keys, [mx.nd.array(w, ctx=ctx) for w in init_w])
    for _ in range(2):
        for k, g in zip(keys, grads[rank]):
            kv.push(k, mx.nd.array(g, ctx=ctx))
    outs = [mx.nd.zeros(s, ctx=ctx) for s in ZERO_SHAPES]
    kv.pull(keys, out=outs)
    kv.barrier()
    return {"kv_adam_%d" % i: o.asnumpy() for i, o in enumerate(outs)}


def check_compression(mx, rank, world):
    from mxnet_tpu_torch import engine
    ctx = mx.cpu()
    out = {}
    for mode in ("key", "bucket"):
        kv = mx.kv.create("dist_sync")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        packed = []
        real = kv._gc.compress

        def spy(key, arr, real=real, packed=packed):
            p = real(key, arr)
            packed.append(p.numpy().copy())
            return p

        kv._gc.compress = spy
        keys = ["3", "5"]
        kv.init(keys, [mx.nd.zeros((10,), ctx=ctx),
                       mx.nd.zeros((3, 7), ctx=ctx)])
        for s in range(STEPS):
            g = comp_grads(rank, s)
            vals = [mx.nd.array(g[k], ctx=ctx) for k in keys]
            if mode == "key":
                for k, v in zip(keys, vals):
                    kv.push(k, v)
            else:
                with engine.bucket_mb_scope(25):
                    kv.push(keys, vals)
        outs = [mx.nd.zeros((10,), ctx=ctx), mx.nd.zeros((3, 7), ctx=ctx)]
        kv.pull(keys, out=outs)
        for i, p in enumerate(packed):
            out["%s_packed_%d" % (mode, i)] = p
        for name, r in sorted(kv._gc._residual.items()):
            out["%s_residual_%s" % (mode, name)] = r.numpy()
        for k, o in zip(keys, outs):
            out["%s_pulled_%s" % (mode, k)] = o.asnumpy()
    return out


def check_sparse(mx, rank, world):
    from mxnet_tpu_torch.ndarray import sparse
    ctx = mx.cpu()
    kv = mx.kv.create("dist_sync")
    kv.init("w", mx.nd.zeros((SPARSE_ROWS, SPARSE_DIM), ctx=ctx))
    ids, vals = sparse_push(rank)
    g = sparse.RowSparseNDArray(torch.from_numpy(vals),
                                torch.from_numpy(ids),
                                (SPARSE_ROWS, SPARSE_DIM), ctx=ctx)
    kv.push("w", g)
    dense = mx.nd.zeros((SPARSE_ROWS, SPARSE_DIM), ctx=ctx)
    kv.pull("w", out=dense)
    rows = np.array([1, 3, 4, 11, 19], np.int64)
    pulled = sparse.zeros("row_sparse", (SPARSE_ROWS, SPARSE_DIM), ctx=ctx)
    kv.row_sparse_pull("w", out=pulled,
                       row_ids=mx.nd.array(rows, ctx=ctx, dtype="int64"))
    return {"sparse_dense": dense.asnumpy(),
            "sparse_rows": pulled._indices.numpy(),
            "sparse_vals": pulled._values.numpy()}


def check_zero(mx, rank, world):
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.kvstore import DistZeroComm
    from mxnet_tpu_torch.optimizer.zero import ZeroUpdater
    ctx = mx.cpu()
    init_w, grads = zero_inputs(world)
    keys = [str(i) for i in range(len(ZERO_SHAPES))]
    out = {}
    for name, kw in (("sgd", SGD_KW), ("adam", ADAM_KW),
                     ("lamb", LAMB_KW)):
        # 64-byte buckets: several buckets, segments cut by shard edges
        with engine.bucket_mb_scope(64 / 2 ** 20):
            zu = ZeroUpdater(mx.optimizer.create(name, **kw),
                             comm=DistZeroComm())
            ws = [mx.nd.array(w, ctx=ctx) for w in init_w]
            for _ in range(STEPS):
                zu.step(keys, [torch.from_numpy(g) for g in grads[rank]],
                        ws)
        out["nbuckets_" + name] = np.array(len(zu.layout))
        for i, w in enumerate(ws):
            out["zero_%s_%d" % (name, i)] = w.asnumpy()
    return out


def _zero_trainer(mx, rank, world, comm_ready):
    ctx = mx.cpu()
    with ctx:
        net = _mlp(mx, ctx)
        tr = mx.gluon.Trainer(net.collect_params(), "lamb", dict(LAMB_KW),
                              kvstore="dist_sync", zero=True,
                              comm_ready=comm_ready)
        loss_fn = mx.gluon.loss.L2Loss()
        per = GLOBAL_BATCH // world
        for s in range(STEPS):
            x, y = mlp_batch(s)
            x = mx.nd.array(x[rank * per:(rank + 1) * per], ctx=ctx)
            y = mx.nd.array(y[rank * per:(rank + 1) * per], ctx=ctx)
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(GLOBAL_BATCH)
        return [p.data().asnumpy() for p in net.collect_params().values()]


def check_ready_zero(mx, rank, world):
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch import telemetry
    out = {}
    with engine.bucket_mb_scope(64 / 2 ** 20):
        for mode, flag in (("reg", False), ("ready", True)):
            before = telemetry.counter_value("comm.ready.rounds")
            for i, w in enumerate(_zero_trainer(mx, rank, world, flag)):
                out["zt_%s_%d" % (mode, i)] = w
            out["zt_%s_rounds" % mode] = np.array(
                telemetry.counter_value("comm.ready.rounds") - before)
    return out


def check_collectives(mx, rank, world):
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.parallel import collectives as C
    x = torch.from_numpy(np.random.RandomState(rank).randn(world * 3, 2)
                         .astype(np.float32))
    out = {"ar": C.all_reduce(x).numpy(),
           "ar_max": C.all_reduce(x, op="max").numpy(),
           "ag": C.all_gather(x[:2]).numpy(),
           "rs": C.reduce_scatter(x).numpy(),
           "pp": C.ppermute(x, None, [(i, (i + 1) % world)
                                      for i in range(world)]).numpy()}
    xs = [x, x[:1] * 2, x.reshape(-1)[:5] + 1]
    for i, t in enumerate(C.psum_bucketed(xs, bucket_mb=1e-5)):
        out["pb_%d" % i] = t.numpy()
    shards, layout = C.reduce_scatter_multi(xs, bucket_mb=1e-5)
    for i, t in enumerate(C.all_gather_multi(shards, layout)):
        out["rsag_%d" % i] = t.numpy()
    ids = torch.tensor([rank, 7, -1, rank + 1], dtype=torch.int32)
    vals = torch.ones(4, 2) * (rank + 1)
    gid, gval = C.psum_unique_rows(ids, vals)
    out["pur_ids"], out["pur_vals"] = gid.numpy(), gval.numpy()
    C.barrier()
    bench = C.allreduce_bench(size_mb=0.5, iters=2, warmup=1)
    out["bench"] = np.array([bench["world"], bench["algo_gbps"] > 0,
                             bench["bus_gbps"] >= 0, bench["bytes"]])
    assert engine.bucket_bytes() > 0
    return out


def check_steps(mx, rank, world):
    """ShardedTrainStep and FusedTrainStep data parallel over the mesh."""
    from mxnet_tpu_torch.parallel import (LLAMA_RULES, ShardedTrainStep,
                                          create_mesh)
    mesh = create_mesh(data=world)
    out = {}
    per = GLOBAL_BATCH // world
    w0 = mlp_weights()

    def loss_fn(p, b):
        h = torch.relu(b["x"] @ p["w1"].T + p["b1"])
        return ((h @ p["w2"].T + p["b2"] - b["y"]) ** 2).mean()

    for name, kw in STEP_VARIANTS:
        params = {k: torch.from_numpy(w.copy()) for k, w in
                  zip(("w1", "b1", "w2", "b2"), w0)}
        step = ShardedTrainStep(loss_fn, params, mesh=mesh, optimizer="adam",
                                lr=0.01, rules=LLAMA_RULES, **kw)
        p, st = step.init()
        for s in range(STEPS):
            x, y = mlp_batch(s)
            b = {"x": torch.from_numpy(x[rank * per:(rank + 1) * per]),
                 "y": torch.from_numpy(y[rank * per:(rank + 1) * per])}
            p, st, loss = step(p, st, b)
        for k, v in p.items():
            out["sts_%s_%s" % (name, k)] = v.numpy().copy()
        out["sts_%s_loss" % name] = loss.numpy()
    # FusedTrainStep over the data mesh
    ctx = mx.cpu()
    with ctx:
        net = _mlp(mx, ctx)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        fstep = mx.gluon.FusedTrainStep(net, mx.gluon.loss.L2Loss(), tr,
                                        mesh=mesh,
                                        bucket_mb=FUSED_BUCKET_MB)
        fstep = fstep.rebuild_for_mesh(mesh)
        for s in range(STEPS):
            x, y = mlp_batch(s)
            loss = fstep(mx.nd.array(x[rank * per:(rank + 1) * per]),
                         mx.nd.array(y[rank * per:(rank + 1) * per]))
        for i, prm in enumerate(net.collect_params().values()):
            out["fused_%d" % i] = prm.data().asnumpy()
        out["fused_loss"] = loss.asnumpy()
    # tensor parallelism: w1's columns split over ``model``, gathered on
    # use; the batch over ``data``
    if world % 2 == 0:
        from mxnet_tpu_torch.parallel import P, ShardingRules
        tp = create_mesh(data=world // 2, model=2)
        params = {k: torch.from_numpy(w.copy()) for k, w in
                  zip(("w1", "b1", "w2", "b2"), w0)}
        step = ShardedTrainStep(loss_fn, params, mesh=tp, optimizer="adam",
                                lr=0.01, rules=ShardingRules(TP_RULES))
        p, st = step.init()
        out["tp_w1_block"] = np.array(p["w1"].shape)
        for s in range(STEPS):
            x, y = mlp_batch(s)
            p, st, loss = step(p, st, step.shard_batch(
                {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}))
        for k, v in step.gather(p).items():
            out["tp_%s" % k] = v.numpy().copy()
        out["tp_loss"] = loss.numpy()
    return out


def check_ring(mx, rank, world):
    from mxnet_tpu_torch.parallel import create_mesh, mesh_scope
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention
    q, k, v, do = ring_inputs()
    c = RING["S"] // world
    sl = slice(rank * c, (rank + 1) * c)
    mesh = create_mesh(seq=world)
    out = {}
    with mesh_scope(mesh):
        for causal in (False, True):
            qs, ks, vs = (torch.from_numpy(t[:, :, sl].copy())
                          .requires_grad_() for t in (q, k, v))
            o = ring_attention(qs, ks, vs, axis_name="seq", causal=causal)
            o.backward(torch.from_numpy(do[:, :, sl].copy()))
            tag = "causal" if causal else "full"
            out["ring_%s_o" % tag] = o.detach().numpy()
            out["ring_%s_dq" % tag] = qs.grad.numpy()
            out["ring_%s_dk" % tag] = ks.grad.numpy()
            out["ring_%s_dv" % tag] = vs.grad.numpy()
    return out


SCENARIOS = {
    "dist": (check_collectives, check_trainer, check_kvstore,
             check_compression, check_sparse, check_zero, check_ready_zero,
             check_steps),
    "ring": (check_ring,),
}


def main():
    scenario, out_dir = sys.argv[1], sys.argv[2]
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dist
    dist.initialize(backend="gloo")
    rank, world = dist.rank(), dist.num_workers()
    res = {}
    for fn in SCENARIOS[scenario]:
        res.update(fn(mx, rank, world))
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
    dist.shutdown()


if __name__ == "__main__":
    main()
