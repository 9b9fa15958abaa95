"""The port's multi-rank layer against the JAX package, on the CPU.

World 2 and world 4 run as real process groups: `mxnet_tpu_torch.launch`
starts one process per rank (gloo, a FileStore rendezvous under
tmp_path, a join timeout of its own), each runs every check of
`_torch_dist_worker.py` once and writes its arrays, and the tests here
hold them against the JAX package run in this process on conftest's 8
CPU devices:

* the dist_sync Trainer (per key, one bucket, several buckets, readiness
  order, local update) against the reference's Trainer over cpu(0..n-1)
  with the batch split the same way: within 1e-5 relative + 1e-6 (the
  workers add their gradients in gloo's order, the reference in context
  order);
* the store's server-side Adam, per key: the same tolerance;
* 2-bit compression: the packed bytes, the residuals and the summed
  result equal the reference's `GradientCompression` bit for bit;
* a row-sparse push and pull against the reference's one-process store:
  1e-6 (sums of four rows in another order);
* ZeRO (SGD, Adam, LAMB; several buckets whose shards cut parameters)
  against the reference's in-process fleet: SGD and Adam within 1e-6,
  LAMB 1e-5 (its norms sum in another order);
* readiness order equals registration order bit for bit (dist store and
  ZeRO);
* data-parallel `ShardedTrainStep` (plain, bucketed, ZeRO-1) and
  `FusedTrainStep` (bucketed, rebuilt for the mesh) against the
  reference's same steps on a `data` mesh of as many CPU devices, fed
  the whole batch: 2e-6 / 1e-5.
"""
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.launch import build_env, launch_local
from mxnet_tpu_torch.parallel import dist

import _torch_dist_worker as W
from _torch_seed import _seed_torch  # noqa: F401

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
SPAWN_TIMEOUT_S = 240
TRAINER_RTOL, TRAINER_ATOL = 1e-5, 1e-6


def spawn(world, scenario, tmp):
    """Run the worker at `world` ranks over gloo; the ranks' arrays."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("MXNET_TPU_COMM_BUCKET_MB", None)
    rc = launch_local([sys.executable, W.__file__, scenario, str(tmp)],
                      world, root_uri="file://%s" % (tmp / "store"),
                      backend="gloo", timeout=SPAWN_TIMEOUT_S, env=env)
    assert rc == 0, "worker group exited with %s" % rc
    return [dict(np.load(tmp / ("rank%d.npz" % r))) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, spawn(world, "dist", tmp_path_factory.mktemp(
        "dist%d" % world))


def _same_on_every_rank(res, prefix):
    keys = sorted(k for k in res[0] if k.startswith(prefix))
    assert keys
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    return [res[0][k] for k in keys]


# ------------------------------------------------------------ collectives
def test_collectives_match_numpy(ranks):
    world, res = ranks
    xs = [np.random.RandomState(r).randn(world * 3, 2).astype(np.float32)
          for r in range(world)]
    total = xs[0].copy()
    for x in xs[1:]:
        total = total + x
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["ar"], total, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["ar_max"], np.max(xs, axis=0))
        np.testing.assert_array_equal(got["ag"],
                                      np.concatenate([x[:2] for x in xs]))
        np.testing.assert_allclose(got["rs"], total[r * 3:(r + 1) * 3],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["pp"], xs[(r - 1) % world])
        parts = [total, total[:1] * 2, total.reshape(-1)[:5] + world]
        for i, want in enumerate(parts):
            for tag in ("pb_%d", "rsag_%d"):
                np.testing.assert_allclose(got[tag % i], want, rtol=1e-5,
                                           atol=1e-5, err_msg=tag % i)
        # rows r, 7, r+1 of every rank, each row (r+1) ones: merged sums
        rows = {}
        for q in range(world):
            for i in (q, 7, q + 1):
                rows[i] = rows.get(i, 0.0) + (q + 1)
        want_ids = sorted(rows)
        n = len(want_ids)
        np.testing.assert_array_equal(got["pur_ids"][:n], want_ids)
        assert (got["pur_ids"][n:] == -1).all()
        np.testing.assert_array_equal(
            got["pur_vals"][:n], np.repeat([[rows[i]] for i in want_ids],
                                           2, axis=1))
        assert got["bench"][0] == world and got["bench"][1] == 1


# ---------------------------------------------------------------- trainer
def _ref_trainer(world):
    """The reference's Trainer over cpu(0..world-1), one slice a
    context."""
    ctxs = [jmx.cpu(i) for i in range(world)]
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(W.HID, in_units=W.IN, activation="relu"),
            jmx.gluon.nn.Dense(W.OUT, in_units=W.HID))
    net.initialize(ctx=ctxs)
    for p, w in zip(net.collect_params().values(), W.mlp_weights()):
        p.set_data(jmx.nd.array(w))
    tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore="device")
    loss_fn = jmx.gluon.loss.L2Loss()
    per = W.GLOBAL_BATCH // world
    for s in range(W.STEPS):
        x, y = W.mlp_batch(s)
        with jmx.autograd.record():
            losses = [loss_fn(net(jmx.nd.array(x[i * per:(i + 1) * per],
                                               ctx=c)),
                              jmx.nd.array(y[i * per:(i + 1) * per], ctx=c))
                      for i, c in enumerate(ctxs)]
        jmx.autograd.backward(losses)
        tr.step(W.GLOBAL_BATCH)
    return [p.data(ctxs[0]).asnumpy() for p in net.collect_params().values()]


@pytest.mark.parametrize("variant", ["per_key", "bucketed", "small_buckets",
                                     "ready", "local_update"])
def test_dist_trainer_matches_reference_over_contexts(ranks, variant):
    world, res = ranks
    want = _ref_trainer(world)
    got = _same_on_every_rank(res, variant + "_")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TRAINER_RTOL,
                                   atol=TRAINER_ATOL)


def test_dist_readiness_equals_registration_bit_for_bit(ranks):
    world, res = ranks
    for r in res:
        assert int(r["ready_rounds_0"]) == W.STEPS - 1
        for i in range(4):
            np.testing.assert_array_equal(r["ready_%d" % i],
                                          r["bucketed_%d" % i])
        for i in range(4):
            np.testing.assert_array_equal(r["zt_ready_%d" % i],
                                          r["zt_reg_%d" % i])
        assert int(r["zt_ready_rounds"]) == W.STEPS - 1
        assert int(r["zt_reg_rounds"]) == 0


def test_dist_store_server_adam_matches_reference(ranks):
    world, res = ranks
    init_w, grads = W.zero_inputs(world)
    kv = jmx.kv.create("device")
    kv.set_optimizer(jmx.optimizer.create("adam", **W.ADAM_KW))
    keys = [str(i) for i in range(len(W.ZERO_SHAPES))]
    kv.init(keys, [jmx.nd.array(w) for w in init_w])
    for _ in range(2):
        for i, k in enumerate(keys):
            kv.push(k, [jmx.nd.array(grads[r][i]) for r in range(world)])
    outs = [jmx.nd.zeros(s) for s in W.ZERO_SHAPES]
    kv.pull(keys, out=outs)
    got = _same_on_every_rank(res, "kv_adam_")
    for g, o in zip(got, outs):
        np.testing.assert_allclose(g, o.asnumpy(), rtol=TRAINER_RTOL,
                                   atol=TRAINER_ATOL)


# ------------------------------------------------------------ compression
def test_two_bit_compression_bytes_and_residuals_match_reference(ranks):
    from mxnet_tpu.kvstore.kvstore_dist import GradientCompression
    world, res = ranks
    for mode in ("key", "bucket"):
        summed = {}
        for r, got in enumerate(res):
            gc = GradientCompression(0.5)
            packed = []
            for s in range(W.STEPS):
                g = W.comp_grads(r, s)
                if mode == "key":
                    for k in ("3", "5"):
                        packed.append(gc.compress(k, jnp.asarray(g[k])))
                else:
                    flat = np.concatenate([g["3"], g["5"].ravel()])
                    packed.append(gc.compress("__bucket__0",
                                              jnp.asarray(flat)))
            for i, p in enumerate(packed):
                np.testing.assert_array_equal(
                    got["%s_packed_%d" % (mode, i)], np.asarray(p),
                    err_msg="rank %d %s packed %d" % (r, mode, i))
            for name, want in gc._residual.items():
                np.testing.assert_array_equal(
                    got["%s_residual_%s" % (mode, name)],
                    np.asarray(want).reshape(
                        got["%s_residual_%s" % (mode, name)].shape))
            # the stored value is the sum of the last push's decoded values
            last = packed[-2:] if mode == "key" else packed[-1:]
            if mode == "key":
                dec = {k: np.asarray(gc.decompress(p, s_, np.float32))
                       for k, p, s_ in zip(("3", "5"), last,
                                           ((10,), (3, 7)))}
            else:
                flat = np.asarray(gc.decompress(last[0], (31,), np.float32))
                dec = {"3": flat[:10], "5": flat[10:].reshape(3, 7)}
            for k in dec:
                summed[k] = summed.get(k, 0) + dec[k]
        for got in res:
            for k in ("3", "5"):
                np.testing.assert_array_equal(
                    got["%s_pulled_%s" % (mode, k)], summed[k])


def test_one_process_dist_store_compresses_like_the_reference():
    """World 1 (no process group): a dist_sync store still quantizes with
    error feedback; its result is the reference's world-1 store's."""
    from mxnet_tpu.kvstore.kvstore_dist import KVStoreDist as JDist
    outs = []
    for pkg, kv in ((mx, mx.kv.create("dist_sync")), (jmx, JDist())):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        ctx = pkg.cpu()
        kv.init("3", pkg.nd.zeros((10,), ctx=ctx))
        for s in range(W.STEPS):
            kv.push("3", pkg.nd.array(W.comp_grads(0, s)["3"], ctx=ctx))
        o = pkg.nd.zeros((10,), ctx=ctx)
        kv.pull("3", out=o)
        outs.append(o.asnumpy())
    assert dist.num_workers() == 1
    np.testing.assert_array_equal(outs[0], outs[1])


# ------------------------------------------------------------- row-sparse
def test_row_sparse_push_pull_matches_reference(ranks):
    world, res = ranks
    kv = jmx.kv.create("device")
    kv.init("w", jmx.nd.zeros((W.SPARSE_ROWS, W.SPARSE_DIM)))
    reps = []
    for r in range(world):
        ids, vals = W.sparse_push(r)
        reps.append(jmx.nd.sparse.row_sparse_array(
            (vals, ids), shape=(W.SPARSE_ROWS, W.SPARSE_DIM)))
    kv.push("w", reps)
    dense = jmx.nd.zeros((W.SPARSE_ROWS, W.SPARSE_DIM))
    kv.pull("w", out=dense)
    rows = np.array([1, 3, 4, 11, 19], np.int64)
    want = dense.asnumpy()
    for got in res:
        np.testing.assert_allclose(got["sparse_dense"], want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["sparse_rows"], rows)
        np.testing.assert_allclose(got["sparse_vals"], want[rows],
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- ZeRO
class _RefFleet:
    """The reference's in-process fleet: one thread per rank, a barrier'd
    mailbox that adds contributions in rank order."""

    def __init__(self, world):
        self.world = world
        self.lock = threading.Lock()
        self.barrier = threading.Barrier(world)
        self.box = {}

    def comm(self, rank):
        fleet = self

        class Comm:
            world = fleet.world

            def __init__(self):
                self.rank = rank

            def _exchange(self, tag, spec, value):
                with fleet.lock:
                    fleet.box.setdefault((tag, spec.index), {})[rank] = \
                        np.asarray(value)
                fleet.barrier.wait()
                parts = dict(fleet.box[(tag, spec.index)])
                fleet.barrier.wait()
                return parts

            def _sum(self, parts):
                total = parts[0].copy()
                for r in range(1, fleet.world):
                    total = total + parts[r]
                return total

            def reduce_scatter(self, spec, flat):
                total = self._sum(self._exchange("rs", spec, flat))
                lo = rank * spec.shard
                return jnp.asarray(total[lo:lo + spec.shard])

            def all_gather(self, spec, shard):
                parts = self._exchange("ag", spec, shard)
                return jnp.asarray(np.concatenate(
                    [parts[r] for r in range(fleet.world)]))

            def all_reduce(self, spec, value):
                return jnp.asarray(self._sum(self._exchange("ar", spec,
                                                            value)))

        return Comm()


def _ref_zero(name, kw, world):
    from mxnet_tpu.optimizer.zero import ZeroUpdater
    init_w, grads = W.zero_inputs(world)
    keys = [str(i) for i in range(len(W.ZERO_SHAPES))]
    fleet = _RefFleet(world)
    outs, errs, nb = [None] * world, [], [0]

    def run(rank):
        try:
            zu = ZeroUpdater(jmx.optimizer.create(name, **kw),
                             comm=fleet.comm(rank))
            ws = [jmx.nd.array(w) for w in init_w]
            for _ in range(W.STEPS):
                zu.step(keys, [jnp.asarray(g) for g in grads[rank]], ws)
            outs[rank] = [w.asnumpy() for w in ws]
            nb[0] = len(zu.layout)
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)
            fleet.barrier.abort()

    with jmx.engine.bucket_mb_scope(64 / 2 ** 20):
        threads = [threading.Thread(target=run, args=(r,))
                   for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert not errs, errs
    return outs, nb[0]


@pytest.mark.parametrize("name,kw,tol", [
    ("sgd", W.SGD_KW, 1e-6), ("adam", W.ADAM_KW, 1e-6),
    ("lamb", W.LAMB_KW, 1e-5)])
def test_zero_over_gloo_matches_reference_fleet(ranks, name, kw, tol):
    world, res = ranks
    want, nbuckets = _ref_zero(name, kw, world)
    assert nbuckets > 1
    for r, got in enumerate(res):
        assert int(got["nbuckets_" + name]) == nbuckets
        for i in range(len(W.ZERO_SHAPES)):
            np.testing.assert_allclose(got["zero_%s_%d" % (name, i)],
                                       want[r][i], rtol=tol, atol=tol,
                                       err_msg="rank %d key %d" % (r, i))


# ------------------------------------------------------- data-parallel steps
def _ref_steps(world):
    """The reference's ShardedTrainStep (plain, bucketed, ZeRO-1) and
    FusedTrainStep on a `data` mesh of `world` CPU devices, fed the
    global batch that the ranks split."""
    import jax
    from mxnet_tpu.parallel import LLAMA_RULES as JRULES
    from mxnet_tpu.parallel import ShardedTrainStep as JStep
    mesh = jmx.parallel.create_mesh(data=world)
    w0 = W.mlp_weights()

    def loss_fn(p, b):
        h = jax.nn.relu(b["x"] @ p["w1"].T + p["b1"])
        return ((h @ p["w2"].T + p["b2"] - b["y"]) ** 2).mean()

    steps = {}
    for name, kw in W.STEP_VARIANTS:
        params = {k: jnp.asarray(w) for k, w in
                  zip(("w1", "b1", "w2", "b2"), w0)}
        step = JStep(loss_fn, params, mesh, rules=JRULES, optimizer="adam",
                     lr=0.01, donate=False, **kw)
        p, st = step.init()
        for s in range(W.STEPS):
            x, y = W.mlp_batch(s)
            p, st, loss = step(p, st, {"x": jnp.asarray(x),
                                       "y": jnp.asarray(y)})
        steps[name] = ({k: np.asarray(v) for k, v in p.items()},
                       np.asarray(loss))
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(W.HID, in_units=W.IN, activation="relu"),
            jmx.gluon.nn.Dense(W.OUT, in_units=W.HID))
    net.initialize()
    for prm, w in zip(net.collect_params().values(), w0):
        prm.set_data(jmx.nd.array(w))
    tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    fstep = jmx.gluon.FusedTrainStep(net, jmx.gluon.loss.L2Loss(), tr,
                                     mesh=mesh, bucket_mb=W.FUSED_BUCKET_MB)
    fstep = fstep.rebuild_for_mesh(mesh)
    for s in range(W.STEPS):
        x, y = W.mlp_batch(s)
        floss = fstep(jmx.nd.array(x), jmx.nd.array(y))
    fused = [q.data().asnumpy() for q in net.collect_params().values()]
    return steps, fused, np.asarray(floss.asnumpy())


def test_data_parallel_steps_match_the_whole_batch(ranks):
    """Each rank's steps on its slice of the batch against the reference's
    steps on a `data` mesh of as many CPU devices, fed the whole batch:
    ShardedTrainStep within 2e-6, FusedTrainStep within 1e-5 (gloo and
    XLA sum the ranks' gradients in different orders)."""
    world, res = ranks
    steps, fused, floss = _ref_steps(world)
    for name, _ in W.STEP_VARIANTS:
        _same_on_every_rank(res, "sts_%s_" % name)
        want, wloss = steps[name]
        for k, v in want.items():
            np.testing.assert_allclose(res[0]["sts_%s_%s" % (name, k)], v,
                                       rtol=2e-6, atol=2e-6,
                                       err_msg=name + k)
        np.testing.assert_allclose(res[0]["sts_%s_loss" % name], wloss,
                                   rtol=2e-6)
    got = _same_on_every_rank(res, "fused_")
    for g, w in zip(got[:-1], fused):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res[0]["fused_loss"], floss, rtol=1e-5)


def test_tensor_parallel_rules_raise_naming_queue_a5b(ranks):
    """Tensor parallelism (ROADMAP Queue A 5b) no longer raises: on a
    data=world/2, model=2 mesh each rank keeps its ``model`` block of w1,
    gathered on use, and the steps match the reference's GSPMD step on the
    same mesh of CPU devices fed the whole batch within 2e-6, every rank
    gathering the same parameters."""
    import jax
    from mxnet_tpu.parallel import ShardedTrainStep as JStep
    from jax.sharding import PartitionSpec as JP
    from mxnet_tpu.parallel import ShardingRules as JRules
    world, res = ranks
    mesh = jmx.parallel.create_mesh(data=world // 2, model=2)

    def loss_fn(p, b):
        h = jax.nn.relu(b["x"] @ p["w1"].T + p["b1"])
        return ((h @ p["w2"].T + p["b2"] - b["y"]) ** 2).mean()

    params = {k: jnp.asarray(w) for k, w in
              zip(("w1", "b1", "w2", "b2"), W.mlp_weights())}
    step = JStep(loss_fn, params, mesh, rules=JRules(
        [(pat, JP(*spec)) for pat, spec in W.TP_RULES]),
        optimizer="adam", lr=0.01, donate=False)
    p, st = step.init()
    for s in range(W.STEPS):
        x, y = W.mlp_batch(s)
        p, st, loss = step(p, st, {"x": jnp.asarray(x),
                                   "y": jnp.asarray(y)})
    _same_on_every_rank(res, "tp_")
    for r in res:
        assert tuple(r["tp_w1_block"]) == (W.HID, W.IN // 2)
    for k, v in p.items():
        np.testing.assert_allclose(res[0]["tp_" + k], np.asarray(v),
                                   rtol=2e-6, atol=2e-6, err_msg=k)
    np.testing.assert_allclose(res[0]["tp_loss"], np.asarray(loss),
                               rtol=2e-6)


# ------------------------------------------------------------- rendezvous
def test_env_spec_from_dmlc_matches_reference():
    from mxnet_tpu.parallel.dist import env_spec_from_dmlc as ref_spec
    env = {"DMLC_PS_ROOT_URI": "10.0.0.7", "DMLC_PS_ROOT_PORT": "9123",
           "DMLC_NUM_WORKER": "4", "DMLC_WORKER_ID": "3"}
    mine, ref = dist.env_spec_from_dmlc(env), ref_spec(env)
    assert mine["init_method"] == "tcp://" + ref["coordinator_address"]
    assert mine["world_size"] == ref["num_processes"] == 4
    assert mine["rank"] == ref["process_id"] == 3
    assert dist.env_spec_from_dmlc({}) is None and ref_spec({}) is None
    env2 = {"DMLC_PS_ROOT_URI": "10.0.0.7", "DMLC_RANK": "1"}
    assert dist.env_spec_from_dmlc(env2)["rank"] == ref_spec(env2)[
        "process_id"] == 1
    assert dist.env_spec_from_dmlc(env2)["init_method"].endswith(":9091")
    assert dist.env_spec_from_dmlc(
        {"DMLC_PS_ROOT_URI": "file:///tmp/x"})["init_method"] == \
        "file:///tmp/x"


def test_launcher_environment_matches_the_reference_launcher():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import launch as ref_launch
    finally:
        sys.path.pop(0)

    class Args:
        root_uri, root_port, num_workers, num_servers = "1.2.3.4", 77, 4, 0

    for rank in range(4):
        ref = ref_launch.build_env(rank, Args)
        mine = build_env(rank, 4, "1.2.3.4", 77, base={})
        for k, v in ref.items():
            if k.startswith("DMLC_"):
                assert mine[k] == v, k
        assert mine["LOCAL_RANK"] == str(rank)
        assert mine["LOCAL_WORLD_SIZE"] == "4"
    assert build_env(0, 2, backend="gloo", base={})[
        "MXNET_TPU_DIST_BACKEND"] == "gloo"


def test_launcher_ends_the_group_on_a_failed_rank_and_on_timeout():
    code = ("import os, sys, time; r = int(os.environ['DMLC_WORKER_ID']);"
            " sys.exit(3) if r == 1 else time.sleep(60)")
    assert launch_local([sys.executable, "-c", code], 3, timeout=30) == 3
    hang = "import time; time.sleep(60)"
    assert launch_local([sys.executable, "-c", hang], 2, timeout=1) == 124
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
         "--launcher", "local", sys.executable, "-c",
         "import os; print(os.environ['DMLC_WORKER_ID'])"],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0
    assert sorted(out.stdout.split()) == ["0", "1"]


def test_backend_follows_the_device_and_nccl_needs_a_card(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_DIST_BACKEND", raising=False)
    assert dist._pick_backend("gloo") == "gloo"
    if torch.cuda.is_available():
        assert dist._pick_backend(None) == "nccl"
    else:
        with pytest.raises(RuntimeError, match="NCCL"):
            dist._pick_backend(None)
        with pytest.raises(RuntimeError, match="NCCL"):
            dist._pick_backend("nccl")
    monkeypatch.setenv("MXNET_TPU_DIST_BACKEND", "gloo")
    assert dist._pick_backend(None) == "gloo"


def test_one_process_collectives_are_the_identity():
    from mxnet_tpu_torch.parallel import collectives as C
    assert not dist.has_group()
    x = torch.arange(6.0).reshape(3, 2)
    for fn in (C.all_reduce, C.all_gather, C.reduce_scatter):
        y = fn(x)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert torch.equal(C.ppermute(x, None, [(0, 0)]), x)
    r = C.allreduce_bench(size_mb=0.01, iters=1, device="cpu")
    assert r["world"] == 1 and r["bus_gbps"] == 0 and r["backend"] is None


def test_mesh_and_sharding_on_one_process():
    from mxnet_tpu_torch.parallel import (LLAMA_RULES, Mesh, P,
                                          ShardingRules, create_mesh,
                                          mesh_scope, shard_pytree)
    from mxnet_tpu.parallel import sharding as jsh
    mesh = create_mesh(data=1)
    assert mesh.shape["data"] == 1 and mesh.group("data") is None
    with mesh_scope(mesh):
        assert mx.parallel.current_mesh() is mesh
    with pytest.raises(ValueError, match="ranks"):
        create_mesh(data=2)
    # the rules tables and their pruning are the reference's
    jmesh = jmx.parallel.create_mesh(data=2, model=2)
    names = ["layers/0/attn/wq", "layers/0/mlp/w2", "tok_embeddings",
             "norm/scale"]
    mine_mesh = Mesh(np.arange(4).reshape(2, 1, 1, 2, 1),
                     ("data", "fsdp", "seq", "model", "expert"))
    for name in names:
        want = jsh.LLAMA_RULES.spec_for(name, (8, 8), jmesh)
        mine = LLAMA_RULES.spec_for(name, (8, 8), mine_mesh)
        assert tuple(mine) == tuple(want), name
    tree = {"a": torch.ones(4, 2), "b": {"c": torch.zeros(3)}}
    assert shard_pytree(tree, ShardingRules([("a", P("data"))]),
                        mesh)["a"].shape == (4, 2)
