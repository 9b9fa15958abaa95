"""Rank program of the port's resilience, integrity and sharded-checkpoint
tests across ranks.

Started by `mxnet_tpu_torch.launch.launch_local` (one process per rank,
gloo, a FileStore under the test's tmp_path):

    python tests/_torch_resilience_worker.py <mode> <out_dir>

It imports only the port, runs on one thread, runs the checks of `mode`
and writes this rank's arrays to ``<out_dir>/rank<r>.npz``:

``resilience``  (world 4) the restore election over the rendezvous
                store with one rank a prepared step ahead; a coordinated
                run whose save dies mid-commit on one rank (the others
                time out), then every rank resumes at the elected step;
                elastic shrink (data=4 to data=2) and grow-back (data=2
                to data=4) of a `ShardedTrainStep` under the runner;
``ckpt``        (world 4) `save_sharded`/`restore_sharded` across meshes
                and coordinated, `restore_train_state` re-laying a
                ``zero=True`` state, and the world-4 ZeRO state round trip;
``zero2``       (world 2) the ZeRO state round trip and its restore at
                world 1's layout;
``checksum``    (world 2) the dist kvstore's wire checksum.

The data are drawn with numpy from fixed seeds and shared with the tests.
"""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

STEPS = 6


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, "%s/%s" % (prefix, k) if prefix else k)
    else:
        yield prefix, tree


# ------------------------------------------------------------ shared data
def linear_data(steps=STEPS):
    """Binary data: the linear model's gradients sum exactly in any order,
    so runs over different meshes agree bit for bit."""
    rng = np.random.RandomState(11)
    return (rng.randint(0, 2, (steps, 16, 4)).astype(np.float32),
            rng.randint(0, 2, (steps, 16, 2)).astype(np.float32))


def linear_loss(params, batch):
    return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean()


def linear_step(mesh):
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    return ShardedTrainStep(linear_loss, {"w": torch.zeros(4, 2)}, mesh,
                            optimizer="sgd", lr=0.5, momentum=0.5)


def linear_batch(i):
    X, Y = linear_data()
    return {"x": torch.from_numpy(X[i]), "y": torch.from_numpy(Y[i])}


CKPT_TREE_SHAPES = {"embed": (8, 6), "layers/0/attn/wq": (6, 4),
                    "layers/0/attn/wo": (4, 6), "norm": (6,)}


def ckpt_tree():
    rng = np.random.RandomState(21)
    tree = {}
    for name, shape in CKPT_TREE_SHAPES.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = rng.randn(*shape).astype(np.float32)
    return tree


def zero_grads(step):
    rng = np.random.RandomState(300 + step)
    return [rng.randn(*s).astype(np.float32) for s in ZERO_SHAPES]


ZERO_SHAPES = [(5, 3), (7,), (4, 4), (9,)]


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


# ----------------------------------------------------------------- checks
def _mesh(**axes):
    from mxnet_tpu_torch.parallel import create_mesh
    return create_mesh(**axes)


def check_election(rank, world, tmp):
    """Every rank checkpoints steps 1-4; rank 1 prepares step 5 (crashed
    mid-commit). The restore election over the store lands every rank on
    step 4, and each restores it."""
    from mxnet_tpu_torch import resilience as rz
    ck = rz.SnapshotCheckpointer(os.path.join(tmp, "elect%d" % rank))
    for s in (1, 2, 3, 4):
        ck.save(s, {"step": s})
    if rank == 1:
        ck.prepare(5, {"step": 5})
    coord = rz.CommitCoordinator(timeout_s=60, namespace="test.elect")
    elected = coord.elect(max(ck.prepared_steps()), kind="restore")
    step, tree = ck.restore(elected)
    return {"elect/step": np.array([elected, step, tree["step"]])}


def _runner(step, p, o, ck, **kw):
    from mxnet_tpu_torch import resilience as rz
    return rz.ResilientRunner.for_sharded_step(
        step, p, o, linear_batch, ckpt_dir=ck, **kw)


def check_mid_commit(rank, world, tmp):
    """A coordinated run (ckpt_every=2) whose third save dies mid-commit
    on rank 1: rank 1 raises the preemption, the others the election's
    timeout; then every rank resumes (fresh coordinators) at the elected
    step and the final weights equal the fault-free run's."""
    from mxnet_tpu_torch import resilience as rz
    from mxnet_tpu_torch.resilience import faults
    mesh = _mesh(data=world)
    out = {}
    step = linear_step(mesh)
    p, o = step.init()
    for i in range(STEPS):
        p, o, _ = step(p, o, step.shard_batch(linear_batch(i)), i)
    out["commit/clean"] = step.gather(p)["w"].numpy().copy()
    ck = os.path.join(tmp, "commit%d" % rank)
    step = linear_step(mesh)
    p, o = step.init()
    plan = "checkpoint.save:preempt:3" if rank == 1 else ""
    runner = _runner(step, p, o, ck, ckpt_every=2, max_restarts=2,
                     commit=rz.CommitCoordinator(timeout_s=5,
                                                 namespace="test.run1"))
    err = ""
    with faults.inject(plan):
        try:
            runner.run(STEPS)
        except rz.RetriableError as exc:
            err = type(exc).__name__
    out["commit/error"] = np.array(err)
    marker = rz.SnapshotCheckpointer(ck)
    out["commit/durable"] = np.array([marker.latest_step(),
                                      max(marker.prepared_steps())])
    runner = _runner(runner.active["step"], runner.holder["params"],
                     runner.holder["opt_state"], ck, ckpt_every=2,
                     max_restarts=2,
                     commit=rz.CommitCoordinator(timeout_s=60,
                                                 namespace="test.run2"))
    report = runner.run(STEPS, resume=True)
    out["commit/first"] = np.array(
        next(i for i, l in enumerate(report.losses) if l is not None))
    out["commit/final"] = runner.active["step"].gather(
        runner.holder["params"])["w"].numpy().copy()
    return out


def check_elastic(rank, world, tmp):
    """Shrink: a preemption on every rank at the fourth step, and the mesh
    factory now answers data=2: ranks 0-1 go on from the restored step,
    ranks 2-3 stand by; the weights equal an uninterrupted data=2 run's.
    Grow-back: a run starting on data=2 (ranks 2-3 standing by) sees
    data=4 at the step-2 boundary and re-lays the live state; the weights
    equal an uninterrupted data=4 run's. The meshes are made once, on
    every rank, before the runs."""
    from mxnet_tpu_torch.resilience import faults
    meshes = {4: _mesh(data=4), 2: _mesh(data=2)}
    out = {}
    for n in (2, 4):
        if rank < n:
            step = linear_step(meshes[n])
            p, o = step.init()
            losses = []
            for i in range(STEPS):
                p, o, loss = step(p, o, step.shard_batch(linear_batch(i)),
                                  i)
                losses.append(loss.item())
            out["elastic/clean%d" % n] = step.gather(p)["w"].numpy().copy()
            out["elastic/clean%d_losses" % n] = np.array(losses)
    for name, start, end, plan in (("shrink", 4, 2, "run.step:preempt:4"),
                                   ("grow", 2, 4, "")):
        calls = {"n": 0}

        def factory(start=start, end=end, calls=calls):
            # the runner's construction and the step-0 boundary see the
            # first mesh, every later poll the second
            calls["n"] += 1
            return meshes[start if calls["n"] <= 2 else end]

        step = linear_step(meshes[start])
        p, o = step.init() if rank < start else (None, None)
        with faults.inject(plan):
            runner = _runner(step, p, o, os.path.join(tmp, "%s%d" % (
                name, rank)), ckpt_every=2, max_restarts=2,
                mesh_factory=factory)
            report = runner.run(STEPS)
        cur = runner.active["step"]
        out["%s/counts" % name] = np.array(
            [report.restarts, report.mesh_shrinks, report.mesh_grows,
             cur.mesh.size])
        if rank < end:
            out["%s/final" % name] = cur.gather(
                runner.holder["params"])["w"].numpy().copy()
            out["%s/losses" % name] = np.array(
                [np.nan if l is None else l for l in report.losses])
            out["%s/block" % name] = np.array(
                runner.holder["params"]["w"].shape)
        else:
            out["%s/standby" % name] = np.array(
                runner.holder["params"] is None)
    return out


def check_sharded_ckpt(rank, world, tmp):
    """`save_sharded` of blocks on fsdp=2, model=2 (whole leaves on
    disk), restored on data=4 and on model=4 by the rules and by a
    template, coordinated; a torn newest step falls back."""
    from mxnet_tpu_torch.parallel import ShardingRules, checkpoint, mesh_scope
    from mxnet_tpu_torch.parallel.sharding import (gather_block,
                                                   register_block,
                                                   shard_pytree)
    from mxnet_tpu_torch.resilience.errors import CheckpointCorruptError
    rules = ShardingRules([(r"embed", ("model", "fsdp")),
                           (r"wq", ("fsdp", "model")),
                           (r"wo", ("model", "fsdp"))])
    whole = _torch(ckpt_tree())
    out = {}
    m1 = _mesh(fsdp=2, model=2)
    blocks = shard_pytree(whole, rules, m1)
    specs = rules.tree_specs(whole, m1)
    for (name, x), (_, spec) in zip(_flat(blocks), _flat(specs)):
        register_block(x, m1, spec)
    root = os.path.join(tmp, "sharded")
    checkpoint.save_sharded(root, {"params": blocks, "step": 1}, step=1)
    checkpoint.save_sharded(root, {"params": blocks, "step": 2}, step=2,
                            coordinated=True)
    out["ckpt/committed"] = np.array(checkpoint.latest_committed_step(root))
    for tag, mesh in (("data4", _mesh(data=4)), ("model4", _mesh(model=4)),
                      ("m1", m1)):
        got = checkpoint.restore_sharded(root, mesh=mesh, rules=rules,
                                         device="cpu", coordinated=True)
        for name, x in _flat(got["params"]):
            out["ckpt/%s/%s" % (tag, name)] = x.numpy().copy()
        # the whole leaves back from the restored blocks
        with mesh_scope(mesh):
            for name, x in _flat(got["params"]):
                out["ckpt/%s/whole/%s" % (tag, name)] = \
                    gather_block(x).numpy().copy()
    tmpl = checkpoint.restore_sharded(root, template={"params": blocks,
                                                      "step": 0})
    same = all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_flat(tmpl["params"]), _flat(blocks)))
    out["ckpt/template_same"] = np.array(bool(same))
    # a torn newest step: every rank reads the fallback
    from mxnet_tpu_torch.parallel import collectives
    collectives.barrier()
    if rank == 0:
        with open(os.path.join(root, "2", "state.pt"), "r+b") as f:
            f.truncate(64)
    collectives.barrier()
    got = checkpoint.restore_sharded(root, device="cpu")
    out["ckpt/fallback_step"] = np.array(got["step"])
    collectives.barrier()
    if rank == 0:
        with open(os.path.join(root, "1", "state.pt"), "r+b") as f:
            f.truncate(64)
    collectives.barrier()
    try:
        checkpoint.restore_sharded(root, device="cpu")
        out["ckpt/all_corrupt"] = np.array("")
    except CheckpointCorruptError as exc:
        out["ckpt/all_corrupt"] = np.array(str(exc.steps_tried))
    return out


def check_zero_train_state(rank, world, tmp):
    """`restore_train_state` of a ``zero=True`` step on data=2, model=2:
    each rank's parameter blocks and the ``data`` blocks of its slots come
    back bit for bit, and the restored state trains on exactly as the
    live one."""
    from mxnet_tpu_torch.models import llama as T
    from mxnet_tpu_torch.parallel import (LLAMA_RULES, ShardedTrainStep,
                                          restore_train_state,
                                          save_train_state)
    cfg = T.LlamaConfig(vocab_size=64, dim=32, n_layers=1, n_heads=4,
                        n_kv_heads=2, hidden_dim=64, max_seq_len=16,
                        dtype=torch.float32)
    params = T.llama_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    mesh = _mesh(data=2, model=2)
    step = ShardedTrainStep(lambda p, b: T.llama_loss(p, b, cfg), params,
                            mesh, rules=LLAMA_RULES, optimizer="adamw",
                            lr=1e-3, zero=True)
    p, o = step.init()
    rng = np.random.RandomState(5)
    toks = [torch.from_numpy(rng.randint(0, 64, (4, 9))) for _ in range(3)]
    p, o, _ = step(p, o, step.shard_batch({"tokens": toks[0]}))
    path = os.path.join(tmp, "zero_state")
    save_train_state(path, p, o, 1)
    rp, ro, rs = restore_train_state(path, device="cpu", mesh=mesh,
                                     rules=LLAMA_RULES)
    same = rs == 1 and ro["t"] == o["t"]
    for (_, a), (_, b) in zip(_flat(rp), _flat(p)):
        same = same and a.shape == b.shape and torch.equal(a, b)
    for slot in ("m", "v"):
        for (_, a), (_, b) in zip(_flat(ro[slot]), _flat(o[slot])):
            same = same and a.shape == b.shape and torch.equal(a, b)
    for t in toks[1:]:
        p, o, _ = step(p, o, step.shard_batch({"tokens": t}))
        rp, ro, _ = step(rp, ro, step.shard_batch({"tokens": t}))
    for (_, a), (_, b) in zip(_flat(rp), _flat(p)):
        same = same and torch.equal(a, b)
    return {"zero_state/same": np.array(bool(same))}


def _zero_updater(world, rank, opt=None):
    from mxnet_tpu_torch.kvstore.kvstore_dist import DistZeroComm
    from mxnet_tpu_torch.optimizer import create
    from mxnet_tpu_torch.optimizer.zero import ZeroComm, ZeroUpdater
    opt = opt or create("adam", learning_rate=0.01)
    comm = DistZeroComm() if world > 1 else ZeroComm()
    return ZeroUpdater(opt, comm=comm, cap_bytes=64)


def _zero_weights():
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(4)
    return [mx.nd.array(rng.randn(*s).astype(np.float32), ctx=mx.cpu())
            for s in ZERO_SHAPES]


def check_zero_state(rank, world, tmp):
    """ZeRO state saved at this world and restored at this world: the
    payload round-trips bit for bit, and the next step of the restored
    updater (its optimizer's update counts copied, as a Trainer's
    `save_states` carries them) equals the live one's."""
    import copy
    from mxnet_tpu_torch.parallel import restore_zero_state, save_zero_state
    keys = [str(i) for i in range(len(ZERO_SHAPES))]
    upd = _zero_updater(world, rank)
    w = _zero_weights()
    for s in range(2):
        upd.step(keys, [torch.from_numpy(g) for g in zero_grads(s)], w)
    path = os.path.join(tmp, "zero%d" % world)
    save_zero_state(path, upd, step=2)
    upd2 = restore_zero_state(path, _zero_updater(
        world, rank, copy.deepcopy(upd.optimizer)))
    a, b = upd.state_payload(), upd2.state_payload()
    same = a["layout"] == b["layout"]
    for bucket, slots in a["state"].items():
        for name, arr in slots.items():
            same = same and np.array_equal(arr, b["state"][bucket][name])
    w2 = [x.copy() for x in w]
    upd.step(keys, [torch.from_numpy(g) for g in zero_grads(2)], w)
    upd2.step(keys, [torch.from_numpy(g) for g in zero_grads(2)], w2)
    same = same and all(torch.equal(x._data, y._data)
                        for x, y in zip(w, w2))
    out = {"zero%d/same" % world: np.array(bool(same))}
    if world > 1:
        # the state saved at this world, laid out for one rank
        from mxnet_tpu_torch.optimizer.zero import ZeroComm, ZeroUpdater
        one = restore_zero_state(path, ZeroUpdater(
            copy.deepcopy(upd2.optimizer), comm=ZeroComm(), cap_bytes=64))
        c = one.state_payload()
        out["zero%d/to_world1" % world] = np.array(bool(
            all(np.array_equal(arr, c["state"][bucket][name])
                for bucket, slots in b["state"].items()
                for name, arr in slots.items())))
    for i, x in enumerate(w):
        out["zero%d/w%d" % (world, i)] = x.asnumpy()
    return out


def check_checksum(rank, world, tmp):
    """The wire checksum: every bucket of a push is counted; a NaN pushed
    by one rank makes every rank raise DivergenceError at
    ``kvstore_dist.bucket`` before any write."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine, telemetry
    from mxnet_tpu_torch.kvstore.kvstore_dist import KVStoreDist
    from mxnet_tpu_torch.resilience.errors import DivergenceError
    os.environ["MXNET_TPU_COMM_CHECKSUM"] = "1"
    out = {}
    with engine.bucket_mb_scope(25):
        kv = KVStoreDist("dist_sync")
        for k in range(4):
            kv.init(k, mx.nd.zeros((3,), ctx=mx.cpu()))
        before = telemetry.counter_value("comm.checksum.buckets")
        kv.push(list(range(4)),
                [mx.nd.array(np.full(3, float(k + 1 + rank), np.float32),
                             ctx=mx.cpu()) for k in range(4)])
        out["checksum/buckets"] = np.array(
            telemetry.counter_value("comm.checksum.buckets") - before)
        got = mx.nd.zeros((3,), ctx=mx.cpu())
        kv.pull(2, out=got)
        out["checksum/summed"] = got.asnumpy()
        bad = [mx.nd.array(np.full(3, float(k), np.float32), ctx=mx.cpu())
               for k in range(4)]
        if rank == 1:
            bad[2] = mx.nd.array(np.array([1.0, np.nan, 2.0], np.float32),
                                 ctx=mx.cpu())
        site = ""
        try:
            kv.push(list(range(4)), bad)
        except DivergenceError as exc:
            site = exc.site
        out["checksum/site"] = np.array(site)
        kv.pull(2, out=got)
        out["checksum/after"] = got.asnumpy()
    return out


MODES = {"resilience": (check_election, check_mid_commit, check_elastic),
         "ckpt": (check_sharded_ckpt, check_zero_train_state,
                  check_zero_state),
         "zero2": (check_zero_state,),
         "checksum": (check_checksum,)}


def main():
    mode, out_dir = sys.argv[1], sys.argv[2]
    from mxnet_tpu_torch.parallel import dist
    dist.initialize(backend="gloo")
    rank, world = dist.rank(), dist.num_workers()
    res = {}
    for fn in MODES[mode]:
        res.update(fn(rank, world, out_dir))
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
    dist.shutdown()


if __name__ == "__main__":
    main()
