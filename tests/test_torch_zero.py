"""The port's gradient buckets, ZeRO-1 updater and local kvstore against the
JAX package's.

Buckets, specs and layouts must match the reference's key for key. The
ZeroUpdater at world 1 (the identity exchange) is held against the
reference's ZeroUpdater over the same keys, weights and gradients (numpy,
from a seed): SGD and Adam within 1e-5 relative (the flat kernels' plain
versions against XLA, which may contract multiply-adds into FMAs), LAMB
within rtol 5e-5 / atol 5e-6, the reference's own bound for its flat LAMB
against the per-parameter one (the norms are summed in another order). At
world 2 and 4 a threaded in-process fleet (the reference test's FakeFleet,
on torch tensors) exchanges the shards, and every rank's weights are held
against the port's replicated per-parameter update of the rank-summed
gradients.
"""
import pickle
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine
from mxnet_tpu.optimizer import ZeroUpdater as JZeroUpdater
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine
from mxnet_tpu_torch.kvstore import KVStoreLocal, create
from mxnet_tpu_torch.optimizer import ZeroComm, ZeroUpdater, zero_enabled

LAMB_RTOL, LAMB_ATOL = 5e-5, 5e-6
FLAT_REL = 1e-5
SHAPES = [(7, 3), (11,), (6, 5), (9,)]       # 71 elements: straddles shards

OPTS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
            "clip_gradient": 0.5},
    "adam": {"learning_rate": 0.01, "wd": 1e-3},
    "lamb": {"learning_rate": 0.01, "wd": 0.01, "lower_bound": 0.5,
             "upper_bound": 2.0},
}


def _state(shapes, steps, world=1, seed=0):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[[(rng.randn(*s) * 0.1).astype(np.float32) for s in shapes]
           for _ in range(world)] for _ in range(steps)]
    return ws, gs


def _assert_close(got, want, kind):
    for g, w in zip(got, want):
        if kind == "lamb":
            np.testing.assert_allclose(g, w, rtol=LAMB_RTOL, atol=LAMB_ATOL)
        else:
            err = np.abs(g - w).max()
            assert err <= FLAT_REL * max(np.abs(w).max(), 1e-30), err


# ----------------------------------------------------------------- engine
ENTRIES = [((4, 4), "float32"), ((1000,), "float32"), ((3,), "float32"),
           ((0,), "float32"), ((8, 8), "bfloat16"), ((2,), "bfloat16"),
           ((300,), "float32"), ((5,), "float32")]


def _entries(pkg_tensor):
    return [(str(i), pkg_tensor(shape, dt)) for i, (shape, dt)
            in enumerate(ENTRIES)]


@pytest.mark.parametrize("cap", [0, 400, 4096])
def test_bucketize_matches_reference(cap):
    """Caps, dtype splits, oversize gradients and skipped empty ones give
    the reference's buckets."""
    mine = engine.bucketize(_entries(
        lambda s, d: torch.zeros(s, dtype=getattr(torch, d))), cap)
    theirs = jengine.bucketize(_entries(
        lambda s, d: jnp.zeros(s, getattr(jnp, d))), cap)
    assert [(b.keys, b.shapes, b.dtype, b.reason, b.nbytes) for b in mine] \
        == [(b.keys, b.shapes, str(b.dtype), b.reason, b.nbytes)
            for b in theirs]


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_layout_specs_and_shard_segments_match_reference(world):
    mine = engine.BucketLayout.from_entries(_entries(
        lambda s, d: torch.zeros(s, dtype=getattr(torch, d))), world, 400)
    theirs = jengine.BucketLayout.from_entries(_entries(
        lambda s, d: jnp.zeros(s, getattr(jnp, d))), world, 400)
    assert mine.to_payload() == theirs.to_payload()
    assert mine.keys() == theirs.keys()
    for a, b in zip(mine, theirs):
        assert (a.size, a.padded, a.shard, a.nbytes()) == \
            (b.size, b.padded, b.shard, b.nbytes())
        for r in range(world):
            assert a.shard_segments(r) == b.shard_segments(r)
    back = engine.BucketLayout.from_payload(theirs.to_payload(), world=2)
    assert back.world == 2 and back.keys() == mine.keys()
    with pytest.raises(ValueError, match="frozen"):
        mine.assert_matches(list(reversed(mine.keys())))
    mine.assert_matches(theirs.keys())


def test_pack_unpack_round_trip_with_padding():
    spec = engine.BucketSpec(0, ["a", "b"], [(2, 3), (5,)], "bfloat16", 4)
    assert (spec.size, spec.padded, spec.shard) == (11, 12, 3)
    raws = [torch.arange(6.0).reshape(2, 3), torch.arange(5.0) + 10]
    flat = engine.pack_flat(spec, raws)
    assert flat.dtype == torch.bfloat16 and flat.shape == (12,)
    assert flat[-1].item() == 0.0
    for got, want in zip(engine.unpack_flat(spec, flat), raws):
        assert got.shape == want.shape
        assert torch.equal(got.float(), want)


def test_bucket_cap_from_the_environment(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_COMM_BUCKET_MB", "2")
    assert engine.bucket_bytes() == 2 * 1024 * 1024
    monkeypatch.setenv("MXNET_TPU_COMM_BUCKET_MB", "0")
    assert engine.bucket_bytes() == 0
    assert engine.bucket_bytes(1) == 1024 * 1024
    monkeypatch.delenv("MXNET_TPU_COMM_BUCKET_MB")
    assert engine.bucket_bytes() == 25 * 1024 * 1024


# ------------------------------------------------------- updater, world 1
def _port_zero(kind, shapes, ws, gs, cap, comm=None, dtype="float32"):
    zu = ZeroUpdater(mx.optimizer.create(kind, **OPTS[kind]), comm=comm,
                     cap_bytes=cap)
    keys = [str(i) for i in range(len(shapes))]
    w_nd = [mx.nd.array(w, ctx=mx.cpu(), dtype=dtype) for w in ws]
    rank = 0 if comm is None else comm.rank
    for step in gs:
        zu.step(keys, [torch.from_numpy(g).to(getattr(torch, dtype))
                       for g in step[rank]], w_nd)
    return zu, [np.asarray(w.asnumpy(), np.float32) for w in w_nd]


def _ref_zero(kind, shapes, ws, gs, cap, dtype="float32"):
    zu = JZeroUpdater(jmx.optimizer.create(kind, **OPTS[kind]),
                      cap_bytes=cap)
    keys = [str(i) for i in range(len(shapes))]
    w_nd = [jmx.nd.array(w, dtype=dtype) for w in ws]
    for step in gs:
        zu.step(keys, [jnp.asarray(g).astype(dtype) for g in step[0]], w_nd)
    return zu, [np.asarray(w.asnumpy(), np.float32) for w in w_nd]


@pytest.mark.parametrize("kind", ["sgd", "adam", "lamb"])
def test_zero_world1_matches_reference_zero_updater(kind):
    """Three steps over four keys in two buckets (a 200-byte cap)."""
    ws, gs = _state(SHAPES, 3)
    zu, got = _port_zero(kind, SHAPES, ws, gs, 200)
    rzu, want = _ref_zero(kind, SHAPES, ws, gs, 200)
    assert zu.layout.to_payload() == rzu.layout.to_payload()
    assert len(zu.layout) == 2
    _assert_close(got, want, kind)
    assert zu.state_bytes_per_rank() == rzu.state_bytes_per_rank()


def test_zero_lamb_bf16_matches_reference_zero_updater():
    """bf16 weights, gradients and moments (the bucket dtype): both
    packages compute in fp32 and round once per output, so they agree
    within one bf16 rounding of the weights."""
    ws, gs = _state(SHAPES, 2, seed=3)
    _, got = _port_zero("lamb", SHAPES, ws, gs, None, dtype="bfloat16")
    _, want = _ref_zero("lamb", SHAPES, ws, gs, None, dtype="bfloat16")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6)


def test_zero_refuses_other_optimizers_and_comm_entry_points():
    with pytest.raises(ValueError, match="SGD, Adam and LAMB"):
        ZeroUpdater(mx.optimizer.SGD.__base__())
    zu = ZeroUpdater(mx.optimizer.create("lamb"))
    # the readiness entry points are ported; a round needs a frozen layout
    with pytest.raises(RuntimeError, match="frozen layout"):
        zu.finish_ready([], {})


def test_zero_enabled_flag_and_environment(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_ZERO", raising=False)
    assert not zero_enabled() and zero_enabled(True)
    monkeypatch.setenv("MXNET_TPU_ZERO", "1")
    assert zero_enabled() and not zero_enabled(False)


# ----------------------------------------------- updater, world 2 and 4
class FakeFleet:
    """One process, one thread per rank; the fleet is the exchange: a
    barrier'd mailbox that sums contributions in rank order (the order
    the replicated baseline sums them in)."""

    def __init__(self, world):
        self.world = world
        self.lock = threading.Lock()
        self.barrier = threading.Barrier(world)
        self.box = {}

    def comm(self, rank):
        return _FakeComm(self, rank)


class _FakeComm(ZeroComm):
    def __init__(self, fleet, rank):
        self._fleet = fleet
        self.rank = rank

    @property
    def world(self):
        return self._fleet.world

    def _exchange(self, tag, spec, value):
        fleet = self._fleet
        with fleet.lock:
            fleet.box.setdefault((tag, spec.index), {})[self.rank] = \
                value.clone()
        fleet.barrier.wait()
        # a copy: once past the second barrier a rank may deposit its next
        # exchange under the same key while another still reads this one
        parts = dict(fleet.box[(tag, spec.index)])
        fleet.barrier.wait()
        return parts

    def _sum(self, parts):
        total = parts[0].clone()
        for r in range(1, self.world):
            total = total + parts[r]
        return total

    def reduce_scatter(self, spec, flat):
        total = self._sum(self._exchange("rs", spec, flat))
        lo = self.rank * spec.shard
        return total[lo:lo + spec.shard].clone()

    def all_gather(self, spec, shard):
        parts = self._exchange("ag", spec, shard)
        return torch.cat([parts[r] for r in range(self.world)])

    def all_reduce(self, spec, value):
        return self._sum(self._exchange("ar", spec, value))


def _run_fleet(world, fn):
    fleet = FakeFleet(world)
    errs = [None] * world

    def wrap(rank):
        try:
            fn(rank, fleet.comm(rank))
        except BaseException as e:  # noqa: BLE001 - test harness
            errs[rank] = e
            fleet.barrier.abort()

    threads = [threading.Thread(target=wrap, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errs:
        if e is not None:
            raise e


def _replicated(kind, shapes, ws, gs):
    """The port's per-parameter Updater on the rank-summed gradients."""
    upd = mx.optimizer.get_updater(mx.optimizer.create(kind, **OPTS[kind]))
    w_nd = [mx.nd.array(w, ctx=mx.cpu()) for w in ws]
    for step in gs:
        for i in range(len(shapes)):
            total = step[0][i].copy()
            for r in range(1, len(step)):
                total = total + step[r][i]
            upd(i, mx.nd.array(total, ctx=mx.cpu()), w_nd[i])
    return [w.asnumpy() for w in w_nd]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["sgd", "adam", "lamb"])
def test_zero_fleet_matches_the_replicated_update(kind, world):
    """Keys straddle the shard boundaries, so LAMB's norms are right only
    if the per-key partials complete across ranks through all_reduce;
    bounds and weight decay are on."""
    ws, gs = _state(SHAPES, 3, world, seed=world)
    ref = _replicated(kind, SHAPES, ws, gs)
    outs = [None] * world
    states = [None] * world

    def run(rank, comm):
        zu, outs[rank] = _port_zero(kind, SHAPES, ws, gs, None, comm=comm)
        states[rank] = zu.state_bytes_per_rank()

    _run_fleet(world, run)
    for rank in range(world):
        _assert_close(outs[rank], ref, kind)
    total = sum(int(np.prod(s)) for s in SHAPES)
    slots = 1 if kind == "sgd" else 2
    padded = -(-total // world) * world
    assert states[0] == slots * 4 * padded // world


@pytest.mark.parametrize("kind", ["lamb", "adam"])
def test_zero_state_round_trip_and_resume(kind):
    """Save after one step at world 2, restore at world 1: one more step
    equals two uninterrupted steps (the payload is world-portable)."""
    ws, gs = _state(SHAPES, 2, 2, seed=9)
    summed = [[[g0 + g1 for g0, g1 in zip(*step)]] for step in gs]
    _, want = _port_zero(kind, SHAPES, ws, summed, None)
    payloads, mids = [None] * 2, [None] * 2

    def run(rank, comm):
        zu, mids[rank] = _port_zero(kind, SHAPES, ws, gs[:1], None,
                                    comm=comm)
        payloads[rank] = zu.get_states(dump_optimizer=True)

    _run_fleet(2, run)
    zu = ZeroUpdater(mx.optimizer.create(kind))
    zu.set_states(payloads[0])
    assert isinstance(zu.optimizer, type(mx.optimizer.create(kind)))
    assert zu.optimizer._index_update_count == {i: 1 for i in range(4)}
    keys = [str(i) for i in range(len(SHAPES))]
    w_nd = [mx.nd.array(w, ctx=mx.cpu()) for w in mids[0]]
    zu.step(keys, [torch.from_numpy(g) for g in summed[1][0]], w_nd)
    _assert_close([w.asnumpy() for w in w_nd], want, kind)
    payload = pickle.loads(payloads[0])
    assert payload["zero_format"] == 1 and payload["layout"]["world"] == 2


# ---------------------------------------------------------------- kvstore
def _nd(a):
    return mx.nd.array(np.asarray(a, np.float32), ctx=mx.cpu())


def test_kvstore_init_push_pull_pushpull():
    kv = create("local")
    assert isinstance(kv, KVStoreLocal) and kv.type == "local"
    assert create("device").type == "device" and create("nccl").type == \
        "device"
    kv.init(3, _nd([1.0, 2.0]))
    kv.init(["a", "b"], [_nd([0.0]), _nd([5.0, 5.0])])
    with pytest.raises(ValueError, match="duplicate"):
        kv.init(3, _nd([1.0, 2.0]))
    out = _nd([0.0, 0.0])
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), [1.0, 2.0])
    # no updater: the replicas' sum replaces the stored value
    kv.push(3, [_nd([1.0, 1.0]), _nd([2.0, 3.0])])
    kv.pull(3, out=[out])
    np.testing.assert_array_equal(out.asnumpy(), [3.0, 4.0])
    outs = [_nd([0.0]), _nd([0.0, 0.0])]
    kv.pushpull(["a", "b"], [_nd([7.0]), _nd([1.0, 2.0])], out=outs)
    np.testing.assert_array_equal(outs[0].asnumpy(), [7.0])
    np.testing.assert_array_equal(outs[1].asnumpy(), [1.0, 2.0])
    with pytest.raises(mx.MXNetError, match="not been initialized"):
        kv.push(9, _nd([1.0]))


def test_kvstore_with_an_updater_matches_the_updater():
    kv = create("device")
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
    kv.init(0, _nd([1.0, 2.0]))
    kv.push(0, [_nd([1.0, 1.0]), _nd([1.0, 3.0])])
    out = _nd([0.0, 0.0])
    kv.pull(0, out=out)
    np.testing.assert_allclose(out.asnumpy(), [0.0, 0.0])


def test_kvstore_zero_push_and_optimizer_states(tmp_path):
    ws, gs = _state(SHAPES, 2)
    kv = create("device")
    kv.set_optimizer(mx.optimizer.create("lamb", **OPTS["lamb"]), zero=True)
    assert isinstance(kv._updater, ZeroUpdater)
    keys = list(range(len(SHAPES)))
    kv.init(keys, [_nd(w) for w in ws])
    for step in gs:
        kv.push(keys, [_nd(g) for g in step[0]])
    outs = [_nd(np.zeros_like(w)) for w in ws]
    kv.pull(keys, out=outs)
    _, want = _port_zero("lamb", SHAPES, ws, gs, None)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.asnumpy(), w)
    f = str(tmp_path / "zero.states")
    kv.save_optimizer_states(f, dump_optimizer=True)
    kv2 = create("device")
    kv2.set_optimizer(mx.optimizer.create("lamb"), zero=True)
    kv2.load_optimizer_states(f)
    assert kv2._updater.layout.keys() == kv._updater.layout.keys()
    with pytest.raises(mx.MXNetError, match="compression"):
        kv.set_gradient_compression({"type": "2bit"})


def test_kvstore_refuses_what_comes_with_later_slices():
    """The dist stores and readiness sessions are ported; unknown types
    still raise."""
    assert create("dist_sync").type == "dist_sync"
    kv = create("local")
    assert kv.ready_session().finished is False
    with pytest.raises(ValueError, match="unknown"):
        create("nope")


def test_kvstore_row_sparse_pull_of_a_dense_key():
    """row_sparse_pull gathers the requested rows (sorted, deduped) of a
    dense stored value into a row-sparse out, as the reference's does."""
    w = np.arange(12, dtype=np.float32).reshape(6, 2)
    outs = []
    for pkg in (mx, jmx):
        with pkg.cpu():
            kv = pkg.kv.create("local")
            kv.init(0, pkg.nd.array(w))
            out = pkg.nd.sparse.zeros("row_sparse", (6, 2))
            kv.row_sparse_pull(0, out=out,
                               row_ids=pkg.nd.array(np.array([4, 1, 4])))
            outs.append((out.indices.asnumpy(), out.data.asnumpy()))
    np.testing.assert_array_equal(outs[0][0], [1, 4])
    np.testing.assert_array_equal(outs[0][1], w[[1, 4]])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
