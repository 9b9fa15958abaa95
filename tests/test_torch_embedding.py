"""The port's sharded embedding tables, lookup service and kvstore routing
against the JAX package's.

Both packages start from the same table (`weight=`, numpy from a seed: the
port draws its default table from a torch generator, the reference from
jax.random) and take the same ids and gradient rows. At world 1 the port is
held to the reference within 1e-6 of the table's largest magnitude (the
same fp32 formulas; XLA may contract multiply-adds into FMAs), untouched
rows exactly. At world 2 and 4 a threaded in-process fleet (the reference
test's FakeFleet, on torch tensors: rank-order sums and concatenations)
runs one table per rank, and every rank's gathered table and lookups are
held bit-equal to the port's world-1 table driven through the same merge
sequence. `bench.py::bench_sparse`'s loop at its CPU shape (50,000 x 32,
1024 ids a step, 6 steps) is held against the reference's kvstore in the
same way.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.embedding import ShardedEmbedding as JShardedEmbedding
from mxnet_tpu.ndarray import sparse as jsp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.embedding import (EmbeddingLookupService,
                                       ShardedEmbedding)
from mxnet_tpu_torch.embedding.serving import default_buckets
from mxnet_tpu_torch.ndarray import sparse as sp
from mxnet_tpu_torch.parallel.collectives import merge_unique_rows

REL = 1e-6
VOCAB, DIM = 11, 4          # no tested world divides 11: padded tail rows
OPTS = {
    "sgd": dict(optimizer="sgd", learning_rate=0.1, wd=0.01),
    "sgd_momentum": dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
                         wd=0.01),
    "adam": dict(optimizer="adam", learning_rate=0.05, wd=0.01),
}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * max(np.abs(want).max(), 1e-30)


def _weight(vocab=VOCAB, dim=DIM, seed=0):
    return np.random.RandomState(seed).randn(vocab, dim).astype(np.float32)


def _counters():
    return dict(telemetry.snapshot()["counters"])


def _delta(before, after, key):
    return after.get(key, 0) - before.get(key, 0)


def _table(**kw):
    return ShardedEmbedding(VOCAB, DIM, device="cpu", **kw)


# ---------------------------------------------------------------- world 1
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_world1_matches_reference(opt):
    rng = np.random.RandomState(1)
    w0 = _weight()
    mine = _table(weight=w0, **OPTS[opt])
    theirs = JShardedEmbedding(VOCAB, DIM, weight=w0, **OPTS[opt])
    touched = set()
    for _ in range(4):
        ids = rng.randint(-1, 8, size=9).astype(np.int32)   # repeats, pads
        grads = rng.randn(9, DIM).astype(np.float32)
        mine.apply_grads(torch.from_numpy(ids), torch.from_numpy(grads))
        theirs.apply_grads(jnp.asarray(ids), jnp.asarray(grads))
        touched |= set(ids[ids >= 0].tolist())
    got = mine.gathered_weight().numpy()
    want = np.asarray(theirs.gathered_weight())
    _close(got, want)
    untouched = sorted(set(range(VOCAB)) - touched)
    assert untouched
    np.testing.assert_array_equal(got[untouched], w0[untouched])
    for name in mine._state:
        _close(mine._state[name].numpy(), np.asarray(theirs._state[name]))
    probe = np.array([3, 7, 3, -1, 10, 0], np.int32)
    rows = mine.lookup(torch.from_numpy(probe)).numpy()
    _close(rows, np.asarray(theirs.lookup(jnp.asarray(probe))))
    assert not rows[3].any()


def test_default_init_is_seeded_and_scaled():
    a, b = _table(seed=3), _table(seed=3)
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(a.weight, _table(seed=4).weight)
    big = ShardedEmbedding(4000, 64, device="cpu", seed=0)
    assert abs(big.weight.std().item() - 64 ** -0.5) < 0.01
    with pytest.raises(ValueError, match="supports"):
        _table(optimizer="lamb")
    with pytest.raises(ValueError, match="weight shape"):
        _table(weight=np.zeros((3, 3), np.float32))


# ------------------------------------------------------------- fleets
class FakeFleet:
    """A barrier'd mailbox: each rank's table on its own thread; sums and
    concatenations in rank order."""

    def __init__(self, world):
        self.world = world
        self.lock = threading.Lock()
        self.barrier = threading.Barrier(world)
        self.box = {}

    def comm(self, rank):
        return _FleetComm(self, rank)


class _FleetComm:
    def __init__(self, fleet, rank):
        self._fleet = fleet
        self.rank = rank
        self.world = fleet.world
        self._calls = 0

    def _exchange(self, value):
        fleet, tag = self._fleet, self._calls
        self._calls += 1
        with fleet.lock:
            fleet.box.setdefault(tag, {})[self.rank] = value.clone()
        fleet.barrier.wait()
        with fleet.lock:
            parts = [fleet.box[tag][r] for r in range(self.world)]
        fleet.barrier.wait()
        return parts

    def all_reduce(self, x):
        parts = self._exchange(x)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def all_gather(self, x):
        return torch.cat(self._exchange(x))


def _run_fleet(world, fn):
    fleet = FakeFleet(world)
    errs = [None] * world

    def wrap(rank):
        try:
            fn(rank, fleet.comm(rank))
        except BaseException as e:  # noqa: BLE001 - the harness re-raises
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


def _batches(world, steps, seed, batch=6):
    rng = np.random.RandomState(seed)
    return [[(torch.from_numpy(rng.randint(0, VOCAB, size=batch)
                               .astype(np.int32)),
              torch.from_numpy(rng.randn(batch, DIM).astype(np.float32)))
             for _ in range(world)] for _ in range(steps)]


def _dense_step(dense, per_rank):
    """One global step on a world-1 table through the merge sequence the
    fleet sees: each rank's dedup, then the rank-order concatenation,
    merged again inside apply_grads."""
    slabs = [merge_unique_rows(ids, grads) for ids, grads in per_rank]
    dense.apply_grads(torch.cat([s[0] for s in slabs]),
                      torch.cat([s[1] for s in slabs]))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_fleet_matches_world1_bit_exact(world, opt):
    steps = _batches(world, 3, seed=17 + world)
    probe = torch.tensor([3, 7, 3, -1, 10, 0], dtype=torch.int32)
    w0 = _weight()
    dense = _table(weight=w0, **OPTS[opt])
    for per_rank in steps:
        _dense_step(dense, per_rank)
    want_w = dense.gathered_weight()
    want_rows = dense.lookup(probe)
    gathered, looked = [None] * world, [None] * world

    def run(rank, comm):
        table = ShardedEmbedding(VOCAB, DIM, comm=comm, device="cpu",
                                 weight=w0, **OPTS[opt])
        assert table.padded_vocab == 12
        for per_rank in steps:
            table.apply_grads(*per_rank[rank])
        gathered[rank] = table.gathered_weight()
        looked[rank] = table.lookup(probe)

    _run_fleet(world, run)
    for rank in range(world):
        assert torch.equal(gathered[rank], want_w)
        assert torch.equal(looked[rank], want_rows)


# ---------------------------------------------------------- checkpoints
def test_state_payload_round_trip_across_worlds():
    steps4 = _batches(4, 2, seed=31)
    payloads = [None] * 4
    w0 = _weight()

    def train4(rank, comm):
        t = ShardedEmbedding(VOCAB, DIM, comm=comm, device="cpu", weight=w0,
                             **OPTS["adam"])
        for per_rank in steps4:
            t.apply_grads(*per_rank[rank])
        payloads[rank] = t.state_payload()

    _run_fleet(4, train4)
    payload = payloads[0]
    assert payload["layout"]["world"] == 4 and payload["step"] == 2
    assert set(payload["state"]) == {"mean", "var"}
    # the reference loads the port's payload and the port the reference's
    ref = JShardedEmbedding(VOCAB, DIM, seed=9, **OPTS["adam"])
    ref.load_state_payload(payload)
    np.testing.assert_array_equal(np.asarray(ref.gathered_weight()),
                                  payload["table"])
    mine = _table(seed=9, **OPTS["adam"])
    mine.load_state_payload(ref.state_payload())
    np.testing.assert_array_equal(mine.gathered_weight().numpy(),
                                  payload["table"])
    assert mine._step == 2
    # world 4 -> world 2, then one more step, against world 1
    steps2 = _batches(2, 1, seed=77)
    dense = _table(seed=9, **OPTS["adam"])
    dense.load_state_payload(payload)
    _dense_step(dense, steps2[0])
    gathered = [None] * 2

    def resume2(rank, comm):
        t = ShardedEmbedding(VOCAB, DIM, comm=comm, device="cpu", seed=9,
                             **OPTS["adam"])
        t.load_state_payload(payload)
        t.apply_grads(*steps2[0][rank])
        gathered[rank] = t.gathered_weight()

    _run_fleet(2, resume2)
    for g in gathered:
        assert torch.equal(g, dense.gathered_weight())


def test_payload_geometry_is_validated():
    payload = _table(seed=0).state_payload()
    with pytest.raises(ValueError, match="payload table"):
        ShardedEmbedding(VOCAB + 1, DIM, device="cpu").load_state_payload(
            payload)
    with pytest.raises(ValueError, match="not an embedding"):
        _table().load_state_payload({"embed_format": 0})
    with pytest.raises(ValueError, match="optimizer"):
        _table(optimizer="adam").load_state_payload(payload)


# -------------------------------------------------------------- serving
def test_bucket_padding_and_no_retrace_after_warmup():
    assert default_buckets(64) == (8, 16, 32, 64)
    assert default_buckets(100) == (8, 16, 32, 64, 100)
    table = ShardedEmbedding(37, 8, device="cpu", seed=3)
    svc = EmbeddingLookupService(table, max_batch=64)
    svc.warmup()
    full = table.gathered_weight()
    before = _counters()
    for n in (3, 17, 64, 5, 17):
        ids = torch.from_numpy(np.random.RandomState(n).choice(
            37, size=n % 38, replace=True).astype(np.int32))
        assert torch.equal(svc.lookup(ids), full[ids.long()])
    after = _counters()
    assert _delta(before, after, "serve.retrace") == 0
    assert _delta(before, after, "embedding.serve.lookup") == 5
    with pytest.raises(ValueError, match="largest bucket"):
        svc.lookup(torch.zeros(65, dtype=torch.int32))
    svc._fns.pop(32)                    # a bucket that was not warmed
    svc.lookup(torch.arange(20, dtype=torch.int32))
    assert _delta(after, _counters(), "serve.retrace") == 1


def test_pull_between_pushes_sees_the_first_push():
    """The served snapshot is the table after the last push, and a later
    push does not change a snapshot already handed out."""
    kv = mx.kv.create("local")
    w0 = _weight(19)
    table = ShardedEmbedding(19, DIM, optimizer="sgd", learning_rate=1.0,
                             device="cpu", weight=w0)
    kv.init_embedding(7, table, max_batch=16)
    rows = np.array([2, 5, 11], np.int32)

    def push(value):
        kv.push(7, sp.RowSparseNDArray(np.full((3, DIM), value, np.float32),
                                       rows, (19, DIM), ctx=mx.cpu()))

    def pull():
        out = sp.zeros("row_sparse", (19, DIM), ctx=mx.cpu())
        kv.row_sparse_pull(7, out=out, row_ids=torch.from_numpy(rows))
        return out.data.asnumpy()

    push(1.0)
    first = pull()
    snapshot = kv._embed_services["7"]._weight
    held = snapshot.clone()
    push(2.0)
    np.testing.assert_array_equal(first, w0[rows] - 1.0)
    np.testing.assert_array_equal(pull(), w0[rows] - 3.0)
    assert torch.equal(snapshot, held)
    untouched = np.delete(np.arange(19), rows)
    np.testing.assert_array_equal(table.gathered_weight().numpy()[untouched],
                                  w0[untouched])
    with pytest.raises(mx.MXNetError, match="row_sparse"):
        kv.push(7, mx.nd.zeros((19, DIM), ctx=mx.cpu()))


def _bench_sparse_loop(pkg, spm, table, rng_seed, vocab, dim, nnz, steps):
    """`bench.py::bench_sparse`'s loop: push a row-sparse gradient of the
    step's unique ids, then row_sparse_pull up to 256 of them."""
    rng = np.random.RandomState(rng_seed)
    kv = pkg.kv.create("local")
    kv.init_embedding(0, table, max_batch=nnz)
    raw = rng.zipf(1.3, size=(steps, nnz)).astype(np.int64) % vocab
    batches = [np.unique(b).astype(np.int32) for b in raw]
    pulled = []
    for ids in batches:
        grads = rng.randn(len(ids), dim).astype(np.float32)
        kv.push(0, spm.RowSparseNDArray(grads, ids, (vocab, dim)))
        hot = ids[:min(256, len(ids))]
        out = spm.zeros("row_sparse", (vocab, dim))
        kv.row_sparse_pull(0, out=out, row_ids=pkg.nd.array(hot))
        pulled.append(out.data.asnumpy())
    return pulled, sum(len(b) for b in batches)


def test_bench_sparse_loop_matches_reference_kvstore():
    vocab, dim, nnz, steps = 50_000, 32, 1024, 6
    w0 = np.random.RandomState(2).randn(vocab, dim).astype(np.float32) * 0.1
    mine_t = ShardedEmbedding(vocab, dim, optimizer="sgd", learning_rate=0.1,
                              device="cpu", weight=w0)
    theirs_t = JShardedEmbedding(vocab, dim, optimizer="sgd",
                                 learning_rate=0.1, weight=w0)
    before = _counters()
    with mx.cpu():
        mine, pushed = _bench_sparse_loop(mx, sp, mine_t, 0, vocab, dim, nnz,
                                          steps)
    after = _counters()
    with jmx.cpu():
        theirs, _ = _bench_sparse_loop(jmx, jsp, theirs_t, 0, vocab, dim,
                                       nnz, steps)
    for a, b in zip(mine, theirs):
        _close(a, b)
    _close(mine_t.gathered_weight().numpy(),
           np.asarray(theirs_t.gathered_weight()))
    assert _delta(before, after, "serve.retrace") == 0
    assert _delta(before, after, "embedding.push.unique_rows") == pushed
    assert _delta(before, after, "comm.sparse.push") == steps
