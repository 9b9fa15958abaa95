"""The port's sparse NDArrays, the lazy row-sparse optimizer update and the
kvstore's row-sparse push and pull, against the JAX package's.

Every case feeds both packages the same numpy arrays. Storage round trips,
`retain`, `cast_storage`, `elemwise_add` and `merge_rows` are exact (they
move or add values in the same order), so they are held bit-equal. The
lazy SGD/Adam updates and the kvstore pushes run the same fp32 formulas as
the reference, whose XLA may contract multiply-adds into FMAs, so they are
held within 1e-6 of the output's largest magnitude; untouched rows and
their state are held exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ndarray import sparse as sp
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts

REL = 1e-6


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * max(np.abs(want).max(), 1e-30)


def _dense(rng, shape, rows):
    d = np.zeros(shape, np.float32)
    d[rows] = rng.randn(len(rows), *shape[1:]).astype(np.float32)
    return d


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def test_row_sparse_round_trip_matches_reference():
    rng = np.random.RandomState(0)
    dense = _dense(rng, (9, 4), [1, 4, 8])
    mine, theirs = sp.row_sparse_array(dense), jsp.row_sparse_array(dense)
    assert mine.stype == theirs.stype == "row_sparse"
    assert mine.shape == theirs.shape and mine.dtype == np.float32
    np.testing.assert_array_equal(mine.indices.asnumpy(),
                                  theirs.indices.asnumpy())
    np.testing.assert_array_equal(mine.data.asnumpy(), theirs.data.asnumpy())
    np.testing.assert_array_equal(mine.tostype("default").asnumpy(), dense)
    back = mx.nd.array(dense).tostype("row_sparse")
    np.testing.assert_array_equal(back.indices.asnumpy(), [1, 4, 8])
    # from (data, indices) and a shape, and the empty array
    made = sp.row_sparse_array((dense[[1, 4]], [1, 4]), shape=(9, 4))
    np.testing.assert_array_equal(made.asnumpy()[[1, 4]], dense[[1, 4]])
    z = sp.zeros("row_sparse", (5, 3))
    assert z.stype == "row_sparse" and not z.asnumpy().any()
    assert z.indices.shape == (0,)


def test_csr_round_trip_matches_reference():
    rng = np.random.RandomState(1)
    dense = (rng.rand(6, 7) * (rng.rand(6, 7) < 0.3)).astype(np.float32)
    mine, theirs = sp.csr_matrix(dense), jsp.csr_matrix(dense)
    assert mine.stype == "csr"
    for a, b in ((mine.data, theirs.data), (mine.indices, theirs.indices),
                 (mine.indptr, theirs.indptr)):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    np.testing.assert_array_equal(mine.tostype("default").asnumpy(), dense)
    again = mine.tostype("default").tostype("csr")
    np.testing.assert_array_equal(again.asnumpy(), dense)
    three = sp.csr_matrix((theirs.data.asnumpy(), theirs.indices.asnumpy(),
                           theirs.indptr.asnumpy()), shape=(6, 7))
    np.testing.assert_array_equal(three.asnumpy(), dense)
    with pytest.raises(NotImplementedError, match="Gluon-sparse"):
        sp.dot(mine, mx.nd.ones((7, 2)))


@pytest.mark.parametrize("keep", [[0, 4], [4, 8, 2], []])
def test_retain_matches_reference(keep):
    rng = np.random.RandomState(2)
    dense = _dense(rng, (9, 3), [1, 4, 8])
    keep = np.asarray(keep, np.int32)
    mine = sp.retain(sp.row_sparse_array(dense), keep)
    theirs = jsp.retain(jsp.row_sparse_array(dense), keep)
    np.testing.assert_array_equal(mine.indices.asnumpy(),
                                  theirs.indices.asnumpy())
    np.testing.assert_array_equal(mine.data.asnumpy(), theirs.data.asnumpy())


def test_elemwise_add_and_merge_rows_match_reference():
    rng = np.random.RandomState(3)
    a, b = _dense(rng, (12, 5), [0, 3, 7]), _dense(rng, (12, 5), [3, 7, 11])
    mine = sp.elemwise_add(sp.row_sparse_array(a), sp.row_sparse_array(b))
    theirs = jsp.elemwise_add(jsp.row_sparse_array(a),
                              jsp.row_sparse_array(b))
    assert mine.stype == "row_sparse"
    np.testing.assert_array_equal(mine.indices.asnumpy(),
                                  theirs.indices.asnumpy())
    np.testing.assert_array_equal(mine.data.asnumpy(), theirs.data.asnumpy())
    dense_sum = sp.add(mx.nd.array(a), mx.nd.array(b))
    np.testing.assert_array_equal(dense_sum.asnumpy(), a + b)
    # merge_rows: three and more duplicates, in occurrence order
    ids = rng.randint(0, 6, size=40).astype(np.int32)
    vals = (rng.randn(40, 3) * np.exp(rng.randn(40, 1) * 3)).astype(
        np.float32)
    mi, mv = sp.merge_rows(torch.from_numpy(ids), torch.from_numpy(vals))
    ti, tv = jsp.merge_rows(jnp.asarray(ids), jnp.asarray(vals))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ti))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(tv))


def _lazy_case(opt_name, kwargs, seed):
    """Three steps of a lazy row-sparse update through the optimizer's
    Updater on both packages, from the same weights, state and rows."""
    rng = np.random.RandomState(seed)
    w0 = rng.randn(10, 4).astype(np.float32)
    steps = [(np.sort(rng.choice(10, size=3, replace=False)).astype(
        np.int32), rng.randn(3, 4).astype(np.float32)) for _ in range(3)]
    out = []
    for pkg, spm in ((mx, sp), (jmx, jsp)):
        with pkg.cpu():
            upd = pkg.optimizer.get_updater(
                pkg.optimizer.create(opt_name, **kwargs))
            w = pkg.nd.array(w0)
            for ids, g in steps:
                grad = spm.row_sparse_array((g, ids), shape=(10, 4))
                upd(0, grad, w)
            state = upd.states[0]
            state = [s.asnumpy() for s in (state if isinstance(
                state, (tuple, list)) else [state]) if s is not None]
            out.append((w.asnumpy(), state))
    touched = np.unique(np.concatenate([ids for ids, _ in steps]))
    return out, touched


@pytest.mark.parametrize("opt_name,kwargs", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.5}),
    ("adam", {"learning_rate": 0.1, "wd": 0.01})])
def test_lazy_row_sparse_update_matches_reference(opt_name, kwargs):
    (mine, theirs), touched = _lazy_case(opt_name, kwargs, seed=4)
    _close(mine[0], theirs[0])
    for a, b in zip(mine[1], theirs[1]):
        _close(a, b)
    untouched = np.setdiff1d(np.arange(10), touched)
    assert untouched.size
    np.testing.assert_array_equal(mine[0][untouched], theirs[0][untouched])
    for a, b in zip(mine[1], theirs[1]):
        np.testing.assert_array_equal(a[untouched], b[untouched])


def test_lazy_sgd_momentum_leaves_untouched_rows():
    opt = mx.optimizer.create("sgd", learning_rate=1.0, momentum=0.5)
    w = mx.nd.array(np.ones((4, 2), np.float32))
    mom = opt.create_state(0, w)
    mom[:] = np.full((4, 2), 10.0, np.float32)
    grad = sp.RowSparseNDArray(np.ones((1, 2), np.float32),
                               np.array([2], np.int32), (4, 2))
    opt.update(0, w, grad, mom)
    np.testing.assert_array_equal(w.asnumpy()[[0, 1, 3]], 1.0)
    np.testing.assert_array_equal(mom.asnumpy()[[0, 1, 3]], 10.0)
    np.testing.assert_array_equal(mom.asnumpy()[2], [4.0, 4.0])
    np.testing.assert_array_equal(w.asnumpy()[2], [5.0, 5.0])


def _kv_run(pkg, spm, w0, pushes, pull_ids, sparse_store, updater):
    with pkg.cpu():
        kv = pkg.kv.create("local")
        init = spm.row_sparse_array(w0) if sparse_store else pkg.nd.array(w0)
        kv.init(3, init)
        if updater:
            kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.5,
                                                  momentum=0.9))
        for reps in pushes:
            kv.push(3, [spm.row_sparse_array((g, ids), shape=w0.shape)
                        for ids, g in reps])
        out = spm.zeros("row_sparse", w0.shape)
        kv.row_sparse_pull(3, out=out, row_ids=pkg.nd.array(pull_ids))
        return out.indices.asnumpy(), out.data.asnumpy()


@pytest.mark.parametrize("sparse_store,updater", [
    (False, True), (False, False), (True, False)])
def test_kvstore_row_sparse_push_pull_matches_reference(sparse_store,
                                                        updater):
    rng = np.random.RandomState(6)
    w0 = _dense(rng, (8, 3), [0, 2, 5, 7]) if sparse_store \
        else rng.randn(8, 3).astype(np.float32)
    pushes = [[(np.array([1, 5], np.int32), rng.randn(2, 3).astype(
        np.float32)) for _ in range(2)] for _ in range(2)]
    pull = np.array([5, 1, 4, 5], np.float32)
    mine = _kv_run(mx, sp, w0, pushes, pull, sparse_store, updater)
    theirs = _kv_run(jmx, jsp, w0, pushes, pull, sparse_store, updater)
    np.testing.assert_array_equal(mine[0], theirs[0])
    _close(mine[1], theirs[1])


def test_kvstore_multi_key_sparse_push_goes_through_buckets():
    before = mx.telemetry.snapshot()["counters"]
    kv = mx.kv.create("local")
    keys = [0, 1, 2]
    for k in keys:
        kv.init(k, mx.nd.zeros((20, 4)))
    kv.push(keys, [sp.row_sparse_array((np.full((2, 4), k + 1.0,
                                                 np.float32), [1, 7 + k]),
                                       shape=(20, 4)) for k in keys])
    after = mx.telemetry.snapshot()["counters"]
    for name, n in (("comm.sparse.push", 3),
                    ("comm.sparse.bucket.count", 1)):
        assert after.get(name, 0) - before.get(name, 0) == n
    for k in keys:
        out = mx.nd.zeros((20, 4))
        kv.pull(k, out=out)
        want = np.zeros((20, 4), np.float32)
        want[[1, 7 + k]] = k + 1.0
        np.testing.assert_array_equal(out.asnumpy(), want)


def test_sparse_bucketer_matches_reference():
    from mxnet_tpu import engine as jengine
    from mxnet_tpu_torch import engine
    rows = [(3, 4), (50, 4), (0, 4), (2, 8), (7, 4)]
    mine, theirs = engine.SparseGradBucketer(300), \
        jengine.SparseGradBucketer(300)
    got, want = [], []
    for k, (n, d) in enumerate(rows):
        dt = np.float32 if d == 4 else np.float16
        got += mine.add(str(k), torch.zeros(n, dtype=torch.int32),
                        torch.zeros(n, d, dtype=getattr(torch, np.dtype(
                            dt).name)))
        want += theirs.add(str(k), jnp.zeros(n, jnp.int32),
                           jnp.zeros((n, d), dt))
    got.append(mine.flush())
    want.append(theirs.flush())
    assert [(b.keys, b.nbytes, b.reason) for b in got] == \
        [(b.keys, b.nbytes, b.reason) for b in want]


def test_merge_rows_launches_nothing_on_the_cpu():
    reset_launch_counts()
    sp.merge_rows(torch.tensor([2, 2, 1]), torch.ones(3, 2))
    assert launch_counts()["segment_sum"] == 0
