"""The port's `mx.io` iterators against the JAX package's.

Every case feeds both packages the same files or numpy arrays, made from a
seed. Iterating moves values without arithmetic, so every batch is held
exactly: CSR data, column ids, row offsets, labels and `pad`.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _write_libsvm(path, rows, dim, seed, one_based=False, label_col=True):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        nnz = rng.randint(0, 5)
        ids = np.sort(rng.choice(dim - 1, size=nnz, replace=False))
        ids = ids + 1 if one_based else ids
        vals = rng.rand(nnz)
        label = "%d" % rng.randint(0, 2) if label_col else "%.2f" % rng.rand()
        lines.append(" ".join([label] + ["%d:%.4f" % (i, v)
                                         for i, v in zip(ids, vals)]))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _csr_parts(arr):
    return (arr.data.asnumpy(), arr.indices.asnumpy(), arr.indptr.asnumpy())


def _assert_same_batches(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.pad == b.pad
        assert len(a.data) == len(b.data) == 1
        assert a.data[0].stype == b.data[0].stype == "csr"
        assert a.data[0].shape == b.data[0].shape
        for x, y in zip(_csr_parts(a.data[0]), _csr_parts(b.data[0])):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.label[0].asnumpy(),
                                      b.label[0].asnumpy())


@pytest.mark.parametrize("rows,batch,one_based,round_batch", [
    (3, 2, False, True),          # the reference test's shape
    (23, 5, False, True),         # wrap-around of 2 rows
    (23, 5, True, True),          # 1-based ids
    (23, 5, False, False),        # a short last batch, pad 0
    (4, 7, False, True),          # a file shorter than one batch
    (20, 5, True, True),          # whole batches
])
def test_libsvm_iter_matches_reference(tmp_path, rows, batch, one_based,
                                       round_batch):
    dim = 12
    f = _write_libsvm(tmp_path / "d.libsvm", rows, dim, seed=rows + batch,
                      one_based=one_based)
    kw = dict(data_libsvm=f, data_shape=dim, batch_size=batch,
              round_batch=round_batch)
    mine, theirs = mx.io.LibSVMIter(**kw), jmx.io.LibSVMIter(**kw)
    got, want = list(mine), list(theirs)
    _assert_same_batches(got, want)
    assert got[-1].pad == ((-rows) % batch if round_batch else 0)
    assert mine.provide_data == theirs.provide_data
    assert mine.provide_label == theirs.provide_label
    # reset starts the same epoch again
    mine.reset()
    theirs.reset()
    _assert_same_batches(list(mine), list(theirs))


def test_libsvm_iter_label_file_matches_reference(tmp_path):
    f = _write_libsvm(tmp_path / "d.libsvm", 9, 10, seed=3)
    lf = _write_libsvm(tmp_path / "l.libsvm", 9, 10, seed=4, label_col=False)
    kw = dict(data_libsvm=f, label_libsvm=lf, data_shape=10, batch_size=4)
    _assert_same_batches(list(mx.io.LibSVMIter(**kw)),
                         list(jmx.io.LibSVMIter(**kw)))
    short = _write_libsvm(tmp_path / "s.libsvm", 5, 10, seed=5)
    for pkg in (mx, jmx):
        with pytest.raises(ValueError):
            pkg.io.LibSVMIter(data_libsvm=f, label_libsvm=short,
                              data_shape=10, batch_size=4)


def test_libsvm_iter_batches_on_the_current_context(tmp_path):
    f = _write_libsvm(tmp_path / "d.libsvm", 6, 8, seed=0)
    b = next(iter(mx.io.LibSVMIter(data_libsvm=f, data_shape=8,
                                   batch_size=4)))
    assert b.data[0].context == mx.cpu() and b.label[0].context == mx.cpu()
    assert b.data[0].dtype == np.float32


def _nd_batches(it):
    return [([d.asnumpy() for d in b.data], [lb.asnumpy() for lb in b.label],
             b.pad) for b in it]


@pytest.mark.parametrize("handle", ["pad", "discard"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_reference(handle, shuffle):
    rng = np.random.RandomState(7)
    x = rng.randn(11, 3, 2)                      # float64 -> float32
    y = rng.randint(0, 5, size=11).astype(np.int32)
    kw = dict(batch_size=4, shuffle=shuffle, shuffle_seed=2,
              last_batch_handle=handle)
    mine = mx.io.NDArrayIter(x, y, **kw)
    theirs = jmx.io.NDArrayIter(x, y, **kw)
    assert mine.num_batches == theirs.num_batches
    assert mine.provide_data == theirs.provide_data
    assert mine.provide_label == theirs.provide_label
    for _ in range(2):                           # two epochs, reset between
        got, want = _nd_batches(mine), _nd_batches(theirs)
        assert len(got) == len(want)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            assert gp == wp
            for a, b in zip(gd + gl, wd + wl):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        mine.reset()
        theirs.reset()


def test_ndarray_iter_named_inputs_and_arrays():
    rng = np.random.RandomState(1)
    data = {"a": rng.rand(6, 2).astype(np.float32),
            "b": rng.rand(6).astype(np.float32)}
    label = [mx.nd.array(np.arange(6)), mx.nd.array(np.arange(6) * 2)]
    jlabel = [jmx.nd.array(np.arange(6)), jmx.nd.array(np.arange(6) * 2)]
    mine = mx.io.NDArrayIter(data, label, batch_size=4)
    theirs = jmx.io.NDArrayIter(data, jlabel, batch_size=4)
    assert [d.name for d in mine.provide_data] == ["a", "b"]
    assert [d.name for d in mine.provide_label] == \
        [d.name for d in theirs.provide_label]
    for (gd, gl, gp), (wd, wl, wp) in zip(_nd_batches(mine),
                                          _nd_batches(theirs)):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


def test_resize_iter_matches_reference():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    mine = mx.io.ResizeIter(mx.io.NDArrayIter(x, batch_size=2), 7)
    theirs = jmx.io.ResizeIter(jmx.io.NDArrayIter(x, batch_size=2), 7)
    got, want = _nd_batches(mine), _nd_batches(theirs)
    assert len(got) == len(want) == 7
    for (gd, _, gp), (wd, _, wp) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gd[0], wd[0])


def test_prefetching_iter_yields_the_inner_batches():
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    y = np.arange(7, dtype=np.float32)
    want = _nd_batches(mx.io.NDArrayIter(x, y, batch_size=3))
    it = mx.io.PrefetchingIter(mx.io.NDArrayIter(x, y, batch_size=3))
    for _ in range(2):
        got = _nd_batches(it)
        assert len(got) == len(want)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            assert gp == wp
            np.testing.assert_array_equal(gd[0], wd[0])
            np.testing.assert_array_equal(gl[0], wl[0])
        it.reset()
    # two iterators' batches joined into one
    two = mx.io.PrefetchingIter([mx.io.NDArrayIter(x, batch_size=3),
                                 mx.io.NDArrayIter(x * 2, batch_size=3)])
    b = two.next()
    np.testing.assert_array_equal(b.data[1].asnumpy(), 2 * b.data[0].asnumpy())
    assert len(two.provide_data) == 2


def test_data_desc_matches_reference():
    a = mx.io.DataDesc("data", [4, 3], "float16")
    b = jmx.io.DataDesc("data", [4, 3], "float16")
    assert tuple(a) == tuple(b)
