"""The port's Gluon-sparse path against the JAX package's: Embedding's
out-of-range ids, `Embedding(sparse_grad=True)` and row-sparse gradient
buffers, the CSR dot and its gradient, row-sparse Parameters and the
sparse decisions of `Trainer`, the store's row-sparse legs with Gluon
gradients, and narrow copies of the factorization machine and of matrix
factorization for 3 steps.

Every case feeds both packages the same numpy inputs, made from a seed.
Tolerances: CSR dot outputs and rhs gradients within rtol 1e-6 / atol 1e-6
of the output's max abs (the reference's XLA contracts multiply-adds into
FMAs on the CPU); row-sparse gradients with equal indices and values
within 1e-6; the FM and MF parameters after 3 steps within 1e-5 of each
leaf's max abs, their losses within 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ndarray import sparse as jsp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import test_utils as tu
from mxnet_tpu_torch.models import factorization as fz
from mxnet_tpu_torch.ndarray import sparse as sp
from _torch_seed import _seed_torch  # noqa: F401

REL = 1e-6
STEPS_REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _np(a):
    return np.asarray(a.asnumpy(), np.float32)


def _close(got, want, rel=REL):
    got, want = _np(got) if hasattr(got, "asnumpy") else np.asarray(got), \
        _np(want) if hasattr(want, "asnumpy") else np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _same_rows(got, want):
    """Two row-sparse arrays: the same sorted ids, values within REL."""
    assert got.stype == want.stype == "row_sparse"
    np.testing.assert_array_equal(got.indices.asnumpy(),
                                  np.asarray(want._indices))
    _close(got.data, want.data)


# ---------------------------------------------------------------------------
# Embedding: out-of-range ids (negative ids count from the end once; ids
# still outside read NaN and get no gradient)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse_grad", [False, True])
def test_embedding_out_of_range_ids_match_reference(dtype, sparse_grad):
    rng = np.random.RandomState(0)
    table = rng.randn(4, 3).astype(np.float32)
    ids = np.array([[-1, 1, 9], [-5, 3, 0]], np.int32)
    head = rng.randn(2, 3, 3).astype(np.float32)
    outs, grads = [], []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        w = pkg.nd.array(table, dtype=dtype)
        w.attach_grad(stype="row_sparse" if sparse_grad else None)
        with autograd.record():
            out = pkg.nd.Embedding(pkg.nd.array(ids, dtype="int32"), w,
                                   input_dim=4, output_dim=3,
                                   sparse_grad=sparse_grad)
            loss = (out * pkg.nd.array(head, dtype=dtype)).sum()
        loss.backward()
        outs.append(_np(out))
        grads.append(w.grad)
    got, want = outs
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 2]).all() and np.isnan(got[1, 0]).all()
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert grads[0].dtype == grads[1].dtype
    if sparse_grad:
        _same_rows(*grads)
    _close(grads[0], grads[1])


def test_embedding_out_of_range_ids_in_an_integer_table():
    table = np.arange(8, dtype=np.int32).reshape(4, 2)
    got = mx.nd.Embedding(mx.nd.array([5, -1], dtype="int32"),
                          mx.nd.array(table, dtype="int32"), input_dim=4,
                          output_dim=2).asnumpy()
    np.testing.assert_array_equal(got[1], table[3])
    assert (got[0] == np.iinfo(np.int32).min).all()


# ---------------------------------------------------------------------------
# CSR dot (reference tests/test_sparse.py: test_csr_dot_forward_backward,
# test_csr_dot_transpose)
# ---------------------------------------------------------------------------
def _rand_csr(rng, m, n, density):
    return (rng.rand(m, n) * (rng.rand(m, n) < density)).astype(np.float32)


@pytest.mark.parametrize("m,k,n,density", [
    (4, 6, 3, 0.3), (17, 40, 5, 0.2), (9, 30, 1, 0.5), (5, 7, 4, 0.0)])
@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_forward_backward_match_reference(m, k, n, density,
                                                  transpose_a):
    rng = np.random.RandomState(m * k + n)
    dense = _rand_csr(rng, m, k, density)
    rhs = rng.randn(m if transpose_a else k, n).astype(np.float32)
    head = rng.randn(k if transpose_a else m, n).astype(np.float32)
    res = []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        r = pkg.nd.array(rhs)
        r.attach_grad()
        csr = pkg.nd.sparse.csr_matrix(dense)
        with autograd.record():
            out = pkg.nd.sparse.dot(csr, r, transpose_a=transpose_a)
            loss = (out * pkg.nd.array(head)).sum()
        loss.backward()
        res.append((out, r.grad))
    (out, g), (jout, jg) = res
    _close(out, jout)
    _close(g, jg)
    want = dense.T @ rhs if transpose_a else dense @ rhs
    np.testing.assert_allclose(_np(out), want, rtol=1e-5, atol=1e-5)


def test_csr_dot_transpose_b_raises_as_in_reference():
    dense = _rand_csr(np.random.RandomState(0), 3, 4, 0.5)
    for pkg in (mx, jmx):
        with pytest.raises(NotImplementedError):
            pkg.nd.sparse.dot(pkg.nd.sparse.csr_matrix(dense),
                              pkg.nd.array(np.ones((2, 4), np.float32)),
                              transpose_b=True)


def test_csr_dot_row_ids_from_indptr():
    dense = np.zeros((5, 3), np.float32)
    dense[0, 1], dense[2, 0], dense[2, 2], dense[4, 1] = 1, 2, 3, 4
    csr = sp.csr_matrix(dense)
    np.testing.assert_array_equal(csr._row_ids().numpy(), [0, 2, 2, 4])
    np.testing.assert_array_equal(csr.tostype("default").asnumpy(), dense)


# ---------------------------------------------------------------------------
# Embedding(sparse_grad=True) (reference tests/test_sparse.py:228-336)
# ---------------------------------------------------------------------------
def _make_emb(pkg, sparse, rows=12, dim=3):
    emb = pkg.gluon.nn.Embedding(rows, dim, sparse_grad=sparse)
    emb.initialize(pkg.init.Constant(0.5))
    return emb


def _backward(pkg, autograd, emb, sel, head=None):
    idx = pkg.nd.array(np.array(sel), dtype="int32")
    with autograd.record():
        out = emb(idx)
        loss = (out * pkg.nd.array(head)).sum() if head is not None \
            else out.sum()
    loss.backward()


def test_embedding_sparse_grad_rows_and_values():
    head = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = {}
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        for sparse in (True, False):
            emb = _make_emb(pkg, sparse)
            _backward(pkg, autograd, emb, [3, 7, 3, 1], head)
            got[pkg.__name__, sparse] = emb.weight.grad()
    gs, jgs = got["mxnet_tpu_torch", True], got["mxnet_tpu", True]
    assert gs.stype == "row_sparse"
    assert got["mxnet_tpu_torch", False].stype == "default"
    np.testing.assert_array_equal(gs.indices.asnumpy(), [1, 3, 7])
    _same_rows(gs, jgs)
    _close(gs, got["mxnet_tpu_torch", False])


def test_embedding_sparse_grad_add_accumulates_rows():
    grads = []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        emb = _make_emb(pkg, True)
        emb.weight.grad_req = "add"
        for sel in ([0, 1], [1, 2]):
            _backward(pkg, autograd, emb, sel)
        grads.append(emb.weight.grad())
        emb_g = emb.weight.grad()
        if pkg is mx:
            np.testing.assert_array_equal(emb_g.indices.asnumpy(), [0, 1, 2])
            np.testing.assert_allclose(_np(emb_g)[1], 2.0 * np.ones(3))
        dense = _np(emb_g)
        emb.weight.zero_grad()
        assert emb.weight.grad()._indices.shape[0] == 0
        grads[-1] = dense
    np.testing.assert_array_equal(grads[0], grads[1])


def test_embedding_sparse_grad_autograd_grad():
    res = []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        emb = _make_emb(pkg, True)
        w = emb.weight.data()
        with autograd.record():
            loss = (emb(pkg.nd.array(np.array([2, 5, 2]), dtype="int32"))
                    * 3.0).sum()
        res.append(autograd.grad([loss], [w])[0])
        # grad() leaves the buffer untouched
        assert emb.weight.grad()._indices.shape[0] == 0
    _same_rows(*res)
    np.testing.assert_array_equal(res[0].indices.asnumpy(), [2, 5])


def test_embedding_sparse_grad_lazy_momentum_untouched_rows():
    """lazy_update: rows absent from a batch keep their weight and momentum
    (including momentum built by an earlier step)."""
    weights = []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        emb = _make_emb(pkg, True)
        trainer = pkg.gluon.Trainer(emb.collect_params(), "sgd",
                                    {"learning_rate": 1.0, "momentum": 0.9,
                                     "lazy_update": True})
        hist = []
        for rows in ([4, 9], [1], [4, 1]):
            _backward(pkg, autograd, emb, rows)
            trainer.step(1)
            hist.append(_np(emb.weight.data()))
        assert trainer._kvstore is None
        weights.append(hist)
    mine, theirs = weights
    for a, b in zip(mine, theirs):
        _close(a, b)
    moved = np.where(np.abs(mine[1] - mine[0]).sum(axis=1) > 0)[0]
    np.testing.assert_array_equal(moved, [1])
    np.testing.assert_array_equal(mine[1][[4, 9]], mine[0][[4, 9]])


def test_embedding_sparse_grad_hybridized_values_match_dense():
    """The reference fills the row-sparse buffer through its dense path
    under hybridize; the port's hybridize is eager, so the buffer keeps
    only the touched rows. The values are the same."""
    got = []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        emb_h = _make_emb(pkg, True)
        emb_h.hybridize()
        _backward(pkg, autograd, emb_h, [0, 6, 6])
        g = emb_h.weight.grad()
        assert g.stype == "row_sparse"
        got.append(_np(g))
    np.testing.assert_allclose(got[0], got[1], rtol=REL)
    emb_d = _make_emb(mx, False)
    _backward(mx, ag, emb_d, [0, 6, 6])
    np.testing.assert_allclose(got[0], _np(emb_d.weight.grad()), rtol=REL)


def test_embedding_sparse_grad_clips_out_of_range_like_dense():
    grads = []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        for sparse in (True, False):
            emb = _make_emb(pkg, sparse)
            _backward(pkg, autograd, emb, [-1, 3, 99])
            grads.append(emb.weight.grad())
    gs, gd, jgs, jgd = grads
    _same_rows(gs, jgs)
    ids = gs.indices.asnumpy()
    assert ids.min() >= 0 and ids.max() < 12
    _close(gs, gd)
    _close(gd, jgd)


def test_sparse_and_dense_uses_of_one_weight_densify_as_reference():
    """A row-sparse cotangent meeting a dense one is added densely; into a
    row-sparse buffer it then stores every row (the reference's write)."""
    rng = np.random.RandomState(2)
    table = rng.randn(6, 2).astype(np.float32)
    got = []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        w = pkg.nd.array(table)
        w.attach_grad(stype="row_sparse")
        with autograd.record():
            e = pkg.nd.Embedding(pkg.nd.array([1, 1, 4], dtype="int32"), w,
                                 input_dim=6, output_dim=2, sparse_grad=True)
            loss = e.sum() + (w * w).sum()
        loss.backward()
        got.append(w.grad)
    _same_rows(*got)
    _close(got[0], got[1])


def test_attach_grad_row_sparse_buffer_and_zero_grad():
    w = mx.nd.array(np.ones((5, 2), np.float32))
    w.attach_grad(stype="row_sparse")
    assert w.grad.stype == "row_sparse" and w.grad._indices.shape[0] == 0
    with ag.record():
        loss = mx.nd.Embedding(mx.nd.array([3, 0, 3], dtype="int32"), w,
                               input_dim=5, output_dim=2,
                               sparse_grad=True).sum()
    loss.backward()
    np.testing.assert_array_equal(w.grad.indices.asnumpy(), [0, 3])
    np.testing.assert_array_equal(w.grad.data.asnumpy(), [[1, 1], [2, 2]])
    w.zero_grad()
    assert w.grad._indices.shape[0] == 0 and w.grad.shape == (5, 2)
    with pytest.raises(ValueError):
        w.attach_grad(stype="csr")


# ---------------------------------------------------------------------------
# row-sparse Parameters and the Trainer's sparse decisions
# ---------------------------------------------------------------------------
def test_parameter_stypes_match_reference():
    for pkg in (mx, jmx):
        p = pkg.gluon.Parameter("w", shape=(6, 2), stype="row_sparse",
                                grad_stype="row_sparse")
        assert (p.stype, p.grad_stype) == ("row_sparse", "row_sparse")
        p.initialize(pkg.init.Constant(1.0), ctx=pkg.cpu())
        with pytest.raises(RuntimeError):
            p.data()
        assert p.list_grad()[0].stype == "row_sparse"
        assert p._reduce().stype == "default"
        np.testing.assert_array_equal(p._reduce().asnumpy(), np.ones((6, 2)))
        d = pkg.gluon.Parameter("d", shape=(2,))
        d.initialize(ctx=pkg.cpu())
        for bad in (d.row_sparse_data, d.list_row_sparse_data):
            with pytest.raises(RuntimeError):
                bad(pkg.nd.array([0]))
    with pytest.raises(ValueError):
        mx.gluon.Parameter("x", shape=(2,), stype="dense")
    with pytest.raises(ValueError):
        mx.gluon.Parameter("x", shape=(2,), grad_stype="sparse")


def test_parameter_row_sparse_data_pulls_the_rows_from_its_trainer():
    """The reference's row_sparse_data calls data(), which refuses the
    stype it is for, so it always raises; the port pulls the rows from
    the store of the parameter's Trainer (upstream MXNet's behaviour): after
    a step, the rows asked for hold the store's updated weights, the same
    as the reference's `_row_sparse_pull` gives."""
    q = jmx.gluon.Parameter("w", shape=(6, 2), stype="row_sparse")
    q.initialize(jmx.init.Constant(1.0), ctx=jmx.cpu())
    with pytest.raises(RuntimeError):
        q.row_sparse_data(jmx.nd.array([1, 3]))
    p = mx.gluon.Parameter("w", shape=(6, 2), stype="row_sparse",
                           grad_stype="row_sparse")
    p.initialize(mx.init.Constant(1.0), ctx=mx.cpu())
    with pytest.raises(RuntimeError, match="no Trainer"):
        p.row_sparse_data(mx.nd.array([1, 3]))
    q = jmx.gluon.Parameter("w", shape=(6, 2), stype="row_sparse",
                            grad_stype="row_sparse")
    q.initialize(jmx.init.Constant(1.0), ctx=jmx.cpu())
    tr = mx.gluon.Trainer([p], "sgd", {"learning_rate": 0.5})
    jtr = jmx.gluon.Trainer([q], "sgd", {"learning_rate": 0.5})
    for pkg, param, trainer in ((mx, p, tr), (jmx, q, jtr)):
        _set_grad_rows(pkg, param, np.array([2, 4], np.int32),
                       np.array([[3.0, 1.0], [-2.0, 5.0]], np.float32))
        trainer.step(2)
    rows = jmx.nd.sparse.zeros("row_sparse", (6, 2))
    jtr._row_sparse_pull(q, rows, jmx.nd.array([4, 2, 1]))
    want = np.ones((6, 2), np.float32)
    want[rows.indices.asnumpy()] = rows.data.asnumpy()
    got = p.row_sparse_data(mx.nd.array([4, 2, 1]))
    assert got is p.list_data()[0]
    np.testing.assert_array_equal(got.asnumpy(), want)
    assert not np.array_equal(want, np.ones((6, 2)))
    (listed,) = p.list_row_sparse_data(mx.nd.array([2]))
    np.testing.assert_array_equal(listed.asnumpy(), want)
    with pytest.raises(TypeError):
        p.row_sparse_data(np.array([1]))
    # a row-sparse weight lives on one Trainer's store
    with pytest.raises(RuntimeError, match="More than one"):
        mx.gluon.Trainer([p], "sgd")


def _set_grad_rows(pkg, param, rows, values):
    g = param.list_grad()[0]
    if pkg is mx:
        g._set_rows(torch.from_numpy(values), torch.from_numpy(rows))
    else:
        g._set_rows(jsp.jnp.asarray(values), jsp.jnp.asarray(rows))


def test_trainer_with_a_row_sparse_weight_updates_on_a_store():
    res = []
    for pkg in (mx, jmx):
        p = pkg.gluon.Parameter("w", shape=(6, 2), stype="row_sparse",
                                grad_stype="row_sparse")
        p.initialize(pkg.init.Constant(1.0), ctx=pkg.cpu())
        tr = pkg.gluon.Trainer([p], "sgd", {"learning_rate": 0.5})
        _set_grad_rows(pkg, p, np.array([2, 4], np.int32),
                       np.full((2, 2), 3.0, np.float32))
        tr.step(2)
        assert tr._kvstore is not None and tr._update_on_kvstore
        # the step pulls back no row-sparse weight: the replica is as it was
        np.testing.assert_array_equal(p.list_data()[0].asnumpy(),
                                      np.ones((6, 2)))
        out = pkg.nd.sparse.zeros("row_sparse", (6, 2))
        tr._row_sparse_pull(p, out, pkg.nd.array([4, 2, 1]))
        full = pkg.nd.sparse.zeros("row_sparse", (6, 2))
        tr._row_sparse_pull(p, full, None, full_idx=True)
        res.append((out, full))
    (out, full), (jout, jfull) = res
    _same_rows(out, jout)
    np.testing.assert_array_equal(out.indices.asnumpy(), [1, 2, 4])
    np.testing.assert_array_equal(out.data.asnumpy()[1], [0.25, 0.25])
    _same_rows(full, jfull)
    np.testing.assert_array_equal(full.indices.asnumpy(), np.arange(6))
    with pytest.raises(ValueError):
        p = mx.gluon.Parameter("w", shape=(6, 2), stype="row_sparse")
        p.initialize(ctx=mx.cpu())
        mx.gluon.Trainer([p], "sgd", zero=True).step(1)


@pytest.mark.parametrize("optimizer,args", [
    ("sgd", {"learning_rate": 0.3, "momentum": 0.9, "lazy_update": True}),
    ("sgd", {"learning_rate": 0.3, "momentum": 0.9, "lazy_update": False,
             "wd": 0.1}),
    ("adam", {"learning_rate": 0.1, "lazy_update": True}),
    ("adagrad", {"learning_rate": 0.2, "wd": 0.1}),
])
def test_trainer_row_sparse_gradients_of_dense_weights_need_no_store(
        optimizer, args):
    """Embedding(sparse_grad=True) weights are dense: no store, the
    per-tensor lazy route (AdaGrad takes the reference's dense route)."""
    rng = np.random.RandomState(4)
    table = rng.randn(10, 3).astype(np.float32)
    batches = [(sel, rng.randn(len(sel), 3).astype(np.float32))
               for sel in ([1, 5, 5], [2], [5, 7])]
    hist = []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        emb = pkg.gluon.nn.Embedding(10, 3, sparse_grad=True)
        emb.initialize(ctx=pkg.cpu())
        emb.weight.set_data(pkg.nd.array(table))
        tr = pkg.gluon.Trainer(emb.collect_params(), optimizer, dict(args))
        steps = []
        for sel, head in batches:
            _backward(pkg, autograd, emb, sel, head)
            tr.step(len(sel))
            steps.append(_np(emb.weight.data()))
        assert tr._kvstore is None
        hist.append(steps)
    for a, b in zip(*hist):
        _close(a, b)
    untouched = [0, 3, 4, 6, 8, 9]
    decays = args.get("wd", 0) and not args.get("lazy_update", False)
    assert np.array_equal(hist[0][-1][untouched], table[untouched]) \
        != bool(decays)


def test_store_row_sparse_legs_with_gluon_gradients():
    """pull(ignore_sparse=False) into a row-sparse out, row_sparse_pull of
    every row, and a push of an Embedding's row-sparse gradient through
    AdaGrad (dense route) and lazy SGD, as the reference's store does."""
    rng = np.random.RandomState(5)
    table = rng.randn(8, 2).astype(np.float32)
    res = []
    for pkg, autograd in ((mx, ag), (jmx, jag)):
        kv = pkg.kv.create("local")
        w = pkg.nd.array(table)
        w.attach_grad(stype="row_sparse")
        kv.init(0, w)
        kv.init(1, w)
        kv.set_optimizer(pkg.optimizer.create("adagrad", learning_rate=0.4,
                                              wd=0.05))
        with autograd.record():
            loss = (pkg.nd.Embedding(pkg.nd.array([6, 1, 6], dtype="int32"),
                                     w, input_dim=8, output_dim=2,
                                     sparse_grad=True) * 2.0).sum()
        loss.backward()
        kv.push(0, w.grad)
        kv.push(1, [w.grad, w.grad])
        outs = []
        for key in (0, 1):
            o = pkg.nd.sparse.zeros("row_sparse", (8, 2))
            kv.pull(key, out=o, ignore_sparse=False)
            f = pkg.nd.sparse.zeros("row_sparse", (8, 2))
            kv.row_sparse_pull(key, out=f, row_ids=pkg.nd.array(np.arange(8)))
            outs += [o, f]
        res.append(outs)
    for a, b in zip(*res):
        _same_rows(a, b)
    # the dense route: wd decays the rows the gradient did not touch
    assert not np.array_equal(_np(res[0][0])[0], table[0])


# ---------------------------------------------------------------------------
# narrow copies of the two main paths, 3 steps against the reference
# ---------------------------------------------------------------------------
def _jfm_step(kv, batch, w, v, b, batch_size, bias_lr):
    """The reference's loop body (tests/test_sparse.py:195-221)."""
    csr = batch.data[0]
    sq = jsp.CSRNDArray(csr._sp_data * csr._sp_data, csr._sp_indices,
                        csr._indptr, csr.shape)
    y = batch.label[0].reshape((-1, 1))
    with jag.record():
        lin = jsp.dot(csr, w)
        xv = jsp.dot(csr, v)
        x2v2 = jsp.dot(sq, jmx.nd.square(v))
        pair = 0.5 * jmx.nd.sum(jmx.nd.square(xv) - x2v2, axis=1,
                                keepdims=True)
        out = lin + pair + b
        loss = jmx.nd.mean(jmx.nd.log(1 + jmx.nd.exp(-(2 * y - 1) * out)))
    loss.backward()
    touched = np.unique(np.asarray(csr._sp_indices))
    rows = jsp.jnp.asarray(touched.astype(np.int32))
    kv.push(0, jsp.RowSparseNDArray(w.grad._read()[rows] * batch_size, rows,
                                    w.shape))
    kv.push(1, jsp.RowSparseNDArray(v.grad._read()[rows] * batch_size, rows,
                                    v.shape))
    for key, param in ((0, w), (1, v)):
        tmp = jsp.zeros("row_sparse", param.shape)
        kv.row_sparse_pull(key, out=tmp, row_ids=jmx.nd.array(touched))
        param._write(param._read().at[tmp._indices].set(tmp._values))
    b -= bias_lr * b.grad
    for p in (w, v, b):
        p.grad[:] = 0
    return loss


# the narrow copy at the default rates, and at batch 450 (17,550 entries:
# the size at which the card takes #11's presorted route) at other rates
@pytest.mark.parametrize("batch, lr, bias_lr", [
    (50, fz.FM_LR, fz.FM_BIAS_LR), (450, 0.05, 0.2)])
def test_factorization_machine_three_steps_match_reference(tmp_path, batch,
                                                           lr, bias_lr):
    features, factor = 2000, 4
    path = str(tmp_path / "fm.libsvm")
    tu.criteo_libsvm(path, 3 * batch, features, seed=0)
    w, v, b = fz.fm_init(features, factor, seed=1)
    kv = mx.kv.create("local")
    if lr == fz.FM_LR:
        fz.fm_store(kv, w, v, batch)
    else:
        fz.fm_store(kv, w, v, batch, learning_rate=lr)
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=features,
                          batch_size=batch)
    losses = [float(fz.fm_step(kv, bt, w, v, b, batch, bias_lr=bias_lr)
                    .asnumpy()) for bt in it]

    rng = np.random.RandomState(1)
    jv = (rng.randn(features, factor) * 0.05).astype(np.float32)
    jw, jv, jb = (jmx.nd.array(np.zeros((features, 1), np.float32)),
                  jmx.nd.array(jv), jmx.nd.array(np.zeros(1, np.float32)))
    for p in (jw, jv, jb):
        p.attach_grad()
    jkv = jmx.kv.create("local")
    jkv.init(0, jw)
    jkv.init(1, jv)
    jkv.set_optimizer(jmx.optimizer.create(
        "adagrad", learning_rate=lr, rescale_grad=1.0 / batch))
    jit = jmx.io.LibSVMIter(data_libsvm=path, data_shape=features,
                            batch_size=batch)
    jlosses = [float(_jfm_step(jkv, bt, jw, jv, jb, batch, bias_lr)
                     .asnumpy()) for bt in jit]
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=STEPS_REL, atol=0)
    for mine, theirs in ((w, jw), (v, jv), (b, jb)):
        _close(mine, theirs, STEPS_REL)
    assert not np.array_equal(_np(w), np.zeros((features, 1)))
    # the store's weights too
    for key in (0, 1):
        o, jo = (pkg.nd.sparse.zeros("row_sparse", (features,
                                                    1 if key == 0 else factor))
                 for pkg in (mx, jmx))
        kv.pull(key, out=o, ignore_sparse=False)
        jkv.pull(key, out=jo, ignore_sparse=False)
        _close(o, jo, STEPS_REL)


def test_criteo_libsvm_layout(tmp_path):
    path = str(tmp_path / "c.libsvm")
    tu.criteo_libsvm(path, 40, 39 * 10, seed=3)
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=390, batch_size=40)
    csr = next(it).data[0]
    ids = csr.indices.asnumpy().reshape(40, 39)
    assert (np.diff(csr.indptr.asnumpy()) == 39).all()
    # one id a field, each in its own range, ascending along a row
    np.testing.assert_array_equal(ids // 10, np.tile(np.arange(39), (40, 1)))
    vals = csr.data.asnumpy()
    assert vals.min() >= 0 and vals.max() < 1


class _JMFNet(jmx.gluon.HybridBlock):
    """The reference's MFNet (examples/matrix_factorization.py:31-48)."""

    def __init__(self, n_users, n_items, k=16, **kw):
        super().__init__(**kw)
        nn = jmx.gluon.nn
        with self.name_scope():
            self.user = nn.Embedding(n_users, k, sparse_grad=True)
            self.item = nn.Embedding(n_items, k, sparse_grad=True)
            self.user_b = nn.Embedding(n_users, 1, sparse_grad=True)
            self.item_b = nn.Embedding(n_items, 1, sparse_grad=True)

    def hybrid_forward(self, F, user, item):
        p, q = self.user(user), self.item(item)
        score = F.sum(p * q, axis=-1)
        return score + self.user_b(user).reshape((-1,)) \
            + self.item_b(item).reshape((-1,))


def _mf_run(pkg, autograd, net, users, items, ratings, batch, steps):
    init = np.random.RandomState(9)
    for name in sorted(net.collect_params().keys()):
        p = net.collect_params()[name]
        p.set_data(pkg.nd.array(init.normal(0, 0.1, p.shape)
                                .astype(np.float32)))
    loss_fn = pkg.gluon.loss.L2Loss()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9,
                                 "lazy_update": True})
    losses = []
    for s in range(steps):
        sl = slice(s * batch, (s + 1) * batch)
        u = pkg.nd.array(users[sl], dtype="int32")
        i = pkg.nd.array(items[sl], dtype="int32")
        with autograd.record():
            loss = loss_fn(net(u, i), pkg.nd.array(ratings[sl]))
        loss.backward()
        trainer.step(batch)
        losses.append(float(loss.mean().asnumpy()))
    assert trainer._kvstore is None
    return losses, [_np(net.collect_params()[k].data())
                    for k in sorted(net.collect_params().keys())]


# factor 8, and the path's factor 128
@pytest.mark.parametrize("k", [8, 128])
def test_matrix_factorization_three_steps_match_reference(k):
    n_users, n_items, batch, steps = 60, 50, 16, 3
    users, items, ratings, _ = tu.synthetic_ratings(n_users, n_items,
                                                    batch * steps)
    net = fz.MFNet(n_users, n_items, k=k)
    net.initialize(ctx=mx.cpu())
    jnet = _JMFNet(n_users, n_items, k=k)
    jnet.initialize(ctx=jmx.cpu())
    for p in net.collect_params().values():
        assert p.grad_stype == "row_sparse"
    losses, params = _mf_run(mx, ag, net, users, items, ratings, batch, steps)
    jlosses, jparams = _mf_run(jmx, jag, jnet, users, items, ratings, batch,
                               steps)
    np.testing.assert_allclose(losses, jlosses, rtol=STEPS_REL, atol=0)
    for a, b in zip(params, jparams):
        _close(a, b, STEPS_REL)
    # rows no batch touched are bit-unchanged
    names = sorted(net.collect_params().keys())
    init = np.random.RandomState(9)
    ids_of = {net.user.weight.name: users, net.user_b.weight.name: users,
              net.item.weight.name: items, net.item_b.weight.name: items}
    for name, after in zip(names, params):
        before = init.normal(0, 0.1, after.shape).astype(np.float32)
        seen = set(ids_of[name])
        rest = [r for r in range(after.shape[0]) if r not in seen]
        assert rest
        np.testing.assert_array_equal(after[rest], before[rest])
        assert not np.array_equal(after, before)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_gluon_sparse_path_on_the_card_matches_the_cpu():
    """The CSR dot (both orientations) and an Embedding's row-sparse
    gradient through kernel #11 (presorted above 16384 entries), against
    the same calls on the CPU; out-of-range ids take no device assert."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    rng = np.random.RandomState(0)
    m, k, n, nnz_row = 500, 3000, 8, 39
    ids = np.sort(np.stack([rng.choice(k, nnz_row, replace=False)
                            for _ in range(m)]), axis=1).astype(np.int32)
    indptr = np.arange(0, m * nnz_row + 1, nnz_row, dtype=np.int32)
    vals = rng.rand(m * nnz_row).astype(np.float32)
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            csr = sp.csr_matrix((vals, ids.reshape(-1), indptr), shape=(m, k))
            r = mx.nd.array(rng.randn(k, n).astype(np.float32)
                            if not res else res[0][-1])
            r.attach_grad()
            reset_launch_counts()
            with ag.record():
                out = sp.dot(csr, r)
                back = sp.dot(csr, out, transpose_a=True)
                loss = (back * back).sum()
            loss.backward()
            variants = variant_counts()
            res.append((out.asnumpy(), back.asnumpy(), r.grad.asnumpy(),
                        variants, r.asnumpy()))
    (o, bk, g, variants, _), (co, cbk, cg, _, _) = res
    assert variants == {("segment_sum", "presorted"): 4}, variants
    for a, b in ((o, co), (bk, cbk), (g, cg)):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    with mx.gpu(0):
        w = mx.nd.array(np.ones((4, 2), np.float32))
        w.attach_grad(stype="row_sparse")
        with ag.record():
            e = mx.nd.Embedding(mx.nd.array([9, -1, 2, 2], dtype="int32"), w,
                                input_dim=4, output_dim=2, sparse_grad=True)
            loss = (e * 1.0).sum()
        loss.backward()
        got = e.asnumpy()
        assert np.isnan(got[0]).all() and (got[1:] == 1).all()
        np.testing.assert_array_equal(w.grad.indices.asnumpy(), [2, 3])
        np.testing.assert_array_equal(w.grad.data.asnumpy(),
                                      [[2, 2], [1, 1]])
