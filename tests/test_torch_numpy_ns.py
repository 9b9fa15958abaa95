"""`mx.np`, `mx.npx` and Gluon's np mode in the port, against the
reference.

The behaviours of tests/test_numpy_ns.py (np-mode Gluon, hybridized too;
Trainer; the DataLoader with and without a worker; a parameter shared at
two sites; passthrough inputs not retagged) and the indexing, mutation,
zero-dim, operator-protocol and method-surface checks of
tests/test_numpy_behavior.py. Each check runs in both packages where a
value exists and holds the port's values (and types) to the reference's.
The port's random draws come from its own generator and are held to their
distributions in test_torch_numpy_random.py.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

PKGS = [jmx, mx]


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield
    mx.npx.reset_np()
    jmx.npx.reset_np()


def _both(fn, rtol=1e-6, atol=1e-6):
    """Run fn(pkg) in both packages; its dicts of host arrays agree."""
    want, got = fn(jmx), fn(mx)
    assert set(want) == set(got)
    for k in want:
        w, g = onp.asarray(want[k]), onp.asarray(got[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype.kind in "fc":
            onp.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                        err_msg=k)
        else:
            onp.testing.assert_array_equal(g, w, err_msg=k)
    return got


def _h(x):
    return x.asnumpy()


# ---------------------------------------------------------------------------
# tests/test_numpy_ns.py
# ---------------------------------------------------------------------------
def test_np_creation_and_elementwise():
    def run(pkg):
        a = pkg.np.arange(6).reshape((2, 3))
        b = pkg.np.ones((2, 3))
        out = pkg.np.add(a, b)
        assert out.dtype == onp.float32 and a.dtype == onp.int32
        return {"out": _h(out), "sum": _h(pkg.np.sum(out)),
                "exp": _h(pkg.np.exp(pkg.np.zeros((3,))))}
    got = _both(run)
    assert float(got["sum"]) == 21


def test_np_matmul_and_reductions():
    a0 = onp.random.RandomState(1).rand(3, 4).astype("float32")
    b0 = onp.random.RandomState(2).rand(4, 2).astype("float32")

    def run(pkg):
        a, b = pkg.np.array(a0), pkg.np.array(b0)
        return {"mm": _h(pkg.np.matmul(a, b)),
                "mean": _h(pkg.np.mean(a, axis=0)),
                "argmax": _h(pkg.np.argmax(a))}
    _both(run)


def test_np_autograd_flows():
    def run(pkg):
        x = pkg.np.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.np.sum(pkg.np.square(pkg.np.sin(x)))
        y.backward()
        return {"grad": _h(x.grad)}
    got = _both(run)
    expect = 2 * onp.sin([1, 2, 3]) * onp.cos([1, 2, 3])
    onp.testing.assert_allclose(got["grad"], expect, rtol=1e-5)


def test_np_manipulation():
    def run(pkg):
        a = pkg.np.arange(12).reshape((3, 4))
        st = pkg.np.stack([a, a])
        sp = pkg.np.split(a, 2, axis=1)
        w = pkg.np.where(a > 5, a, pkg.np.zeros_like(a))
        assert st.shape == (2, 3, 4) and len(sp) == 2
        return {"sp0": _h(sp[0]), "w": _h(w), "t": _h(pkg.np.transpose(a))}
    _both(run)


def test_np_random_seeded():
    mx.np.random.seed(3)
    a = mx.np.random.uniform(size=(5,)).asnumpy()
    mx.np.random.seed(3)
    b = mx.np.random.uniform(size=(5,)).asnumpy()
    onp.testing.assert_array_equal(a, b)
    r = mx.np.random.randint(0, 10, size=(100,)).asnumpy()
    assert r.min() >= 0 and r.max() < 10 and r.dtype == onp.int32
    n = mx.np.random.normal(2.0, 0.1, size=(2000,)).asnumpy()
    assert abs(n.mean() - 2.0) < 0.05


def test_npx_ops_and_np_mode():
    def run(pkg):
        x = pkg.np.array([[1.0, 2.0, 3.0]])
        s = pkg.npx.softmax(x)
        assert not pkg.npx.is_np_array()
        pkg.npx.set_np()
        assert pkg.npx.is_np_array() and pkg.npx.is_np_shape()
        assert pkg.util.is_np_array()
        pkg.npx.reset_np()
        assert not pkg.npx.is_np_shape()
        with pkg.util.np_array(True):
            assert pkg.npx.is_np_array() and not pkg.npx.is_np_shape()
        assert not pkg.npx.is_np_array()

        @pkg.util.use_np
        def inside():
            return pkg.npx.is_np_array() and pkg.npx.is_np_shape()
        assert inside() and not pkg.npx.is_np_array()
        r = pkg.npx.relu(pkg.np.array([-1.0, 2.0]))
        assert type(r) is pkg.np.ndarray
        with pkg.util.np_array(True):
            d = pkg.util.default_array([1.0, 2.0])
        assert type(d) is pkg.np.ndarray
        assert type(pkg.util.default_array([1.0])) is pkg.nd.NDArray
        return {"s": _h(s), "r": _h(r)}
    _both(run)


def test_np_ndarray_is_distinct_type():
    x = mx.np.array([[1.0, 2.0], [3.0, 4.0]])
    assert isinstance(x, mx.np.ndarray) and isinstance(x, mx.nd.NDArray)
    assert type(x) is not mx.nd.NDArray
    assert type((x + 1) * 2) is mx.np.ndarray
    assert type(x.sum()) is mx.np.ndarray
    assert type(x.T) is mx.np.ndarray
    assert type(mx.np.exp(x)) is mx.np.ndarray
    assert type(mx.np.random.normal(size=(2,))) is mx.np.ndarray
    with pytest.raises(TypeError):
        hash(x)


def test_np_ndarray_numpy_semantics():
    def run(pkg):
        x = pkg.np.array([1.0, -2.0, 3.0, -4.0])
        pos = x[x > 0]
        assert type(pos) is pkg.np.ndarray
        fancy = x[pkg.np.array([0, 3]).astype("int32")]
        s = x.sum()
        assert s.shape == () and abs(s.item() - (-2.0)) < 1e-6
        assert x.tolist() == [1.0, -2.0, 3.0, -4.0]
        assert repr(x).startswith("array(")
        rows = list(pkg.np.array([[1, 2], [3, 4]]).astype("float32"))
        assert len(rows) == 2 and type(rows[0]) is pkg.np.ndarray
        return {"pos": _h(pos), "fancy": _h(fancy)}
    _both(run)


def test_np_nd_interop_and_autograd():
    def run(pkg):
        x = pkg.np.array([2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.np.sum(x * x)
        y.backward()
        legacy = x.as_nd_ndarray()
        assert type(legacy) is pkg.nd.NDArray
        return {"grad": _h(x.grad), "legacy": _h(legacy)}
    _both(run)


def test_np_linalg_namespace():
    rng = onp.random.RandomState(0)
    a0 = rng.randn(4, 4).astype(onp.float32)

    def run(pkg):
        np = pkg.np
        a = np.array(a0)
        spd = np.matmul(a, a.T) + 4 * np.eye(4)
        L = np.linalg.cholesky(spd)
        u, s, vt = np.linalg.svd(a)
        x = np.linalg.solve(spd, np.ones((4,)))
        inv = np.linalg.inv(spd)
        sign, logdet = np.linalg.slogdet(spd)
        qq, rr = np.linalg.qr(a)
        assert type(L) is np.ndarray and type(u) is np.ndarray
        w = np.array(onp.eye(3, dtype=onp.float32) * 2.0)
        w.attach_grad()
        with pkg.autograd.record():
            y = np.linalg.det(w)
        y.backward()
        return {"norm": _h(np.linalg.norm(a)), "L": _h(L), "s": _h(s),
                "usv": (_h(u) * _h(s)) @ _h(vt), "x": _h(x), "inv": _h(inv),
                "sign": _h(sign), "logdet": _h(logdet),
                "qr": _h(np.matmul(qq, rr)), "dgrad": _h(w.grad)}
    got = _both(run, rtol=1e-4, atol=1e-4)
    onp.testing.assert_allclose(got["dgrad"], onp.eye(3) * 4.0, atol=1e-4)


def test_np_linalg_multioutput_backward():
    rng = onp.random.RandomState(1)
    w0 = (rng.randn(3, 3) @ rng.randn(3, 3).T + 3 * onp.eye(3)).astype(
        onp.float32)
    a0 = rng.randn(3, 5).astype(onp.float32)

    def run(pkg):
        np = pkg.np
        w = np.array(w0)
        w.attach_grad()
        with pkg.autograd.record():
            sign, ld = np.linalg.slogdet(w)
        ld.backward()
        a = np.array(a0)
        a.attach_grad()
        with pkg.autograd.record():
            u, s, vt = np.linalg.svd(a)
            y = np.sum(s)
        assert u.shape == (3, 3) and s.shape == (3,) and vt.shape == (3, 5)
        y.backward()
        h = np.array(w0)
        h.attach_grad()
        with pkg.autograd.record():
            vals, vecs = np.linalg.eigh(h)
            z = np.sum(vals)
        z.backward()
        return {"ld": _h(w.grad), "svd": _h(a.grad), "eigh": _h(h.grad)}
    got = _both(run, rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(got["eigh"], onp.eye(3), atol=1e-4)


def _dense(pkg, units, in_units, w0, b0=None, use_bias=True):
    net = pkg.gluon.nn.Dense(units, in_units=in_units, use_bias=use_bias)
    net.initialize()
    net.weight.set_data(pkg.nd.array(w0))
    if use_bias:
        net.bias.set_data(pkg.nd.array(b0))
    return net


@pytest.mark.parametrize("hybridize", [False, True])
def test_gluon_np_mode(hybridize):
    w0 = onp.random.RandomState(4).randn(4, 3).astype("float32")
    b0 = onp.random.RandomState(5).randn(4).astype("float32")

    def run(pkg):
        net = _dense(pkg, 4, 3, w0, b0)
        if hybridize:
            net.hybridize()
        x_np = pkg.np.array(onp.ones((2, 3), onp.float32))
        try:
            pkg.npx.set_np()
            out = net(x_np)
            assert type(out) is pkg.np.ndarray
            w = net.weight.data()
            assert type(w) is pkg.np.ndarray
            before = float(out.asnumpy().sum())
            w[:] = w * 2.0          # the view writes through
            after = net(x_np)
            assert abs(float(after.asnumpy().sum()) - (
                2.0 * before - float(b0.sum()) * 2)) < 1e-3
        finally:
            pkg.npx.reset_np()
        legacy = net(pkg.nd.ones((2, 3)))
        assert type(legacy) is pkg.nd.NDArray
        return {"out": _h(out), "after": _h(after), "legacy": _h(legacy)}
    _both(run, rtol=1e-5, atol=1e-5)


def test_gluon_np_mode_training_updates_params():
    w0 = onp.random.RandomState(6).randn(3, 4).astype("float32")
    b0 = onp.zeros(3, "float32")

    def run(pkg):
        try:
            pkg.npx.set_np()
            net = _dense(pkg, 3, 4, w0, b0)
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.5})
            x = pkg.np.array(onp.arange(8, dtype=onp.float32).reshape(2, 4))
            before = net.weight.data().asnumpy().copy()
            with pkg.autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            g = net.weight.grad().asnumpy()
            assert float(onp.abs(g).sum()) > 0
            tr.step(2)
            after = net.weight.data().asnumpy()
            assert not onp.allclose(after, before)
        finally:
            pkg.npx.reset_np()
        return {"g": g, "after": after}
    _both(run, rtol=1e-5, atol=1e-5)


def test_gluon_np_mode_passthrough_does_not_mutate_caller():
    for pkg in PKGS:
        class Identity(pkg.gluon.Block):
            def forward(self, x):
                return x
        try:
            pkg.npx.set_np()
            x = pkg.nd.ones((2, 2))
            out = Identity()(x)
            assert type(x) is pkg.nd.NDArray
            assert type(out) is pkg.np.ndarray
            out[0, 0] = 5.0
            assert float(x.asnumpy()[0, 0]) == 5.0
        finally:
            pkg.npx.reset_np()


def test_gluon_np_mode_passthrough_keeps_the_tape():
    """Backward through an identity block's np view reaches the input."""
    class Identity(mx.gluon.Block):
        def forward(self, x):
            return x
    try:
        mx.npx.set_np()
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = Identity()(x * 3)
            z = (y * y).sum()
        z.backward()
        onp.testing.assert_allclose(x.grad.asnumpy(), [18.0, 36.0])
    finally:
        mx.npx.reset_np()


@pytest.mark.parametrize("workers", [0, 1])
def test_dataloader_np_mode(workers):
    for pkg in PKGS:
        ds = pkg.gluon.data.ArrayDataset(
            onp.arange(12, dtype=onp.float32).reshape(6, 2),
            onp.arange(6, dtype=onp.float32))
        try:
            pkg.npx.set_np()
            loader = pkg.gluon.data.DataLoader(ds, batch_size=3,
                                               num_workers=workers)
            xb, yb = next(iter(loader))
            assert type(xb) is pkg.np.ndarray and type(yb) is pkg.np.ndarray
            assert xb.shape == (3, 2)
            onp.testing.assert_array_equal(xb.asnumpy(), [[0, 1], [2, 3],
                                                          [4, 5]])
            del loader
        finally:
            pkg.npx.reset_np()
        if workers == 0:
            loader = pkg.gluon.data.DataLoader(ds, batch_size=3)
            xb, _ = next(iter(loader))
            assert type(xb) is pkg.nd.NDArray


def test_np_mode_shared_param_two_sites_accumulates():
    def run(pkg):
        try:
            pkg.npx.set_np()
            net = _dense(pkg, 1, 2, onp.array([[0.5, -1.0]], "float32"),
                         use_bias=False)
            a = pkg.np.array(onp.array([[1.0, 0.0]], onp.float32))
            b = pkg.np.array(onp.array([[0.0, 1.0]], onp.float32))
            assert net.weight.data() is net.weight.data()
            with pkg.autograd.record():
                loss = (net(a) + net(b)).sum()
            loss.backward()
            g = net.weight.grad().asnumpy()
        finally:
            pkg.npx.reset_np()
        return {"g": g}
    got = _both(run)
    onp.testing.assert_allclose(got["g"], [[1.0, 1.0]], atol=1e-6)


def test_np_mode_container_passthrough_not_mutated():
    for pkg in PKGS:
        class First(pkg.gluon.Block):
            def forward(self, pair):
                return pair[0]
        try:
            pkg.npx.set_np()
            a, b = pkg.nd.ones((2,)), pkg.nd.zeros((2,))
            out = First()([a, b])
            assert type(a) is pkg.nd.NDArray
            assert type(out) is pkg.np.ndarray
        finally:
            pkg.npx.reset_np()


def test_attach_grad_on_np_array_and_unhashable_leaves():
    """np arrays are unhashable: the tape keys its variables by identity."""
    x = mx.np.array([1.0, 2.0])
    y = mx.np.array([3.0, 4.0])
    for v in (x, y):
        v.attach_grad()
    with mx.autograd.record():
        z = (x * y).sum()
    z.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), [3.0, 4.0])
    onp.testing.assert_allclose(y.grad.asnumpy(), [1.0, 2.0])
    assert type(x.grad) is mx.np.ndarray


# ---------------------------------------------------------------------------
# tests/test_numpy_behavior.py: indexing, mutation, zero-dim, protocols,
# the method surface
# ---------------------------------------------------------------------------
BASIC_KEYS = [0, -1, (0, 1), (slice(None), 1), (slice(1, None),),
              (0, slice(None, None, 2)), (Ellipsis, 0), (None, 0),
              (0, None, 1), (slice(None), slice(None, None, -1)),
              (1, slice(2, 0, -1), slice(None))]


@pytest.mark.parametrize("key", BASIC_KEYS, ids=[str(k) for k in BASIC_KEYS])
def test_basic_indexing_matches_numpy(key):
    x = onp.arange(24.0, dtype="float32").reshape(2, 3, 4)
    got = mx.np.array(x)[key]
    assert type(got) is mx.np.ndarray
    onp.testing.assert_array_equal(got.asnumpy(), x[key])


SET_KEYS = [(slice(None, None, -1), 1), (1, slice(None, None, -2)),
            (Ellipsis, slice(None, None, -1)), (slice(None), slice(3, 0, -1)),
            (slice(2, None), 0), (0, slice(1, 3))]


@pytest.mark.parametrize("key", SET_KEYS, ids=[str(k) for k in SET_KEYS])
def test_basic_index_assignment_matches_numpy(key):
    x = onp.arange(12.0, dtype="float32").reshape(3, 4)
    m = mx.np.array(x)
    v = onp.arange(100.0, 100.0 + x[key].size, dtype="float32").reshape(
        x[key].shape)
    m[key] = mx.np.array(v)
    x[key] = v
    onp.testing.assert_array_equal(m.asnumpy(), x)


def test_boolean_mask_get_set():
    def run(pkg):
        x = onp.arange(12.0, dtype="float32").reshape(3, 4)
        m = pkg.np.array(x)
        mask = m > 5
        assert mask.dtype == onp.bool_
        sel = m[mask]
        m[mask] = -1.0
        rm = pkg.np.array(onp.array([True, False, True]))
        return {"sel": _h(sel), "m": _h(m), "rows": _h(m[rm])}
    got = _both(run)
    x = onp.arange(12.0, dtype="float32").reshape(3, 4)
    onp.testing.assert_array_equal(got["sel"], x[x > 5])


def test_fancy_indexing_get_set():
    def run(pkg):
        x = onp.arange(12.0, dtype="float32").reshape(3, 4)
        m = pkg.np.array(x)
        idx = pkg.np.array(onp.array([2, 0], dtype="int32"))
        out = {"a": _h(m[idx]), "b": _h(m[idx, 1]), "c": _h(m[idx, idx]),
               "d": _h(m[[0, 2]])}
        m[idx] = 9.0
        m[pkg.np.array([0], dtype="int32"),
          pkg.np.array([3], dtype="int32")] = 7.0
        out["m"] = _h(m)
        return out
    _both(run)


def test_zero_dim_semantics():
    def run(pkg):
        s = pkg.np.array(3.5)
        assert s.shape == () and s.ndim == 0
        assert abs(float(s) - 3.5) < 1e-6 and abs(s.item() - 3.5) < 1e-6
        with pytest.raises(TypeError):
            iter(s)
        r = pkg.np.array([1.0, 2.0]).sum()
        assert r.shape == ()
        return {"sum": _h(s + pkg.np.array([1.0]))}
    _both(run)


def test_operator_protocols_match_reference():
    a0 = onp.array([[1.0, 2.0], [3.0, 4.0]], dtype="float32")
    b0 = onp.array([[5.0, 6.0], [7.0, 8.0]], dtype="float32")
    ia = onp.array([6, 12], dtype="int32")
    ib = onp.array([3, 10], dtype="int32")

    def run(pkg):
        ma, mb = pkg.np.array(a0), pkg.np.array(b0)
        q, r = divmod(ma, mb)
        mi, mj = pkg.np.array(ia), pkg.np.array(ib)
        out = {"mm": _h(ma @ mb), "fd": _h(ma // mb), "mod": _h(ma % mb),
               "q": _h(q), "r": _h(r), "and": _h(mi & mj), "or": _h(mi | mj),
               "xor": _h(mi ^ mj), "inv": _h(~mi), "ls": _h(mi << 1),
               "rs": _h(mi >> 1), "pow": _h(ma ** 2), "rpow": _h(2 ** ma),
               "neg": _h(-ma), "abs": _h(abs(-ma)), "rsub": _h(1 - ma),
               "rdiv": _h(1 / ma)}
        assert (ma > 2).dtype == onp.bool_
        c = pkg.np.array(a0.copy())
        c += 1
        out["iadd"] = _h(c)
        c = pkg.np.array(a0.copy())
        c //= 2
        out["ifloordiv"] = _h(c)
        c = pkg.np.array(a0.copy())
        c **= 2
        out["ipow"] = _h(c)
        c = pkg.np.array(a0.copy())
        c -= 0.5
        c *= 3
        c /= 2
        out["isub_imul_idiv"] = _h(c)
        assert 3.0 in ma and 99.0 not in ma
        return out
    _both(run)


def test_inplace_ops_write_the_same_tensor():
    """x -= y writes into x's own storage: a parameter table holding x sees
    the update (the hand-rolled optimizers rely on it)."""
    x = mx.np.array([1.0, 2.0])
    table = {"w": x}
    ptr = x._data.data_ptr()
    x -= mx.np.array([0.5, 0.5])
    assert table["w"] is x and x._data.data_ptr() == ptr
    onp.testing.assert_array_equal(table["w"].asnumpy(), [0.5, 1.5])


def test_numpy_deviation_defaults():
    def run(pkg):
        np = pkg.np
        assert np.array([1, 2]).dtype == onp.float32
        assert np.array(onp.array([1, 2], dtype="int64")).dtype == onp.int32
        assert np.array(onp.ones(3, dtype="float64")).dtype == onp.float32
        assert np.array(onp.array([1, 2], dtype="int16")).dtype == \
            onp.int16
        assert np.array(onp.ones(3, dtype="float16")).dtype == onp.float16
        assert np.arange(5).dtype == onp.int32
        assert np.argmax(np.array([1.0, 2.0])).dtype == onp.int32
        assert np.mean(np.arange(4)).dtype == onp.float32
        assert np.divide(np.arange(4), 2).dtype == onp.float32
        assert np.sum(np.array(onp.ones(3, "int8"))).dtype == onp.int32
        assert np.linspace(0, 1, 3).dtype == onp.float32
        return {}
    _both(run)


def test_method_surface_matches_reference():
    x = onp.random.RandomState(3).rand(4, 5).astype("float32")

    def run(pkg):
        m = pkg.np.array(x)
        nz = m.nonzero()
        y = pkg.np.array([3.0, 1.0, 2.0])
        y.sort()
        z = pkg.np.zeros((2, 2))
        z.fill(7.0)
        assert m.flatten().shape == (20,) and m.ravel().shape == (20,)
        assert m.itemsize == 4 and m.nbytes == 80
        assert m.tobytes() == x.tobytes()
        flat = [round(v.item(), 3) for v in
                pkg.np.array([[1., 2.], [3., 4.]]).flat]
        assert flat == [1.0, 2.0, 3.0, 4.0]
        return {"std": _h(m.std()), "var": _h(m.var(axis=1)),
                "cumsum": _h(m.cumsum(axis=0)),
                "argsort": _h(m.argsort(axis=1)),
                "diag": _h(m.diagonal()), "trace": _h(m.trace()),
                "dot": _h(m.dot(m.T)), "ptp": _h(m.ptp()),
                "round": _h(m.round(2)),
                "take": _h(m.take(pkg.np.array([0, 2], dtype="int32"),
                                  axis=1)),
                "nz0": _h(nz[0]), "nz1": _h(nz[1]), "sorted": _h(y),
                "fill": _h(z), "max": _h(m.max(axis=0)),
                "min": _h(m.min()), "mean": _h(m.mean(axis=1)),
                "prod": _h(m.prod(axis=0)), "all": _h(m.all()),
                "any": _h((m > 0.9).any(axis=1)),
                "clip": _h(m.clip(0.2, 0.7)),
                "repeat": _h(m.repeat(2, axis=0)),
                "argmax": _h(m.argmax(axis=1)),
                "squeeze": _h(m[None].squeeze(0)),
                "swap": _h(m.swapaxes(0, 1)), "tile": _h(m.tile(2)),
                "reshape": _h(m.reshape(5, 4)),
                "transpose": _h(m.transpose(1, 0)),
                "astype": _h(m.astype("int32")),
                "searchsorted": _h(pkg.np.array([0.1, 0.5, 0.9])
                                   .searchsorted(pkg.np.array([0.3])))}
    _both(run)


def test_mutating_functions_match_reference():
    def run(pkg):
        np = pkg.np
        m = np.array(onp.eye(3, dtype="float32"))
        np.fill_diagonal(m, 5.0)
        a = _h(m)
        np.place(m, m == 0.0, 9.0)
        b = _h(m)
        np.put(m, onp.array([0, 20]), -1.0)
        c = _h(m)
        dst = np.zeros((3, 3))
        np.copyto(dst, m)
        e = np.zeros((2, 3))
        np.put_along_axis(e, onp.array([[1], [2]]), 4.0, 1)
        f = np.zeros((2, 2))
        np.copyto(f, np.ones((2, 2)), where=np.array([[True, False],
                                                      [False, True]]))
        return {"fill": a, "place": b, "put": c, "copyto": _h(dst),
                "pal": _h(e), "where": _h(f)}
    _both(run)


def test_logic_and_type_inspection():
    a = mx.np.array([1.0, 2.0])
    assert bool(mx.np.allclose(a, a)) and bool(mx.np.array_equal(a, a))
    assert not bool(mx.np.array_equal(a, a + 1))
    assert mx.np.isscalar(3.0) and not mx.np.isscalar(a)
    assert mx.np.result_type(a, onp.float64) == onp.float64
    assert mx.np.iscomplexobj(mx.np.array(onp.array([1 + 1j]))) is True
    assert mx.np.isrealobj(a) is True
    assert mx.np.shape(a) == (2,) and mx.np.ndim(a) == 1 and \
        mx.np.size(a) == 2
    assert mx.np.shares_memory(a, a[0:1])
    assert not mx.np.shares_memory(a, a.copy())


def test_save_load_roundtrip(tmp_path):
    x = mx.np.array(onp.random.rand(3, 2).astype("float32"))
    p = str(tmp_path / "arr.npy")
    mx.np.save(p, x)
    onp.testing.assert_array_equal(mx.np.load(p).asnumpy(), x.asnumpy())
    mx.np.savez(str(tmp_path / "z.npz"), a=x)
    onp.testing.assert_array_equal(
        mx.np.load(str(tmp_path / "z.npz"))["a"], x.asnumpy())
    mx.np.savetxt(str(tmp_path / "t.txt"), x)
    onp.testing.assert_allclose(
        mx.np.loadtxt(str(tmp_path / "t.txt")).asnumpy(), x.asnumpy(),
        rtol=1e-6)
    mx.npx.save(str(tmp_path / "p.params"), {"x": x})
    back = mx.npx.load(str(tmp_path / "p.params"))
    assert type(back["x"]) is mx.np.ndarray


def test_asarray_does_not_mutate_legacy_array():
    a = mx.nd.array([[1.0, 2.0], [3.0, 4.0]])
    d = {a: "cached"}
    view = mx.np.asarray(a)
    assert type(a) is mx.nd.NDArray and d[a] == "cached"
    assert type(view) is mx.np.ndarray
    a[0, 0] = 9.0
    assert abs(view[0, 0].item() - 9.0) < 1e-6
    view[1, 1] = -1.0
    assert abs(float(a.asnumpy()[1, 1]) - (-1.0)) < 1e-6
    assert view.flatten().shape == (4,)


def test_window_block_and_indexers_match_reference():
    def run(pkg):
        np = pkg.np
        return {
            "block": _h(np.block([[np.ones((2, 2)), np.zeros((2, 2))]])),
            "c_": _h(np.c_[np.array([1., 2.]), np.array([3., 4.])]),
            "r_": _h(np.r_[np.array([1., 2.]), np.array([3., 4.])]),
            "r_slice": _h(np.r_[0:5]), "r_lin": _h(np.r_[0:1:5j]),
            "r_mixed": _h(np.r_[np.array([9.0]), 0:3]),
            "cat": _h(np.concatenate((np.ones((2, 3)),) * 2, 1)),
            "stk": _h(np.stack((np.ones((2, 3)),) * 2, 1)),
            "frombuffer": _h(np.frombuffer(b"\x00\x00\x80?",
                                           dtype="float32")),
            "fromiter": _h(np.fromiter(range(4), "float32")),
            "vec": _h(np.vectorize(lambda v: v * 2)(np.array([1.0, 2.0]))),
        }
    _both(run)


def test_npx_softmax_respects_length_and_masked_softmax():
    def run(pkg):
        x = pkg.np.array([[1.0, 2.0, 3.0, 4.0]])
        s = pkg.npx.softmax(x, axis=-1,
                            length=pkg.np.array([2], dtype="int32"))
        d = pkg.np.array(onp.random.RandomState(0).rand(2, 4).astype(
            "float16"))
        m = pkg.np.array(onp.array([[1, 1, 0, 0], [0, 0, 0, 0]],
                                   dtype="float16"))
        ms = pkg.npx.masked_softmax(d, m)
        return {"s": _h(s), "ms": _h(ms).astype("float32")}
    got = _both(run, rtol=1e-3, atol=1e-3)
    assert got["s"][0, 2] == 0.0 and got["s"][0, 3] == 0.0
    assert onp.isfinite(got["ms"]).all()
    onp.testing.assert_allclose(got["ms"][1], 0.0)


def test_take_clips_and_sum_dtype():
    def run(pkg):
        a = pkg.np.array([1.0, 2.0, 3.0])
        big = pkg.np.full((70000,), 1.0, dtype="float16")
        assert onp.isinf(big.sum().asnumpy())
        return {"take": _h(a.take(pkg.np.array([5], dtype="int32"))),
                "sum32": _h(big.sum(dtype="float32"))}
    got = _both(run)
    assert float(got["sum32"]) == 70000.0


NPX_CASES = [
    ("log_softmax", lambda p, x: p.npx.log_softmax(x, axis=-1)),
    ("relu", lambda p, x: p.npx.relu(x)),
    ("sigmoid", lambda p, x: p.npx.sigmoid(x)),
    ("erf", lambda p, x: p.npx.erf(x)),
    ("erfinv", lambda p, x: p.npx.erfinv(x * 0.3)),
    ("gamma", lambda p, x: p.npx.gamma(x * x + 0.5)),
    ("activation", lambda p, x: p.npx.activation(x, act_type="tanh")),
    ("one_hot", lambda p, x: p.npx.one_hot(
        p.np.array([0, 2, 1], dtype="int32"), 4)),
    ("pick", lambda p, x: p.npx.pick(x, p.np.array([0., 3., 1.]))),
    ("topk", lambda p, x: p.npx.topk(x, k=2)),
    ("batch_dot", lambda p, x: p.npx.batch_dot(
        x.reshape(1, 3, 4), x.reshape(1, 3, 4), transpose_b=True)),
    ("embedding", lambda p, x: p.npx.embedding(
        p.np.array([0, 2], dtype="int32"), x, input_dim=3, output_dim=4)),
    ("fully_connected", lambda p, x: p.npx.fully_connected(
        x, x, p.np.ones((3,)), num_hidden=3)),
    ("layer_norm", lambda p, x: p.npx.layer_norm(
        x, p.np.ones((4,)), p.np.zeros((4,)))),
    ("group_norm", lambda p, x: p.npx.group_norm(
        x.reshape(1, 3, 4), p.np.ones((1,)), p.np.zeros((1,)))),
    ("dropout", lambda p, x: p.npx.dropout(x, p=0.0)),
    ("leaky_relu", lambda p, x: p.npx.leaky_relu(x, slope=0.1)),
    ("reshape_like", lambda p, x: p.npx.reshape_like(x, p.np.zeros((4, 3)))),
    ("arange_like", lambda p, x: p.npx.arange_like(x, axis=1)),
    ("broadcast_like", lambda p, x: p.npx.broadcast_like(
        x[0:1], p.np.zeros((3, 4)))),
    ("gather_nd", lambda p, x: p.npx.gather_nd(
        x, p.np.array([[0, 2], [1, 3]], dtype="int32"))),
    ("scatter_nd", lambda p, x: p.npx.scatter_nd(
        p.np.array([5.0, 6.0]), p.np.array([[0, 2], [1, 3]],
                                           dtype="int32"), (3, 4))),
    ("smooth_l1", lambda p, x: p.npx.smooth_l1(x, scalar=1.5)),
    ("sequence_mask", lambda p, x: p.npx.sequence_mask(
        x.reshape(3, 4, 1), p.np.array([1.0, 2.0, 3.0, 1.0]), value=-1.0)),
    ("cast", lambda p, x: p.npx.cast(x, "float16")),
    ("convolution", lambda p, x: p.npx.convolution(
        x.reshape(1, 1, 3, 4), p.np.ones((2, 1, 2, 2)), kernel=(2, 2),
        num_filter=2, no_bias=True)),
    ("deconvolution", lambda p, x: p.npx.deconvolution(
        x.reshape(1, 1, 3, 4), p.np.ones((1, 2, 2, 2)), kernel=(2, 2),
        num_filter=2)),
    ("pooling", lambda p, x: p.npx.pooling(
        x.reshape(1, 1, 3, 4), kernel=(2, 2), pool_type="avg")),
    ("batch_norm", lambda p, x: p.npx.batch_norm(
        x.reshape(1, 3, 4), p.np.ones((3,)), p.np.zeros((3,)),
        p.np.zeros((3,)), p.np.ones((3,)), use_global_stats=True)),
    ("selfatt", lambda p, x: p.npx.interleaved_matmul_selfatt_valatt(
        p.np.array(onp.random.RandomState(2).randn(3, 2, 12).astype(
            "float32")),
        p.npx.softmax(p.npx.interleaved_matmul_selfatt_qk(
            p.np.array(onp.random.RandomState(2).randn(3, 2, 12).astype(
                "float32")), heads=2)), heads=2)),
]


@pytest.mark.parametrize("name,fn", NPX_CASES, ids=[c[0] for c in NPX_CASES])
def test_npx_ops_match_reference(name, fn):
    x0 = onp.random.RandomState(7).randn(3, 4).astype("float32")

    def run(pkg):
        out = fn(pkg, pkg.np.array(x0))
        outs = out if isinstance(out, (list, tuple)) else [out]
        for o in outs:
            assert type(o) is pkg.np.ndarray, type(o)
        return {str(i): _h(o).astype("float32") for i, o in enumerate(outs)}
    _both(run, rtol=1e-5, atol=1e-5)
