"""The port's `gluon.rnn` (cells, the fused RNN/LSTM/GRU layers) and
`gluon.contrib.rnn` against the JAX package's, on the reference's own
cases (tests/test_rnn_data.py, tests/test_parity_additions.py).

Both packages build the same block with the same prefix; the reference
initializes it and its parameters are copied into the port by name (or
written to a `.params` file and read back, both ways), then the same
seeded input goes through both. Outputs, states and gradients agree
within 1e-5 (fp32). `unroll(valid_length=...)` is a fault of the
reference that the port fixes (it masks nothing and, given the lengths
by keyword, raises); it is held to its closed form: the outputs without
lengths, zero past each length, and the states of each sequence's last
valid step.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import contrib, rnn
from _torch_seed import _seed_torch  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_host():
    """The port's default context is gpu(0); these tests run on the CPU."""
    with mx.cpu():
        yield


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _copy(ref, port):
    """The reference block's parameters into the port's, by full name."""
    rp, pp = ref.collect_params(), port.collect_params()
    assert sorted(rp.keys()) == sorted(pp.keys())
    for k in rp.keys():
        pp[k].set_data(mx.nd.array(rp[k].data().asnumpy()))


def _close(a, b, tol=TOL, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, msg
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, np.abs(b).max()),
                               err_msg=msg)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy()


def _pair(make, init_input, seed=3):
    """(reference block, port block) with equal parameters: the reference
    initialized (Xavier for weights, random biases) and run once to
    resolve deferred shapes; the port run once the same way, then given
    the reference's values."""
    jb = make(jmx)
    jb.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    init_input(jmx, jb)
    rng = np.random.RandomState(seed)
    for p in jb.collect_params().values():
        if p.name.endswith("bias"):
            p.set_data(jmx.nd.array(rng.randn(*p.shape).astype("float32")
                                    * 0.1))
    with mx.cpu():
        pb = make(mx)
        pb.initialize(ctx=mx.cpu())
        init_input(mx, pb)
    _copy(jb, pb)
    return jb, pb


def _cell(cls_name, **kw):
    def make(pkg):
        return getattr(pkg.gluon.rnn, cls_name)(prefix="c_", **kw)
    return make


def _step_once(pkg, cell, x=None, batch=4):
    x = _x((batch, 6), 1) if x is None else x
    return cell(pkg.nd.array(x), cell.begin_state(batch_size=batch,
                                                  ctx=pkg.cpu()))


@pytest.mark.parametrize("cls_name,n_states", [("RNNCell", 1),
                                               ("LSTMCell", 2),
                                               ("GRUCell", 1)])
def test_cells_one_step_match_reference(cls_name, n_states):
    jc, pc = _pair(_cell(cls_name, hidden_size=10, input_size=6),
                   lambda pkg, c: None)
    x = _x((4, 6), 1)
    h = [_x((4, 10), 2 + i) for i in range(n_states)]
    jo, js = jc(jmx.nd.array(x), [jmx.nd.array(s) for s in h])
    with mx.cpu():
        po, ps = pc(mx.nd.array(x), [mx.nd.array(s) for s in h])
    assert po.shape == (4, 10) and len(ps) == n_states
    _close(po.asnumpy(), jo.asnumpy())
    for a, b in zip(ps, js):
        _close(a.asnumpy(), b.asnumpy())


def test_rnn_cell_relu_and_softsign_activations():
    for act in ("relu", "softsign"):
        jc, pc = _pair(_cell("RNNCell", hidden_size=5, activation=act,
                             input_size=6), lambda pkg, c: None)
        with mx.cpu():
            po, _ = _step_once(mx, pc)
        jo, _ = _step_once(jmx, jc)
        _close(po.asnumpy(), jo.asnumpy(), msg=act)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("merge", [False, True])
def test_lstm_unroll_matches_reference(layout, merge):
    jc, pc = _pair(_cell("LSTMCell", hidden_size=8, input_size=5),
                   lambda pkg, c: None)
    x = _x((2, 3, 5) if layout == "NTC" else (3, 2, 5), 4)
    jo, js = jc.unroll(3, jmx.nd.array(x), layout=layout,
                       merge_outputs=merge)
    with mx.cpu():
        po, ps = pc.unroll(3, mx.nd.array(x), layout=layout,
                           merge_outputs=merge)
    if merge:
        _close(po.asnumpy(), jo.asnumpy())
    else:
        assert len(po) == len(jo) == 3 and po[0].shape == (2, 8)
        for a, b in zip(po, jo):
            _close(a.asnumpy(), b.asnumpy())
    for a, b in zip(ps, js):
        _close(a.asnumpy(), b.asnumpy())


def test_unroll_deferred_input_size_and_gradient():
    """input_size 0: the i2h weight takes its shape from the first input
    (the port's cell run first, then given the reference's values)."""
    jc, pc = _pair(_cell("GRUCell", hidden_size=4),
                   lambda pkg, c: c.unroll(2, pkg.nd.ones((3, 2, 7)),
                                           layout="NTC"))
    assert pc.i2h_weight.shape == (12, 7)
    x = _x((3, 2, 7), 5)
    grads = []
    for pkg, c in ((jmx, jc), (mx, pc)):
        with pkg.cpu():
            xa = pkg.nd.array(x)
            with pkg.autograd.record():
                out, _ = c.unroll(2, xa, layout="NTC", merge_outputs=True)
                loss = (out * out).sum()
            loss.backward()
            grads.append((out.asnumpy(), c.i2h_weight.grad().asnumpy(),
                          c.h2h_bias.grad().asnumpy()))
    for a, b in zip(grads[1], grads[0]):
        _close(a, b)


@pytest.mark.parametrize("merge", [False, True])
def test_unroll_with_valid_length_closed_form(merge):
    """Outputs past each length are zero, the others those of the plain
    unroll; the states are those after each sequence's last valid step
    (the reference's plain unroll of that prefix)."""
    jc, pc = _pair(_cell("LSTMCell", hidden_size=6, input_size=3),
                   lambda pkg, c: None)
    x = _x((3, 5, 3), 6)
    lengths = [2, 5, 1]
    full, _ = jc.unroll(5, jmx.nd.array(x), layout="NTC", merge_outputs=True)
    want = full.asnumpy().copy()
    for n, L in enumerate(lengths):
        want[n, L:] = 0.0
    with mx.cpu():
        out, states = pc.unroll(5, mx.nd.array(x), layout="NTC",
                                merge_outputs=merge,
                                valid_length=mx.nd.array(lengths))
    got = np.stack(_np(out), axis=1) if not merge else out.asnumpy()
    if not merge:
        assert isinstance(out, list) and len(out) == 5
    _close(got, want)
    for n, L in enumerate(lengths):
        _, ref_states = jc.unroll(L, jmx.nd.array(x[n:n + 1, :L]),
                                  layout="NTC")
        for a, b in zip(states, ref_states):
            _close(a.asnumpy()[n], b.asnumpy()[0])


def test_reference_unroll_with_valid_length_raises():
    """Pins the reference's fault that the port fixes: SequenceMask gets
    the lengths as an NDArray by keyword, which its op cannot read."""
    cell = jmx.gluon.rnn.LSTMCell(4, input_size=3)
    cell.initialize()
    with pytest.raises(Exception):
        out, _ = cell.unroll(5, jmx.nd.array(_x((2, 5, 3))), layout="NTC",
                             merge_outputs=True,
                             valid_length=jmx.nd.array([3, 5]))
        out.asnumpy()


def test_sequential_cell_step_and_unroll():
    def make(pkg):
        s = pkg.gluon.rnn.SequentialRNNCell(prefix="s_")
        with s.name_scope():
            s.add(pkg.gluon.rnn.LSTMCell(8, input_size=5, prefix="l0_"))
            s.add(pkg.gluon.rnn.LSTMCell(8, input_size=8, prefix="l1_"))
        return s
    js, ps = _pair(make, lambda pkg, c: None)
    assert len(ps.begin_state(batch_size=2, ctx=mx.cpu())) == 4
    x = _x((2, 5), 7)
    jo, jst = js(jmx.nd.array(x), js.begin_state(batch_size=2))
    with mx.cpu():
        po, pst = ps(mx.nd.array(x), ps.begin_state(batch_size=2))
    _close(po.asnumpy(), jo.asnumpy())
    seq = _x((2, 4, 5), 8)
    jo, jst = js.unroll(4, jmx.nd.array(seq), merge_outputs=True)
    with mx.cpu():
        po, pst = ps.unroll(4, mx.nd.array(seq), merge_outputs=True)
    _close(po.asnumpy(), jo.asnumpy())
    for a, b in zip(pst, jst):
        _close(a.asnumpy(), b.asnumpy())


def test_residual_and_bidirectional_cells():
    jr, pr = _pair(lambda pkg: pkg.gluon.rnn.ResidualCell(
        pkg.gluon.rnn.GRUCell(5, input_size=5, prefix="g_")),
        lambda pkg, c: None)
    x = _x((2, 3, 5), 9)
    for merge in (False, True):
        jo, _ = jr.unroll(3, jmx.nd.array(x), merge_outputs=merge)
        with mx.cpu():
            po, _ = pr.unroll(3, mx.nd.array(x), merge_outputs=merge)
        _close(np.stack(_np(po)) if not merge else po.asnumpy(),
               np.stack(_np(jo)) if not merge else jo.asnumpy())

    def bi(pkg):
        return pkg.gluon.rnn.BidirectionalCell(
            pkg.gluon.rnn.LSTMCell(4, input_size=5, prefix="l_"),
            pkg.gluon.rnn.LSTMCell(4, input_size=5, prefix="r_"))
    jb, pb = _pair(bi, lambda pkg, c: None)
    jo, js = jb.unroll(3, jmx.nd.array(x), merge_outputs=True)
    with mx.cpu():
        po, ps = pb.unroll(3, mx.nd.array(x), merge_outputs=True)
        with pytest.raises(NotImplementedError):
            pb(mx.nd.array(x[:, 0]), ps)
    assert po.shape == (2, 3, 8) and len(ps) == 4
    _close(po.asnumpy(), jo.asnumpy())
    for a, b in zip(ps, js):
        _close(a.asnumpy(), b.asnumpy())


def test_zoneout_cell():
    """Outside training the zoneout masks are ones: the base cell's
    output, as the reference gives it. While training each output element
    is the new output or the previous one: at the first step, zero."""
    def make(pkg):
        return pkg.gluon.rnn.ZoneoutCell(
            pkg.gluon.rnn.RNNCell(6, input_size=6, prefix="z_"),
            zoneout_outputs=0.5, zoneout_states=0.3)
    jz, pz = _pair(make, lambda pkg, c: None)
    x = _x((4, 3, 6), 10)
    jo, _ = jz.unroll(3, jmx.nd.array(x), merge_outputs=True)
    with mx.cpu():
        po, _ = pz.unroll(3, mx.nd.array(x), merge_outputs=True)
        _close(po.asnumpy(), jo.asnumpy())
        mx.random.seed(0)
        with mx.autograd.record():
            pt, _ = pz.unroll(3, mx.nd.array(x), merge_outputs=False)
    # the first step: each element the new output or the zero before it
    first = pt[0].asnumpy()
    new = np.isclose(first, po.asnumpy()[:, 0], atol=1e-6)
    assert (new | (first == 0)).all()
    assert 0.2 < new.mean() < 0.8


@pytest.mark.parametrize("cls_name,n_states", [("LSTM", 2), ("GRU", 1),
                                               ("RNN", 1)])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
def test_fused_layers_match_reference(cls_name, n_states, layout):
    """Two layers, deferred input size; with and without begin states."""
    def make(pkg):
        return getattr(pkg.gluon.rnn, cls_name)(
            hidden_size=8, num_layers=2, layout=layout, prefix="f_")
    shape = (5, 3, 6) if layout == "TNC" else (3, 5, 6)
    jl, pl = _pair(make, lambda pkg, c: c(pkg.nd.ones(shape)))
    x = _x(shape, 11)
    _close(_np(pl(mx.nd.array(x, ctx=mx.cpu()))),
           _np(jl(jmx.nd.array(x))))
    states = [_x((2, 3, 8), 12 + i) for i in range(n_states)]
    jo, js = jl(jmx.nd.array(x), [jmx.nd.array(s) for s in states])
    with mx.cpu():
        po, ps = pl(mx.nd.array(x), [mx.nd.array(s) for s in states])
    assert len(ps) == n_states and ps[0].shape == (2, 3, 8)
    _close(po.asnumpy(), jo.asnumpy())
    for a, b in zip(ps, js):
        _close(a.asnumpy(), b.asnumpy())
    with mx.cpu(), pytest.raises(ValueError):
        pl(mx.nd.array(x), [mx.nd.zeros((1, 3, 8))] * n_states)


def test_fused_bidirectional_ntc_and_gradients():
    def make(pkg):
        return pkg.gluon.rnn.LSTM(hidden_size=4, num_layers=2, layout="NTC",
                                  bidirectional=True, prefix="b_")
    jl, pl = _pair(make, lambda pkg, c: c(pkg.nd.ones((3, 5, 6))))
    assert sorted(pl.collect_params().keys()) == sorted(
        "b_%s%d_%s_%s" % (d, i, g, k) for d in "lr" for i in range(2)
        for g in ("i2h", "h2h") for k in ("weight", "bias"))
    x = _x((3, 5, 6), 13)
    w = _x((3, 5, 8), 14)
    grads = []
    for pkg, layer in ((jmx, jl), (mx, pl)):
        with pkg.cpu():
            xa = pkg.nd.array(x)
            xa.attach_grad()
            with pkg.autograd.record():
                out = layer(xa)
                loss = (out * pkg.nd.array(w)).sum()
            loss.backward()
            grads.append([out.asnumpy(), xa.grad.asnumpy()] + [
                layer.collect_params()[k].grad().asnumpy()
                for k in sorted(layer.collect_params().keys())])
    assert grads[1][0].shape == (3, 5, 8)
    for a, b in zip(grads[1], grads[0]):
        _close(a, b)


def test_fused_lstm_matches_the_cell():
    """The fused layer against the unfused cell with the same weights (the
    reference's own check, on the port alone)."""
    with mx.cpu():
        layer = rnn.LSTM(hidden_size=5, num_layers=1, input_size=3)
        layer.initialize(mx.init.Xavier())
        cell = rnn.LSTMCell(5, input_size=3)
        cell.initialize()
        for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            getattr(cell, name).set_data(getattr(layer, "l0_" + name).data())
        x = mx.nd.array(_x((4, 2, 3), 15))
        fused = layer(x).asnumpy()
        outs, _ = cell.unroll(4, x, layout="TNC", merge_outputs=False)
    for t in range(4):
        np.testing.assert_allclose(fused[t], outs[t].asnumpy(), rtol=1e-5,
                                   atol=1e-6)


def test_layer_begin_state_and_repr():
    with mx.cpu():
        layer = rnn.GRU(7, num_layers=3, bidirectional=True, dropout=0.2)
        st = layer.begin_state(batch_size=2)
    assert [s.shape for s in st] == [(6, 2, 7)]
    assert repr(layer) == repr(jmx.gluon.rnn.GRU(
        7, num_layers=3, bidirectional=True, dropout=0.2))


class _Net:
    """A block holding an Embedding, a fused LSTM and a Dense, as the word
    LM does, in either package."""

    @staticmethod
    def make(pkg):
        class Net(pkg.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.embed = pkg.gluon.nn.Embedding(20, 6)
                    self.lstm = pkg.gluon.rnn.LSTM(5, num_layers=2,
                                                   layout="NTC")
                    self.proj = pkg.gluon.nn.Dense(20, flatten=False)

            def hybrid_forward(self, F, x):
                return self.proj(self.lstm(self.embed(x)))
        return Net(prefix="net_")


def test_params_files_cross_both_packages(tmp_path):
    """save_parameters in one package, load_parameters in the other: the
    same structural names, the same logits."""
    ids = np.random.RandomState(16).randint(0, 20, (2, 4)).astype("float32")
    jnet = _Net.make(jmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    want = jnet(jmx.nd.array(ids)).asnumpy()
    f = str(tmp_path / "ref.params")
    jnet.save_parameters(f)
    with mx.cpu():
        pnet = _Net.make(mx)
        pnet.load_parameters(f, ctx=mx.cpu())
        got = pnet(mx.nd.array(ids)).asnumpy()
        g = str(tmp_path / "port.params")
        pnet.save_parameters(g)
    _close(got, want)
    back = _Net.make(jmx)
    back.load_parameters(g, ctx=jmx.cpu())
    _close(back(jmx.nd.array(ids)).asnumpy(), want)
    assert sorted(mx.nd.load(g)) == sorted(jmx.nd.load(f))


# -- gluon.contrib.rnn --------------------------------------------------------
@pytest.mark.parametrize("cls_name,n_states", [("Conv2DLSTMCell", 2),
                                               ("Conv2DGRUCell", 1),
                                               ("Conv2DRNNCell", 1)])
def test_conv2d_cells_unroll_and_grad_match_reference(cls_name, n_states):
    def make(pkg):
        return getattr(pkg.gluon.contrib.rnn, cls_name)(
            input_shape=(3, 8, 8), hidden_channels=5, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1, prefix="conv_")
    jc, pc = _pair(make, lambda pkg, c: None)
    x = np.random.RandomState(0).rand(2, 4, 3, 8, 8).astype("float32")
    res = []
    for pkg, cell in ((jmx, jc), (mx, pc)):
        with pkg.cpu():
            with pkg.autograd.record():
                outs, states = cell.unroll(4, pkg.nd.array(x), layout="NTC",
                                           merge_outputs=True)
                loss = outs.sum()
            loss.backward()
            res.append([outs.asnumpy()] + [s.asnumpy() for s in states] +
                       [cell.i2h_weight.grad().asnumpy(),
                        cell.h2h_weight.grad().asnumpy()])
    assert res[1][0].shape == (2, 4, 5, 8, 8) and len(res[1]) == 3 + n_states
    for a, b in zip(res[1], res[0]):
        _close(a, b)
    assert np.abs(res[1][-2]).max() > 0


def test_conv_cells_1d_3d_raise_until_those_convolutions_come():
    """Named when these six cells raised NotImplementedError until the
    port had 1-D and 3-D convolutions. It has them now, so the same
    constructor calls must build the cells, and one step must keep the
    state's shape ('same' recurrent padding). Their values are held to
    the reference in tests/test_torch_conv_cells_nd.py."""
    cases = [((2, 10), (3, 4, 10), (contrib.rnn.Conv1DLSTMCell,
                                    contrib.rnn.Conv1DRNNCell,
                                    contrib.rnn.Conv1DGRUCell)),
             ((1, 4, 4, 4), (3, 2, 4, 4, 4), (contrib.rnn.Conv3DGRUCell,
                                              contrib.rnn.Conv3DLSTMCell,
                                              contrib.rnn.Conv3DRNNCell))]
    for input_shape, state_shape, classes in cases:
        hidden = state_shape[1]
        for cls in classes:
            with mx.cpu():
                cell = cls(input_shape=input_shape, hidden_channels=hidden,
                           i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
                cell.initialize(ctx=mx.cpu())
                x = mx.nd.ones((3,) + input_shape)
                out, states = cell(x, cell.begin_state(batch_size=3))
            assert out.shape == state_shape
            assert all(st.shape == state_shape for st in states)


def test_conv_cell_shape_rules():
    with pytest.raises(ValueError):
        contrib.rnn.Conv2DLSTMCell(input_shape=(3, 8, 8), hidden_channels=5,
                                   i2h_kernel=3, h2h_kernel=4)
    cell = contrib.rnn.Conv2DRNNCell(input_shape=(3, 8, 8),
                                     hidden_channels=2, i2h_kernel=3,
                                     h2h_kernel=3)
    assert cell.state_info(batch_size=4)[0]["shape"] == (4, 2, 6, 6)


def test_conv_lstm_hybridize_and_checkpoint(tmp_path):
    x = np.random.RandomState(5).rand(2, 3, 3, 8, 8).astype("float32")
    with mx.cpu():
        def build():
            return contrib.rnn.Conv2DLSTMCell(
                input_shape=(3, 8, 8), hidden_channels=4, i2h_kernel=3,
                h2h_kernel=3, i2h_pad=1, prefix="clstm_")
        cell = build()
        cell.initialize(mx.init.Xavier())
        out_e, _ = cell.unroll(3, mx.nd.array(x), layout="NTC",
                               merge_outputs=True)
        cell.hybridize()
        out_h, _ = cell.unroll(3, mx.nd.array(x), layout="NTC",
                               merge_outputs=True)
        np.testing.assert_array_equal(out_e.asnumpy(), out_h.asnumpy())
        f = str(tmp_path / "clstm.params")
        cell.save_parameters(f)
        cell2 = build()
        cell2.load_parameters(f)
        out_l, _ = cell2.unroll(3, mx.nd.array(x), layout="NTC",
                                merge_outputs=True)
    np.testing.assert_array_equal(out_l.asnumpy(), out_e.asnumpy())


def test_lstmp_cell_matches_reference():
    def make(pkg):
        return pkg.gluon.contrib.rnn.LSTMPCell(16, 6, input_size=8,
                                               prefix="p_")
    jc, pc = _pair(make, lambda pkg, c: None)
    x = _x((3, 8), 17)
    res = []
    for pkg, cell in ((jmx, jc), (mx, pc)):
        with pkg.cpu():
            with pkg.autograd.record():
                o, s = cell(pkg.nd.array(x), cell.begin_state(batch_size=3))
                loss = (o * o).sum()
            loss.backward()
            res.append([o.asnumpy(), s[1].asnumpy(),
                        cell.h2r_weight.grad().asnumpy(),
                        cell.i2h_weight.grad().asnumpy()])
    assert res[1][0].shape == (3, 6) and res[1][1].shape == (3, 16)
    assert res[1][2].shape == (6, 16)
    for a, b in zip(res[1], res[0]):
        _close(a, b)


def test_variational_dropout_cell():
    """Outside training: the base cell's outputs, as the reference. While
    training the masks are drawn once: an input element dropped at one
    step is dropped at every step."""
    def make(pkg):
        return pkg.gluon.contrib.rnn.VariationalDropoutCell(
            pkg.gluon.rnn.RNNCell(4, input_size=32, prefix="v_"),
            drop_inputs=0.5, drop_states=0.5, drop_outputs=0.5)
    jc, pc = _pair(make, lambda pkg, c: None)
    x = np.ones((2, 3, 32), "float32")
    jo, _ = jc.unroll(3, jmx.nd.array(x), merge_outputs=True)
    with mx.cpu():
        po, _ = pc.unroll(3, mx.nd.array(x), merge_outputs=True)
        _close(po.asnumpy(), jo.asnumpy())
        mx.random.seed(1)
        with mx.autograd.record():
            pt, _ = pc.unroll(3, mx.nd.array(x), merge_outputs=True)
        mask = pc._input_mask.asnumpy()
    assert set(np.unique(mask)) <= {0.0, 2.0} and 0 < mask.mean() < 2
    out = pt.asnumpy()
    zero = out == 0
    assert (zero[:, 0] == zero[:, 1]).all() and (zero[:, 1] == zero[:, 2]).all()
