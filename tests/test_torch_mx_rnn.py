"""The port's symbolic `mx.rnn` against the JAX package's: the cells'
graphs, `FusedRNNCell` (unfuse, pack/unpack), `BucketSentenceIter`, an
LSTM `BucketingModule` (upstream MXNet's example/rnn/bucketing at narrow
width) and the rnn checkpoints, on the reference's own cases
(tests/test_namespaces.py, tests/test_parity_additions.py).

The same seeded parameters and inputs go through both packages' graphs;
outputs agree within 1e-5 (fp32), and the bucketing module's parameters
after 3 batches within 1e-5. The iterators' batches are equal.
"""
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_host():
    """The port's default context is gpu(0); these tests run on the CPU."""
    with mx.cpu():
        yield


def _close(a, b, tol=TOL, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, msg
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, np.abs(b).max()),
                               err_msg=msg)


def _unnumbered(graph_json):
    return re.sub(r"_scalarconst\d+", "_scalarconst", graph_json)


def _bind_both(make, shapes, seed=0):
    """Each package's graph from `make(pkg)` bound at `shapes`, its
    arguments filled with the same seeded values; forward outputs."""
    rng = np.random.RandomState(seed)
    values = {}
    outs = []
    for pkg in (jmx, mx):
        with pkg.name.NameManager():
            sym = make(pkg)
        ex = sym.simple_bind(pkg.cpu(), grad_req="null", **shapes)
        for name in sym.list_arguments():
            if name not in values:
                values[name] = (rng.randn(*ex.arg_dict[name].shape) * 0.5
                                ).astype("float32")
            ex.arg_dict[name][:] = values[name]
        outs.append([o.asnumpy() for o in ex.forward(is_train=False)])
        outs[-1].append(sym)
    return outs


def test_lstm_unroll_executes_and_matches_reference():
    def make(pkg):
        cell = pkg.rnn.LSTMCell(8, prefix="l0_")
        out, _ = cell.unroll(3, inputs=pkg.sym.Variable("data"),
                             merge_outputs=True)
        return out
    (want, rsym), (got, psym) = [(o[:-1], o[-1]) for o in _bind_both(
        make, dict(data=(2, 3, 4), l0_begin_state_0=(2, 8),
                   l0_begin_state_1=(2, 8)))]
    assert got[0].shape == (2, 3, 8)
    _close(got[0], want[0])
    assert psym.list_arguments() == rsym.list_arguments()
    # literal scalars are named from a process-wide counter in each package
    assert _unnumbered(psym.tojson()) == _unnumbered(rsym.tojson())


def test_stack_and_modifiers_match_reference():
    def make(pkg):
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.GRUCell(8, prefix="g0_"))
        stack.add(pkg.rnn.DropoutCell(0.2))
        stack.add(pkg.rnn.ResidualCell(pkg.rnn.RNNCell(8, prefix="r0_")))
        outs, states = stack.unroll(2, inputs=pkg.sym.Variable("data"),
                                    merge_outputs=True)
        assert len(states) == len(stack.state_info) == 2
        return outs
    shapes = dict(data=(3, 2, 8), g0_begin_state_0=(3, 8),
                  r0_begin_state_0=(3, 8))
    (want, rsym), (got, psym) = [(o[:-1], o[-1])
                                 for o in _bind_both(make, shapes)]
    assert psym.list_arguments() == rsym.list_arguments()
    _close(got[0], want[0])


def test_zoneout_and_encode_sentences():
    z = mx.rnn.ZoneoutCell(mx.rnn.LSTMCell(4, prefix="zl_"),
                           zoneout_states=0.1)
    outs, st = z.unroll(3, mx.sym.Variable("data"))
    assert len(outs) == 3 and len(st) == 2
    with pytest.raises(AssertionError):
        mx.rnn.ZoneoutCell(mx.rnn.FusedRNNCell(4))
    sents = [["a", "b"], ["b", "c", "d"]]
    coded, vocab = mx.rnn.encode_sentences(sents, start_label=1)
    assert (coded, vocab) == jmx.rnn.encode_sentences(sents, start_label=1)
    assert coded == [[1, 2], [2, 3, 4]]
    with pytest.raises(ValueError):
        mx.rnn.encode_sentences([["zzz"]], vocab=dict(vocab))
    assert mx.rnn.encode_sentences([["zzz"]], vocab=dict(vocab),
                                   unknown_token="a")[0] == [[1]]


@pytest.mark.parametrize("mode,layers,bidirectional", [
    ("lstm", 2, False), ("lstm", 1, True), ("gru", 2, False),
    ("rnn_tanh", 1, False)])
def test_fused_cell_matches_reference_and_its_unfused_stack(
        tmp_path, mode, layers, bidirectional):
    """The fused graph against the reference's with the same flat vector;
    then against the port's own unfused stack under the unpacked weights;
    pack the exact inverse of unpack; the rnn checkpoint round trip."""
    H, shape = 4, (2, 5, 6)
    x = np.random.RandomState(0).rand(*shape).astype("float32")
    outs = []
    for pkg in (jmx, mx):
        cell = pkg.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                    bidirectional=bidirectional,
                                    prefix="f_")
        out, _ = cell.unroll(5, pkg.sym.Variable("data"), layout="NTC")
        ex = out.simple_bind(pkg.cpu(), data=shape)
        if pkg is jmx:
            init = jmx.init.FusedRNN(jmx.init.Xavier(), H, layers, mode,
                                     bidirectional=bidirectional)
            init("f_parameters", ex.arg_dict["f_parameters"])
            flat = ex.arg_dict["f_parameters"].asnumpy()
        else:
            ex.arg_dict["f_parameters"][:] = flat
        for k, v in ex.arg_dict.items():
            if "begin_state" in k:
                v[:] = 0.0
        ex.forward(data=x)
        outs.append(ex.outputs[0].asnumpy())
    _close(outs[1], outs[0])

    args = {"f_parameters": mx.nd.array(flat)}
    unpacked = cell.unpack_weights(args)
    assert "f_parameters" not in unpacked
    rwant = jmx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                 bidirectional=bidirectional,
                                 prefix="f_").unpack_weights(
        {"f_parameters": jmx.nd.array(flat)})
    assert sorted(unpacked) == sorted(rwant)
    for k in rwant:
        np.testing.assert_array_equal(unpacked[k].asnumpy(),
                                      rwant[k].asnumpy())
    stack = cell.unfuse()
    uout, _ = stack.unroll(5, mx.sym.Variable("data"), layout="NTC",
                           merge_outputs=True)
    states = {n: (2, H) for n in uout.list_arguments() if "begin_state" in n}
    ex2 = uout.simple_bind(mx.cpu(), data=shape, **states)
    for k, v in unpacked.items():
        ex2.arg_dict[k][:] = v.asnumpy()
    ex2.forward(data=x)
    _close(ex2.outputs[0].asnumpy(), outs[1], tol=2e-5)
    np.testing.assert_array_equal(
        cell.pack_weights(unpacked)["f_parameters"].asnumpy(), flat)

    prefix = str(tmp_path / "cp")
    mx.rnn.save_rnn_checkpoint(cell, prefix, 3, out, dict(args), {})
    _, arg2, _ = mx.rnn.load_rnn_checkpoint(cell, prefix, 3)
    assert sorted(arg2) == sorted(unpacked)
    # the reference reads the port's checkpoint, and the other way round
    _, rarg, _ = jmx.rnn.load_rnn_checkpoint(
        jmx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                             bidirectional=bidirectional, prefix="f_"),
        prefix, 3)
    for k in rarg:
        np.testing.assert_array_equal(rarg[k].asnumpy(), arg2[k].asnumpy())
    rprefix = str(tmp_path / "ref")
    jmx.rnn.save_rnn_checkpoint(
        jmx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                             bidirectional=bidirectional, prefix="f_"),
        rprefix, 1, jmx.sym.load(prefix + "-symbol.json"),
        {k: jmx.nd.array(v.asnumpy()) for k, v in arg2.items()}, {})
    _, packed = mx.model.load_checkpoint(rprefix, 1)[:2]
    np.testing.assert_array_equal(packed["f_parameters"].asnumpy(), flat)


def test_fused_unfuse_structure():
    stack = mx.rnn.FusedRNNCell(16, num_layers=2, mode="lstm",
                                dropout=0.3).unfuse()
    assert [type(c).__name__ for c in stack._cells] == [
        "LSTMCell", "DropoutCell", "LSTMCell"]
    bi = mx.rnn.FusedRNNCell(8, bidirectional=True, mode="gru").unfuse()
    assert isinstance(bi._cells[0], mx.rnn.BidirectionalCell)


def test_do_rnn_checkpoint_callback(tmp_path):
    cell = mx.rnn.FusedRNNCell(3, num_layers=1, mode="gru", prefix="g_")
    out, _ = cell.unroll(2, mx.sym.Variable("data"))
    n = mx.ops.rnn_ops.rnn_param_size("gru", 4, 3, 1)
    args = {"g_parameters": mx.nd.array(np.arange(n, dtype="float32"))}
    prefix = str(tmp_path / "cb")
    mx.rnn.do_rnn_checkpoint(cell, prefix, period=2)(1, out, args, {})
    _, arg, _ = mx.rnn.load_rnn_checkpoint(cell, prefix, 2)
    assert "g_l0_i2h_weight" in arg and arg["g_l0_i2h_weight"].shape == (9, 4)


def _sentences(vocab=50, n=200, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, vocab, rng.randint(2, 16)))
            for _ in range(n)]


@pytest.mark.parametrize("buckets", [[5, 10, 15], None])
def test_bucket_sentence_iter_matches_reference(buckets):
    batches = []
    for pkg in (jmx, mx):
        np.random.seed(4)
        it = pkg.rnn.BucketSentenceIter(
            _sentences(), batch_size=8,
            buckets=list(buckets) if buckets else None, invalid_label=0)
        assert it.provide_data[0].shape == (8, it.default_bucket_key)
        seen = []
        for epoch in range(2):
            it.reset()
            for b in it:
                seen.append((b.bucket_key, b.data[0].asnumpy(),
                             b.label[0].asnumpy(),
                             b.provide_data[0].shape))
        batches.append((it.buckets, it.default_bucket_key, seen))
    (rb, rk, want), (pb, pk, got) = batches
    assert (pb, pk) == (rb, rk) and len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])


V, E, HID, B = 40, 8, 8, 4
BUCKETS = [4, 8, 12]


def _sym_gen(pkg):
    """upstream example/rnn/bucketing/lstm_bucketing.py's graph: 2 stacked
    LSTMCells, zero begin states, merged outputs, FC, SoftmaxOutput."""
    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data=data, input_dim=V, output_dim=E,
                                  name="embed")
        stack = pkg.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(pkg.rnn.LSTMCell(num_hidden=HID,
                                       prefix="lstm_l%d_" % i))
        begin = [pkg.sym.zeros((B, HID)) for _ in range(4)]
        outputs, _ = stack.unroll(seq_len, inputs=embed, begin_state=begin,
                                  merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, HID))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=V, name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _bucketing(pkg, params, n_batches=3):
    with pkg.cpu():
        np.random.seed(1)       # the first 3 batches: buckets 12, 8, 4
        it = pkg.rnn.BucketSentenceIter(_sentences(V, 120, 1), B,
                                        buckets=list(BUCKETS),
                                        invalid_label=0)
        mod = pkg.mod.BucketingModule(_sym_gen(pkg),
                                      default_bucket_key=it.default_bucket_key,
                                      context=pkg.cpu())
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in params.items()},
                        aux_params={})
        mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params={
            "learning_rate": 0.5, "momentum": 0.0, "wd": 1e-5})
        metric = pkg.metric.Perplexity(0)
        outs, keys = [], []
        for i, batch in enumerate(it):
            if i == n_batches:
                break
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            mod.update_metric(metric, batch.label)
            outs.append(mod.get_outputs()[0].asnumpy())
            keys.append(batch.bucket_key)
        args, _ = mod.get_params()
        return outs, keys, {k: v.asnumpy() for k, v in args.items()}, \
            metric.get()[1], mod


def _bucketing_params(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"embed_weight": (V, E), "pred_weight": (V, HID),
              "pred_bias": (V,)}
    for i in range(2):
        shapes.update({"lstm_l%d_i2h_weight" % i: (4 * HID, E if i == 0
                                                    else HID),
                       "lstm_l%d_h2h_weight" % i: (4 * HID, HID),
                       "lstm_l%d_i2h_bias" % i: (4 * HID,),
                       "lstm_l%d_h2h_bias" % i: (4 * HID,)})
    return {k: (rng.randn(*s) * 0.3).astype("float32")
            for k, s in shapes.items()}


def test_lstm_bucketing_module_matches_reference():
    """3 batches of SGD through both packages' BucketingModules over the
    same BucketSentenceIter order: outputs, parameters and perplexity;
    the port builds one whole-graph program per bucket seen and falls
    back on none."""
    params = _bucketing_params()
    telemetry.reset()
    outs, keys, got, ppl, mod = _bucketing(mx, params)
    routs, rkeys, want, rppl, _ = _bucketing(jmx, params)
    assert keys == rkeys == [12, 8, 4]
    assert telemetry.counter_value("compiler.fallback") == 0
    assert telemetry.counter_value("compiler.compile") == len(set(keys))
    for o, r in zip(outs, routs):
        _close(o, r)
    assert sorted(got) == sorted(want) == sorted(params)
    for k in want:
        _close(got[k], want[k], msg=k)
    assert abs(ppl - rppl) <= 1e-5 * rppl
    # the begin states are constants, not arguments to train
    assert not [n for n in mod.symbol.list_arguments() if "begin" in n]
