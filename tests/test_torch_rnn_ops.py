"""The port's fused `RNN` op and the ops of the recurrent cells against
the JAX package's (`mxnet_tpu/ops/rnn_ops.py::_rnn`, `ops/tensor.py`).

The same seeded numpy inputs go through both. The op's outputs and final
states agree within 1e-5 (fp32; measured at most 5e-7) and the gradients
of a weighted sum of all three outputs with respect to the data, the flat
parameters and both begin states, torch.autograd against `jax.grad`,
within 1e-4 (measured at most 2e-6). The split and Sequence* ops are
exact. Inter-layer dropout is a kept deviation (the port draws its mask
from its own generator): a training run with p > 0 is held to the mask's
rate and its 1/(1-p) scale, not to the reference's draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import rnn_ops as ref_rnn
from mxnet_tpu.ops import tensor as ref_tensor
from mxnet_tpu_torch.ops import rnn_ops
from mxnet_tpu_torch.ops import tensor as port_tensor

FWD_TOL = 1e-5
GRAD_TOL = 1e-4

T, N, C, H = 5, 3, 4, 6


def _inputs(mode, bidirectional, layers, seed=0):
    rng = np.random.RandomState(seed)
    ndir = 2 if bidirectional else 1
    n = ref_rnn.rnn_param_size(mode, C, H, layers, bidirectional)
    x = rng.randn(T, N, C).astype("float32")
    p = (rng.randn(n) * 0.3).astype("float32")
    h0 = rng.randn(layers * ndir, N, H).astype("float32")
    c0 = rng.randn(layers * ndir, N, H).astype("float32")
    w = rng.randn(T, N, H * ndir).astype("float32")
    return x, p, h0, c0, w


def _reference(args, w, kw):
    def loss(x, p, h0, c0):
        o, hn, cn = ref_rnn._rnn(x, p, h0, c0, _training=False, **kw)
        return (jnp.sum(o * w) + 0.7 * jnp.sum(hn) + 0.3 * jnp.sum(cn),
                (o, hn, cn))
    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                          has_aux=True)(*args)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port(args, w, kw):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    o, hn, cn = rnn_ops._rnn(*ts, _training=False, **kw)
    ((o * torch.tensor(w)).sum() + 0.7 * hn.sum() + 0.3 * cn.sum()).backward()
    grads = [t.grad.numpy() if t.grad is not None else np.zeros_like(a)
             for t, a in zip(ts, args)]
    return [t.detach().numpy() for t in (o, hn, cn)], grads


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_matches_reference(mode, bidirectional, layers):
    x, p, h0, c0, w = _inputs(mode, bidirectional, layers)
    kw = dict(state_size=H, num_layers=layers, mode=mode,
              bidirectional=bidirectional)
    if mode == "lstm":
        kw.update(lstm_state_clip_min=-0.5, lstm_state_clip_max=0.5)
    want, want_g = _reference((x, p, h0, c0), w, kw)
    got, got_g = _port((x, p, h0, c0), w, kw)
    for name, a, b in zip(("output", "state_n", "cell_n"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=FWD_TOL, err_msg=name)
    for name, a, b in zip(("data", "parameters", "state", "state_cell"),
                          got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_TOL,
                                   err_msg=name)


def test_state_clip_bounds_the_cell_and_only_when_set():
    x, p, h0, c0, _ = _inputs("lstm", False, 1, seed=1)
    args = [torch.tensor(a) for a in (x, p * 8, h0, c0 * 4)]
    kw = dict(state_size=H, num_layers=1, mode="lstm", _training=False)
    _, _, free = rnn_ops._rnn(*args, **kw)
    _, _, clipped = rnn_ops._rnn(*args, lstm_state_clip_min=-0.25,
                                 lstm_state_clip_max=0.25, **kw)
    assert free.abs().max() > 0.25
    assert clipped.abs().max() <= 0.25


def test_ignored_arguments_are_accepted_and_three_outputs_come_back():
    """Copied from the reference: sequence lengths, projection_size,
    state_outputs and lstm_state_clip_nan change nothing."""
    x, p, h0, c0, _ = _inputs("lstm", False, 1)
    args = [torch.tensor(a) for a in (x, p, h0, c0)]
    kw = dict(state_size=H, num_layers=1, mode="lstm", _training=False)
    base = rnn_ops._rnn(*args, **kw)
    other = rnn_ops._rnn(*args, use_sequence_length=True,
                         sequence_length=torch.tensor([1.0, 2.0, 3.0]),
                         projection_size=2, state_outputs=False,
                         lstm_state_clip_nan=True, **kw)
    assert len(base) == len(other) == 3
    for a, b in zip(base, other):
        assert torch.equal(a, b)


def test_inter_layer_dropout_rate_and_scale():
    """Kept deviation: the mask comes from the port's generator. With
    these weights every first-layer output is tanh(1) and the second layer
    passes its input through tanh element by element, so each output
    shows its mask element: tanh(tanh(1) / (1 - p)) kept, 0 dropped."""
    p = 0.5
    n = rnn_ops.rnn_param_size("rnn_tanh", 1, 512, 2)
    flat = torch.zeros(n)
    # layer 0: h = tanh(1 * x) with x = 1; layer 1: h = tanh(W x), W = I
    flat[:512] = 1.0
    off = 512 + 512 * 512
    flat[off:off + 512 * 512] = torch.eye(512).reshape(-1)
    data = torch.ones(64, 8, 1)
    state = torch.zeros(2, 8, 512)
    with mx.cpu():
        mx.random.seed(3)
        out, _, _ = rnn_ops._rnn(data, flat, state, state_size=512,
                                 num_layers=2, mode="rnn_tanh", p=p,
                                 _training=True)
    first = np.tanh(1.0)
    vals = out.numpy().ravel()
    kept = np.isclose(vals, np.tanh(first / (1 - p)), atol=1e-6)
    dropped = np.isclose(vals, 0.0, atol=1e-6)
    assert (kept | dropped).all()
    assert abs(kept.mean() - (1 - p)) < 0.01
    # no dropout outside training or at p = 0
    for kw in (dict(p=p, _training=False), dict(p=0.0, _training=True)):
        out, _, _ = rnn_ops._rnn(data, flat, state, state_size=512,
                                 num_layers=2, mode="rnn_tanh", **kw)
        np.testing.assert_allclose(out.numpy(), np.tanh(first), atol=1e-6)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_param_size_and_its_inverse_match_reference(mode, bidirectional):
    for layers in (1, 3):
        for in_sz in (1, 7, 32):
            n = rnn_ops.rnn_param_size(mode, in_sz, 5, layers,
                                       bidirectional)
            assert n == ref_rnn.rnn_param_size(mode, in_sz, 5, layers,
                                               bidirectional)
            assert rnn_ops.rnn_solve_input_size(
                mode, n, 5, layers, bidirectional) == in_sz
    with pytest.raises(ValueError):
        rnn_ops.rnn_solve_input_size(mode, n + 1, 5, 3, bidirectional)


def test_slices_of_the_flat_vector_match_reference():
    n = rnn_ops.rnn_param_size("gru", 4, 3, 2, True)
    flat = np.arange(n, dtype="float32")
    want = ref_rnn._slice_params(jnp.asarray(flat), "gru", 4, 3, 2, True)
    got = rnn_ops._slice_params(torch.tensor(flat), "gru", 4, 3, 2, True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_rnn_shape_hint_fills_parameters_and_states():
    sym = mx.sym.RNN(mx.sym.var("data"), state_size=H, num_layers=2,
                     mode="lstm", bidirectional=True, name="rnn")
    rsym = jmx.sym.RNN(jmx.sym.var("data"), state_size=H, num_layers=2,
                       mode="lstm", bidirectional=True, name="rnn")
    assert sym.list_arguments() == rsym.list_arguments()
    got = sym.infer_shape(data=(T, N, C))
    want = rsym.infer_shape(data=(T, N, C))
    assert [tuple(s) for s in got[0]] == [tuple(s) for s in want[0]]
    assert [tuple(s) for s in got[1]] == [tuple(s) for s in want[1]]


# -- the ops of the cells ---------------------------------------------------
def _pair(x):
    return torch.tensor(x), jnp.asarray(x)


@pytest.mark.parametrize("kw", [
    dict(num_outputs=3, axis=1), dict(num_outputs=2, axis=-1),
    dict(num_outputs=6, axis=1, squeeze_axis=True),
    dict(num_outputs=1, axis=0)])
def test_split_matches_reference(kw):
    x = np.random.RandomState(0).randn(2, 6, 4).astype("float32")
    t, j = _pair(x)
    got = port_tensor._split(t, **kw)
    want = ref_tensor._split(j, **kw)
    if kw["num_outputs"] == 1:
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert mx.ops.registry.get("SliceChannel") is mx.ops.registry.get("split")


@pytest.mark.parametrize("sections", [3, [1, 4], [2]])
def test_split_v2_matches_reference(sections):
    x = np.random.RandomState(1).randn(6, 2).astype("float32")
    t, j = _pair(x)
    got = port_tensor._split_v2(t, sections, axis=0)
    want = ref_tensor._split_v2_op(j, sections, axis=0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with mx.cpu():
        parts = mx.nd.split_v2(mx.nd.array(x), 6, axis=0, squeeze_axis=True)
    assert len(parts) == 6 and parts[0].shape == (2,)


def test_split_refuses_an_uneven_count():
    with pytest.raises(ValueError):
        port_tensor._split(torch.zeros(2, 5), num_outputs=2, axis=1)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("op", ["SequenceMask", "SequenceLast",
                                "SequenceReverse"])
def test_sequence_ops_match_reference(op, axis):
    """Time on `axis` (SequenceReverse reads time on axis 0 whatever
    `axis` says, as the reference does); lengths 1 to 5 over 5 steps."""
    rng = np.random.RandomState(2)
    x = rng.randn(5, 4, 3).astype("float32")
    if axis == 1 and op != "SequenceReverse":
        x = x.transpose(1, 0, 2).copy()
    lengths = np.array([5, 1, 3, 2], "float32")
    port, ref = {"SequenceMask": (port_tensor._sequence_mask,
                                  ref_tensor._sequence_mask),
                 "SequenceLast": (port_tensor._sequence_last,
                                  ref_tensor._sequence_last),
                 "SequenceReverse": (port_tensor._sequence_reverse,
                                     ref_tensor._sequence_reverse)}[op]
    for use in (False, True):
        got = port(torch.tensor(x), torch.tensor(lengths),
                   use_sequence_length=use, axis=axis)
        want = ref(jnp.asarray(x), jnp.asarray(lengths),
                   use_sequence_length=use, axis=axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sequence_mask_value_and_keyword_lengths_through_nd():
    x = np.ones((3, 2, 2), "float32")
    with mx.cpu():
        out = mx.nd.SequenceMask(mx.nd.array(x),
                                 sequence_length=mx.nd.array([1, 2]),
                                 use_sequence_length=True, value=-1.0)
    want = np.asarray(ref_tensor._sequence_mask(
        jnp.asarray(x), jnp.asarray([1.0, 2.0]), True, -1.0))
    np.testing.assert_array_equal(out.asnumpy(), want)


def test_expand_dims_clip_and_the_new_methods():
    x = np.random.RandomState(3).randn(2, 3).astype("float32")
    with mx.cpu():
        a = mx.nd.array(x)
        np.testing.assert_array_equal(a.expand_dims(1).asnumpy(),
                                      np.expand_dims(x, 1))
        np.testing.assert_array_equal(
            mx.nd.clip(a, a_min=-0.5, a_max=0.5).asnumpy(),
            np.clip(x, -0.5, 0.5))
        np.testing.assert_allclose(a.sigmoid().asnumpy(),
                                   1 / (1 + np.exp(-x)), rtol=1e-6)
        np.testing.assert_allclose(a.tanh().asnumpy(), np.tanh(x),
                                   rtol=1e-6)
        np.testing.assert_array_equal(a.relu().asnumpy(),
                                      np.maximum(x, 0))
        soft = mx.nd.Activation(a, act_type="softsign").asnumpy()
    np.testing.assert_allclose(soft, x / (1 + np.abs(x)), rtol=1e-6)


# -- initializer.FusedRNN ----------------------------------------------------
@pytest.mark.parametrize("mode,bidirectional", [("lstm", False),
                                                ("gru", True),
                                                ("rnn", False)])
def test_fused_rnn_initializer_layout_matches_reference(mode,
                                                        bidirectional):
    """A constant block initializer makes the draw deterministic: the
    whole vector (weights, zero biases, the LSTM forget gate's bias) is
    equal to the reference's."""
    op_mode = "rnn_tanh" if mode == "rnn" else mode
    n = rnn_ops.rnn_param_size(op_mode, 6, 4, 2, bidirectional)
    with mx.cpu():
        arr = mx.nd.zeros((n,))
        mx.init.FusedRNN(mx.init.Constant(0.25), num_hidden=4, num_layers=2,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=1.5)("rnn_parameters", arr)
    rarr = jmx.nd.zeros((n,))
    jmx.init.FusedRNN(jmx.init.Constant(0.25), num_hidden=4, num_layers=2,
                      mode=mode, bidirectional=bidirectional,
                      forget_bias=1.5)("rnn_parameters", rarr)
    np.testing.assert_array_equal(arr.asnumpy(), rarr.asnumpy())


def test_fused_rnn_initializer_xavier_blocks():
    """The reference's own case (tests/test_parity_additions.py): input 6,
    4 hidden, 2 layers: 288 weights, then biases, the forget gate 1.0."""
    with mx.cpu():
        arr = mx.nd.zeros((352,))
        mx.init.FusedRNN(mx.init.Xavier(), num_hidden=4, num_layers=2,
                         mode="lstm", forget_bias=1.0)("lstm_parameters", arr)
    v = arr.asnumpy()
    assert np.abs(v[:288]).max() > 0
    bias = v[288:].reshape(4, 16)
    np.testing.assert_array_equal(bias[:, 4:8], 1.0)
    np.testing.assert_array_equal(bias[:, :4], 0.0)
    np.testing.assert_array_equal(bias[:, 8:], 0.0)
    with pytest.raises(ValueError):
        with mx.cpu():
            mx.init.FusedRNN(None, 4, 2, "lstm")("p", mx.nd.zeros((353,)))


def test_fused_rnn_initializer_through_its_dumps():
    """A Variable's init attribute holds the initializer's JSON; it is read
    back into a FusedRNN whose blocks get the inner initializer."""
    init = mx.init.FusedRNN(mx.init.Constant(0.5), num_hidden=2,
                            num_layers=1, mode="gru")
    n = rnn_ops.rnn_param_size("gru", 3, 2, 1)
    with mx.cpu():
        arr = mx.nd.zeros((n,))
        mx.init.Uniform()(mx.init.InitDesc("g_parameters",
                                           {"__init__": init.dumps()}), arr)
    v = arr.asnumpy()
    np.testing.assert_array_equal(v[:n - 12], 0.5)
    np.testing.assert_array_equal(v[n - 12:], 0.0)
