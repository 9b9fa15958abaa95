"""`mx.np` on the card against the CPU (the file imports no JAX:
tests/test_torch_numpy_ops.py holds the CPU to the reference). A few
`_np_*` ops, outputs on gpu(0), and one np-mode `Trainer("adam")` step of
a narrow Gluon BERT: its loss, gradients and parameters against the same
step on the CPU, the update one `multi` flat_adam launch. Needs a CUDA
card and skips without one.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import bert
from mxnet_tpu_torch.models.convert import gluon_params_from_jax
from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts, \
    variant_counts

pytestmark = pytest.mark.cuda

R = np.random.RandomState(0)
A = R.randn(6, 5).astype("float32")
B = R.randn(6, 5).astype("float32")
I = R.randint(0, 5, (6, 5)).astype("int32")

OPS = [
    ("add", (A, B), {}), ("true_divide", (I, 3), {}),
    ("logaddexp", (A, B), {}), ("sum", (I,), {"axis": 0}),
    ("mean", (A,), {"axis": 1}), ("median", (A,), {}),
    ("quantile", (A, 0.3), {"axis": 0}), ("cumsum", (A,), {"axis": 1}),
    ("sort", (A,), {}), ("argsort", (A,), {}), ("unique", (I,), {}),
    ("take", (A, np.array([1, -1, 9], "int32"), 1), {}),
    ("matmul", (A, B.T), {}), ("einsum", ("ij,kj->ik", A, B), {}),
    ("histogram", (A,), {"bins": 4}), ("pad", (A, 2), {"mode": "reflect"}),
    ("nonzero", (A > 0,), {}), ("bincount", (I.ravel(),), {}),
    ("interp", (A.ravel(), np.sort(B.ravel()), A.ravel()), {}),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return mx.gpu(0)


def _run(name, args, kw, ctx):
    conv = [mx.np.array(a, dtype=a.dtype, ctx=ctx)
            if isinstance(a, np.ndarray) else a for a in args]
    out = getattr(mx.np, name)(*conv, **kw)
    return out if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("name,args,kw", OPS, ids=[o[0] for o in OPS])
def test_np_ops_on_card_match_cpu(card, name, args, kw):
    got = _run(name, args, kw, card)
    want = _run(name, args, kw, mx.cpu())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is mx.np.ndarray and g._data.device.type == "cuda"
        assert np.dtype(g.dtype) == np.dtype(w.dtype)
        gh, wh = g.asnumpy(), w.asnumpy()
        if wh.dtype.kind == "f":
            scale = max(1.0, float(np.abs(wh).max()))
            np.testing.assert_allclose(gh, wh, rtol=1e-5, atol=1e-5 * scale)
        else:
            np.testing.assert_array_equal(gh, wh)


def _step(ctx, tok, tgt, mask, weights=None):
    mx.random.seed(0)
    net = bert.get_bert_model("bert_12_768_12", vocab_size=200, units=64,
                              hidden_size=128, num_layers=2, num_heads=2,
                              max_length=32, dropout=0.0)
    net.initialize(mx.init.Normal(0.02), ctx=ctx)
    net(mx.np.array(tok, dtype="int32", ctx=ctx))
    if weights is not None:
        gluon_params_from_jax(weights, net, ctx=ctx)
    params = net._collect_params_with_prefix()
    start = {k: p.data().asnumpy() for k, p in params.items()}
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3, "epsilon": 1e-6})
    x, y, m = (mx.np.array(a, dtype=a.dtype, ctx=ctx)
               for a in (tok, tgt, mask))
    with mx.autograd.record():
        out = net(x)
        assert all(type(o) is mx.np.ndarray for o in out)
        logp = mx.npx.log_softmax(out[3], axis=-1)
        nll = -mx.npx.pick(logp, y.astype("float32"), axis=-1)
        loss = mx.np.sum(nll * m) / mx.np.sum(m)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in params.items()}
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
        reset_launch_counts()
    trainer.step(1)
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
        launches = launch_counts()
        assert launches["flat_adam"] == 1 and sum(launches.values()) == 1
        assert variant_counts() == {("flat_adam", "multi"): 1}
    after = {k: p.data().asnumpy() for k, p in params.items()}
    return float(loss.item()), grads, after, start


def test_np_mode_trainer_adam_step_on_card_matches_cpu(card):
    rng = np.random.RandomState(1)
    tok = rng.randint(0, 200, (4, 32)).astype("int32")
    tgt = rng.randint(0, 200, (4, 32)).astype("int32")
    mask = (rng.rand(4, 32) < 0.15).astype("float32")
    mask[:, 0] = 1.0
    mx.npx.set_np()
    try:
        gl, gg, ga, start = _step(card, tok, tgt, mask)
        cl, cg, ca, _ = _step(mx.cpu(), tok, tgt, mask, weights=start)
    finally:
        mx.npx.reset_np()
    assert abs(gl - cl) <= 1e-5 * abs(cl)
    for k in cg:
        scale = max(float(np.abs(cg[k]).max()), 1e-30)
        assert float(np.abs(gg[k] - cg[k]).max()) <= 1e-4 * scale, k
        np.testing.assert_allclose(ga[k], ca[k], atol=1e-5, err_msg=k)
