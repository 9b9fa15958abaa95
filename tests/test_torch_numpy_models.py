"""Models written on `mx.np`/`mx.npx` in the port against the reference.

- examples/transformer_np.py's encoder (its widths: VOCAB 16, DIM 32,
  HEADS 4, SEQ 12), from the same numpy weights: the logits and every
  parameter's gradient of the example's loss within 1e-5, then three steps
  of the example's hand-rolled Adam (in-place `-=` on np arrays,
  `v.grad[:] = 0`) with the losses within 1e-5 step by step.
- Gluon BERT under `npx.set_np()` at 2 layers: the reference initializes
  it, `models.convert.gluon_params_from_jax` carries the weights over, and
  the MLM loss (written on the np surface: `npx.log_softmax`, `npx.pick`,
  `np.sum` over the site mask) and every gradient agree within 1e-5.
  One `Trainer("adam")` step then moves every parameter as Adam's first
  step does (held to its closed form from the reference's gradients): the
  reference's np-mode `Trainer("adam")` leaves this model's parameters
  where they were (a kept deviation, ROADMAP Queue C).
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.models.convert import gluon_params_from_jax

VOCAB, DIM, HEADS, SEQ, BATCH = 16, 32, 4, 12, 8
TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield
    mx.npx.reset_np()
    jmx.npx.reset_np()


def init_params(pkg, rng):
    np = pkg.np

    def W(*shape, s=0.08):
        return np.array((rng.randn(*shape) * s).astype("float32"))
    p = {"embed": W(VOCAB, DIM), "pos": W(SEQ, DIM),
         "qkv_w": W(3 * DIM, DIM), "qkv_b": np.zeros((3 * DIM,)),
         "proj_w": W(DIM, DIM), "proj_b": np.zeros((DIM,)),
         "ln1_g": np.ones((DIM,)), "ln1_b": np.zeros((DIM,)),
         "ffn1_w": W(4 * DIM, DIM), "ffn1_b": np.zeros((4 * DIM,)),
         "ffn2_w": W(DIM, 4 * DIM), "ffn2_b": np.zeros((DIM,)),
         "ln2_g": np.ones((DIM,)), "ln2_b": np.zeros((DIM,)),
         "out_w": W(VOCAB, DIM), "out_b": np.zeros((VOCAB,))}
    for v in p.values():
        v.attach_grad()
    return p


def encoder(pkg, p, tokens):
    """examples/transformer_np.py's encoder."""
    np, npx = pkg.np, pkg.npx
    B = tokens.shape[0]
    h = npx.embedding(tokens, p["embed"], input_dim=VOCAB,
                      output_dim=DIM) + p["pos"]
    x = np.transpose(h, (1, 0, 2))
    qkv = npx.fully_connected(x.reshape(-1, DIM), p["qkv_w"], p["qkv_b"],
                              num_hidden=3 * DIM, flatten=False)
    qkv = qkv.reshape(SEQ, B, 3 * DIM)
    att = npx.interleaved_matmul_selfatt_qk(qkv, heads=HEADS)
    att = npx.softmax(att, axis=-1)
    ctx = npx.interleaved_matmul_selfatt_valatt(qkv, att, heads=HEADS)
    ctx = npx.fully_connected(ctx.reshape(-1, DIM), p["proj_w"],
                              p["proj_b"], num_hidden=DIM, flatten=False)
    h = npx.layer_norm(x.reshape(-1, DIM) + ctx, p["ln1_g"], p["ln1_b"])
    f = npx.fully_connected(h, p["ffn1_w"], p["ffn1_b"],
                            num_hidden=4 * DIM, flatten=False)
    f = npx.activation(f, act_type="gelu")
    f = npx.fully_connected(f, p["ffn2_w"], p["ffn2_b"], num_hidden=DIM,
                            flatten=False)
    h = npx.layer_norm(h + f, p["ln2_g"], p["ln2_b"])
    logits = npx.fully_connected(h, p["out_w"], p["out_b"],
                                 num_hidden=VOCAB, flatten=False)
    return np.transpose(logits.reshape(SEQ, B, VOCAB), (1, 0, 2))


def _loss(pkg, p, x, y):
    np, npx = pkg.np, pkg.npx
    with pkg.autograd.record():
        logits = encoder(pkg, p, x)
        logp = npx.log_softmax(logits, axis=-1)
        nll = -npx.pick(logp.reshape(-1, VOCAB),
                        y.reshape(-1).astype("float32"))
        loss = np.mean(nll)
    loss.backward()
    return logits, loss


def _adam_steps(pkg, steps, lr=3e-3):
    np = pkg.np
    rng = onp.random.RandomState(0)
    p = init_params(pkg, rng)
    m = {k: np.zeros(v.shape) for k, v in p.items()}
    s2 = {k: np.zeros(v.shape) for k, v in p.items()}
    losses, first = [], None
    for t in range(1, steps + 1):
        toks = rng.randint(0, VOCAB, (BATCH, SEQ))
        x = np.array(toks.astype("int32"), dtype="int32")
        y = np.array(onp.sort(toks, axis=1).astype("int32"), dtype="int32")
        logits, loss = _loss(pkg, p, x, y)
        if first is None:
            first = (logits.asnumpy(),
                     {k: v.grad.asnumpy().copy() for k, v in p.items()})
        corr = float(onp.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t))
        for k, v in p.items():
            g = v.grad
            m[k] = 0.9 * m[k] + 0.1 * g
            s2[k] = 0.999 * s2[k] + 0.001 * np.square(g)
            v -= lr * corr * m[k] / (np.sqrt(s2[k]) + 1e-8)
            v.grad[:] = 0
        losses.append(float(loss.asnumpy()))
        pred = np.argmax(logits, axis=-1)
        assert pred.dtype == onp.int32
    return first, losses, {k: v.asnumpy() for k, v in p.items()}


def test_transformer_np_encoder_matches_reference():
    (jl, jg), jlosses, jp = _adam_steps(jmx, 3)
    (tl, tg), tlosses, tp = _adam_steps(mx, 3)
    onp.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    for k in jg:
        onp.testing.assert_allclose(tg[k], jg[k], rtol=TOL, atol=TOL,
                                    err_msg=k)
    onp.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    for k in jp:
        onp.testing.assert_allclose(tp[k], jp[k], rtol=1e-4, atol=1e-5,
                                    err_msg=k)


NARROW = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
              num_heads=2, max_length=16, dropout=0.0)
B, S = 4, 16


def _bert(pkg, mod):
    with pkg.name.NameManager():
        return mod.get_bert_model("bert_12_768_12", **NARROW)


def _mlm(pkg, net, x, y, m):
    np, npx = pkg.np, pkg.npx
    with pkg.autograd.record():
        out = net(x)
        for o in out:
            assert type(o) is np.ndarray
        logp = npx.log_softmax(out[3], axis=-1)
        nll = -npx.pick(logp, y.astype("float32"), axis=-1)
        loss = np.sum(nll * m) / np.sum(m)
    loss.backward()
    return float(loss.asnumpy())


def test_np_mode_gluon_bert_matches_reference():
    rng = onp.random.RandomState(3)
    x0 = rng.randint(0, NARROW["vocab_size"], (B, S)).astype("int32")
    y0 = rng.randint(0, NARROW["vocab_size"], (B, S)).astype("int32")
    m0 = (rng.rand(B, S) < 0.15).astype("float32")
    m0[:, 0] = 1.0
    jnet = _bert(jmx, jbert)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Normal(0.02), ctx=jmx.cpu())
    jnet(jmx.nd.array(x0))
    weights = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    tnet = _bert(mx, tbert)
    tnet.initialize(ctx=mx.cpu())
    tnet(mx.nd.array(x0))
    gluon_params_from_jax(weights, tnet, ctx=mx.cpu())

    res = {}
    for pkg, net in ((jmx, jnet), (mx, tnet)):
        pkg.npx.set_np()
        try:
            trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                        {"learning_rate": 1e-3})
            x, y, m = (pkg.np.array(a, dtype=a.dtype)
                       for a in (x0, y0, m0))
            loss = _mlm(pkg, net, x, y, m)
            params = net._collect_params_with_prefix()
            grads = {k: p.grad().asnumpy() for k, p in params.items()}
            for p in params.values():
                assert type(p.data()) is pkg.np.ndarray
            trainer.step(1)
            after = {k: p.data().asnumpy() for k, p in params.items()}
        finally:
            pkg.npx.reset_np()
        res[pkg] = (loss, grads, after)
    (jl, jg, ja), (tl, tg, ta) = res[jmx], res[mx]
    onp.testing.assert_allclose(tl, jl, rtol=TOL)
    for k in jg:
        scale = max(1.0, float(onp.abs(jg[k]).max()))
        onp.testing.assert_allclose(tg[k], jg[k], rtol=TOL,
                                    atol=TOL * scale, err_msg=k)
    # Adam's first step: m = 0.1 g, v = 0.001 g^2, lr_t = lr sqrt(1 - b2)
    # / (1 - b1)
    lr, eps, c = 1e-3, 1e-8, onp.sqrt(0.001)
    for k in ja:
        g = jg[k].astype("float64")
        want = weights[k] - lr * c * g / (c * onp.abs(g) + eps)
        onp.testing.assert_allclose(ta[k], want, rtol=1e-5, atol=2e-6,
                                    err_msg=k)
