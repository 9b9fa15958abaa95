"""The port's eleven newer loss blocks against the JAX package's.

Each block gets the same seeded inputs in both packages, with and without
`sample_weight`; the per-sample losses and the gradient of their sum with
respect to every float input are held within 1e-5 of the reference's max
abs. The reference's `CTCLoss` leaves its own tape (it calls
``optax.ctc_loss`` on the raw arrays), so its gradient is taken with
``jax.grad`` through the same block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon import loss as JL
from mxnet_tpu_torch.gluon import loss as L

REL = 1e-5
N, C = 6, 5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= REL * max(np.abs(b).max(), 1e-30), \
        np.abs(a - b).max()


def _inputs(name, rng):
    """(block kwargs, [float inputs], [other inputs], sample_weight
    shape)."""
    x = rng.randn(N, C).astype(np.float32)
    if name == "SigmoidBinaryCrossEntropyLoss":
        return {}, [x], [rng.randint(0, 2, (N, C)).astype(np.float32)], \
            (N, 1)
    if name == "SigmoidBCE_from_sigmoid":
        p = (1 / (1 + np.exp(-x))).astype(np.float32)
        return {"from_sigmoid": True}, [p], \
            [rng.randint(0, 2, (N, C)).astype(np.float32)], (N, 1)
    if name == "KLDivLoss":
        q = np.exp(x) / np.exp(x).sum(1, keepdims=True)
        return {}, [np.log(q).astype(np.float32)], \
            [rng.dirichlet(np.ones(C), N).astype(np.float32)], (N, 1)
    if name == "KLDiv_logits":
        return {"from_logits": False}, [x], \
            [rng.dirichlet(np.ones(C), N).astype(np.float32)], (N, 1)
    if name in ("HuberLoss", "SquaredHingeLoss", "HingeLoss",
                "LogisticLoss"):
        lab = rng.randn(N, C).astype(np.float32) * 2 if name == "HuberLoss" \
            else np.sign(rng.randn(N, C)).astype(np.float32)
        return {}, [x], [lab], (N, 1)
    if name == "Logistic_binary":
        return {"label_format": "binary"}, [x], \
            [rng.randint(0, 2, (N, C)).astype(np.float32)], (N, 1)
    if name == "TripletLoss":
        return {}, [x, rng.randn(N, C).astype(np.float32),
                    rng.randn(N, C).astype(np.float32)], [], (N,)
    if name == "PoissonNLLLoss":
        return {}, [x * 0.5], [rng.poisson(2.0, (N, C)).astype(
            np.float32)], (N, 1)
    if name == "PoissonNLL_full":
        rate = np.exp(x * 0.5).astype(np.float32)
        return {"from_logits": False, "compute_full": True}, [rate], \
            [rng.poisson(2.0, (N, C)).astype(np.float32)], (N, 1)
    if name == "CosineEmbeddingLoss":
        return {"margin": 0.1}, [x, rng.randn(N, C).astype(np.float32)], \
            [np.array([1, -1, 1, -1, -1, 1], np.float32)], (N, 1)
    if name == "SDMLLoss":
        return {}, [x, (x + 0.3 * rng.randn(N, C)).astype(np.float32)], [], \
            (N,)
    raise KeyError(name)


BLOCKS = {"SigmoidBCE_from_sigmoid": "SigmoidBinaryCrossEntropyLoss",
          "KLDiv_logits": "KLDivLoss", "Logistic_binary": "LogisticLoss",
          "PoissonNLL_full": "PoissonNLLLoss"}
NAMES = ["SigmoidBinaryCrossEntropyLoss", "SigmoidBCE_from_sigmoid",
         "KLDivLoss", "KLDiv_logits", "HuberLoss", "HingeLoss",
         "SquaredHingeLoss", "LogisticLoss", "Logistic_binary",
         "TripletLoss", "PoissonNLLLoss", "PoissonNLL_full",
         "CosineEmbeddingLoss", "SDMLLoss"]


def _run(pkg, block, floats, others, sw):
    """(loss, [gradients of its sum w.r.t. each float input])."""
    xs = [pkg.nd.array(f) for f in floats]
    for x in xs:
        x.attach_grad()
    rest = [pkg.nd.array(o) for o in others]
    extra = [pkg.nd.array(sw)] if sw is not None else []
    with pkg.autograd.record():
        loss = block(*xs, *rest, *extra)
    loss.backward()
    return loss.asnumpy(), [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_loss_forward_and_gradient(name, weighted):
    rng = np.random.RandomState(len(name))
    kwargs, floats, others, sw_shape = _inputs(name, rng)
    sw = rng.rand(*sw_shape).astype(np.float32) if weighted else None
    cls = BLOCKS.get(name, name)
    mine = _run(mx, getattr(L, cls)(**kwargs), floats, others, sw)
    ref = _run(jmx, getattr(JL, cls)(**kwargs), floats, others, sw)
    _close(mine[0], ref[0])
    for g, rg in zip(mine[1], ref[1]):
        _close(g, rg)


def test_sigmoid_bce_pos_weight():
    rng = np.random.RandomState(0)
    x = rng.randn(N, C).astype(np.float32)
    y = rng.randint(0, 2, (N, C)).astype(np.float32)
    pw = (rng.rand(1, C) * 3).astype(np.float32)
    for from_sigmoid in (False, True):
        inp = 1 / (1 + np.exp(-x)) if from_sigmoid else x
        outs = []
        for pkg, mod in ((mx, L), (jmx, JL)):
            blk = mod.SigmoidBCELoss(from_sigmoid=from_sigmoid)
            outs.append(blk(pkg.nd.array(inp), pkg.nd.array(y), None,
                            pkg.nd.array(pw)).asnumpy())
        _close(*outs)


def _ctc_inputs(rng, layout, lengths):
    T, Nb, Cc, Lmax = 9, 4, 6, 4
    logits = rng.randn(Nb, T, Cc).astype(np.float32)
    labels = -np.ones((Nb, Lmax), np.float32)
    lab_len = np.array([4, 2, 3, 1], np.int32)
    for i, n in enumerate(lab_len):
        labels[i, :n] = rng.randint(0, Cc - 1, n)
    pred_len = np.array([9, 7, 8, 5], np.int32)
    if layout == "TNC":
        logits = logits.transpose(1, 0, 2).copy()
    if lengths:
        # padding with a valid class: only the lengths say where a row ends
        labels = np.where(labels < 0, 0, labels).astype(np.float32)
    return logits, labels, pred_len, lab_len


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("label_layout", ["NT", "TN"])
@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_ctc_loss(layout, label_layout, lengths, weighted):
    rng = np.random.RandomState(3)
    logits, labels, pred_len, lab_len = _ctc_inputs(rng, layout, lengths)
    if label_layout == "TN":
        labels = labels.T.copy()
    sw = rng.rand(4).astype(np.float32) if weighted else None
    kw = dict(layout=layout, label_layout=label_layout)

    def ref_fn(x):
        args = [jmx.nd.array(labels)]
        if lengths:
            args += [jmx.nd.array(pred_len, dtype="int32"),
                     jmx.nd.array(lab_len, dtype="int32")]
        elif weighted:
            args += [None, None]
        if weighted:
            args.append(jmx.nd.array(sw))
        out = JL.CTCLoss(**kw)(jmx.nd.from_jax(x), *args)
        return out.data_jax

    ref_loss = np.asarray(ref_fn(jnp.asarray(logits)))
    ref_grad = np.asarray(jax.grad(lambda x: ref_fn(x).sum())(
        jnp.asarray(logits)))

    x = mx.nd.array(logits)
    x.attach_grad()
    args = [mx.nd.array(labels)]
    if lengths:
        args += [mx.nd.array(pred_len, dtype="int32"),
                 mx.nd.array(lab_len, dtype="int32")]
    elif weighted:
        args += [None, None]
    if weighted:
        args.append(mx.nd.array(sw))
    with mx.autograd.record():
        loss = L.CTCLoss(**kw)(x, *args)
    loss.backward()
    _close(loss.asnumpy(), ref_loss)
    _close(x.grad.asnumpy(), ref_grad)


def test_loss_reprs_and_argument_checks():
    assert repr(L.HingeLoss()) == repr(JL.HingeLoss())
    with pytest.raises(ValueError):
        L.LogisticLoss(label_format="other")
    with pytest.raises(AssertionError):
        L.CTCLoss(layout="CTN")
    assert L.SigmoidBCELoss is L.SigmoidBinaryCrossEntropyLoss
    assert sorted(L.__all__) == sorted(JL.__all__)
