"""The repo's word-level language model (examples/word_lm.py: Embedding ->
rnn.LSTM(layout="NTC") -> Dropout -> Dense(vocab, flatten=False)) on the
port against the JAX package, at narrow width: vocab 50, width 16, 2
layers, 5 steps of BPTT, batch 4, dropout 0, on the example's seeded Zipf
corpus, trained 3 steps with the example's Trainer("sgd", lr 1.0,
clip_gradient 0.25) after hybridize(static_alloc=True). The losses agree
within 1e-5 relative and the parameters after 3 steps within 1e-5 of
their largest value (fp32); the greedy continuation is the same tokens.
A `cuda`-marked test runs one narrow step on the card against the CPU:
one `multi` flat_sgd launch and no other kernel.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from _torch_seed import _seed_torch  # noqa: F401

VOCAB, WIDTH, LAYERS, SEQ, BATCH = 50, 16, 2, 5, 4
REL = 1e-5


def word_lm(pkg, vocab=VOCAB, width=WIDTH, layers=LAYERS, dropout=0.0):
    """examples/word_lm.py's WordLM in either package."""
    gluon = pkg.gluon

    class WordLM(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = gluon.nn.Embedding(vocab, width)
                self.lstm = gluon.rnn.LSTM(width, num_layers=layers,
                                           dropout=dropout, layout="NTC")
                self.drop = gluon.nn.Dropout(dropout)
                self.proj = gluon.nn.Dense(vocab, flatten=False)

        def hybrid_forward(self, F, x, *args, **params):
            return self.proj(self.drop(self.lstm(self.embed(x))))
    return WordLM(prefix="wordlm_")


def corpus(n_tokens, vocab, seed=0):
    """examples/word_lm.py's synthetic corpus: Zipf(1.3) ids mod vocab."""
    rng = np.random.RandomState(seed)
    return (rng.zipf(1.3, n_tokens) % vocab).astype(np.int32)


def batchify(data, batch, seq):
    n = (len(data) - 1) // (batch * seq) * (batch * seq)
    x = data[:n].reshape(batch, -1)
    y = data[1:n + 1].reshape(batch, -1)
    for t in range(0, x.shape[1] - seq + 1, seq):
        yield x[:, t:t + seq], y[:, t:t + seq]


def _train(pkg, net, ctx, steps=3):
    sce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 1.0, "clip_gradient": 0.25})
    losses = []
    for (xb, yb), _ in zip(batchify(corpus(2000, VOCAB), BATCH, SEQ),
                           range(steps)):
        x = pkg.nd.array(xb, ctx=ctx)
        y = pkg.nd.array(yb, ctx=ctx)
        with pkg.autograd.record():
            logits = net(x)
            loss = sce(logits.reshape((-1, VOCAB)), y.reshape((-1,))).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    return losses


def _greedy(pkg, net, ctx, n=10):
    out, cur = [], pkg.nd.array(np.full((1, 1), 1, np.int32), ctx=ctx)
    for _ in range(n):
        nxt = int(np.argmax(net(cur).asnumpy()[0, -1]))
        out.append(nxt)
        cur = pkg.nd.array(np.array([[nxt]], np.int32), ctx=ctx)
    return out


def _params(net):
    return {k: v.data().asnumpy()
            for k, v in sorted(net.collect_params().items())}


def _reference_net(tmp_path):
    jmx.random.seed(0)
    ref = word_lm(jmx)
    ref.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    ref(jmx.nd.zeros((1, SEQ)))
    path = str(tmp_path / "word_lm.params")
    ref.save_parameters(path)
    return ref, path


def test_word_lm_trains_like_reference(tmp_path):
    ref, path = _reference_net(tmp_path)
    with mx.cpu():
        net = word_lm(mx)
        net.load_parameters(path, ctx=mx.cpu())
        assert sorted(_params(net)) == sorted(_params(ref))
        net.hybridize(static_alloc=True)
        ref.hybridize(static_alloc=True)
        got = _train(mx, net, mx.cpu())
        want = _train(jmx, ref, jmx.cpu())
        assert got[-1] < got[0]
        for a, b in zip(got, want):
            assert abs(a - b) <= REL * abs(b), (got, want)
        pg, pw = _params(net), _params(ref)
        for k in pw:
            assert np.abs(pg[k] - pw[k]).max() <= REL * np.abs(pw[k]).max(), k
        assert _greedy(mx, net, mx.cpu()) == _greedy(jmx, ref, jmx.cpu())


@pytest.mark.cuda
def test_word_lm_step_on_the_card(tmp_path):
    """One narrow step on the card against the same step on the CPU (TF32
    off for cuBLAS): the loss within 1e-5 and the parameters within 1e-5
    of their largest value; the update is one `multi` flat_sgd launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    _, path = _reference_net(tmp_path)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            with ctx:
                net = word_lm(mx)
                net.load_parameters(path, ctx=ctx)
                net.hybridize(static_alloc=True)
                reset_launch_counts()
                losses = _train(mx, net, ctx, steps=1)
                runs.append((losses, _params(net), variant_counts()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (lc, pc, vc), (lg, pg, vg) = runs
    assert vc == {} and vg == {("flat_sgd", "multi"): 1}, vg
    assert abs(lg[0] - lc[0]) <= REL * abs(lc[0])
    for k in pc:
        assert np.abs(pg[k] - pc[k]).max() <= REL * np.abs(pc[k]).max(), k
