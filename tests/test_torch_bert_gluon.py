"""BERT trained through Gluon with AdamW and `FusedTrainStep` (the port of
`bench.py::bench_bert_gluon`) against the JAX package's, and the
multi-tensor optimizer ops' kernel route on a card.

The narrow model is bench_bert_gluon's CPU configuration (2 layers, 64
units, 128 hidden, 4 heads, vocab 256, batch 4 x seq 32), in fp32. The
reference initializes it (Normal(0.02)) and writes a `.params` file that
the port loads; both then take 3 `FusedTrainStep` steps with
`Trainer("adamw", lr 1e-4, wd 0.01)` and the MLM loss (out[3]) over every
position. Tolerances: each step's loss within 1e-5 relative (summation
order only) and every parameter after within 1e-4 of its norm (as the
LAMB/ZeRO BERT test holds it). The pooler and NSP head, which the MLM
loss does not reach, take zero gradients, and AdamW's decoupled decay
moves them on both sides.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import (launch_counts, registry,
                                 reset_launch_counts, variant_counts)
from _torch_seed import _seed_torch  # noqa: F401

LOSS_REL = 1e-5
TRAIN_REL = 1e-4
NARROW = dict(vocab_size=256, units=64, hidden_size=128, num_layers=2,
              num_heads=4, max_length=32, dropout=0.0)
BATCH, SEQ, STEPS = 4, 32, 3
ADAMW = {"learning_rate": 1e-4, "wd": 0.01}
UNREACHED = ("pooler", "classifier")     # no gradient from the MLM loss


def _make(pkg, mod):
    with pkg.name.NameManager():
        return mod.BERTModel(**NARROW)


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, NARROW["vocab_size"], (BATCH, SEQ))
    y = rng.randint(0, NARROW["vocab_size"], (BATCH, SEQ))
    return x.astype(np.float32), y.astype(np.float32)


def _params(net):
    """{structural name: a float32 copy of the parameter}."""
    return {k: np.array(p.data().asnumpy(), np.float32)
            for k, p in net._collect_params_with_prefix().items()}


def _fused_steps(pkg, net, x, y):
    sce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = pkg.gluon.Trainer(net.collect_params(), "adamw", dict(ADAMW))
    step = pkg.gluon.FusedTrainStep(net, lambda out, label: sce(out[3],
                                                                label),
                                    trainer)
    xs, ys = pkg.nd.array(x, ctx=pkg.cpu()), pkg.nd.array(y, ctx=pkg.cpu())
    return [float(np.asarray(step(xs, ys).asnumpy())) for _ in range(STEPS)]


def test_fused_adamw_bert_matches_reference(tmp_path):
    x, y = _batch()
    jnet = _make(jmx, jbert)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Normal(0.02), ctx=jmx.cpu())
    jnet(jmx.nd.array(x))
    f = str(tmp_path / "bert_ref.params")
    jnet.save_parameters(f)
    tnet = _make(mx, tbert)
    tnet.load_parameters(f, ctx=mx.cpu())
    start = _params(tnet)

    want_losses = _fused_steps(jmx, jnet, x, y)
    got_losses = _fused_steps(mx, tnet, x, y)
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_REL)
    assert got_losses[-1] < got_losses[0]
    want, got = _params(jnet), _params(tnet)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= TRAIN_REL, (k, err)
        assert got[k].dtype == np.float32
    # the parameters the loss does not reach moved by the decay alone (the
    # biases start at zero and stay there)
    unreached = [k for k in got if k.startswith(UNREACHED)]
    assert len(unreached) == 4
    for k in unreached:
        assert np.array_equal(got[k], start[k]) == k.endswith("bias"), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9)


def test_bert_gluon_training_on_the_cpu_launches_no_kernel(tmp_path):
    net = _make(mx, tbert)
    mx.random.seed(0)
    net.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    x, y = _batch(seed=2)
    before = launch_counts()
    losses = _fused_steps(mx, net, x, y)
    assert all(np.isfinite(losses))
    assert launch_counts() == before


# ------------------------------------------------------------- on a card
def _mixed(n_list, mp, seed, device):
    """8 tensors of ragged sizes, bf16 and fp32 (fp32 masters under mp)."""
    rng = np.random.RandomState(seed)
    out = []
    for j, n in enumerate(n_list):
        dt = torch.bfloat16 if j % 3 != 2 else torch.float32
        w32 = torch.from_numpy(rng.randn(n).astype(np.float32))
        out.append({"w": w32.to(dt).to(device),
                    "g": torch.from_numpy(rng.randn(n).astype(np.float32))
                    .to(dt).to(device),
                    "mom": torch.from_numpy((rng.randn(n) * 0.1)
                                            .astype(np.float32))
                    .to(dt).to(device),
                    "w32": w32.to(device)})
    return out


MULTI = {"multi_sgd_update": ("w", "g"),
         "multi_sgd_mom_update": ("w", "g", "mom"),
         "multi_mp_sgd_update": ("w", "g", "w32"),
         "multi_mp_sgd_mom_update": ("w", "g", "mom", "w32")}


@pytest.mark.cuda
def test_multi_sgd_ops_launch_once_and_equal_the_plain_version():
    """Each multi-SGD registry op on CUDA tensors (8 tensors, bf16 and
    fp32, ragged, clip on) makes exactly one flat_sgd launch of variant
    "multi", and its outputs equal the plain version's on the card bit
    for bit; the mp LAMB phases make one flat_lamb1 / flat_lamb2 launch
    each, and their elementwise outputs equal the plain versions'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sizes = [1, 7, 300, 4097, 64, 2048, 33, 8192]
    for name, keys in MULTI.items():
        for seed in (0, 1):
            groups = _mixed(sizes, "w32" in keys, seed, "cuda")
            args = [grp[k] for grp in groups for k in keys]
            kw = dict(lrs=[0.01 * (j + 1) for j in range(len(sizes))],
                      wds=[1e-4] * len(sizes), rescale_grad=0.5,
                      clip_gradient=0.3 if seed else -1.0)
            if "mom" in keys:
                kw["momentum"] = 0.9
            want = registry.get(name).fn(*[a.clone() for a in args], **kw)
            torch.cuda.synchronize()
            reset_launch_counts()
            got = registry.get(name).best_fn(True)(*args, **kw)
            torch.cuda.synchronize()
            assert variant_counts() == {("flat_sgd", "multi"): 1}, name
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), name
    rng = np.random.RandomState(3)
    n = 4097
    w32 = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    w = w32.bfloat16()
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    mean = torch.zeros(n, device="cuda")
    var = torch.zeros(n, device="cuda")
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, t=1, wd=0.01,
              rescale_grad=0.5, clip_gradient=1.0)
    op1 = registry.get("mp_lamb_update_phase1")
    want = op1.fn(w, g, mean.clone(), var.clone(), w32.clone(), **kw)
    reset_launch_counts()
    got = op1.best_fn(True)(w, g, mean, var, w32, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flat_lamb1"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    op2 = registry.get("mp_lamb_update_phase2")
    gdir = got[0]
    r1, r2 = w32.norm(), gdir.norm()
    want = op2.fn(w.clone(), gdir, r1, r2, w32.clone(), lr=1e-3)
    reset_launch_counts()
    got = op2.best_fn(True)(w, gdir, r1, r2, w32, lr=1e-3)
    torch.cuda.synchronize()
    assert launch_counts()["flat_lamb2"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
