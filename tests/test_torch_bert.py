"""BERT in the port (the ops and layers it adds, the Gluon model zoo's
BERTModel, Trainer(zero=True) on it, and the functional `models.bert`)
against the JAX package's.

Inputs and weights come from numpy with a seed (or from a `.params` file
the reference wrote) and go to both sides. Tolerances: fp32 outputs within
1e-5 of the output's scale (summation order only), bf16 within 2e-2 (each
op rounds to bf16 at other places on the two sides), training over three
steps within 1e-4 per parameter (relative norm), the loss per step within
1e-5. The narrow model is `bench.py::bench_bert_gluon`'s CPU configuration
(2 layers, 64 units, 4 heads, vocab 256, seq 32).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.models import bert as jfbert
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.models import bert as tfbert
from mxnet_tpu_torch.models import params_from_jax
from mxnet_tpu_torch.ops import launch_counts, registry
from _torch_seed import _seed_torch  # noqa: F401

FP32_REL = 1e-5
BF16_REL = 2e-2
TRAIN_REL = 1e-4
NARROW = dict(vocab_size=256, units=64, hidden_size=128, num_layers=2,
              num_heads=4, max_length=32, dropout=0.0)
BATCH, SEQ = 4, 32


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    if hasattr(a, "asnumpy"):
        return np.asarray(a.asnumpy(), np.float32)
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, rel)


def _jop(name, *args, **kw):
    return jreg.get(name).fn(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args), **kw)


def _top(name, *args, **kw):
    return registry.get(name).fn(*(torch.from_numpy(a.copy())
                                   if isinstance(a, np.ndarray) else a
                                   for a in args), **kw)


# -------------------------------------------------------------------- ops
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_casts_before_gamma_and_beta(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 64) * 2 + 1).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jreg.get("LayerNorm").fn(*(jnp.asarray(a).astype(jdt)
                                      for a in (x, g, b)), eps=1e-12)
    got = registry.get("LayerNorm").fn(*(torch.from_numpy(a).to(tdt)
                                         for a in (x, g, b)), eps=1e-12)
    assert got.dtype == tdt
    _close(got, want, FP32_REL if dtype == "float32" else BF16_REL)
    if dtype == "bfloat16":
        # the order matters: gamma and beta applied after the cast, in bf16
        xt, gt, bt = (torch.from_numpy(a).to(tdt) for a in (x, g, b))
        norm = torch.nn.functional.layer_norm(xt.float(), (64,), eps=1e-12)
        assert torch.equal(got, norm.to(tdt) * gt + bt)


@pytest.mark.parametrize("name,kw", [
    ("Activation", {"act_type": "gelu"}),
    ("Activation", {"act_type": "tanh"}),
    ("LeakyReLU", {"act_type": "gelu"}),
    ("LeakyReLU", {"act_type": "leaky", "slope": 0.1}),
], ids=["gelu", "tanh", "leaky_gelu", "leaky"])
def test_activations_match_reference(name, kw):
    x = np.random.RandomState(1).randn(4, 33).astype(np.float32) * 3
    _close(_top(name, x, **kw), _jop(name, x, **kw), FP32_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_in_fp32_cast_back(dtype):
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 3, 7) * 4).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = registry.get("softmax").fn(tx, axis=-1)
    assert got.dtype == tx.dtype
    _close(got, jreg.get("softmax").fn(jx, axis=-1),
           FP32_REL if dtype == "float32" else BF16_REL)
    _close(registry.get("softmax").fn(tx, axis=1, temperature=2.0),
           jreg.get("softmax").fn(jx, axis=1, temperature=2.0),
           FP32_REL if dtype == "float32" else BF16_REL)


def test_embedding_float_ids_and_negative_rows():
    rng = np.random.RandomState(3)
    w = rng.randn(10, 6).astype(np.float32)
    ids = np.array([[0, 9, 3], [-1, 2, 2]], np.float32)
    _close(_top("Embedding", ids, w, input_dim=10, output_dim=6),
           _jop("Embedding", ids, w, input_dim=10, output_dim=6), 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interleaved_selfatt_ops(dtype):
    rng = np.random.RandomState(4)
    qkv = rng.randn(5, 2, 4 * 3 * 16).astype(np.float32)
    att = rng.rand(2 * 4, 5, 5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rel = FP32_REL if dtype == "float32" else BF16_REL
    jq, tq = jnp.asarray(qkv).astype(jdt), torch.from_numpy(qkv).to(tdt)
    _close(registry.get("_contrib_interleaved_matmul_selfatt_qk").fn(
        tq, heads=4), jreg.get("_contrib_interleaved_matmul_selfatt_qk").fn(
        jq, heads=4), rel)
    ja, ta = jnp.asarray(att).astype(jdt), torch.from_numpy(att).to(tdt)
    _close(registry.get("_contrib_interleaved_matmul_selfatt_valatt").fn(
        tq, ta, heads=4),
        jreg.get("_contrib_interleaved_matmul_selfatt_valatt").fn(
            jq, ja, heads=4), rel)


def test_shape_ops_and_comparisons():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    pairs = [("transpose", (x,), {"axes": (1, 0, 3, 2)}),
             ("transpose", (x,), {}),
             ("slice_axis", (x,), {"axis": 2, "begin": 1, "end": 3}),
             ("reshape", (x,), {"shape": (-3, 0, 0)}),
             ("reshape", (x,), {"shape": (0, -3, -1)}),
             ("broadcast_to", (x[:, :1],), {"shape": (0, 3, 4, 5)}),
             ("zeros_like", (x,), {}),
             ("broadcast_lesser", (np.arange(5, dtype=np.float32)
                                   .reshape(1, 5),
                                   np.array([[2.0], [4.0]], np.float32)),
              {})]
    for name, args, kw in pairs:
        got, want = _top(name, *args, **kw), _jop(name, *args, **kw)
        assert got.dtype == torch.float32, name
        _close(got, want, 0.0)
    a = mx.nd.arange(4, ctx=mx.cpu())
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a.asnumpy(), jmx.nd.arange(4).asnumpy())
    np.testing.assert_array_equal(
        mx.nd.arange(1, 7, 2, repeat=2, ctx=mx.cpu()).asnumpy(),
        jmx.nd.arange(1, 7, 2, repeat=2).asnumpy())


def test_dropout_rate_statistics_and_modes():
    x = mx.nd.ones((200, 500), ctx=mx.cpu())
    drop = mx.gluon.nn.Dropout(0.3)
    with mx.autograd.record():
        y = drop(x).asnumpy()
    kept = (y != 0).mean()
    assert abs(kept - 0.7) < 0.01, kept       # 1e5 draws: sd 0.0015
    np.testing.assert_allclose(y[y != 0], 1.0 / 0.7, rtol=1e-6)
    # predict mode, and rate 0 while training, pass the input through
    np.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())
    with mx.autograd.record():
        np.testing.assert_array_equal(mx.gluon.nn.Dropout(0.0)(x).asnumpy(),
                                      x.asnumpy())
    # mode="always" drops in predict mode too; axes share one draw
    out = mx.nd.Dropout(x, p=0.5, mode="always", axes=(1,)).asnumpy()
    assert (out == out[:, :1]).all() and 0.3 < (out[:, 0] != 0).mean() < 0.7
    mx.random.seed(7)
    with mx.autograd.record():
        a = drop(x).asnumpy()
    mx.random.seed(7)
    with mx.autograd.record():
        b = drop(x).asnumpy()
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ model
def _make(pkg, mod, **kw):
    with pkg.name.NameManager():
        return mod.BERTModel(**dict(NARROW, **kw))


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, NARROW["vocab_size"], (BATCH, SEQ)).astype(np.float32)
    y = rng.randint(0, NARROW["vocab_size"], (BATCH, SEQ)).astype(np.float32)
    return x, y


def _pair(tmp_path, **kw):
    """(reference net, port net) with the same weights: the reference's
    Normal(0.02) initialization, written to a `.params` file the port
    loads."""
    jnet = _make(jmx, jbert, **kw)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Normal(0.02), ctx=jmx.cpu())
    jnet(jmx.nd.array(_batch()[0]))
    f = str(tmp_path / "bert_ref.params")
    jnet.save_parameters(f)
    tnet = _make(mx, tbert, **kw)
    tnet.load_parameters(f, ctx=mx.cpu())
    return jnet, tnet


@pytest.mark.parametrize("masked", [False, True], ids=["full", "valid_length"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_model_loads_reference_params_and_matches(tmp_path, dtype,
                                                       masked):
    jnet, tnet = _pair(tmp_path)
    if dtype != "float32":
        jnet.cast(dtype)
        tnet.cast(dtype)
    x = _batch()[0]
    vl = np.array([SEQ, 20, 7, 1], np.float32)
    jargs = [jmx.nd.array(x)] + ([None, jmx.nd.array(vl)] if masked else [])
    targs = [mx.nd.array(x, ctx=mx.cpu())] + (
        [None, mx.nd.array(vl, ctx=mx.cpu())] if masked else [])
    want, got = jnet(*jargs), tnet(*targs)
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(g, w, FP32_REL if dtype == "float32" else BF16_REL)


def test_bert_params_cross_read_both_ways(tmp_path):
    jnet, tnet = _pair(tmp_path, use_classifier=False)
    names = sorted(tnet._collect_params_with_prefix())
    assert names == sorted(jnet._collect_params_with_prefix())
    assert "encoder.position_weight" in names
    assert "encoder.4.attention_qkv.weight" in names     # layer 0
    f = str(tmp_path / "bert_port.params")
    tnet.save_parameters(f)
    back = _make(jmx, jbert, use_classifier=False)
    back.load_parameters(f, ctx=jmx.cpu())
    for k, p in back._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(),
            tnet._collect_params_with_prefix()[k].data().asnumpy())
    tnet.cast("bfloat16")
    tnet.save_parameters(f)
    again = _make(mx, tbert, use_classifier=False)
    again.cast("bfloat16")
    again.load_parameters(f, ctx=mx.cpu())
    for k, p in again._collect_params_with_prefix().items():
        assert torch.equal(p.data().data_torch, tnet._collect_params_with_prefix()
                           [k].data().data_torch)


def test_bert_presets():
    for pkg, mod in ((mx, tbert), (jmx, jbert)):
        with pytest.raises(ValueError, match="unknown BERT preset"):
            mod.get_bert_model("bert_3_3_3")
        with pytest.raises(ValueError, match="use_pooler"):
            mod.BERTModel(use_pooler=False)
    with mx.name.NameManager():
        net = tbert.bert_12_768_12(vocab_size=100, num_layers=1)
    assert net.encoder.position_weight.shape == (512, 768)
    assert net.encoder.transformer_cells[0]._num_heads == 12


# --------------------------------------------------------------- training
TRAINERS = {
    "lamb": ("lamb", {"learning_rate": 1e-3, "wd": 0.01}),
    "sgd": ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    "adam": ("adam", {"learning_rate": 1e-3, "wd": 1e-4}),
}


def _train(pkg, net, opt, zero, x, y, steps=3, **trainer_kw):
    name, kw = TRAINERS[opt]
    trainer = pkg.gluon.Trainer(net.collect_params(), name, dict(kw),
                                kvstore="device", zero=zero, **trainer_kw)
    sce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    ctx = pkg.cpu()
    xs, ys = pkg.nd.array(x, ctx=ctx), pkg.nd.array(y, ctx=ctx)
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = sce(net(xs)[3], ys)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(np.asarray(loss.asnumpy(), np.float32).mean()))
    return trainer, losses


def _params(net):
    return {k: np.asarray(p.data().asnumpy(), np.float32)
            for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("opt", ["lamb", "sgd", "adam"])
def test_trainer_zero_matches_reference_trainer(tmp_path, opt):
    """Three steps of record -> backward -> Trainer(kvstore="device",
    zero=True).step on the narrow BERTModel, MLM loss over every position:
    the losses and the parameters after agree with the reference's."""
    jnet, tnet = _pair(tmp_path)
    x, y = _batch(seed=2)
    jtr, jl = _train(jmx, jnet, opt, True, x, y)
    ttr, tl = _train(mx, tnet, opt, True, x, y)
    from mxnet_tpu_torch.optimizer import ZeroUpdater
    assert isinstance(ttr._kvstore._updater, ZeroUpdater)
    assert ttr._kvstore._updater.layout.to_payload() == \
        jtr._kvstore._updater.layout.to_payload()
    np.testing.assert_allclose(tl, jl, rtol=FP32_REL)
    assert tl[-1] < tl[0]
    want, got = _params(jnet), _params(tnet)
    for k, w in want.items():
        err = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= TRAIN_REL, (k, err)


def test_trainer_zero_and_per_parameter_lamb_agree(tmp_path):
    """The ZeRO route (flat buckets, norms from the chunk partials) and the
    per-parameter route (kvstore=None: phase 1 and 2 once per parameter)
    from one state: within the reference's bound for the two."""
    _, a = _pair(tmp_path)
    _, b = _pair(tmp_path)
    x, y = _batch(seed=3)
    _, la = _train(mx, a, "lamb", True, x, y)
    _, lb = _train(mx, b, "lamb", None, x, y)
    np.testing.assert_allclose(la, lb, rtol=FP32_REL)
    pa, pb = _params(a), _params(b)
    for k in pa:
        np.testing.assert_allclose(pa[k], pb[k], rtol=5e-5, atol=5e-6)


def test_trainer_update_on_kvstore_equals_the_local_update(tmp_path,
                                                           monkeypatch):
    """The store's updater runs once per key (the per-parameter route, as
    the reference's store does); the local update with the aggregated
    route turned off (MXNET_OPTIMIZER_AGGREGATION_SIZE=0) runs the same
    route: bit-equal. (With aggregation on, Adam's 1 - beta is fp32 on the
    local route, as in the reference; see the next test.)"""
    _, a = _pair(tmp_path)
    _, b = _pair(tmp_path)
    x, y = _batch(seed=4)
    tra, _ = _train(mx, a, "adam", None, x, y, steps=2,
                    update_on_kvstore=True)
    assert tra._kvstore is not None and tra._update_on_kvstore
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "0")
    trb, _ = _train(mx, b, "adam", None, x, y, steps=2)
    assert trb._kvstore is None and trb.optimizer.aggregate_num == 0
    pa, pb = _params(a), _params(b)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])


def test_trainer_update_on_kvstore_equals_the_aggregated_local_sgd(
        tmp_path, monkeypatch):
    """SGD computes the same fp32 arithmetic on both routes, so the local
    update through the aggregated route (one multi_sgd call a step, the
    default) is bit-equal to the store's per-key updates."""
    _, a = _pair(tmp_path)
    _, b = _pair(tmp_path)
    x, y = _batch(seed=4)
    tra, _ = _train(mx, a, "sgd", None, x, y, steps=2,
                    update_on_kvstore=True)
    assert tra._kvstore is not None and tra._update_on_kvstore
    monkeypatch.delenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", raising=False)
    trb, _ = _train(mx, b, "sgd", None, x, y, steps=2)
    assert trb._kvstore is None and trb.optimizer.aggregate_num == 4
    pa, pb = _params(a), _params(b)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])


def test_trainer_zero_save_and_load_states(tmp_path):
    _, net = _pair(tmp_path)
    x, y = _batch(seed=5)
    tr, _ = _train(mx, net, "lamb", True, x, y, steps=1)
    f = str(tmp_path / "trainer.states")
    tr.save_states(f)
    name, kw = TRAINERS["lamb"]
    tr2 = mx.gluon.Trainer(net.collect_params(), name, dict(kw), zero=True)
    tr2.load_states(f)
    assert isinstance(tr2.optimizer, mx.optimizer.LAMB)
    assert tr2._kvstore._updater.layout.keys() == \
        tr._kvstore._updater.layout.keys()
    with pytest.raises(ValueError, match="needs a kvstore"):
        mx.gluon.Trainer(net.collect_params(), "lamb", kvstore=None,
                         zero=True)
    with pytest.raises(ValueError, match="contradicts"):
        mx.gluon.Trainer(net.collect_params(), "lamb",
                         update_on_kvstore=False, zero=True)


def test_bert_training_on_the_cpu_launches_no_kernel(tmp_path):
    before = launch_counts()
    _, net = _pair(tmp_path)
    _train(mx, net, "lamb", True, *_batch(), steps=1)
    assert launch_counts() == before


# ------------------------------------------------------------- functional
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functional_bert_matches_jax(dtype):
    jcfg = dataclasses.replace(jfbert.CONFIGS["bert_tiny"],
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tfbert.CONFIGS["bert_tiny"],
                               dtype=getattr(torch, dtype))
    jp = jfbert.bert_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    assert tp["layers"]["0"]["attn_norm"]["gamma"].dtype == torch.float32
    assert tp["word_embed"].dtype == getattr(torch, dtype)
    rng = np.random.RandomState(6)
    batch = {"tokens": rng.randint(0, 256, (2, 24)),
             "targets": rng.randint(0, 256, (2, 24)),
             "mask": (rng.rand(2, 24) < 0.3).astype(np.float32)}
    rel = FP32_REL if dtype == "float32" else BF16_REL
    _close(tfbert.bert_forward(tp, batch["tokens"], tcfg),
           jfbert.bert_forward(jp, jnp.asarray(batch["tokens"]), jcfg), rel)
    jl, jg = jax.value_and_grad(jfbert.bert_mlm_loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = {}

    def track(node, path=""):
        if isinstance(node, dict):
            return {k: track(v, path + "/" + k) for k, v in node.items()}
        leaves[path] = node.clone().requires_grad_(True)
        return leaves[path]

    loss = tfbert.bert_mlm_loss(track(tp), batch, tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=FP32_REL if dtype == "float32" else 1e-3)
    flat = {}

    def walk(node, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + "/" + k)
        else:
            flat[path] = node

    walk(jg)
    grel = 1e-4 if dtype == "float32" else 5e-2
    median = np.median([np.linalg.norm(_np(g)) for g in flat.values()])
    for path, t in leaves.items():
        w, g = _np(flat[path]), _np(t.grad)
        if path.endswith("/attn/bk"):
            # the key bias adds q . bk to every score of a query row, which
            # the softmax takes out: its gradient is zero in exact
            # arithmetic and rounding noise on both sides (bf16 rounds at
            # 2^-8, fp32 at 2^-24)
            noise = 1e-5 if dtype == "float32" else 1e-2
            assert max(np.linalg.norm(w), np.linalg.norm(g)) <= noise * median
            continue
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= grel, (path, err)
