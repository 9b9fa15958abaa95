"""The port's optimizers and flat update kernels' plain versions against the
JAX package's.

Inputs come from numpy with a seed and go to both sides. On the CPU the
port's `flat_sgd`/`flat_adam` run their plain versions (the reference's
`_fused_flat_xla` arithmetic as separate fp32 torch ops). XLA on the CPU
contracts a multiply-add into one FMA, rounded once, where the port rounds
twice, so fp32 results agree within a few ulps of the largest term, not
bit for bit: held to 1e-6 of the output's max abs (FMA_REL). bf16 weights
are held to one bf16 ulp of the fp32-then-round result of the reference's
`_fused_fn`; the reference's per-parameter ops compute a bf16 weight in
bf16 arithmetic, so against those the port is held to 2e-2 (BF16_REL).
Adam's variances are made from squared gradients, as training makes
them. Bit-equality of each kernel with its plain version is checked on a
card (`cuda` marker, and chip_smoke.py).
"""
import itertools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import optimizer_ops as jops
from mxnet_tpu.optimizer import optimizer as jopt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import fused_optimizer as tfo
from mxnet_tpu_torch.ops import launch_counts, registry

FMA_REL = 1e-6
BF16_REL = 2e-2
N = 1000


def _rng_inputs(kind, n=N, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32)
    out = {"w": rng.randn(n).astype(np.float32), "g": g,
           "lr": (rng.rand(n) * 0.1).astype(np.float32),
           "wd": (rng.rand(n) * 1e-3).astype(np.float32)}
    if kind == "sgd":
        out["mom"] = (rng.randn(n) * 0.1).astype(np.float32)
    else:
        out["mean"] = (rng.randn(n) * 0.1).astype(np.float32)
        prev = rng.randn(n).astype(np.float32)
        out["var"] = (0.1 * g * g + 0.9 * prev * prev).astype(np.float32)
    return out


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel=FMA_REL):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, rel)


def _bf16_ulp(a):
    a = np.abs(a).astype(np.float32)
    exp = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


FLAGS = list(itertools.product([False, True], repeat=3))


@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("momentum_on,clip_on,mp_on", FLAGS)
def test_flat_sgd_matches_fused_flat_xla(momentum_on, clip_on, mp_on, vec):
    a = _rng_inputs("sgd")
    lr, wd = (a["lr"], a["wd"]) if vec else (0.05, 1e-4)
    ref = jopt._fused_flat_xla("sgd", momentum_on, clip_on, mp_on)(
        jnp.asarray(a["w"]), jnp.asarray(a["g"]), jnp.asarray(a["mom"]),
        jnp.asarray(a["w"]) if mp_on else None,
        jnp.asarray(lr), jnp.asarray(wd), 0.9, 1.0 / 32, 0.5)
    w, mom = _t(a["w"]), _t(a["mom"])
    master = _t(a["w"]) if mp_on else None
    fn = tfo.flat_update_fn("sgd", momentum_on, clip_on, mp_on)
    out = fn(w, _t(a["g"]), mom, master, _t(lr) if vec else lr,
             _t(wd) if vec else wd, 0.9, 1.0 / 32, 0.5)
    assert out[0] is w and out[1] is mom      # updated in place
    _close(w, ref[0])
    if momentum_on:
        _close(mom, ref[1])
    else:
        np.testing.assert_array_equal(_np(mom), a["mom"])
    if mp_on:
        _close(master, ref[2])


@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("clip_on,mp_on", list(itertools.product(
    [False, True], repeat=2)))
def test_flat_adam_matches_fused_flat_xla(clip_on, mp_on, vec):
    a = _rng_inputs("adam")
    lr, wd = (a["lr"], a["wd"]) if vec else (1e-3, 1e-4)
    b1, b2 = 0.9, 0.999
    ref = jopt._fused_flat_xla("adam", True, clip_on, mp_on)(
        jnp.asarray(a["w"]), jnp.asarray(a["g"]), jnp.asarray(a["mean"]),
        jnp.asarray(a["var"]), jnp.asarray(a["w"]) if mp_on else None,
        jnp.asarray(lr), jnp.asarray(wd), b1, 1.0 - b1, b2, 1.0 - b2, 1e-8,
        1.0 / 32, 0.5)
    w, mean, var = _t(a["w"]), _t(a["mean"]), _t(a["var"])
    master = _t(a["w"]) if mp_on else None
    out = tfo.flat_update_fn("adam", True, clip_on, mp_on)(
        w, _t(a["g"]), mean, var, master, _t(lr) if vec else lr,
        _t(wd) if vec else wd, b1, 1.0 - b1, b2, 1.0 - b2, 1e-8, 1.0 / 32,
        0.5)
    assert out[0] is w
    for got, want in zip((w, mean, var), ref[:3]):
        _close(got, want)
    if mp_on:
        _close(master, ref[3])


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_flat_bf16_weights_with_fp32_master(kind):
    """mp on with bf16 weights: the master is updated in fp32 and the
    weight is its rounding (the reference's flat path computes the same)."""
    a = _rng_inputs(kind)
    wb = jnp.asarray(a["w"]).astype(jnp.bfloat16)
    w32 = np.array(wb.astype(jnp.float32))
    if kind == "sgd":
        ref = jopt._fused_flat_xla("sgd", True, False, True)(
            wb, jnp.asarray(a["g"]), jnp.asarray(a["mom"]),
            jnp.asarray(w32), 0.05, 1e-4, 0.9, 1.0, 0.0)
        w, master = _t(w32, torch.bfloat16), _t(w32)
        tfo.flat_sgd(w, _t(a["g"]), _t(a["mom"]), master, 0.05, 1e-4, 0.9,
                     1.0, 0.0, True, False, True)
        want_master = ref[2]
    else:
        ref = jopt._fused_flat_xla("adam", True, False, True)(
            wb, jnp.asarray(a["g"]), jnp.asarray(a["mean"]),
            jnp.asarray(a["var"]), jnp.asarray(w32), 1e-3, 1e-4, 0.9,
            1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8, 1.0, 0.0)
        w, master = _t(w32, torch.bfloat16), _t(w32)
        tfo.flat_adam(w, _t(a["g"]), _t(a["mean"]), _t(a["var"]), master,
                      1e-3, 1e-4, 0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8,
                      1.0, 0.0, False, True)
        want_master = ref[3]
    assert w.dtype == torch.bfloat16
    _close(master, want_master)
    got, want = _np(w), _np(ref[0])
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def _ref_op(name, arrays, **kw):
    return getattr(jops, name)(*(jnp.asarray(a) for a in arrays), **kw)


PER_PARAM = [
    ("sgd_update", ("w", "g"), {}),
    ("sgd_mom_update", ("w", "g", "mom"), {"momentum": 0.9}),
    ("mp_sgd_update", ("w", "g", "w"), {}),
    ("mp_sgd_mom_update", ("w", "g", "mom", "w"), {"momentum": 0.9}),
    ("adam_update", ("w", "g", "mean", "var"),
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
]


@pytest.mark.parametrize("clip", [-1.0, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("name,keys,kw", PER_PARAM,
                         ids=[p[0] for p in PER_PARAM])
def test_per_param_ops_match_reference_ops_fp32(name, keys, kw, clip):
    kind = "adam" if name.startswith("adam") else "sgd"
    a = _rng_inputs(kind)
    kw = dict(kw, lr=0.01, wd=1e-3, rescale_grad=0.25, clip_gradient=clip)
    want = _ref_op(name, [a[k] for k in keys], **kw)
    got = registry.get(name).fn(*(_t(a[k]) for k in keys), **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_bf16_per_param_ops_vs_reference(kind):
    """bf16 weight, gradient and state: the port computes in fp32 and
    rounds once. That is one bf16 ulp from the reference's `_fused_fn`
    (fp32 too), and within BF16_REL of the reference's per-parameter op,
    which computes in bf16 (ROADMAP Queue C)."""
    a = _rng_inputs(kind, seed=3)
    wb = jnp.asarray(a["w"]).astype(jnp.bfloat16)
    gb = jnp.asarray(a["g"]).astype(jnp.bfloat16)
    states = ("mom",) if kind == "sgd" else ("mean", "var")
    sb = [jnp.asarray(a[k]).astype(jnp.bfloat16) for k in states]
    lr, wd = 0.01, 1e-3
    tw, tg = _t(_np(wb), torch.bfloat16), _t(_np(gb), torch.bfloat16)
    ts = [_t(_np(s), torch.bfloat16) for s in sb]
    if kind == "sgd":
        fused = jopt._fused_fn("sgd", True, False)(
            [wb], [gb], sb, [jnp.float32(lr)], [jnp.float32(wd)],
            jnp.float32(0.9), jnp.float32(1.0), jnp.float32(0.0))
        per_op = jops.sgd_mom_update(wb, gb, sb[0], lr, momentum=0.9, wd=wd)
        got = registry.get("sgd_mom_update").fn(tw, tg, ts[0], lr=lr,
                                                momentum=0.9, wd=wd)
        fused_w = fused[0][0]
    else:
        fused = jopt._fused_fn("adam", True, False)(
            [wb], [gb], sb[:1], sb[1:], [jnp.float32(lr)],
            [jnp.float32(wd)], jnp.float32(0.9), jnp.float32(0.999),
            jnp.float32(1e-8), jnp.float32(1.0), jnp.float32(0.0))
        per_op = jops.adam_update(wb, gb, sb[0], sb[1], lr, wd=wd)
        got = registry.get("adam_update").fn(tw, tg, ts[0], ts[1], lr=lr,
                                             wd=wd)
        fused_w = fused[0][0]
    assert got[0].dtype == torch.bfloat16
    w_got, w_fused = _np(got[0]), _np(fused_w)
    assert (np.abs(w_got - w_fused) <= _bf16_ulp(w_fused)).all()
    _close(got[0], per_op[0], BF16_REL)


def _updater_run(pkg, name, opt_kw, steps, ctx, seed=0):
    """Drive `name` through the package's Updater over three parameters
    for `steps` steps; returns the final weights."""
    rng = np.random.RandomState(seed)
    shapes = [(6, 5), (5,), (7,)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(steps)]
    opt = pkg.optimizer.create(name, param_idx2name={
        0: "fc_weight", 1: "fc_bias", 2: "bn_gamma"}, **opt_kw)
    opt.set_lr_mult({0: 0.5})
    opt.set_wd_mult({2: 2.0})
    upd = pkg.optimizer.get_updater(opt)
    w_nd = [pkg.nd.array(w, ctx=ctx) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            upd(i, pkg.nd.array(g, ctx=ctx), w_nd[i])
    return [w.asnumpy() for w in w_nd]


UPDATERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "rescale_grad": 0.5, "clip_gradient": 0.8}),
    ("sgd", {"learning_rate": 0.1, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3, "clip_gradient": 1.0}),
    ("adam", {"learning_rate": 0.01, "beta1": 0.8, "beta2": 0.99}),
]


@pytest.mark.parametrize("name,kw", UPDATERS,
                         ids=["sgd_mom_clip", "sgd", "adam_clip", "adam"])
def test_updater_matches_reference(name, kw):
    """Several steps through the Updater with lr_mult, wd_mult, the
    default wd_mult 0 of non-weights, clip and rescale, and an
    lr_scheduler."""
    sched = dict(step=2, factor=0.5, base_lr=kw["learning_rate"])
    got = _updater_run(mx, name, dict(
        kw, lr_scheduler=mx.lr_scheduler.FactorScheduler(**sched)), 5,
        mx.cpu())
    want = _updater_run(jmx, name, dict(
        kw, lr_scheduler=jmx.lr_scheduler.FactorScheduler(**sched)), 5,
        jmx.cpu())
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_adam_bias_correction_is_folded_into_lr():
    lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8
    opt = mx.optimizer.Adam(learning_rate=lr, beta1=b1, beta2=b2,
                            epsilon=eps)
    upd = mx.optimizer.get_updater(opt)
    rng = np.random.RandomState(5)
    w = rng.randn(8).astype(np.float64)
    w_nd = mx.nd.array(w, ctx=mx.cpu())
    m = v = np.zeros(8)
    for t in range(1, 4):
        g = rng.randn(8)
        upd(0, mx.nd.array(g, ctx=mx.cpu()), w_nd)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        lr_t = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        w = w - lr_t * m / (np.sqrt(v) + eps)
    np.testing.assert_allclose(w_nd.asnumpy(), w, rtol=1e-5, atol=1e-6)


def test_bf16_updater_matches_fused_fn():
    """A bf16 weight through the port's Updater (one op per parameter,
    fp32 then one rounding) against the reference's aggregated `_fused_fn`
    (fp32 then one rounding): within one bf16 ulp per step."""
    rng = np.random.RandomState(9)
    w = rng.randn(64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    mom = jnp.zeros(64, jnp.bfloat16)
    new_w, _ = jopt._fused_fn("sgd", True, False)(
        [wb], [gb], [mom], [jnp.float32(0.1)], [jnp.float32(0.0)],
        jnp.float32(0.9), jnp.float32(1.0), jnp.float32(0.0))
    opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    w_nd = mx.nd.array(_np(wb), ctx=mx.cpu(), dtype="bfloat16")
    mx.optimizer.get_updater(opt)(
        0, mx.nd.array(_np(gb), ctx=mx.cpu(), dtype="bfloat16"), w_nd)
    assert w_nd.dtype == "bfloat16"
    want = _np(new_w[0])
    assert (np.abs(w_nd.asnumpy() - want) <= _bf16_ulp(want)).all()


SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, base_lr=1.0,
                             warmup_steps=2, warmup_begin_lr=0.1)),
    ("MultiFactorScheduler", dict(step=[4, 9], factor=0.3, base_lr=0.5)),
    ("PolyScheduler", dict(max_update=20, base_lr=1.0, pwr=2,
                           final_lr=0.01, warmup_steps=3)),
    ("CosineScheduler", dict(max_update=20, base_lr=1.0, final_lr=0.1,
                             warmup_steps=4, warmup_mode="constant",
                             warmup_begin_lr=0.2)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS, ids=[s[0] for s in
                                                     SCHEDULERS])
def test_lr_schedulers_match_reference(name, kw):
    mine = getattr(mx.lr_scheduler, name)(**kw)
    theirs = getattr(jmx.lr_scheduler, name)(**kw)
    assert [mine(t) for t in range(30)] == [theirs(t) for t in range(30)]


@pytest.mark.parametrize("name,match", [("rmsprop", "later slice"),
                                        ("nag", "later slice"),
                                        ("adamw", "later slice")])
def test_optimizers_not_ported_raise(name, match):
    with pytest.raises(NotImplementedError, match=match):
        mx.optimizer.create(name)
    with pytest.raises(ValueError, match="Cannot find"):
        mx.optimizer.create("no_such_optimizer")


def test_updater_states_round_trip_keeps_dtypes():
    opt = mx.optimizer.Adam(learning_rate=0.01)
    upd = mx.optimizer.get_updater(opt)
    w = mx.nd.array(np.ones(4), ctx=mx.cpu(), dtype="bfloat16")
    upd(0, mx.nd.array(np.full(4, 0.5), ctx=mx.cpu(), dtype="bfloat16"), w)
    blob = upd.get_states(dump_optimizer=True)
    back = mx.optimizer.get_updater(mx.optimizer.SGD())
    back.set_states(blob)
    assert isinstance(back.optimizer, mx.optimizer.Adam)
    assert back.optimizer._index_update_count == {0: 1}
    for a, b in zip(upd.states[0], back.states[0]):
        assert b.dtype == "bfloat16"
        assert torch.equal(a.data_torch, b.data_torch)


def test_cpu_updates_launch_nothing():
    before = launch_counts()
    a = _rng_inputs("sgd", n=16)
    tfo.flat_sgd(_t(a["w"]), _t(a["g"]), _t(a["mom"]), None, 0.1, 0.0, 0.9,
                 1.0, 0.0, True, False, False)
    assert launch_counts() == before


def test_kernel_rejects_a_device_without_one():
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfo.flat_sgd(t, t, t, None, 0.1, 0.0, 0.9, 1.0, 0.0, True, False,
                     False)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_kernels_bit_equal_to_plain_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in (torch.float32, torch.bfloat16):
        a = {k: _t(v, dtype if k in ("w", "g", "mom", "mean", "var")
                   else torch.float32).cuda()
             for k, v in _rng_inputs(kind, n=4097).items()}
        k = {n: t.clone() for n, t in a.items()}
        if kind == "sgd":
            tfo.flat_sgd(k["w"], k["g"], k["mom"], None, k["lr"], k["wd"],
                         0.9, 0.5, 0.3, True, True, False)
            want = tfo._ref_flat_sgd(a["w"], a["g"], a["mom"], None,
                                     a["lr"], a["wd"], 0.9, 0.5, 0.3, True,
                                     True, False)
            pairs = [(k["w"], want[0]), (k["mom"], want[1])]
        else:
            tfo.flat_adam(k["w"], k["g"], k["mean"], k["var"], None, 1e-3,
                          1e-4, 0.9, 0.1, 0.999, 1.0 - 0.999, 1e-8, 0.5,
                          0.3, True, False)
            want = tfo._ref_flat_adam(a["w"], a["g"], a["mean"], a["var"],
                                      None, 1e-3, 1e-4, 0.9, 0.1, 0.999,
                                      1.0 - 0.999, 1e-8, 0.5, 0.3, True,
                                      False)
            pairs = list(zip((k["w"], k["mean"], k["var"]), want[:3]))
        for got, ref in pairs:
            assert torch.equal(got, ref)
