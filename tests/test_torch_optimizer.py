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
them. The multi-tensor updates (`multi_sgd`/`multi_adam`, the reference's
aggregated `fused_update`) are held to the reference's `_fused_fn` over
mixed bf16/fp32 lists, and the port's `Updater` and `Trainer` to the
reference's on that route. Bit-equality of each kernel with its plain
version, and of a multi-tensor launch with the one-tensor launches, is
checked on a card (`cuda` marker, and chip_smoke.py).
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
from _torch_seed import _seed_torch  # noqa: F401

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


# the 19 optimizers that the reference's optimizer module registers (its
# contrib modules may register more once imported)
REFERENCE_OPTIMIZERS = sorted(
    name for name, klass in jopt.Optimizer.opt_registry.items()
    if klass.__module__ == jopt.__name__)


@pytest.mark.parametrize("name", REFERENCE_OPTIMIZERS
                         + ["no_such_optimizer"])
def test_every_reference_optimizer_is_registered(name):
    """`create` makes each of the reference's registered optimizers, as
    the class of the same name, and refuses a name the reference does not
    know as the reference does."""
    assert len(REFERENCE_OPTIMIZERS) == 19
    if name not in REFERENCE_OPTIMIZERS:
        for pkg in (mx, jmx):
            with pytest.raises(ValueError, match="Cannot find optimizer"):
                pkg.optimizer.create(name)
        return
    opt = mx.optimizer.create(name)
    assert type(opt).__name__ == jopt.Optimizer.opt_registry[name].__name__
    assert mx.optimizer.create(name.upper()).__class__ is type(opt)


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


def _mixed_list(kind, sizes, seed, on="cpu"):
    """A seeded list like a network's: bf16 weights, gradients and states
    beside fp32 ones (every third tensor fp32, as BatchNorm's), per-tensor
    lr and wd. Returns (numpy arrays per tensor, dtypes, lrs, wds)."""
    rng = np.random.RandomState(seed)
    arrays, dtypes = [], []
    for j, n in enumerate(sizes):
        a = _rng_inputs(kind, n=n, seed=seed * 1000 + j)
        del a["lr"], a["wd"]
        arrays.append(a)
        dtypes.append(torch.float32 if j % 3 == 2 else torch.bfloat16)
    lrs = [float(x) for x in rng.rand(len(sizes)) * 0.1]
    wds = [float(x) for x in rng.rand(len(sizes)) * 1e-3]
    return arrays, dtypes, lrs, wds


def _bf16_round(a):
    return _np(_t(a, torch.bfloat16))


MULTI_SIZES = [1, 7, 300, 4097, 64, 2048, 33]


@pytest.mark.parametrize("kind,momentum_on,clip_on", [
    ("sgd", True, True), ("sgd", True, False), ("sgd", False, True),
    ("sgd", False, False), ("adam", True, True), ("adam", True, False)],
    ids=["sgd_mom_clip", "sgd_mom", "sgd_clip", "sgd", "adam_clip", "adam"])
def test_multi_matches_fused_fn(kind, momentum_on, clip_on):
    """multi_sgd / multi_adam on the CPU (the plain version, tensor by
    tensor) against the reference's aggregated `_fused_fn` over a mixed
    bf16/fp32 list with per-tensor lr/wd: fp32 outputs within FMA_REL of
    their max abs, bf16 outputs within one bf16 ulp of the reference's fp32
    result rounded."""
    arrays, dtypes, lrs, wds = _mixed_list(kind, MULTI_SIZES, seed=4)
    states = ("mom",) if kind == "sgd" else ("mean", "var")
    # both sides start from the same (bf16-rounded where bf16) values
    start = [{k: (_bf16_round(v) if dt == torch.bfloat16 else v)
              for k, v in a.items()} for a, dt in zip(arrays, dtypes)]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jl = {k: [jnp.asarray(a[k]).astype(jdt[dt])
              for a, dt in zip(start, dtypes)] for k in ("w", "g") + states}
    tl = {k: [_t(a[k], dt) for a, dt in zip(start, dtypes)]
          for k in ("w", "g") + states}
    f32 = [jnp.float32(x) for x in lrs], [jnp.float32(x) for x in wds]
    rescale, clip = 1.0 / 8, 0.3
    if kind == "sgd":
        want = jopt._fused_fn("sgd", momentum_on, clip_on)(
            jl["w"], jl["g"], jl["mom"] if momentum_on else [], *f32,
            jnp.float32(0.9), jnp.float32(rescale), jnp.float32(clip))
        tfo.multi_sgd(tl["w"], tl["g"], tl["mom"], None, lrs, wds, 0.9,
                      rescale, clip, momentum_on, clip_on, False)
        pairs = [(tl["w"], want[0])] + (
            [(tl["mom"], want[1])] if momentum_on else [])
    else:
        b1, b2 = 0.9, 0.999
        want = jopt._fused_fn("adam", True, clip_on)(
            jl["w"], jl["g"], jl["mean"], jl["var"], *f32, jnp.float32(b1),
            jnp.float32(b2), jnp.float32(1e-8), jnp.float32(rescale),
            jnp.float32(clip))
        one = np.float32(1.0)
        tfo.multi_adam(tl["w"], tl["g"], tl["mean"], tl["var"], None, lrs,
                       wds, b1, float(one - np.float32(b1)), b2,
                       float(one - np.float32(b2)), 1e-8, rescale, clip,
                       clip_on, False)
        pairs = [(tl["w"], want[0]), (tl["mean"], want[1]),
                 (tl["var"], want[2])]
    for got_list, want_list in pairs:
        for got, ref in zip(got_list, want_list):
            ref = _np(ref)
            if got.dtype == torch.bfloat16:
                ref = _bf16_round(ref)
                assert (np.abs(_np(got) - ref) <= _bf16_ulp(ref)).all()
            else:
                _close(got, ref)
    if not momentum_on and kind == "sgd":
        for got, a in zip(tl["mom"], start):
            np.testing.assert_array_equal(_np(got), a["mom"])


def _list_updater_run(pkg, name, opt_kw, steps, ctx, seed=0):
    """`name` through the package's Updater, called with lists (the
    reference's aggregated route, aggregate_num 4), over four parameters
    for `steps` steps; returns the final weights and states."""
    rng = np.random.RandomState(seed)
    shapes = [(6, 5), (5,), (7,), (3, 4)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(steps)]
    opt = pkg.optimizer.create(name, aggregate_num=4, param_idx2name={
        0: "fc_weight", 1: "fc_bias", 2: "bn_gamma", 3: "fc2_weight"},
        **opt_kw)
    opt.set_lr_mult({0: 0.5})
    opt.set_wd_mult({2: 2.0})
    upd = pkg.optimizer.get_updater(opt)
    w_nd = [pkg.nd.array(w, ctx=ctx) for w in ws]
    for step in gs:
        upd(list(range(len(shapes))),
            [pkg.nd.array(g, ctx=ctx) for g in step], w_nd)
    states = []
    for i in range(len(shapes)):
        st = upd.states[i]
        st = () if st is None else st if isinstance(st, tuple) else (st,)
        states.extend(s.asnumpy() for s in st)
    return [w.asnumpy() for w in w_nd], states


@pytest.mark.parametrize("name,kw", UPDATERS,
                         ids=["sgd_mom_clip", "sgd", "adam_clip", "adam"])
def test_list_updater_matches_reference_fused_update(monkeypatch, name, kw):
    """The port's Updater given lists takes `fused_update` (one multi_*
    call a step) and matches the reference's Updater given the same lists
    (its `fused_update`, `_fused_fn`) over 5 steps with lr_mult, wd_mult,
    rescale, clip and an lr scheduler, weights and states alike."""
    sched = dict(step=2, factor=0.5, base_lr=kw["learning_rate"])
    calls = []
    for cls in (mx.optimizer.SGD, mx.optimizer.Adam):
        orig = cls.fused_update
        monkeypatch.setattr(cls, "fused_update",
                            lambda self, *a, _o=orig: (calls.append(1),
                                                       _o(self, *a)))
    got = _list_updater_run(mx, name, dict(
        kw, lr_scheduler=mx.lr_scheduler.FactorScheduler(**sched)), 5,
        mx.cpu())
    want = _list_updater_run(jmx, name, dict(
        kw, lr_scheduler=jmx.lr_scheduler.FactorScheduler(**sched)), 5,
        jmx.cpu())
    assert len(calls) == 5
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _close(g, w, 1e-5)


def _adam_trainer_var(pkg, ctx):
    """One Trainer.step of Adam over two Dense layers (four parameters,
    batch 1): the loss is sum(out * c), so every gradient is one exact
    product on both sides. Returns each parameter's var state."""
    rng = np.random.RandomState(11)
    x = rng.randn(1, 6).astype(np.float32)
    c = rng.randn(1, 3).astype(np.float32)
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(5, in_units=6))
        net.add(pkg.gluon.nn.Dense(3, in_units=5))
    net.initialize(ctx=ctx)
    params = net.collect_params()
    for k in sorted(params.keys()):
        params[k].set_data(pkg.nd.array(
            rng.randn(*params[k].shape).astype(np.float32), ctx=ctx))
    trainer = pkg.gluon.Trainer(params, "adam",
                                {"learning_rate": 0.01, "wd": 1e-3})
    with pkg.autograd.record():
        loss = (net(pkg.nd.array(x, ctx=ctx))
                * pkg.nd.array(c, ctx=ctx)).sum()
    loss.backward()
    trainer.step(1)
    upd = trainer._updaters[0]
    return [upd.states[i][1].asnumpy() for i in sorted(upd.states)]


def test_trainer_adam_var_matches_reference():
    """Trainer.step with Adam over several parameters takes the aggregated
    route on both sides, which computes 1 - beta2 in fp32: the var state
    after one step matches the reference's at rtol 1e-6 (1 - beta2 in
    double would be 1.3e-5 apart)."""
    got = _adam_trainer_var(mx, mx.cpu())
    want = _adam_trainer_var(jmx, jmx.cpu())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def _card_list(kind, sizes, dtypes, seed, offset_at=None):
    """Seeded CUDA tensors of a multi-tensor update: per tensor a dict of
    w, g and the states in that tensor's dtype, plus an fp32 master. The
    tensor at `offset_at` is a view one element into a larger buffer (off
    16 bytes), as a slice of a flat buffer may be."""
    out = []
    for j, (n, dt) in enumerate(zip(sizes, dtypes)):
        a = _rng_inputs(kind, n=n + 1, seed=seed * 1000 + j)
        d = {}
        for k in ("w", "g", "mom", "mean", "var"):
            if k in a:
                full = _t(a[k], dt).cuda()
                d[k] = full[1:] if j == offset_at else full[:n]
        d["master"] = d["w"].float()
        out.append(d)
    return out


def _clone_list(lst):
    return [{k: v.clone() for k, v in d.items()} for d in lst]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_multi_kernel_bit_equal_to_single_and_plain_on_the_card(kind):
    """One multi-tensor launch over a mixed bf16/fp32 list (sizes 1 to
    40000, a tensor off 16-byte alignment, flags on and off) against one
    launch per tensor and against the plain versions: 0 ulps. Then a list
    longer than one launch holds: consecutive launches, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    from mxnet_tpu_torch.ops._build import library
    cap = library("flat_sgd").mx_multi_capacity()
    sizes = [1, 7, 4097, 8192, 8193, 40000, 64, 2048, 300]
    dtypes = [torch.bfloat16, torch.float32] * 4 + [torch.bfloat16]
    cases = [(sizes, dtypes, 5), ([3] * (cap + 5),
                                  [torch.bfloat16] * (cap + 5), None)]
    states = ("mom",) if kind == "sgd" else ("mean", "var")
    flag_sets = list(itertools.product([False, True], repeat=3)) \
        if kind == "sgd" else [(True, c, m) for c in (False, True)
                               for m in (False, True)]
    for (sz, dts, off), (mom_on, clip_on, mp_on) in itertools.product(
            cases, flag_sets):
        base = _card_list(kind, sz, dts, seed=7, offset_at=off)
        lrs = [0.01 * (1 + j % 5) for j in range(len(sz))]
        wds = [1e-4 * (j % 3) for j in range(len(sz))]
        multi, single, plain = (_clone_list(base) for _ in range(3))
        args = (0.9, 0.25, 0.3) if kind == "sgd" else \
            (0.9, 0.1, 0.999, 1.0 - 0.999, 1e-8, 0.25, 0.3)
        flags = (mom_on, clip_on, mp_on) if kind == "sgd" else \
            (clip_on, mp_on)
        reset_launch_counts()
        lists = [[d[k] for d in multi] for k in ("w", "g") + states]
        masters = [d["master"] for d in multi]
        if kind == "sgd":
            tfo.multi_sgd(lists[0], lists[1], lists[2], masters, lrs, wds,
                          *args, *flags)
        else:
            tfo.multi_adam(*lists, masters, lrs, wds, *args, *flags)
        want = -(-len(sz) // cap)
        assert variant_counts() == {("flat_" + kind, "multi"): want}
        for j, (s, p) in enumerate(zip(single, plain)):
            st = [s[k] for k in states]
            pt = [p[k] for k in states]
            if kind == "sgd":
                tfo.flat_sgd(s["w"], s["g"], st[0], s["master"], lrs[j],
                             wds[j], *args, *flags)
                new = tfo._ref_flat_sgd(p["w"], p["g"], pt[0], p["master"],
                                        lrs[j], wds[j], *args, *flags)
                p.update(w=new[0], mom=new[1], master=new[2])
            else:
                tfo.flat_adam(s["w"], s["g"], *st, s["master"], lrs[j],
                              wds[j], *args, *flags)
                new = tfo._ref_flat_adam(p["w"], p["g"], *pt, p["master"],
                                         lrs[j], wds[j], *args, *flags)
                p.update(w=new[0], mean=new[1], var=new[2],
                         master=new[3])
        torch.cuda.synchronize()
        for m, s, p in zip(multi, single, plain):
            for k in m:
                assert torch.equal(m[k], s[k]), (kind, k, mom_on, clip_on,
                                                 mp_on)
                assert torch.equal(m[k], p[k]), (kind, k, mom_on, clip_on,
                                                 mp_on)


def test_table_packs_once_and_checks_gradients_every_call():
    """The multi-tensor table (what the C entry reads): empty tensors left
    out, one plan per list of live weights and states, reused while they
    come again (only the gradients, lr and wd packed anew and checked),
    dropped when a tensor is replaced or freed."""
    f32, b16 = torch.float32, torch.bfloat16
    ws = [torch.zeros(5, dtype=b16), torch.zeros(0), torch.zeros(7)]
    moms = [torch.zeros_like(w) for w in ws]
    lrs, wds = [0.1, 0.2, 0.3], [0.0, 1e-4, 2e-4]

    def table(gs, ws=ws, moms=moms):
        return tfo._table("multi_sgd", ws, gs, [("momentum", moms)], None,
                          lrs, wds, False)
    t1 = table([torch.ones_like(w) for w in ws])
    assert len(t1) == 2
    assert list(t1["n"]) == [5, 7]
    assert list(t1["w"]) == [ws[0].data_ptr(), ws[2].data_ptr()]
    assert list(t1["s0"]) == [moms[0].data_ptr(), moms[2].data_ptr()]
    assert list(t1["w_dtype"]) == [1, 0] and list(t1["s_dtype"]) == [1, 0]
    assert list(t1["lr"]) == [np.float32(0.1), np.float32(0.3)]
    gs = [torch.ones(5, dtype=f32), torch.ones(0), torch.ones(7, dtype=b16)]
    t2 = table(gs)
    assert t2 is t1
    assert list(t2["g"]) == [gs[0].data_ptr(), gs[2].data_ptr()]
    assert list(t2["g_dtype"]) == [0, 1]
    with pytest.raises(ValueError, match="grad of tensor 1"):
        table([gs[0], gs[1], torch.ones(8)])
    with pytest.raises(ValueError, match="grad of tensor 0"):
        table([torch.ones(10)[::2], gs[1], gs[2]])
    with pytest.raises(ValueError, match="3 weights but 2 grads"):
        table(gs[:2])
    ws2 = [ws[0].clone()] + ws[1:]
    assert table(gs, ws=ws2) is not t1
    plan = tfo._plans[("multi_sgd", 1, False)]
    del ws2
    assert not plan.alive
    with pytest.raises(ValueError, match="momentum of tensor 1"):
        table(gs, moms=moms[:2] + [torch.zeros(7, dtype=torch.float16)])
    with pytest.raises(ValueError, match="mean and var of tensor 0"):
        tfo._table("multi_adam", ws[:1], gs[:1],
                   [("mean", [torch.zeros(5)]),
                    ("var", [torch.zeros(5, dtype=b16)])], None, lrs[:1],
                   wds[:1], False)


def test_multi_rejects_a_device_without_one_and_mixed_lists():
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfo.multi_sgd([t], [t], [t], None, [0.1], [0.0], 0.9, 1.0, 0.0,
                      True, False, False)
    c = torch.zeros(4)
    with pytest.raises(ValueError, match="mixes"):
        tfo.multi_adam([c, t], [c, t], [c, t], [c, t], None, [0.1] * 2,
                       [0.0] * 2, 0.9, 0.1, 0.999, 0.001, 1e-8, 1.0, 0.0,
                       False, False)
