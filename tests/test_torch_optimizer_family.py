"""The port's optimizer family (every optimizer of the reference besides
SGD, Adam and LAMB, their per-parameter update ops, the multi-tensor ops
and every `FusedTrainStep` entry) against the JAX package's.

Inputs come from numpy with a seed and go to both sides. fp32 results
are held to 1e-6 of the output's max abs (FMA_REL: XLA on the CPU
contracts a multiply-add into one FMA, rounded once, where the port rounds
twice). A bf16 op computes in fp32 and rounds once, so it is held to one
bf16 ulp of the reference's fp32 result on the same bf16 inputs, rounded.
`Updater` runs go 3 steps with lr_mult, wd_mult and an lr scheduler and
are held to 1e-5 of each weight's max abs; `FusedTrainStep` runs go 4
steps on the reference test's MLP (its weights written by the reference
to a `.params` file the port loads) and are held to the reference's
`FusedTrainStep` within rtol 2e-5 / atol 2e-6, the reference's own bar
between its two routes. SGLD's noise comes from the port's seeded torch
generator, not JAX's stream: its drift is held to the reference with the
noise zeroed on both sides, its noise to N(0, lr) by mean and standard
deviation over 1e5 elements.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import launch_counts, registry
from mxnet_tpu_torch.optimizer import optimizer as topt
from _torch_seed import _seed_torch  # noqa: F401

FMA_REL = 1e-6
UPDATER_REL = 1e-5
N = 1000


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel=FMA_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, rel)


def _bf16_ulp(a):
    a = np.abs(a).astype(np.float32)
    exp = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7)


def _bf16_round(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _within_one_bf16_ulp(got, want32):
    want = _bf16_round(want32)
    assert got.dtype == torch.bfloat16
    assert (np.abs(_np(got) - want) <= _bf16_ulp(want)).all()


def _arrays(kinds, n=N, seed=0):
    """One seeded array per kind: "s" signed (randn), "p" positive
    (uniform in [0.1, 1.1)), "c" a centered-RMSProp (n, g) pair's n,
    which stays above g * g."""
    rng = np.random.RandomState(seed)
    out = []
    for k in kinds:
        if k == "s":
            out.append(rng.randn(n).astype(np.float32))
        elif k == "p":
            out.append((rng.rand(n) + 0.1).astype(np.float32))
        elif k == "c":
            out.append((out[-1] ** 2 + rng.rand(n) + 0.1)
                       .astype(np.float32))
    return out


# name: (the kind of each array input, keyword scalars, the clip keyword)
BASE = dict(wd=1e-3, rescale_grad=0.25)
OPS = {
    "nag_mom_update": ("sss", dict(BASE, lr=0.01, momentum=0.9),
                       "clip_gradient"),
    "mp_nag_mom_update": ("ssss", dict(BASE, lr=0.01, momentum=0.9),
                          "clip_gradient"),
    "rmsprop_update": ("ssp", dict(BASE, lr=0.01, gamma1=0.9,
                                   clip_weights=0.5), "clip_gradient"),
    "rmspropalex_update": ("ssscs", dict(BASE, lr=0.01, gamma1=0.9,
                                        gamma2=0.85), "clip_gradient"),
    "ftrl_update": ("sssp", dict(BASE, lr=0.05, lamda1=0.01, beta=1.0),
                    "clip_gradient"),
    "signsgd_update": ("ss", dict(BASE, lr=0.01), "clip_gradient"),
    "signum_update": ("sss", dict(BASE, lr=0.01, momentum=0.9, wd_lh=1e-3),
                      "clip_gradient"),
    "ftml_update": ("sspps", dict(BASE, lr=0.01, beta1=0.6, beta2=0.999,
                                  epsilon=1e-8, t=3), "clip_grad"),
    "adagrad_update": ("ssp", dict(BASE, lr=0.05, epsilon=1e-7),
                       "clip_gradient"),
    "adadelta_update": ("sspp", dict(BASE, rho=0.9, epsilon=1e-5),
                        "clip_gradient"),
    "adamax_update": ("sssp", dict(BASE, lr=0.002, beta1=0.9, beta2=0.999),
                      "clip_gradient"),
    "nadam_update": ("sssp", dict(BASE, lr=0.005, beta1=0.9, beta2=0.999,
                                  epsilon=1e-8, schedule_decay=0.004, t=3,
                                  m_schedule=0.8), "clip_gradient"),
    "adamw_update": ("sssp", dict(BASE, lr=0.01, beta1=0.9, beta2=0.999,
                                  epsilon=1e-8, eta=0.9), "clip_gradient"),
}
# the centered RMSProp's arrays are made as (w, grad, g, n, delta), n from
# g, and reordered to its inputs (w, grad, n, g, delta)
_ORDER = {"rmspropalex_update": (0, 1, 3, 2, 4)}


def _op_inputs(name, seed=0):
    kinds, kw, clip_key = OPS[name]
    arrays = _arrays(kinds, seed=seed)
    order = _ORDER.get(name)
    if order:
        arrays = [arrays[i] for i in order]
    return arrays, kw, clip_key


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("clip", [-1.0, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_reference_fp32(name, clip):
    arrays, kw, clip_key = _op_inputs(name)
    kw = dict(kw, **{clip_key: clip})
    want = _as_tuple(jreg.get(name).fn(*(jnp.asarray(a) for a in arrays),
                                       **kw))
    got = _as_tuple(registry.get(name).fn(
        *(torch.from_numpy(a.copy()) for a in arrays), **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_bf16_rounds_the_fp32_result_once(name):
    """bf16 weight, gradient and states (the master of mp_nag_mom_update
    stays fp32): each output within one bf16 ulp of the reference's fp32
    result on the same bf16 values, rounded."""
    arrays, kw, clip_key = _op_inputs(name, seed=1)
    arrays = [a if name.startswith("mp_") and j == 3 else _bf16_round(a)
              for j, a in enumerate(arrays)]
    kw = dict(kw, **{clip_key: 0.5})
    want = _as_tuple(jreg.get(name).fn(*(jnp.asarray(a) for a in arrays),
                                       **kw))
    tin = [torch.from_numpy(a.copy()) for a in arrays]
    tin = [t if name.startswith("mp_") and j == 3 else t.bfloat16()
           for j, t in enumerate(tin)]
    got = _as_tuple(registry.get(name).fn(*tin, **kw))
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            _close(g, w)
        else:
            _within_one_bf16_ulp(g, _np(w))


def test_aliases_name_the_same_ops():
    for alias, name in (("_adamw_update", "adamw_update"),
                        ("_contrib_adamw_update", "adamw_update"),
                        ("_adam_update", "adam_update"),
                        ("preloaded_multi_mp_sgd_mom_update",
                         "multi_mp_sgd_mom_update")):
        assert registry.get(alias) is registry.get(name)
        assert hasattr(mx.nd, alias)


# ---------------------------------------------------------------- Updater
UPDATERS = [
    ("adamw", {"learning_rate": 0.01, "wd": 1e-2, "eta": 0.9,
               "clip_gradient": 1.0}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 1e-3, "clip_weights": 2.0}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "gamma2": 0.85}),
    ("adagrad", {"learning_rate": 0.05, "wd": 1e-3, "eps": 1e-6}),
    ("adadelta", {"rho": 0.9, "epsilon": 1e-5, "wd": 1e-3}),
    ("adamax", {"learning_rate": 0.01, "wd": 1e-3}),
    ("nadam", {"learning_rate": 0.005, "wd": 1e-3}),
    ("ftrl", {"learning_rate": 0.05, "lamda1": 0.001, "wd": 1e-3}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 1e-3,
                "wd": 1e-3}),
    ("signsgd", {"learning_rate": 0.01, "wd": 1e-3}),
    ("ftml", {"learning_rate": 0.01, "wd": 1e-3, "clip_gradient": 0.8}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.01,
              "wd": 1e-3}),
    ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
               "warmup_epochs": 1, "updates_per_epoch": 4,
               "batch_scale": 4}),
    ("lbsgd", {"learning_rate": 0.1, "warmup_strategy": "lars",
               "wd": 1e-3}),
    ("sgld", {"learning_rate": 0.01, "wd": 1e-3, "clip_gradient": 1.0}),
    ("test", {"rescale_grad": 0.5}),
]
UPDATER_IDS = ["adamw", "nag", "rmsprop", "rmsprop_centered", "adagrad",
               "adadelta", "adamax", "nadam", "ftrl", "signum", "signsgd",
               "ftml", "lars", "dcasgd", "lbsgd", "lbsgd_lars", "sgld",
               "test"]


def _updater_run(pkg, name, opt_kw, steps, ctx, seed=0):
    """`name` through the package's Updater over three parameters for
    `steps` steps, one parameter a call; returns the final weights and
    states."""
    rng = np.random.RandomState(seed)
    shapes = [(6, 5), (5,), (7,)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(steps)]
    sched = pkg.lr_scheduler.FactorScheduler(
        step=2, factor=0.5, base_lr=opt_kw.get("learning_rate", 0.01))
    opt = pkg.optimizer.create(name, lr_scheduler=sched, param_idx2name={
        0: "fc_weight", 1: "fc_bias", 2: "bn_gamma"}, **opt_kw)
    opt.set_lr_mult({0: 0.5})
    opt.set_wd_mult({2: 2.0})
    upd = pkg.optimizer.get_updater(opt)
    w_nd = [pkg.nd.array(w, ctx=ctx) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            upd(i, pkg.nd.array(g, ctx=ctx), w_nd[i])
    states = []
    for i in range(len(shapes)):
        st = upd.states[i]
        st = () if st is None else st if isinstance(st, tuple) else (st,)
        states.extend(s.asnumpy() for s in st if s is not None)
    return [w.asnumpy() for w in w_nd], states, opt


def _zero_noise(monkeypatch):
    """SGLD without its noise on both sides."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(topt, "_sgld_noise",
                        lambda weight, lr: torch.zeros(weight.shape))


@pytest.mark.parametrize("name,kw", UPDATERS, ids=UPDATER_IDS)
def test_updater_matches_reference(monkeypatch, name, kw):
    """Three steps through the Updater with lr_mult, wd_mult (and the
    default wd_mult 0 of non-weights), an lr scheduler, rescale and clip:
    weights and states against the reference's."""
    if name == "sgld":
        _zero_noise(monkeypatch)
    kw = dict(kw)
    kw.setdefault("rescale_grad", 0.5)
    got, got_states, opt = _updater_run(mx, name, kw, 3, mx.cpu())
    want, want_states, jopt = _updater_run(jmx, name, kw, 3, jmx.cpu())
    assert type(opt).__name__ == type(jopt).__name__
    for g, w in zip(got + got_states, want + want_states):
        _close(g, w, UPDATER_REL)
    if name == "nadam":
        assert opt.m_schedule == jopt.m_schedule


def test_sgld_noise_is_seeded_normal_with_variance_lr():
    """w = 0 and g = 0 leave w = the noise: mean 0 and standard deviation
    sqrt(lr) over 1e5 elements (5 standard errors for the mean, 1% for the
    deviation, whose standard error here is 0.22%), the same draw again
    under the same seed."""
    lr, n = 0.01, 100_000

    def draw(seed):
        mx.random.seed(seed)
        opt = mx.optimizer.create("sgld", learning_rate=lr)
        w = mx.nd.zeros((n,), ctx=mx.cpu())
        mx.optimizer.get_updater(opt)(0, mx.nd.zeros((n,), ctx=mx.cpu()), w)
        return w.asnumpy().astype(np.float64)

    a = draw(3)
    sd = np.sqrt(lr)
    assert abs(a.mean()) <= 5 * sd / np.sqrt(n), a.mean()
    assert abs(a.std() / sd - 1.0) <= 0.01, a.std()
    np.testing.assert_array_equal(a, draw(3))
    assert not np.array_equal(a, draw(4))


# ----------------------------------------------------------- fused step
FUSED = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 1e-4}),
    ("signsgd", {"learning_rate": 0.005}),
    ("ftml", {"learning_rate": 0.01}),
    ("adagrad", {"learning_rate": 0.05}),
    ("adadelta", {"rho": 0.9, "epsilon": 1e-5}),
    ("adamax", {"learning_rate": 0.002}),
    ("nadam", {"learning_rate": 0.005}),
    ("rmsprop", {"learning_rate": 0.005}),
    ("rmsprop", {"learning_rate": 0.005, "centered": True, "gamma2": 0.85}),
    ("ftrl", {"learning_rate": 0.05, "lamda1": 0.001}),
    ("lamb", {"learning_rate": 0.01}),
    ("lars", {"learning_rate": 0.05, "momentum": 0.9, "eta": 0.001}),
    ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9}),
]
FUSED_IDS = [n if not kw.get("centered") else n + "_centered"
             for n, kw in FUSED]


def _mlp(pkg):
    nn = pkg.gluon.nn
    with pkg.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(32, activation="relu"))
            net.add(nn.Dense(8))
    return net


def _mlp_data(n=16, d=12, classes=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randint(0, classes, (n,)).astype(np.float32))


def _params(net):
    return {k: np.asarray(p.data().asnumpy(), np.float32)
            for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("optimizer,opt_args", FUSED, ids=FUSED_IDS)
def test_fused_step_matches_reference_fused_step(tmp_path, optimizer,
                                                 opt_args):
    """The reference test's MLP (Xavier weights from the reference, by
    file), SoftmaxCrossEntropyLoss, 4 FusedTrainStep steps on both sides:
    each step's mean loss and the parameters after, within the
    reference's own bar between its routes."""
    x, y = _mlp_data()
    jmx.random.seed(7)
    jnet = _mlp(jmx)
    jnet.initialize(jmx.init.Xavier(rnd_type="gaussian"), ctx=jmx.cpu())
    jnet(jmx.nd.array(x))
    f = str(tmp_path / "mlp.params")
    jnet.save_parameters(f)
    tnet = _mlp(mx)
    tnet.load_parameters(f, ctx=mx.cpu())
    out = []
    for pkg, net in ((jmx, jnet), (mx, tnet)):
        tr = pkg.gluon.Trainer(net.collect_params(), optimizer,
                               dict(opt_args))
        step = pkg.gluon.FusedTrainStep(
            net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), tr)
        xs, ys = pkg.nd.array(x, ctx=pkg.cpu()), pkg.nd.array(y,
                                                             ctx=pkg.cpu())
        out.append([float(np.asarray(step(xs, ys).asnumpy()))
                    for _ in range(4)])
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-6)
    want, got = _params(jnet), _params(tnet)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=2e-6,
                                   err_msg="param %s diverged" % k)


def test_fused_step_refuses_sgld_as_the_reference_does():
    x, y = _mlp_data()
    for pkg in (jmx, mx):
        net = _mlp(pkg)
        net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
        tr = pkg.gluon.Trainer(net.collect_params(), "sgld",
                               {"learning_rate": 0.01})
        step = pkg.gluon.FusedTrainStep(
            net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), tr)
        with pytest.raises(NotImplementedError, match="imperative"):
            step(pkg.nd.array(x, ctx=pkg.cpu()), pkg.nd.array(y,
                                                              ctx=pkg.cpu()))


def test_fused_step_takes_the_references_optimizers():
    from mxnet_tpu.gluon import fused_step as jfs
    from mxnet_tpu_torch.gluon import fused_step as tfs
    assert sorted(tfs._FUSABLE) == sorted(jfs._FUSABLE)
    assert "sgld" not in tfs._FUSABLE


# -------------------------------------------------------- extended ops
def _sgd_list(seed, mp, n_tensors=5):
    """Interleaved per-tensor arrays of ragged sizes: w (bf16 values under
    mp), grad, mom, and the fp32 master under mp."""
    rng = np.random.RandomState(seed)
    sizes = [1, 7, 300, 33, 64][:n_tensors]
    groups = []
    for n in sizes:
        w = rng.randn(n).astype(np.float32)
        groups.append({"w": _bf16_round(w) if mp else w,
                       "g": rng.randn(n).astype(np.float32),
                       "mom": (rng.randn(n) * 0.1).astype(np.float32),
                       "w32": w})
    lrs = [float(v) for v in rng.rand(len(sizes)) * 0.1]
    wds = [float(v) for v in rng.rand(len(sizes)) * 1e-3]
    return groups, lrs, wds


MULTI_SGD = {
    # name: (keys a group, momentum)
    "multi_sgd_update": (("w", "g"), False),
    "multi_sgd_mom_update": (("w", "g", "mom"), True),
    "multi_mp_sgd_update": (("w", "g", "w32"), False),
    "multi_mp_sgd_mom_update": (("w", "g", "mom", "w32"), True),
    "preloaded_multi_mp_sgd_mom_update": (("w", "g", "mom", "w32"), True),
}


def _multi_sgd_case(name, clip):
    keys, mom_on = MULTI_SGD[name]
    mp = "w32" in keys
    groups, lrs, wds = _sgd_list(5, mp)
    kw = dict(lrs=lrs, wds=wds, rescale_grad=0.5, clip_gradient=clip)
    if mom_on:
        kw["momentum"] = 0.9
    want = jreg.get(name).fn(
        *(jnp.asarray(grp[k]).astype(jnp.bfloat16 if mp and k == "w"
                                     else jnp.float32)
          for grp in groups for k in keys), **kw)
    tin = [torch.from_numpy(grp[k].copy()) for grp in groups for k in keys]
    if mp:
        tin = [t.bfloat16() if j % len(keys) == 0 else t
               for j, t in enumerate(tin)]
    return want, tin, kw


def _check_multi(got, want, mp):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype == torch.bfloat16:
            assert mp
            _within_one_bf16_ulp(g, _np(w))
        else:
            _close(g, w)


EXTENDED = sorted(MULTI_SGD) + ["multi_all_finite", "multi_lars",
                                "mp_lamb_update_phase1",
                                "mp_lamb_update_phase2"]


@pytest.mark.parametrize("name", EXTENDED)
def test_extended_op_matches_reference(name):
    """The multi-tensor ops (interleaved lists: fp32, and bf16 weights
    with fp32 masters for the mp ones; clip on and off), the all-finite
    check, the LARS rates and the mp LAMB phases against the
    reference's."""
    if name in MULTI_SGD:
        for clip in (-1.0, 0.3):
            want, tin, kw = _multi_sgd_case(name, clip)
            got = registry.get(name).fn(*tin, **kw)
            _check_multi(got, want, "w32" in MULTI_SGD[name][0])
        return
    rng = np.random.RandomState(6)
    if name == "multi_all_finite":
        arrays = [rng.randn(n).astype(np.float32) for n in (3, 50, 7)]
        for bad in (None, np.nan, np.inf, -np.inf):
            arrs = [a.copy() for a in arrays]
            if bad is not None:
                arrs[1][17] = bad
            want = jreg.get(name).fn(*(jnp.asarray(a) for a in arrs),
                                     num_arrays=3)
            got = registry.get(name).fn(*(torch.from_numpy(a) for a in arrs),
                                        num_arrays=3)
            assert got.dtype == torch.float32 and got.shape == (1,)
            np.testing.assert_array_equal(_np(got), _np(want))
        return
    if name == "multi_lars":
        k = 6
        lrs = (rng.rand(k) * 0.1).astype(np.float32)
        wss = (rng.rand(k) * 10).astype(np.float32)
        gss = (rng.rand(k) * 3).astype(np.float32)
        wss[1], gss[2] = 0.0, 0.0
        wds = (rng.rand(k) * 1e-3).astype(np.float32)
        args = (lrs, wss, gss, wds)
        kw = dict(eta=0.01, eps=1e-8, rescale_grad=0.25)
        want = jreg.get(name).fn(*(jnp.asarray(a) for a in args), **kw)
        got = registry.get(name).fn(*(torch.from_numpy(a) for a in args),
                                    **kw)
        _close(got, want)
        return
    n = 300
    w32 = rng.randn(n).astype(np.float32)
    w = _bf16_round(w32)
    g = rng.randn(n).astype(np.float32)
    mean = (rng.randn(n) * 0.1).astype(np.float32)
    var = (rng.rand(n) * 0.1).astype(np.float32)
    if name == "mp_lamb_update_phase1":
        for master, clip in ((w32, -1.0), (None, 0.3), (w32, 0.3)):
            kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, t=3, wd=0.01,
                      rescale_grad=0.5, clip_gradient=clip)
            want = jreg.get(name).fn(
                jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(g),
                jnp.asarray(mean), jnp.asarray(var),
                None if master is None else jnp.asarray(master), **kw)
            got = registry.get(name).fn(
                torch.from_numpy(w).bfloat16(), torch.from_numpy(g),
                torch.from_numpy(mean), torch.from_numpy(var),
                None if master is None else torch.from_numpy(master), **kw)
            for a, b in zip(got, want):
                _close(a, b)
        return
    gdir = rng.randn(n).astype(np.float32)
    for master, r1, r2, lo, hi in ((w32, 2.0, 0.5, -1.0, -1.0),
                                   (w32, 2.0, 0.5, 0.1, 3.0),
                                   (None, 0.0, 0.5, -1.0, -1.0),
                                   (w32, 1.0, 4.0, 0.5, -1.0)):
        kw = dict(lr=0.01, lower_bound=lo, upper_bound=hi)
        want = jreg.get(name).fn(
            jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(gdir),
            jnp.float32(r1), jnp.float32(r2),
            None if master is None else jnp.asarray(master), **kw)
        got = registry.get(name).fn(
            torch.from_numpy(w).bfloat16(), torch.from_numpy(gdir),
            torch.tensor(r1), torch.tensor(r2),
            None if master is None else torch.from_numpy(master), **kw)
        _within_one_bf16_ulp(got[0], _np(want[1]))
        _close(got[1], want[1])


def test_extended_ops_on_the_cpu_launch_nothing():
    before = launch_counts()
    _, tin, kw = _multi_sgd_case("multi_mp_sgd_mom_update", 0.3)
    registry.get("multi_mp_sgd_mom_update").best_fn(False)(*tin, **kw)
    assert launch_counts() == before
