"""LAMB in the port (kernels #9/#10's plain versions, the per-parameter ops
and the optimizer) against the JAX package's.

Inputs come from numpy with a seed and go to both sides. On the CPU
`flat_lamb1`/`flat_lamb2` run their plain versions (the reference's
`_lamb1_xla_impl`/`_apply_xla_impl` as separate fp32 torch ops). XLA on the
CPU may contract a multiply-add into one FMA where the port rounds twice,
so elementwise outputs are held to 1e-6 of the output's max abs (FMA_REL,
as for SGD/Adam); the per-key squared norms are sums in another order,
held to 1e-5 relative (NORM_REL). The reference's Pallas kernels run in
interpret mode (MXNET_FLASH_INTERPRET=1) for the same comparison.
Bit-equality of each kernel with its plain version is checked on a card
(`cuda` marker, and chip_smoke.py).
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import fused_optimizer as jfo
from mxnet_tpu.ops import optimizer_ops as jops
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import fused_optimizer as tfo
from mxnet_tpu_torch.ops import launch_counts, registry

FMA_REL = 1e-6
NORM_REL = 1e-5
BF16_REL = 2e-2
N = 1000
# three keys and 10 padding elements, as a ZeRO bucket's shard holds them
SEGMENTS = ((0, 0, 300), (1, 300, 500), (2, 800, 190))
B1, B2, EPS, T = 0.9, 0.999, 1e-6, 3


def _inputs(n=N, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32)
    prev = rng.randn(n).astype(np.float32)
    out = {"w": rng.randn(n).astype(np.float32), "g": g,
           "mean": (rng.randn(n) * 0.1).astype(np.float32),
           "var": (0.1 * g * g + 0.9 * prev * prev).astype(np.float32),
           "wd": (rng.rand(n) * 1e-2).astype(np.float32),
           "scale": (rng.rand(n) * 1e-2).astype(np.float32)}
    tail = SEGMENTS[-1][1] + SEGMENTS[-1][2]
    for k in ("w", "g", "mean", "var", "wd", "scale"):
        if n > tail:
            out[k][tail:] = 0.0      # the padding of a flat shard
    return out


def _seg_ids(n=N):
    ids = np.zeros(n, np.int32)
    for k, s, ln in SEGMENTS:
        ids[s:s + ln] = k
    return ids


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel=FMA_REL):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, rel)


def _norms_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=NORM_REL, atol=0)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _scalars(bias_corr):
    d1, d2 = (1.0 - B1 ** T, 1.0 - B2 ** T) if bias_corr else (1.0, 1.0)
    return B1, 1.0 - B1, B2, 1.0 - B2, d1, d2, EPS, 1.0 / 32, 0.5


def _ref_phase1(a, clip_on, mp_on, bias_corr, vec):
    scal = [jnp.float32(s) for s in _scalars(bias_corr)]
    wd = jnp.asarray(a["wd"]) if vec else jnp.float32(0.01)
    return jfo._lamb1_xla_impl(clip_on, mp_on, bias_corr, SEGMENTS, 3)(
        jnp.asarray(a["w"]), jnp.asarray(a["g"]), jnp.asarray(a["mean"]),
        jnp.asarray(a["var"]), jnp.asarray(a["w"]) if mp_on else None, wd,
        jnp.asarray(_seg_ids()), *scal)


def _port_phase1(a, clip_on, mp_on, bias_corr, vec, dtype=torch.float32):
    mean, var = _t(a["mean"], dtype), _t(a["var"], dtype)
    out = tfo.lamb_flat_phase1_fn(clip_on, mp_on, bias_corr, SEGMENTS, 3)(
        _t(a["w"], dtype), _t(a["g"], dtype), mean, var,
        _t(a["w"]) if mp_on else None, _t(a["wd"]) if vec else 0.01,
        torch.from_numpy(_seg_ids()), *_scalars(bias_corr))
    assert out[1] is mean and out[2] is var       # updated in place
    return out


FLAGS = list(itertools.product([False, True], repeat=3))


@pytest.mark.parametrize("vec", [False, True], ids=["scalar_wd", "vector_wd"])
@pytest.mark.parametrize("clip_on,mp_on,bias_corr", FLAGS)
def test_flat_lamb1_matches_lamb1_xla_impl(clip_on, mp_on, bias_corr, vec):
    a = _inputs()
    ref = _ref_phase1(a, clip_on, mp_on, bias_corr, vec)
    got = _port_phase1(a, clip_on, mp_on, bias_corr, vec)
    assert got[0].dtype == torch.float32 and got[0].shape == (N,)
    for g, w in zip(got[:3], ref[:3]):
        _close(g, w)
    _norms_close(got[3], ref[3])


@pytest.mark.parametrize("clip_on,bias_corr", [(False, True), (True, False)])
def test_flat_lamb1_matches_the_pallas_kernel_interpreted(monkeypatch,
                                                          clip_on,
                                                          bias_corr):
    """The reference's `_kernel_flat_lamb1` run by the Pallas interpreter
    (one masked reduction per key per tile) against the port's plain
    version."""
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
    a = _inputs()
    scal = [jnp.float32(s) for s in _scalars(bias_corr)]
    ref = jfo.lamb_flat_phase1_fn(clip_on, False, bias_corr, SEGMENTS, 3)(
        jnp.asarray(a["w"]), jnp.asarray(a["g"]), jnp.asarray(a["mean"]),
        jnp.asarray(a["var"]), None, jnp.asarray(a["wd"]),
        jnp.asarray(_seg_ids()), *scal)
    got = _port_phase1(a, clip_on, False, bias_corr, True)
    for g, w in zip(got[:3], ref[:3]):
        _close(g, w)
    _norms_close(got[3], ref[3])


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("mp_on,vec", list(itertools.product(
    [False, True], repeat=2)))
def test_flat_lamb2_matches_reference_apply(monkeypatch, mp_on, vec,
                                            interpret):
    a = _inputs(seed=1)
    gdir = a["g"] * 0.5
    scale = a["scale"] if vec else 0.003
    w32 = a["w"]
    if interpret:
        monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
        ref = jfo.lamb_flat_apply_fn(mp_on, vec)(
            jnp.asarray(a["w"]), jnp.asarray(w32) if mp_on else None,
            jnp.asarray(gdir), jnp.asarray(scale) if vec
            else jnp.float32(scale))
    else:
        ref = jfo._apply_xla_impl(mp_on)(
            jnp.asarray(a["w"]), jnp.asarray(w32) if mp_on else None,
            jnp.asarray(gdir), jnp.asarray(scale))
    w, master = _t(a["w"]), (_t(w32) if mp_on else None)
    out = tfo.lamb_flat_apply_fn(mp_on)(w, master, _t(gdir),
                                        _t(scale) if vec else scale)
    assert out[0] is w
    _close(w, ref[0])
    if mp_on:
        _close(master, ref[1])


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_flat_lamb_half_weights_with_fp32_master(dtype):
    """mp on with half weights: the moments and master in fp32, the
    weight the rounding of the fp32 master (the reference's flat path
    computes the same from the master)."""
    tdt = getattr(torch, dtype)
    a = _inputs(seed=2)
    ref1 = _ref_phase1(a, False, True, True, True)
    mean, var = _t(a["mean"]), _t(a["var"])
    gdir, _, _, norms = tfo.flat_lamb1(
        _t(a["w"], tdt), _t(a["g"]), mean, var, _t(a["w"]), _t(a["wd"]),
        *_scalars(True), False, True, True, SEGMENTS, 3)
    for g, w in zip((gdir, mean, var), ref1[:3]):
        _close(g, w)
    _norms_close(norms, ref1[3])
    w, master = _t(a["w"], tdt), _t(a["w"])
    tfo.flat_lamb2(w, master, gdir, _t(a["scale"]), True)
    want = a["w"] - a["scale"] * _np(gdir)
    assert w.dtype == tdt
    _close(master, want)
    np.testing.assert_array_equal(_np(w), _np(master.to(tdt)))


def test_chunk_table_covers_each_element_once_grouped_by_key():
    segs = ((1, 5, 20000), (0, 0, 5), (2, 20005, 3))
    n = 20010
    starts, lens, first = tfo.lamb_chunk_table(segs, 3, n, torch.device("cpu"))
    starts, lens, first = starts.tolist(), lens.tolist(), first.tolist()
    assert max(lens) <= tfo.LAMB_CHUNK
    seen = np.zeros(n, np.int32)
    for s, ln in zip(starts, lens):
        seen[s:s + ln] += 1
    assert (seen == 1).all()
    assert first == [0, 1, 4, 5]                  # key 1 takes 3 chunks
    assert starts[first[3]:] == [20008]           # the padding, last
    for k, s, ln in segs:
        own = [(starts[c], lens[c]) for c in range(first[k], first[k + 1])]
        assert own[0][0] == s and sum(x for _, x in own) == ln
    with pytest.raises(ValueError, match="overlapping"):
        tfo.lamb_chunk_table(((0, 0, 5), (1, 4, 5)), 2, 10, torch.device("cpu"))


def _ref_op(name, arrays, **kw):
    return getattr(jops, name)(*(jnp.asarray(x) for x in arrays), **kw)


@pytest.mark.parametrize("clip", [-1.0, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("bias_correction", [True, False],
                         ids=["bias", "nobias"])
def test_lamb_per_param_ops_match_reference_ops(clip, bias_correction):
    a = _inputs(seed=4)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, t=2,
              bias_correction=bias_correction, wd=1e-3, rescale_grad=0.25,
              clip_gradient=clip)
    keys = ("w", "g", "mean", "var")
    want = _ref_op("lamb_update_phase1", [a[k] for k in keys], **kw)
    got = registry.get("lamb_update_phase1").fn(*(_t(a[k]) for k in keys),
                                                **kw)
    for g, w in zip(got, want):
        _close(g, w)
    r1 = jnp.linalg.norm(jnp.asarray(a["w"]))
    r2 = jnp.linalg.norm(want[0])
    for lb, ub in ((-1.0, -1.0), (0.5, 2.0), (50.0, -1.0)):
        want2 = jops.lamb_update_phase2(jnp.asarray(a["w"]), want[0], r1, r2,
                                        0.01, lower_bound=lb,
                                        upper_bound=ub)
        got2 = registry.get("lamb_update_phase2").fn(
            _t(a["w"]), got[0], torch.tensor(float(r1)),
            torch.tensor(float(r2)), 0.01, lower_bound=lb, upper_bound=ub)
        _close(got2, want2)


def test_lamb_phase2_trust_ratio_is_one_unless_both_norms_are_positive():
    w = torch.ones(4)
    g = torch.full((4,), 2.0)
    op = registry.get("lamb_update_phase2").fn
    for r1, r2 in ((0.0, 3.0), (3.0, 0.0)):
        out = op(w, g, torch.tensor(r1), torch.tensor(r2), 0.1)
        np.testing.assert_allclose(out.numpy(), 1.0 - 0.1 * 2.0)
    out = op(w, g, torch.tensor(3.0), torch.tensor(6.0), 0.1)
    np.testing.assert_allclose(out.numpy(), 1.0 - 0.1 * 0.5 * 2.0)


def test_lamb_per_param_tpu_impl_interpreted_matches_the_port(monkeypatch):
    """The reference's per-parameter `tpu_impl`s (kernels #9/#10 with a
    scalar wd and scale, Pallas interpret mode) against the port's ops."""
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
    a = _inputs(seed=5)
    kw = dict(t=4, wd=1e-3, rescale_grad=0.5, clip_gradient=0.8)
    keys = ("w", "g", "mean", "var")
    want = jfo._lamb_phase1_tpu(*(jnp.asarray(a[k]) for k in keys), **kw)
    got = registry.get("lamb_update_phase1").fn(*(_t(a[k]) for k in keys),
                                                **kw)
    for g, w in zip(got, want):
        _close(g, w)
    r1, r2 = jnp.linalg.norm(jnp.asarray(a["w"])), jnp.linalg.norm(want[0])
    want2 = jfo._lamb_phase2_tpu(jnp.asarray(a["w"]), want[0], r1, r2, 0.02)
    got2 = registry.get("lamb_update_phase2").fn(
        _t(a["w"]), got[0], torch.tensor(float(r1)), torch.tensor(float(r2)),
        0.02)
    _close(got2, want2)


def _updater_run(pkg, opt_kw, steps, ctx, seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(6, 5), (5,), (7,)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(steps)]
    opt = pkg.optimizer.create("lamb", param_idx2name={
        0: "fc_weight", 1: "fc_bias", 2: "ln_gamma"}, **opt_kw)
    opt.set_lr_mult({0: 0.5})
    opt.set_wd_mult({2: 2.0})
    upd = pkg.optimizer.get_updater(opt)
    w_nd = [pkg.nd.array(w, ctx=ctx) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            upd(i, pkg.nd.array(g, ctx=ctx), w_nd[i])
    return [w.asnumpy() for w in w_nd]


LAMB_UPDATERS = [
    {"learning_rate": 0.01, "wd": 1e-3},
    {"learning_rate": 0.02, "wd": 1e-2, "clip_gradient": 0.5,
     "rescale_grad": 0.5, "lower_bound": 0.5, "upper_bound": 3.0},
    {"learning_rate": 0.01, "beta1": 0.8, "beta2": 0.99,
     "bias_correction": False},
]


@pytest.mark.parametrize("kw", LAMB_UPDATERS, ids=["plain", "clip_bounds",
                                                   "no_bias_correction"])
def test_lamb_updater_matches_reference(kw):
    """Several steps through the Updater with lr_mult, wd_mult (and the
    default wd_mult 0 of non-weights), clip, rescale, bounds and an
    lr_scheduler."""
    sched = dict(step=2, factor=0.5, base_lr=kw["learning_rate"])
    got = _updater_run(mx, dict(kw, lr_scheduler=mx.lr_scheduler
                                .FactorScheduler(**sched)), 5, mx.cpu())
    want = _updater_run(jmx, dict(kw, lr_scheduler=jmx.lr_scheduler
                                  .FactorScheduler(**sched)), 5, jmx.cpu())
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_lamb_bf16_updater_vs_reference():
    """A bf16 weight: the port computes in fp32 and rounds once (the
    reference's per-parameter ops compute in bf16, ROADMAP Queue C), so
    the two agree within BF16_REL over three steps."""
    rng = np.random.RandomState(7)
    w = rng.randn(64).astype(np.float32)
    gs = [rng.randn(64).astype(np.float32) for _ in range(3)]
    outs = []
    for pkg, ctx in ((mx, mx.cpu()), (jmx, jmx.cpu())):
        opt = pkg.optimizer.create("lamb", learning_rate=0.01, wd=1e-3)
        upd = pkg.optimizer.get_updater(opt)
        w_nd = pkg.nd.array(w, ctx=ctx, dtype="bfloat16")
        for g in gs:
            upd(0, pkg.nd.array(g, ctx=ctx, dtype="bfloat16"), w_nd)
        assert str(w_nd.dtype) == "bfloat16"
        outs.append(np.asarray(w_nd.asnumpy(), np.float32))
    _close(outs[0], outs[1], BF16_REL)


def test_lamb_states_round_trip():
    opt = mx.optimizer.LAMB(learning_rate=0.01)
    upd = mx.optimizer.get_updater(opt)
    w = mx.nd.array(np.ones(4), ctx=mx.cpu())
    upd(0, mx.nd.array(np.full(4, 0.5), ctx=mx.cpu()), w)
    back = mx.optimizer.get_updater(mx.optimizer.SGD())
    back.set_states(upd.get_states(dump_optimizer=True))
    assert isinstance(back.optimizer, mx.optimizer.LAMB)
    assert back.optimizer._index_update_count == {0: 1}
    for a, b in zip(upd.states[0], back.states[0]):
        assert torch.equal(a.data_torch, b.data_torch)


def test_cpu_lamb_launches_nothing():
    before = launch_counts()
    a = _inputs(n=16)
    tfo.flat_lamb1(_t(a["w"]), _t(a["g"]), _t(a["mean"]), _t(a["var"]),
                   None, 0.01, *_scalars(True), False, False, True)
    tfo.flat_lamb2(_t(a["w"]), None, _t(a["g"]), 0.1, False)
    assert launch_counts() == before


def test_lamb_kernels_reject_a_device_without_one():
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfo.flat_lamb1(t, t, t, t, None, 0.0, *_scalars(True), False,
                       False, True)
    with pytest.raises(ValueError, match="no kernel"):
        tfo.flat_lamb2(t, None, t, 0.1, False)


@pytest.mark.cuda
def test_lamb_kernels_bit_equal_to_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        a = {k: _t(v, dtype if k in ("w", "g", "mean", "var")
                   else torch.float32).cuda()
             for k, v in _inputs(n=4097).items()}
        segs = ((0, 0, 3), (1, 3, 4000))
        args = (a["wd"], *_scalars(True), True, False, True, segs, 2)
        km, kv = a["mean"].clone(), a["var"].clone()
        kd, _, _, kn = tfo.flat_lamb1(a["w"], a["g"], km, kv, None, *args)
        pd, pm, pv, pn = tfo._ref_flat_lamb1(a["w"], a["g"], a["mean"],
                                             a["var"], None, *args)
        for got, ref in ((kd, pd), (km, pm), (kv, pv)):
            assert torch.equal(got, ref)
        torch.testing.assert_close(kn, pn, rtol=NORM_REL, atol=0)
        kw = a["w"].clone()
        tfo.flat_lamb2(kw, None, kd, a["scale"], False)
        assert torch.equal(kw, tfo._ref_flat_lamb2(a["w"], None, pd,
                                                   a["scale"], False)[0])
