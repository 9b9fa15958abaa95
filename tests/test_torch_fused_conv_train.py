"""The port's training form of the fused conv3x3 + BN + ReLU against the
JAX package's.

On the CPU the port runs the kernels' plain versions: `_ref_conv_bn_stats`
(kernel #5: the conv output and its per-channel sum and sum of squares)
and `_ref_cbr_train_bwd` (kernel #6: dconv, dgamma, dbeta, dres), inside
the op's autograd Function. The JAX side runs its Pallas kernels
(`_pallas_conv_stats`, `_pallas_cbr_bwd`) through the interpreter
(MXNET_FLASH_INTERPRET=1), as tests/test_fused_conv.py does, and its XLA
paths (`_xla_conv_stats`, `_xla_cbr_bwd`), which also take channel counts
that are not multiples of 8. Inputs come from numpy with a seed and go to
both sides. Tolerances, as max |a - b| over max |b|: fp32 1e-5 (the
summation order only), bf16 2e-2 (both sides round the conv output and
the gradients to bf16, on either side of a rounding boundary). The CUDA
kernels run only on a card (`cuda` marker); the plan that picks #6's
variant is pure Python and is tested here, with a stubbed launch for the
count of each variant.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import fused_conv as jfc
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import fused_conv as tfc
from mxnet_tpu_torch.ops import (launch_counts, registry,
                                 reset_launch_counts, variant_counts)

FP32_REL = 1e-5
BF16_REL = 2e-2
EPS = 1e-3

CASES = [
    # N, H, W, C, Cout
    (2, 6, 6, 8, 16),
    (2, 5, 7, 16, 8),
]
ODD_CASES = [(2, 5, 5, 3, 12), (2, 7, 6, 20, 36)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")


def _inputs(N, H, W, C, Cout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) / np.sqrt(9 * C)).astype(np.float32)
    gamma = (rng.rand(Cout) + 0.5).astype(np.float32)
    beta = (rng.randn(Cout) * 0.1).astype(np.float32)
    res = rng.randn(N, H, W, Cout).astype(np.float32)
    dy = rng.randn(N, H, W, Cout).astype(np.float32)
    return x, w, gamma, beta, res, dy


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = FP32_REL if dtype == "float32" else BF16_REL
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, tol)


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_conv_stats_matches_reference(case, dtype, route):
    x, w, *_ = _inputs(*case)
    ref = getattr(jfc, "_%s_conv_stats" % route)(_j(x, dtype), _j(w, dtype))
    got = tfc._ref_conv_bn_stats(_t(x, dtype), _t(w, dtype))
    assert got[0].dtype == getattr(torch, dtype)
    for a, b in zip(got, ref):
        _close(a, b, dtype)


@pytest.mark.parametrize("case", ODD_CASES)
def test_conv_stats_odd_channels_match_xla(case):
    x, w, *_ = _inputs(*case)
    ref = jfc._xla_conv_stats(_j(x, "float32"), _j(w, "float32"))
    got = tfc._ref_conv_bn_stats(_t(x, "float32"), _t(w, "float32"))
    for a, b in zip(got, ref):
        _close(a, b, "float32")


def _ref_forward(x, w, gamma, beta, res, dtype):
    args = [_j(x, dtype), _j(w, dtype), _j(gamma, "float32"),
            _j(beta, "float32")]
    if res is not None:
        args.append(_j(res, dtype))
    return jfc._conv_bn_relu_train(*args, eps=EPS)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + ODD_CASES)
def test_train_op_forward_matches_reference(case, dtype, residual):
    """(out, batch mean, batch var) of the op through mx.nd, against the
    reference op (its Pallas kernel where the shape takes it, else XLA)."""
    x, w, gamma, beta, res, _ = _inputs(*case)
    res = res if residual else None
    want = _ref_forward(x, w, gamma, beta, res, dtype)
    ctx = mx.cpu()
    args = [mx.nd.array(_t(x, dtype), ctx=ctx),
            mx.nd.array(_t(w, dtype), ctx=ctx), mx.nd.array(gamma, ctx=ctx),
            mx.nd.array(beta, ctx=ctx)]
    if res is not None:
        args.append(mx.nd.array(_t(res, dtype), ctx=ctx))
    got = mx.nd.contrib.conv_bn_relu_train(*args, eps=EPS)
    assert got[0].dtype == (dtype if dtype == "bfloat16" else np.float32)
    for a, b in zip(got, want):
        _close(a.data_torch, b, dtype)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + ODD_CASES[:1])
def test_train_op_gradients_match_jax_vjp(case, dtype, residual):
    """dx, dw, dgamma, dbeta (and dres) through torch.autograd against
    jax.vjp of the reference op, for the cotangent dy on out (the mean/var
    outputs carry no gradient on either side)."""
    x, w, gamma, beta, res, dy = _inputs(*case)
    has_res = residual
    jargs = [_j(x, dtype), _j(w, dtype), _j(gamma, "float32"),
             _j(beta, "float32")] + ([_j(res, dtype)] if has_res else [])

    def f(*a):
        return jfc._cbr_train(EPS, has_res, *a[:4],
                              a[4] if has_res else None)[0]

    _, vjp = jax.vjp(f, *jargs)
    want = vjp(_j(dy, dtype))
    targs = [_t(x, dtype), _t(w, dtype), _t(gamma, "float32"),
             _t(beta, "float32")] + ([_t(res, dtype)] if has_res else [])
    for t in targs:
        t.requires_grad_(True)
    out, mean, var = tfc._conv_bn_relu_train(*targs, eps=EPS)
    assert not mean.requires_grad and not var.requires_grad
    got = torch.autograd.grad(out, targs, _t(dy, dtype))
    for a, b, t in zip(got, want, targs):
        assert a.dtype == t.dtype
        _close(a, b, dtype)


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_reference(case, dtype, residual, route):
    """The plain cbr_train_bwd against the reference's Pallas kernel
    (interpreted) and its XLA epilogue, from the same saved tensors."""
    x, w, gamma, beta, res, dy = _inputs(*case)
    conv, s, sq = jfc._xla_conv_stats(_j(x, dtype), _j(w, dtype))
    M = case[0] * case[1] * case[2]
    mean = s / M
    var = jnp.maximum(sq / M - mean * mean, 0.0)
    invstd = jax.lax.rsqrt(var + EPS)
    jres = _j(res, dtype) if residual else None
    want = getattr(jfc, "_%s_cbr_bwd" % route)(
        conv, _j(dy, dtype), mean, invstd, _j(gamma, "float32"),
        _j(beta, "float32"), jres)
    got = tfc._ref_cbr_train_bwd(
        torch.from_numpy(_np(conv)).to(getattr(torch, dtype)),
        _t(dy, dtype), torch.from_numpy(_np(mean)),
        torch.from_numpy(_np(invstd)), _t(gamma, "float32"),
        _t(beta, "float32"), _t(res, dtype) if residual else None)
    assert got[0].dtype == torch.float32
    for a, b in zip(got[:3], want[:3]):
        # dconv, dgamma, dbeta are fp32 on both sides, from the same inputs
        _close(a, b, "float32")
    if residual:
        assert got[3].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np(got[3]), _np(want[3]))
    else:
        assert got[3] is None and want[3] is None


def test_train_op_is_registered_differentiable():
    op = registry.get("_contrib_conv_bn_relu_train")
    assert op.differentiable and op.num_outputs == 3
    assert hasattr(mx.nd.contrib, "conv_bn_relu_train")


def test_wrappers_refuse_a_device_without_a_kernel():
    x = torch.zeros(1, 3, 3, 8, device="meta")
    w = torch.zeros(3, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfc.conv_bn_stats(x, w)
    with pytest.raises(ValueError, match="no kernel"):
        tfc.cbr_train_bwd(x, x, *(torch.zeros(8, device="meta"),) * 4)


def test_cpu_tensors_launch_nothing():
    x, w, gamma, beta, res, dy = _inputs(*CASES[0])
    before = launch_counts()
    tfc.conv_bn_stats(_t(x, "float32"), _t(w, "float32"))
    assert launch_counts() == before


@pytest.mark.parametrize("M, Cout, tile, rows", [
    (256 * 56 * 56, 64, ("wgmma", 128, 64), 6272),
    (64 * 7 * 7, 512, ("wgmma", 64, 128), 49),
    (3 * 7 * 7, 512, ("wgmma", 64, 128), 3),
    (37 * 28 * 28, 128, ("wgmma", 128, 128), 227),
    (3 * 9 * 11, 36, ("mma", 64, 64), 5),
    (2 * 6 * 6, 16, ("fma", 64, 64), 2),
])
def test_stats_scratch_follows_the_tile(M, Cout, tile, rows):
    assert tfc.stats_scratch_shape(M, Cout, tfc.ConvTile(*tile)) == (
        rows, 2, Cout)


def test_stats_scratch_of_the_stage_shapes():
    # the tile the wrapper launches sets the scratch's rows: one pair of
    # partial sums per tile of bm rows
    for N, H, W, C, Cout in [(256, 56, 56, 64, 64), (64, 7, 7, 512, 512),
                             (1, 28, 28, 128, 128)]:
        tile = tfc.conv_tile(N, H, W, C, Cout, torch.bfloat16)
        M = N * H * W
        assert tfc.stats_scratch_shape(M, Cout, tile)[0] * tile.bm >= M
        assert (tfc.stats_scratch_shape(M, Cout, tile)[0] - 1) * tile.bm < M


@pytest.mark.parametrize("Cout,aligned,variant", [
    (64, True, "persistent"), (512, True, "persistent"),
    (4096, True, "persistent"), (8, True, "persistent"),
    (8192, True, "split_v8"), (12, True, "split_v1"), (36, True, "split_v1"),
    (64, False, "split_v1")])
def test_cbr_bwd_plan(Cout, aligned, variant):
    assert tfc.cbr_bwd_plan(Cout, aligned) == variant


@pytest.mark.parametrize("variant,Cout,grid,rows", [
    # split: chunks of 8 rows a thread over min(Cout / vec, 256) groups
    ("split_v8", 64, 256, 4), ("split_v8", 512, 32, 32),
    ("split_v8", 8192, 8, 125), ("split_v1", 12, 168, 6),
    ("split_v1", 36, 56, 18)])
def test_split_scratch_follows_the_chunk(variant, Cout, grid, rows):
    assert tfc._bwd_grid(variant, 1000, Cout, "cpu") == (grid, rows)


@pytest.mark.parametrize("case,residual", [((2, 6, 6, 8, 16), False),
                                           ((2, 5, 7, 16, 12), True)])
def test_cbr_bwd_counts_the_variant_it_launches(monkeypatch, case,
                                                residual):
    """The wrapper's variant reaches variant_counts, with the launch
    stubbed (no card here): one count per call, under the planned
    variant, and the grid and scratch the variant needs."""
    args = []
    monkeypatch.setattr(tfc, "_launch_bwd_entry",
                        lambda dev, args_of: args.append(args_of))
    monkeypatch.setattr(tfc, "_bwd_grid", lambda variant, M, Cout, dev: (
        132, 132) if variant == "persistent" else (8, -(-M // 8)))
    N, H, W, C, Cout = case
    x = torch.zeros(N, H, W, Cout)
    vec = torch.ones(Cout)
    reset_launch_counts()
    outs = tfc._launch_cbr_bwd(tfc.cbr_bwd_plan(Cout), x, x, vec, vec, vec,
                               vec, x if residual else None)
    assert len(args) == 1
    assert outs[0].shape == x.shape and outs[0].dtype == torch.float32
    assert (outs[3] is not None) == residual
    assert variant_counts() == {("cbr_train_bwd", tfc.cbr_bwd_plan(Cout)): 1}


@pytest.mark.cuda
def test_cbr_train_bwd_variants_on_the_card():
    """Each variant of #6 on the card (the planned one, and the split ones
    where Cout allows them) within FP32_REL of the plain version, dres
    equal, two launches bit-equal: ResNet-50's four stage shapes at batch
    32, the edge shapes of chip_smoke.py's CBR_EDGES, a residual, bf16 and
    fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shapes = [(32, 56, 56, 64), (32, 28, 28, 128), (32, 14, 14, 256),
              (32, 7, 7, 512), (2, 5, 5, 12), (4, 1, 1, 64), (1, 7, 7, 64),
              (3, 9, 11, 36), (3, 7, 7, 512), (2, 14, 14, 256),
              (1, 56, 56, 64), (37, 28, 28, 128), (7, 56, 56, 64)]
    for N, H, W, Cout in shapes:
        rng = np.random.RandomState(N + Cout)
        for dtype in ("bfloat16", "float32"):
            conv = _t(rng.randn(N, H, W, Cout), dtype).cuda()
            dy = _t(rng.randn(N, H, W, Cout), dtype).cuda()
            vecs = [_t(a, "float32").cuda() for a in (
                rng.randn(Cout) * 0.1, rng.rand(Cout) + 0.5,
                rng.rand(Cout) + 0.5, rng.randn(Cout) * 0.1)]
            for res in (None, _t(rng.randn(N, H, W, Cout), dtype).cuda()):
                want = tfc._ref_cbr_train_bwd(conv, dy, *vecs, res)
                variants = {tfc.cbr_bwd_plan(Cout), "split_v1"} | (
                    {"split_v8"} if Cout % 8 == 0 else set())
                for variant in sorted(variants):
                    reset_launch_counts()
                    got = tfc._launch_cbr_bwd(variant, conv, dy, *vecs, res)
                    again = tfc._launch_cbr_bwd(variant, conv, dy, *vecs,
                                                res)
                    torch.cuda.synchronize()
                    assert variant_counts() == {("cbr_train_bwd", variant): 2}
                    for a, b in zip(got[:3], want[:3]):
                        _close(a.cpu(), b.cpu(), "float32")
                    assert all(torch.equal(a, b) for a, b in zip(got, again)
                               if a is not None)
                    if res is not None:
                        assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("residual", [False, True])
def test_global_backward_splits_the_sums_across_ranks(world, residual):
    """`cbr_train_bwd_global`'s plain version: with `world` equal shards
    of one batch, each adding its rows' sums through `reduce` (here the
    sum over the shards, as the all-reduce gives it), every shard's dconv
    equals the whole batch's rows of `_ref_cbr_train_bwd` and the shards'
    dgamma and dbeta add up to the whole batch's, within FP32_REL."""
    N, H, W, C, Cout = 4, 5, 6, 8, 16
    x, w, gamma, beta, res, dy = _inputs(N, H, W, C, Cout, seed=3)
    conv = torch.from_numpy(np.random.RandomState(4).randn(
        N, H, W, Cout).astype(np.float32))
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    r = torch.from_numpy(res) if residual else None
    d = torch.from_numpy(dy)
    mean = conv.mean(dim=(0, 1, 2))
    invstd = torch.rsqrt(conv.var(dim=(0, 1, 2), unbiased=False) + EPS)
    want = tfc._ref_cbr_train_bwd(conv, d, mean, invstd, g, b, r)
    per = N // world
    parts = [(conv[i * per:(i + 1) * per], d[i * per:(i + 1) * per],
              None if r is None else r[i * per:(i + 1) * per])
             for i in range(world)]
    sums = []
    for c, dd, rr in parts:
        sums.append(tfc.cbr_train_bwd_global(
            c, dd, mean, invstd, g, b, rr, lambda t: t, 1)[1:3])
    total = torch.stack([sums[0][1] * 0, sums[0][0] * 0])
    for dgamma, dbeta in sums:
        total = total + torch.stack([dbeta, dgamma])
    outs = [tfc.cbr_train_bwd_global(c, dd, mean, invstd, g, b, rr,
                                     lambda t: total, N * H * W)
            for c, dd, rr in parts]
    _close(torch.cat([o[0] for o in outs]), want[0], "float32")
    _close(sum(o[1] for o in outs), want[1], "float32")
    _close(sum(o[2] for o in outs), want[2], "float32")
    if residual:
        assert torch.equal(torch.cat([o[3] for o in outs]), want[3])


@pytest.mark.cuda
def test_global_backward_on_the_card_is_the_split_variant():
    """`cbr_train_bwd_global` on the card: the split variant in two calls,
    with an identity sum bit-equal to the variant's one call, one count
    labelled ``+global``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for N, H, W, Cout in [(8, 28, 28, 64), (2, 5, 5, 12), (4, 14, 14, 256)]:
        rng = np.random.RandomState(N + Cout)
        for dtype in ("bfloat16", "float32"):
            conv = _t(rng.randn(N, H, W, Cout), dtype).cuda()
            dy = _t(rng.randn(N, H, W, Cout), dtype).cuda()
            vecs = [_t(a, "float32").cuda() for a in (
                rng.randn(Cout) * 0.1, rng.rand(Cout) + 0.5,
                rng.rand(Cout) + 0.5, rng.randn(Cout) * 0.1)]
            split = "split_v8" if Cout % 8 == 0 else "split_v1"
            for res in (None, _t(rng.randn(N, H, W, Cout), dtype).cuda()):
                one = tfc._launch_cbr_bwd(split, conv, dy, *vecs, res)
                reset_launch_counts()
                got = tfc.cbr_train_bwd_global(conv, dy, *vecs, res,
                                               torch.clone, N * H * W)
                torch.cuda.synchronize()
                assert variant_counts() == {("cbr_train_bwd",
                                             split + "+global"): 1}
                assert all(torch.equal(a, b) for a, b in zip(got, one)
                           if a is not None)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # small-batch stage shapes and ragged edges reach the wgmma variant
    wgmma = [(1, 56, 56, 64, 64), (1, 28, 28, 128, 128),
             (1, 14, 14, 256, 256), (2, 7, 7, 512, 512),
             (3, 7, 7, 512, 512), (7, 56, 56, 64, 64),
             (37, 28, 28, 128, 128)]
    for case in CASES + ODD_CASES + wgmma:
        x, w, gamma, beta, res, dy = _inputs(*case)
        for dtype in ("float32", "bfloat16"):
            xt, wt = _t(x, dtype).cuda(), _t(w, dtype).cuda()
            got = tfc.conv_bn_stats(xt, wt)
            want = tfc._ref_conv_bn_stats(xt, wt)
            again = tfc.conv_bn_stats(xt, wt)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            a, b = got[0].float().cpu(), want[0].float().cpu()
            if dtype == "bfloat16":
                # one bf16 ulp of the larger value, plus the fp32 sum's
                # order share (it decides the rounding near zero)
                ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
                    a.abs(), b.abs()).clamp_min(1e-30))) - 7)
                assert bool(((a - b).abs() <= ulp + FP32_REL
                             * b.abs().max()).all())
            else:
                _close(a, b, "float32")
            for a, b in zip(got[1:], want[1:]):
                _close(a.cpu(), b.cpu(), "float32")
            M = case[0] * case[1] * case[2]
            mean = want[1] / M
            invstd = torch.rsqrt(torch.clamp_min(
                want[2] / M - mean * mean, 0.0) + EPS)
            args = (want[0], _t(dy, dtype).cuda(), mean, invstd,
                    _t(gamma, "float32").cuda(), _t(beta, "float32").cuda(),
                    _t(res, dtype).cuda())
            reset_launch_counts()
            kb, pb = tfc.cbr_train_bwd(*args), tfc._ref_cbr_train_bwd(*args)
            again = tfc.cbr_train_bwd(*args)
            assert variant_counts() == {
                ("cbr_train_bwd", tfc.cbr_bwd_plan(case[4])): 2}
            for a, b in zip(kb[:3], pb[:3]):
                _close(a.cpu(), b.cpu(), "float32")
            assert torch.equal(kb[3], pb[3])
            assert all(torch.equal(a, b) for a, b in zip(kb, again))

