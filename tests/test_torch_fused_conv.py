"""The port's fused conv3x3 + folded-BN + ReLU against the JAX package's.

On the CPU the port runs the kernel's plain version (`_ref_conv_bn_relu`);
the JAX side runs its Pallas kernel (`_pallas_conv_bn_relu`) through the
interpreter (MXNET_FLASH_INTERPRET=1), as tests/test_fused_conv.py does,
and its XLA path (`_xla_conv_bn_relu`), which also takes channel counts
that are not multiples of 8. Inputs come from numpy with a seed and go to
both. Tolerances: fp32 1e-5 abs (summation order only); bf16 within one
bf16 ulp of the reference's output, or 2e-2 (the fp32 results round to
bf16 on either side of a rounding boundary). The CUDA kernel itself runs
only on a card (`cuda` marker).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu  # noqa: F401 — package import order
from mxnet_tpu.ops import fused_conv as jfc
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ops import launch_counts
from mxnet_tpu_torch.ops import fused_conv as tfc
from mxnet_tpu_torch.ops import registry

FP32_ATOL = 1e-5
BF16_ATOL = 2e-2

CASES = [
    # N, H, W, C, Cout
    (2, 8, 8, 16, 16),
    (2, 5, 7, 8, 16),
    (2, 6, 6, 16, 8),
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
    mean = (rng.randn(Cout) * 0.1).astype(np.float32)
    var = (rng.rand(Cout) + 0.5).astype(np.float32)
    res = rng.randn(N, H, W, Cout).astype(np.float32)
    return x, w, gamma, beta, mean, var, res


def _bf16_ulp(a):
    """One bf16 ulp at each value of a (float32 array of bf16 values)."""
    a = np.abs(a).astype(np.float32)
    exp = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7)


def _run_both(case, dtype, residual, ref_fn):
    x, w, g, b, m, v, res = _inputs(*case)
    scale, shift = jfc.fold_bn_params(jnp.asarray(g), jnp.asarray(b),
                                      jnp.asarray(m), jnp.asarray(v))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = ref_fn(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                  scale, shift,
                  jnp.asarray(res).astype(jdt) if residual else None)
    got = tfc.conv_bn_relu(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
        torch.from_numpy(np.array(scale)), torch.from_numpy(np.array(shift)),
        torch.from_numpy(res).to(tdt) if residual else None)
    assert got.dtype == tdt and got.shape == want.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    else:
        err = np.abs(got - want)
        assert np.all((err <= _bf16_ulp(want)) | (err <= BF16_ATOL)), \
            err.max()


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "res"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_pallas_kernel(case, dtype, residual):
    got, want = _run_both(case, dtype, residual, jfc._pallas_conv_bn_relu)
    _assert_close(got, want, dtype)
    assert got.min() == 0.0 and got.max() > 0.0      # ReLU clamps


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "res"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + ODD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_xla_path(case, dtype, residual):
    got, want = _run_both(case, dtype, residual, jfc._xla_conv_bn_relu)
    _assert_close(got, want, dtype)


def test_fold_bn_params_matches_reference():
    _, _, g, b, m, v, _ = _inputs(1, 1, 1, 1, 24, seed=3)
    for eps in (1e-3, 1e-5):
        js, jb = jfc.fold_bn_params(jnp.asarray(g), jnp.asarray(b),
                                    jnp.asarray(m), jnp.asarray(v), eps=eps)
        ts, tb = tfc.fold_bn_params(*(torch.from_numpy(a)
                                      for a in (g, b, m, v)), eps=eps)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-7)


def test_op_through_nd_contrib_matches_reference():
    from mxnet_tpu_torch import cpu
    x, w, g, b, m, v, res = _inputs(2, 6, 6, 8, 16, seed=5)
    scale, shift = jfc.fold_bn_params(g, b, m, v)
    want = jfc._xla_conv_bn_relu(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(scale), jnp.asarray(shift),
                                 jnp.asarray(res))
    out = nd.contrib.conv_bn_relu(*(nd.array(a, ctx=cpu()) for a in
                                    (x, w, scale, shift, res)))
    np.testing.assert_allclose(out.asnumpy(), np.asarray(want),
                               atol=FP32_ATOL)


def test_registry_takes_the_kernel_on_a_gpu_context(monkeypatch):
    # no environment variable switches the kernel off
    monkeypatch.setenv("MXNET_TPU_USE_PALLAS", "0")
    op = registry.get("_contrib_conv_bn_relu")
    assert op.best_fn(True) is tfc._conv_bn_relu_cuda
    assert op.best_fn(False) is tfc._conv_bn_relu


def test_no_route_for_a_device_without_a_kernel():
    x = torch.zeros(1, 4, 4, 8, device="meta")
    w = torch.zeros(3, 3, 8, 8, device="meta")
    s = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfc.conv_bn_relu(x, w, s, s)


@pytest.mark.parametrize("bad", ["dtype", "weight", "residual", "scale",
                                 "layout"])
def test_inputs_the_kernel_cannot_take_raise(bad):
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8, 16)
    s = torch.zeros(16)
    res = None
    if bad == "dtype":
        x, w = x.half(), w.half()
    elif bad == "weight":
        w = torch.zeros(1, 1, 8, 16)
    elif bad == "residual":
        res = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    elif bad == "scale":
        s = torch.zeros(16, dtype=torch.bfloat16)
    else:
        x = torch.zeros(1, 8, 4, 4).permute(0, 2, 3, 1)
    with pytest.raises(ValueError):
        tfc._check(x, w, s, s, res)


# ResNet-50's bottleneck 3x3 convs: (H, W, C, Cout), and the tile the
# wgmma variant takes at batch 1, 64 and 256 on a 132-SM card: BN 64 where
# Cout is 64, else 128; BM 64 where 128-row tiles give under 132 blocks
STAGES = [(56, 56, 64, 64), (28, 28, 128, 128), (14, 14, 256, 256),
          (7, 7, 512, 512)]
STAGE_TILES = {
    1: [(64, 64), (64, 128), (64, 128), (64, 128)],
    64: [(128, 64), (128, 128), (128, 128), (64, 128)],
    256: [(128, 64), (128, 128), (128, 128), (128, 128)],
}


@pytest.mark.parametrize("batch", sorted(STAGE_TILES))
def test_stage_shapes_take_the_wgmma_variant(batch):
    for (H, W, C, Cout), (bm, bn) in zip(STAGES, STAGE_TILES[batch]):
        tile = tfc.conv_tile(batch, H, W, C, Cout, torch.bfloat16)
        assert tile == ("wgmma", bm, bn), (batch, H, tile)
        assert tile.label == "wgmma_%dx%d" % (bm, bn)


@pytest.mark.parametrize("case", [(2, 5, 5, 3, 12), (3, 9, 11, 20, 36),
                                  (2, 8, 8, 64, 96), (2, 8, 8, 96, 64),
                                  (2, 8, 8, 16, 16)],
                         ids=lambda c: "x".join(map(str, c)))
def test_other_bf16_shapes_take_the_general_kernel(case):
    assert tfc.conv_tile(*case, torch.bfloat16) == ("mma", 64, 64)


@pytest.mark.parametrize("shape", STAGES)
def test_fp32_takes_the_fma_kernel(shape):
    assert tfc.conv_tile(64, *shape, torch.float32) == ("fma", 64, 64)


def test_tile_rows_follow_the_wave():
    # 3 x 7 x 7 x 512: 2 tiles of 128 rows x 4 = 8 blocks, under one wave
    assert tfc.conv_tile(3, 7, 7, 512, 512, torch.bfloat16).bm == 64
    # the same grid on a card of 8 SMs fills a wave at 128 rows
    assert tfc.conv_tile(3, 7, 7, 512, 512, torch.bfloat16, sms=8).bm == 128
    # 37 x 28 x 28: 227 tiles of 128 rows (the last ragged), over a wave
    assert tfc.conv_tile(37, 28, 28, 128, 128, torch.bfloat16) == (
        "wgmma", 128, 128)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    # small-batch stage shapes and ragged edges reach the wgmma variant
    # at every tile it has
    wgmma = [(1,) + st for st in STAGES] + [(2,) + STAGES[3],
                                            (3, 7, 7, 512, 512),
                                            (2, 14, 14, 256, 256),
                                            (7, 56, 56, 64, 64),
                                            (37, 28, 28, 128, 128)]
    tiles = set()
    for case in CASES + ODD_CASES + [(1, 1, 1, 16, 16),
                                     (4, 7, 7, 64, 64)] + wgmma:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, g, b, m, v, res = (torch.from_numpy(a).cuda() for a in
                                     _inputs(*case))
            scale, shift = tfc.fold_bn_params(g, b, m, v)
            tile = tfc.conv_tile(*case, dtype)
            assert (tile.variant == "wgmma") == (
                dtype == torch.bfloat16 and case[3] % 64 == 0
                and case[4] % 64 == 0)
            tiles.add(tile)
            for r in (None, res.to(dtype)):
                before = launch_counts()["conv_bn_relu"]
                got = tfc.conv_bn_relu(x.to(dtype), w.to(dtype), scale,
                                       shift, r)
                want = tfc._ref_conv_bn_relu(x.to(dtype), w.to(dtype),
                                             scale, shift, r)
                torch.cuda.synchronize()
                assert launch_counts()["conv_bn_relu"] == before + 1
                err = (got.float() - want.float()).abs()
                if dtype == torch.float32:
                    assert err.max().item() <= 1e-4
                else:
                    assert bool((err <= 2e-2 + 2e-2 * want.float().abs())
                                .all())
    assert {("wgmma", 64, 64), ("wgmma", 64, 128), ("wgmma", 128, 64),
            ("wgmma", 128, 128)} <= tiles
    with pytest.raises(ValueError):
        tfc.conv_bn_relu(x.half(), w.half(), scale, shift)
