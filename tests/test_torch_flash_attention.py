"""The port's flash attention against the JAX package's.

On the CPU the port's `flash_attention` runs its plain versions
(`_ref_forward`, and `_ref_backward_inner` for the gradient); the JAX side
runs the real Pallas kernels (`_fwd_kernel`, `_dq_kernel`, `_dkv_kernel`)
through the interpreter (MXNET_FLASH_INTERPRET=1), as
tests/test_flash_attention.py does. Inputs come from numpy with a seed and
go to both. fp32 throughout: the tolerances (2e-5 forward, 1e-4 gradients)
cover summation order only. The kernels themselves run only on a CUDA card
(`cuda` marker).
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu  # noqa: F401 — package import order
from mxnet_tpu_torch.ops import launch_counts, variant_counts
from mxnet_tpu_torch.parallel import (paged_attention,
                                      paged_attention_chunk)
from mxnet_tpu_torch.parallel import flash_attention as tflash
from mxnet_tpu_torch.parallel.flash_attention import (FlashBwdPlan,
                                                      FlashFwdPlan,
                                                      _backward_inner,
                                                      _check,
                                                      _check_backward,
                                                      _delta,
                                                      _flash_backward,
                                                      _flash_forward,
                                                      _launch_dkv,
                                                      _launch_dq,
                                                      _ref_backward,
                                                      _ref_forward,
                                                      flash_bwd_plan,
                                                      flash_fwd_plan)

jfa = sys.modules["mxnet_tpu.parallel.flash_attention"]

ATOL = 2e-5
GRAD_ATOL = 1e-4

CASES = [
    # B, H, Hkv, Sq, Sk, D, causal
    (1, 2, 2, 128, 128, 64, False),
    (1, 2, 2, 128, 128, 64, True),
    (1, 4, 2, 128, 128, 64, True),      # GQA
    (1, 2, 2, 160, 160, 64, True),      # not a tile multiple
    (1, 2, 2, 96, 224, 64, True),       # Sq != Sk, causal offset
    (2, 2, 1, 77, 301, 128, False),     # MQA, ragged, head_dim 128
]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")


def _qkv(B, H, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, Hkv, Sk, D).astype(np.float32),
            rng.randn(B, Hkv, Sk, D).astype(np.float32))


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", CASES)
def test_flash_attention_matches_pallas_kernel(B, H, Hkv, Sq, Sk, D, causal):
    q, k, v = _qkv(B, H, Hkv, Sq, Sk, D)
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))
    before = launch_counts()["flash_fwd"]
    out = tflash(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), causal=causal)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert launch_counts()["flash_fwd"] == before
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", CASES)
def test_lse_matches_pallas_forward(B, H, Hkv, Sq, Sk, D, causal):
    q, k, v = _qkv(B, H, Hkv, Sq, Sk, D, seed=1)
    sc = D ** -0.5
    o_j, lse_j = jfa._pallas_forward(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, sc)
    o_t, lse_t = _flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal, sc)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (B, H, Sq)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL,
                               rtol=0)


def _pool_case(seed, B=3, H=4, Hkv=2, C=5, D=16, N=10, bs=4, nb=4):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, C, D).astype(np.float32)
    kp = rng.randn(N, Hkv, bs, D).astype(np.float32)
    vp = rng.randn(N, Hkv, bs, D).astype(np.float32)
    tables = rng.randint(0, N, size=(B, nb)).astype(np.int32)
    tables[0, -1] = N                   # an unallocated tail entry
    return q, kp, vp, tables


def test_paged_attention_matches_jax():
    q, kp, vp, tables = _pool_case(2, C=1)
    lengths = np.array([1, 9, 13], np.int32)
    ref = jfa.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(tables),
                              jnp.asarray(lengths))
    out = paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                          torch.from_numpy(vp), torch.from_numpy(tables),
                          torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_paged_attention_chunk_matches_jax():
    q, kp, vp, tables = _pool_case(3)
    q_lengths = np.array([[1, 2, 3, 4, 5], [8, 9, 10, 11, 12],
                          [1, 1, 14, 15, 16]], np.int32)
    ref = jfa.paged_attention_chunk(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(tables),
                                    jnp.asarray(q_lengths))
    out = paged_attention_chunk(torch.from_numpy(q), torch.from_numpy(kp),
                                torch.from_numpy(vp),
                                torch.from_numpy(tables),
                                torch.from_numpy(q_lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("q,k,v,match", [
    (_t(1, 2, 8, 32), _t(1, 2, 8, 32), _t(1, 2, 8, 32), "head_dim"),
    (_t(1, 2, 8, 64, dtype=torch.float16), _t(1, 2, 8, 64,
                                              dtype=torch.float16),
     _t(1, 2, 8, 64, dtype=torch.float16), "bfloat16"),
    (_t(1, 3, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 8, 64), "multiple"),
    (_t(1, 2, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 9, 64), "differ"),
    (_t(1, 2, 64, 8).transpose(2, 3), _t(1, 2, 8, 64), _t(1, 2, 8, 64),
     "contiguous"),
    (_t(2, 8, 64), _t(2, 8, 64), _t(2, 8, 64), "4-D"),
    (_t(1 + 2 * 8 * 64)[1:].view(1, 2, 8, 64), _t(1, 2, 8, 64),
     _t(1, 2, 8, 64), "aligned"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(q, k, v,
                                                              match):
    with pytest.raises(ValueError, match=match):
        _check(q, k, v)


def test_kernel_wrapper_accepts_the_kernel_shapes():
    for D in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            _check(_t(2, 8, 5, D, dtype=dtype), _t(2, 2, 7, D, dtype=dtype),
                   _t(2, 2, 7, D, dtype=dtype))


# the forward's card cases beyond CASES: Sq 1, ragged Sq and Sk (Sk not a
# multiple of the 128-row K/V tile), causal with Sq < Sk and Sq > Sk (rows
# with no visible key), GQA groups 4 and 8, and a GQA prefill with a short Sq
FWD_CARD_CASES = CASES + [
    (1, 2, 2, 1, 301, 64, True),        # Sq 1
    (2, 8, 2, 77, 301, 128, True),      # group 4, Sq < Sk, ragged
    (1, 8, 1, 301, 77, 64, True),       # group 8, Sq > Sk: rows see no key
    (2, 4, 2, 200, 330, 64, False),     # Sk not a multiple of 128
    (1, 32, 8, 16, 1040, 128, True),    # GQA prefill, short Sq
]


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (B, H, Hkv, Sq, Sk, D, causal), (dtype, atol) in zip(
            FWD_CARD_CASES * 2, [(torch.float32, 1e-4)] * len(FWD_CARD_CASES)
            + [(torch.bfloat16, 2e-2)] * len(FWD_CARD_CASES)):
        q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in
                   _qkv(B, H, Hkv, Sq, Sk, D))
        plan = flash_fwd_plan(B, H, Hkv, Sq, Sk, D, dtype)
        assert plan.variant == ("wgmma" if dtype == torch.bfloat16
                                else "fma")
        before, vbefore = launch_counts()["flash_fwd"], variant_counts()
        o, lse = _flash_forward(q, k, v, causal, D ** -0.5)
        o2, lse2 = _flash_forward(q, k, v, causal, D ** -0.5)
        torch.cuda.synchronize()
        assert launch_counts()["flash_fwd"] == before + 2
        assert variant_counts().get(("flash_fwd", plan.label), 0) \
            == vbefore.get(("flash_fwd", plan.label), 0) + 2
        # two launches bit-equal
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        o_ref, lse_ref = _ref_forward(q, k, v, causal, D ** -0.5)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=atol,
                                   rtol=atol)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
        if causal and Sq > Sk:
            # rows with no visible key: o = 0 and lse = -1e30 exactly
            blind = Sq - Sk
            assert not o[:, :, :blind].any()
            assert bool((lse[:, :, :blind] == -1e30).all())


def test_rows_without_a_visible_key_read_zero():
    """Causal with Sq > Sk: query rows i < Sq - Sk see no key. The port's
    plain forward (like its kernels) gives them o = 0 and lse = -1e30 (P =
    0 on every masked entry); every other row matches the Pallas kernel
    (interpret mode). The JAX kernel's values on the blind rows depend on
    its tile geometry, so they are not compared."""
    B, H, Hkv, Sq, Sk, D = 1, 4, 2, 200, 77, 64
    q, k, v = _qkv(B, H, Hkv, Sq, Sk, D, seed=10)
    sc = D ** -0.5
    o_j, lse_j = jfa._pallas_forward(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), True, sc)
    o_t, lse_t = _flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), True, sc)
    blind = Sq - Sk
    assert not o_t[:, :, :blind].any()
    assert bool((lse_t[:, :, :blind] == -1e30).all())
    np.testing.assert_allclose(o_t[:, :, blind:].numpy(),
                               np.asarray(o_j)[:, :, blind:], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse_t[:, :, blind:].numpy(),
                               np.asarray(lse_j)[:, :, blind:], atol=ATOL,
                               rtol=0)


# the main paths' forward shapes: llama_110m serving (4 x 512), llama_110m
# training (8 x 1024), llama3_8b (GQA 32/8, D 128), BERT-base (non-causal)
FWD_PATH_SHAPES = [(4, 12, 12, 512, 512, 64), (8, 12, 12, 1024, 1024, 64),
                   (1, 32, 8, 2048, 2048, 128), (2, 32, 8, 512, 512, 128),
                   (128, 12, 12, 128, 128, 64)]


@pytest.mark.parametrize("shape", FWD_PATH_SHAPES + [
    (1, 12, 12, 304, 304, 64), (2, 4, 2, 77, 301, 64), (1, 2, 2, 1, 301, 64),
    (1, 8, 1, 301, 77, 64), (1, 32, 8, 16, 1040, 128),
    (3, 8, 2, 200, 330, 128), (1, 1, 1, 1, 1, 64)])
def test_forward_plan_takes_wgmma_for_every_bf16_shape(shape):
    plan = flash_fwd_plan(*shape, torch.bfloat16)
    assert plan == FlashFwdPlan("wgmma", 128, 128)
    assert plan.label == "wgmma_128x128"


@pytest.mark.parametrize("shape", FWD_PATH_SHAPES + [(2, 4, 2, 77, 301, 64),
                                                     (1, 4, 1, 33, 5, 128)])
def test_forward_plan_takes_fma_for_fp32(shape):
    plan = flash_fwd_plan(*shape, torch.float32)
    assert plan == FlashFwdPlan("fma", 64, 64)
    assert plan.label == "fma_64x64"


def test_forward_plan_tiles_per_head_dim():
    # both head dims: 128-row work items over 128-row K/V tiles
    for D in (64, 128):
        for S in (1, 128, 129, 4096):
            plan = flash_fwd_plan(2, 8, 2, S, S, D, torch.bfloat16)
            assert (plan.rows, plan.block_k) == (128, 128), (D, S)


@pytest.mark.parametrize("args,match", [
    ((1, 2, 2, 8, 8, 96, torch.bfloat16), "head_dim"),
    ((1, 3, 2, 8, 8, 64, torch.bfloat16), "no kernel"),
    ((0, 2, 2, 8, 8, 64, torch.bfloat16), "no kernel"),
    ((1, 2, 2, 8, 0, 64, torch.bfloat16), "no kernel"),
    ((1, 2, 2, 8, 8, 64, torch.float16), "bfloat16"),
])
def test_forward_plan_refuses_what_no_kernel_takes(args, match):
    with pytest.raises(ValueError, match=match):
        flash_fwd_plan(*args)


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1),
                                        (torch.float32, 0)])
def test_forward_wrapper_counts_the_plans_variant(monkeypatch, dtype, code):
    """The wrapper's launch path with the kernel stubbed: the plan's
    variant and rows reach the C entry, and its label reaches
    variant_counts."""
    import contextlib
    import types
    fa_mod = sys.modules["mxnet_tpu_torch.parallel.flash_attention"]
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(fa_mod, "_on_cuda", lambda q: True)
    monkeypatch.setattr(fa_mod, "bind", lambda *a: (None, entry))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(2, 8, 2, 77, 301, 128))
    plan = flash_fwd_plan(2, 8, 2, 77, 301, 128, dtype)
    before, vbefore = launch_counts()["flash_fwd"], variant_counts()
    o, lse = _flash_forward(q, k, v, True, 0.125)
    assert o.shape == q.shape and lse.shape == (2, 8, 77)
    assert launch_counts()["flash_fwd"] == before + 1
    assert variant_counts()[("flash_fwd", plan.label)] == \
        vbefore.get(("flash_fwd", plan.label), 0) + 1
    # (..., causal, scale, dtype, variant, rows, stream)
    (args,) = calls
    assert args[-6:] == (1, 0.125, code, code, plan.rows, 7)


def _grad_case(B, H, Hkv, Sq, Sk, D, seed):
    q, k, v = _qkv(B, H, Hkv, Sq, Sk, D, seed=seed)
    # a weighted-sum loss, so the cotangent differs per position
    w = np.random.RandomState(seed + 100).randn(B, H, Sq, D) \
        .astype(np.float32)
    return q, k, v, w


def _torch_grads(q, k, v, w, causal):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tflash(qt, kt, vt, causal=causal) * torch.from_numpy(w)).sum() \
        .backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", CASES)
def test_flash_attention_grads_match_pallas_backward(B, H, Hkv, Sq, Sk, D,
                                                     causal):
    q, k, v, w = _grad_case(B, H, Hkv, Sq, Sk, D, seed=2)

    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, causal=causal)
                       * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    before = launch_counts()
    got = _torch_grads(q, k, v, w, causal)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert launch_counts() == before
    for g, j, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == j.shape, name
        np.testing.assert_allclose(g, np.asarray(j), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", CASES)
def test_backward_inner_matches_pallas_backward_inner(B, H, Hkv, Sq, Sk, D,
                                                      causal):
    q, k, v, do = _grad_case(B, H, Hkv, Sq, Sk, D, seed=3)
    sc = D ** -0.5
    _, lse = _ref_forward(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal, sc)
    # delta is an input of its own here (ring attention passes a global one)
    delta = np.random.RandomState(4).randn(B, H, Sq).astype(np.float32)
    want = jfa._pallas_backward_inner(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lse.numpy()), jnp.asarray(delta), jnp.asarray(do),
        causal, sc)
    got = _backward_inner(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), lse, torch.from_numpy(delta),
                          torch.from_numpy(do), causal, sc)
    for g, j, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", CASES)
def test_ref_backward_matches_autograd_of_ref_forward(B, H, Hkv, Sq, Sk, D,
                                                      causal):
    q, k, v, w = _grad_case(B, H, Hkv, Sq, Sk, D, seed=5)
    qt, kt, vt = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    o, lse = _ref_forward(qt, kt, vt, causal, D ** -0.5)
    (o * torch.from_numpy(w).double()).sum().backward()
    got = _ref_backward(qt.detach(), kt.detach(), vt.detach(), o.detach(),
                        lse.detach(), torch.from_numpy(w).double(), causal,
                        D ** -0.5)
    for g, t, name in zip(got, (qt, kt, vt), ("dq", "dk", "dv")):
        # the plain backward computes in fp32; autograd here in fp64
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_rows_without_a_visible_key_get_no_gradient():
    """Causal with Sq > Sk: query rows i < Sq - Sk see no key. The port's
    rule (kernels and plain version alike) gives them P = 0, so no dq, and
    no share in dk/dv; with a cotangent that is zero on those rows the
    rest equals autograd of the plain forward. (The JAX kernels' values on
    such rows depend on their tile geometry, so they are held only against
    the port's own plain version.)"""
    B, H, Hkv, Sq, Sk, D = 1, 4, 2, 40, 24, 16
    q, k, v, w = _grad_case(B, H, Hkv, Sq, Sk, D, seed=6)
    blind = Sq - Sk
    w[:, :, :blind] = 0.0
    qt, kt, vt = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    o, lse = _ref_forward(qt, kt, vt, True, D ** -0.5)
    (o * torch.from_numpy(w).double()).sum().backward()
    dq, dk, dv = _ref_backward(qt.detach(), kt.detach(), vt.detach(),
                               o.detach(), lse.detach(),
                               torch.from_numpy(w).double(), True, D ** -0.5)
    assert not dq[:, :, :blind].any()
    for g, t in zip((dq, dk, dv), (qt, kt, vt)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-5,
                                   rtol=0)
    # a nonzero cotangent on the blind rows still leaves them without dq
    w2 = torch.ones(B, H, Sq, D, dtype=torch.float64)
    dq2, _, _ = _flash_backward(qt.detach(), kt.detach(), vt.detach(),
                                o.detach(), lse.detach(), w2, True,
                                D ** -0.5)
    assert not dq2[:, :, :blind].any()


def test_gradient_keeps_the_inputs_dtypes():
    q, k, v, w = _grad_case(1, 4, 2, 33, 33, 64, seed=7)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    out = tflash(qt, kt, vt, causal=True)
    assert out.dtype == torch.bfloat16 and out.requires_grad
    out.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape
               for t in (qt, kt, vt))
    with torch.no_grad():
        assert not tflash(qt, kt, vt, causal=True).requires_grad


def _bwd_args(**over):
    args = {"q": _t(1, 4, 8, 64), "k": _t(1, 2, 8, 64), "v": _t(1, 2, 8, 64),
            "lse": _t(1, 4, 8), "delta": _t(1, 4, 8), "do": _t(1, 4, 8, 64)}
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    ({"do": _t(1, 4, 8, 64, dtype=torch.bfloat16)}, "dO"),
    ({"do": _t(1, 4, 9, 64)}, "dO"),
    ({"lse": _t(1, 4, 8, dtype=torch.bfloat16)}, "lse"),
    ({"delta": _t(1, 4, 9)}, "delta"),
    ({"do": _t(1, 4, 64, 8).transpose(2, 3)}, "contiguous"),
    ({"lse": _t(1 + 4 * 8)[1:].view(1, 4, 8)}, "aligned"),
    ({"q": _t(1, 4, 8, 32), "do": _t(1, 4, 8, 32)}, "head_dim"),
], ids=["do-dtype", "do-shape", "lse-dtype", "delta-shape", "do-contiguous",
        "lse-aligned", "head_dim"])
def test_backward_wrapper_rejects_what_the_kernels_do_not_take(over, match):
    with pytest.raises(ValueError, match=match):
        _check_backward(**_bwd_args(**over))


def test_backward_wrapper_accepts_the_kernel_shapes():
    for D in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            _check_backward(**_bwd_args(
                q=_t(2, 8, 5, D, dtype=dtype), k=_t(2, 2, 7, D, dtype=dtype),
                v=_t(2, 2, 7, D, dtype=dtype), do=_t(2, 8, 5, D, dtype=dtype),
                lse=_t(2, 8, 5), delta=_t(2, 8, 5)))


# H100 multiprocessors, and the main paths' backward shapes
SMS = 132
TRAIN_PATH = (8, 12, 12, 1024, 1024, 64)          # llama_110m, causal
LLAMA3_8B_DRY_GQA = (2, 32, 8, 512, 512, 128)     # GQA 32/8, causal
BERT_BASE_PATH = (128, 12, 12, 128, 128, 64)      # non-causal


@pytest.mark.parametrize("shape", [
    TRAIN_PATH, LLAMA3_8B_DRY_GQA, BERT_BASE_PATH, (1, 2, 2, 70, 130, 64),
    (1, 2, 2, 130, 70, 128), (2, 4, 2, 160, 160, 64), (1, 1, 1, 1, 1, 64),
    (3, 8, 2, 200, 200, 128), (1, 40, 8, 4096, 4096, 128)])
def test_backward_plan_takes_wgmma_for_every_bf16_shape(shape):
    plan = flash_bwd_plan(*shape, torch.bfloat16, sms=SMS)
    assert plan.variant == "wgmma"
    assert plan.dq_rows in (64, 128) and plan.dkv_rows in (64, 128)
    B, H, Hkv = shape[:3]
    assert (H // Hkv) % plan.split == 0
    assert plan.dq_label.startswith("wgmma") \
        and plan.dkv_label.startswith("wgmma")


@pytest.mark.parametrize("shape", [TRAIN_PATH, LLAMA3_8B_DRY_GQA,
                                   (2, 4, 2, 77, 301, 64),
                                   (1, 4, 1, 33, 5, 128)])
def test_backward_plan_takes_fma_for_fp32(shape):
    assert flash_bwd_plan(*shape, torch.float32, sms=SMS) == \
        FlashBwdPlan("fma", 64, 64, 1)


def test_backward_plan_splits_the_gqa_group_where_the_grid_is_short():
    # llama3_8b_dry: 8 key tiles x 8 kv heads x 2 = 128 dk/dv blocks, under
    # two waves of 132 SMs: two shares of the group of 4 make 256
    gqa = flash_bwd_plan(*LLAMA3_8B_DRY_GQA, torch.bfloat16, sms=SMS)
    assert gqa == FlashBwdPlan("wgmma", 128, 64, 2)
    assert gqa.dkv_label == "wgmma_64_split2"
    # the training path has no GQA and 768 blocks: no split
    assert flash_bwd_plan(*TRAIN_PATH, torch.bfloat16,
                          sms=SMS).split == 1
    # enough blocks: the group sum stays in registers
    assert flash_bwd_plan(16, 32, 8, 2048, 2048, 128, torch.bfloat16,
                          sms=SMS).split == 1
    # a tiny grid takes the whole group apart, one head a share
    assert flash_bwd_plan(1, 8, 2, 64, 64, 64, torch.bfloat16,
                          sms=SMS).split == 4


def test_backward_plan_tiles_per_head_dim():
    # D 64: one-consumer dq blocks (two fit an SM), 128-row dk/dv blocks
    assert flash_bwd_plan(*TRAIN_PATH, torch.bfloat16, sms=SMS) == \
        FlashBwdPlan("wgmma", 64, 128, 1)
    assert flash_bwd_plan(*BERT_BASE_PATH, torch.bfloat16, sms=SMS) == \
        FlashBwdPlan("wgmma", 64, 128, 1)
    # D 128: two-consumer dq blocks, 64-row dk/dv blocks (dk and dv hold
    # 128 fp32 a thread)
    plan = flash_bwd_plan(8, 32, 32, 1024, 1024, 128, torch.bfloat16,
                          sms=SMS)
    assert (plan.dq_rows, plan.dkv_rows) == (128, 64)
    # the tile follows D alone, however small the grid
    assert flash_bwd_plan(1, 2, 2, 256, 256, 128, torch.bfloat16,
                          sms=SMS) == FlashBwdPlan("wgmma", 128, 64, 1)
    assert flash_bwd_plan(1, 2, 2, 256, 256, 64, torch.bfloat16,
                          sms=SMS) == FlashBwdPlan("wgmma", 64, 128, 1)


@pytest.mark.parametrize("args,match", [
    ((1, 2, 2, 8, 8, 96, torch.bfloat16), "head_dim"),
    ((1, 3, 2, 8, 8, 64, torch.bfloat16), "no kernel"),
    ((0, 2, 2, 8, 8, 64, torch.bfloat16), "no kernel"),
    ((1, 2, 2, 0, 8, 64, torch.bfloat16), "no kernel"),
    ((1, 2, 2, 8, 8, 64, torch.float16), "bfloat16"),
])
def test_backward_plan_refuses_what_no_kernel_takes(args, match):
    with pytest.raises(ValueError, match=match):
        flash_bwd_plan(*args, sms=SMS)


def _group_sum(partial, dtype):
    """The fixed-order reduction of the split launch's second kernel
    (flash_bwd_dkv_group_sum), as a plain function: partial (B, Hkv, split,
    Sk, D) fp32, each share's dk (or dv), added over the shares in order
    (0, 1, ...) in fp32 and rounded once to `dtype`."""
    out = partial[:, :, 0].clone()
    for s in range(1, partial.shape[2]):
        out += partial[:, :, s]
    return out.to(dtype)


@pytest.mark.parametrize("B,Hkv,group,Sk,D", [(2, 8, 4, 33, 64),
                                              (1, 2, 2, 130, 128),
                                              (3, 1, 8, 7, 64)])
def test_group_sum_matches_reference_group_sum(B, Hkv, group, Sk, D):
    """The split launch's second kernel, as its plain version: per-head
    fp32 dk (or dv) partials summed over the group in a fixed order and
    rounded once, against the reference's group sum after its per-head
    kernel (mxnet_tpu/parallel/flash_attention.py, _pallas_backward_inner)."""
    rng = np.random.RandomState(B * 100 + Sk)
    dk_h = rng.randn(B, Hkv * group, Sk, D).astype(np.float32)
    want = np.asarray(jnp.asarray(dk_h).reshape(B, Hkv, group, Sk, D)
                      .sum(axis=2))
    partial = torch.from_numpy(dk_h).reshape(B, Hkv, group, Sk, D)
    got = _group_sum(partial, torch.float32)
    assert got.shape == (B, Hkv, Sk, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the order is fixed: shares added 0, 1, 2, ... in fp32
    ordered = partial[:, :, 0].clone()
    for s in range(1, group):
        ordered = ordered + partial[:, :, s]
    assert torch.equal(got, ordered)
    # rounded once to the output type
    assert torch.equal(_group_sum(partial, torch.bfloat16),
                       ordered.to(torch.bfloat16))


def _card_backward(q, k, v, o, lse, do, causal, sc, plan):
    """dq, dk, dv through the kernels at a given plan, with the variant
    labels the launches counted."""
    delta = _delta(o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    before = variant_counts()
    _launch_dq(q, k, v, do, lse, delta, dq, causal, sc, plan)
    _launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, sc, plan)
    after = variant_counts()
    labels = sorted("%s/%s" % key for key, n in after.items()
                    if n != before.get(key, 0))
    return (dq, dk, dv), labels


@pytest.mark.cuda
def test_backward_kernels_match_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (B, H, Hkv, Sq, Sk, D, causal), dtype in [
            (c, dt) for dt in (torch.float32, torch.bfloat16)
            for c in CASES + [(1, 2, 2, 130, 70, 64, True),
                              (1, 2, 2, 70, 130, 64, True),
                              (2, 4, 4, 200, 200, 128, True),
                              (1, 8, 2, 160, 160, 64, False)]]:
        q, k, v, w = (torch.from_numpy(a).cuda().to(dtype) for a in
                      _grad_case(B, H, Hkv, Sq, Sk, D, seed=8))
        sc = D ** -0.5
        o, lse = _flash_forward(q, k, v, causal, sc)
        before = launch_counts()
        got = _flash_backward(q, k, v, o, lse, w, causal, sc)
        torch.cuda.synchronize()
        after = launch_counts()
        assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
        assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
        want = _ref_backward(q, k, v, o, lse, w, causal, sc)
        plan = flash_bwd_plan(B, H, Hkv, Sq, Sk, D, dtype,
                              sms=torch.cuda.get_device_properties(
                                  q.device).multi_processor_count)
        again, labels = _card_backward(q, k, v, o, lse, w, causal, sc, plan)
        torch.cuda.synchronize()
        # the variant and split the plan names; two launches bit-equal
        assert labels == sorted(["flash_bwd_dq/" + plan.dq_label,
                                 "flash_bwd_dkv/" + plan.dkv_label])
        assert plan.variant == ("wgmma" if dtype == torch.bfloat16
                                else "fma")
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for name, g, r in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == r.dtype and g.shape == r.shape
            g, r = g.float(), r.float()
            if dtype == torch.float32:
                assert (g - r).abs().max().item() <= 1e-4
            else:
                assert bool(torch.isfinite(g).all())
                # dS enters as bf16 hi + lo: dq, dk keep ~16 bits; P is
                # rounded to bf16 for dv
                limit = 5e-3 if name == "dv" else 5e-4
                assert ((g - r).norm() / r.norm()).item() <= limit, name


@pytest.mark.cuda
def test_backward_kernels_split_and_shared_key_mean_on_the_card():
    """A GQA shape with and without the group split, bit-equal between
    launches; and keys sharing a large mean (k = randn + 4), where dq and
    dk stay within 1e-3 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Hkv, S, D = 1, 8, 2, 256, 128
    q, k, v, w = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in
                  _grad_case(B, H, Hkv, S, S, D, seed=9))
    k = (k.float() + 4.0).to(torch.bfloat16)
    sc = D ** -0.5
    o, lse = _flash_forward(q, k, v, True, sc)
    want = _ref_backward(q, k, v, o, lse, w, True, sc)
    outs = []
    for split in (1, 2, 4):
        plan = FlashBwdPlan("wgmma", 128, 64, split)
        got, labels = _card_backward(q, k, v, o, lse, w, True, sc, plan)
        again, _ = _card_backward(q, k, v, o, lse, w, True, sc, plan)
        torch.cuda.synchronize()
        assert "flash_bwd_dkv/wgmma_64_split%d" % split in labels
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for name, g, r in zip(("dq", "dk", "dv"), got, want):
            err = ((g.float() - r.float()).norm() / r.float().norm()).item()
            assert err <= (5e-3 if name == "dv" else 1e-3), (split, name)
        outs.append(got)
    # dq does not depend on the split
    assert all(torch.equal(outs[0][0], o_[0]) for o_ in outs[1:])
