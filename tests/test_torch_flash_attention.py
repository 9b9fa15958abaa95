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
from mxnet_tpu_torch.ops import launch_counts
from mxnet_tpu_torch.parallel import (paged_attention,
                                      paged_attention_chunk)
from mxnet_tpu_torch.parallel import flash_attention as tflash
from mxnet_tpu_torch.parallel.flash_attention import (_backward_inner,
                                                      _check,
                                                      _check_backward,
                                                      _flash_backward,
                                                      _flash_forward,
                                                      _ref_backward,
                                                      _ref_forward)

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


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (B, H, Hkv, Sq, Sk, D, causal), (dtype, atol) in zip(
            CASES * 2, [(torch.float32, 1e-4)] * len(CASES)
            + [(torch.bfloat16, 2e-2)] * len(CASES)):
        q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in
                   _qkv(B, H, Hkv, Sq, Sk, D))
        before = launch_counts()["flash_fwd"]
        o, lse = _flash_forward(q, k, v, causal, D ** -0.5)
        torch.cuda.synchronize()
        assert launch_counts()["flash_fwd"] == before + 1
        o_ref, lse_ref = _ref_forward(q, k, v, causal, D ** -0.5)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=atol,
                                   rtol=atol)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


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


@pytest.mark.cuda
def test_backward_kernels_match_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (B, H, Hkv, Sq, Sk, D, causal), dtype in [
            (c, dt) for dt in (torch.float32, torch.bfloat16)
            for c in CASES + [(1, 2, 2, 130, 70, 64, True)]]:
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
        for g, r in zip(got, want):
            assert g.dtype == r.dtype and g.shape == r.shape
            g, r = g.float(), r.float()
            if dtype == torch.float32:
                assert (g - r).abs().max().item() <= 1e-4
            else:
                assert bool(torch.isfinite(g).all())
                assert ((g - r).norm() / r.norm()).item() <= 2e-2
