"""Flash attention on the CUDA card (forward and backward), and the paged
attention of serving.

`flash_attention` is the port of `mxnet_tpu.parallel.flash_attention`'s
`flash_attention`: a `torch.autograd.Function` whose forward launches the
hand-written kernel in ``csrc/flash_fwd.cu`` (online softmax over K/V
tiles, fp32 accumulation, GQA, causal with the (Sk - Sq) diagonal offset,
any sequence length) and saves (q, k, v, o, lse); its backward computes
delta = rowsum(dO * O) in PyTorch, as the JAX package leaves it to XLA, and
launches the two kernels of ``csrc/flash_bwd.cu``: dq, and dk/dv with the
GQA group-sum folded in. On CPU tensors each kernel's plain PyTorch version
runs instead (`_ref_forward`, `_ref_backward_inner`). There is no other
route: a CUDA tensor a kernel does not take raises.

`paged_attention` and `paged_attention_chunk` stay plain PyTorch (a gather
plus two batched products), as the JAX package leaves them to XLA.

Shapes: q (B, H, Sq, D); k/v (B, Hkv, Sk, D) with H % Hkv == 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops import count_launch
from ..ops._build import library

__all__ = ["flash_attention", "paged_attention", "paged_attention_chunk"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _ref_forward(q, k, v, causal, sm_scale):
    """Plain attention with an fp32 softmax: (o in q's dtype, lse fp32
    (B, H, Sq)). GQA runs as a grouped product over (kv_head, group), with
    no repeated copy of K/V."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D).float()
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))
    logits = logits * sm_scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits,
                             torch.full_like(logits, _NEG_INF))
    lse = torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v[:, :, None])
    return out.reshape(B, H, Sq, D).to(q.dtype), lse


def _ref_attention(q, k, v, causal, sm_scale):
    """The kernel's plain version: attention output only."""
    return _ref_forward(q, k, v, causal, sm_scale)[0]


def _visible(Sq, Sk, causal, device):
    """(Sq, Sk) bool: which keys each query row sees."""
    if not causal:
        return torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    qi = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    return torch.arange(Sk, device=device)[None, :] <= qi


def _ref_backward_inner(q, k, v, lse, delta, do, causal, sm_scale):
    """The backward kernels' plain version, on dense fp32 tensors:
    P = exp(S * scale - lse) on visible entries and exactly 0 elsewhere,
    dS = P * (dO V^T - delta) * scale, dq = dS K, dk = dS^T Q and
    dv = P^T dO summed over each kv head's query group. Returns (dq, dk, dv)
    in q's, k's and v's dtypes. A query row with no visible key (causal
    with Sq > Sk) gets no gradient, as in the kernels."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D).float()
    dog = do.reshape(B, Hkv, g, Sq, D).float()
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = torch.matmul(qg, kf.transpose(-1, -2)) * sm_scale
    lse_g = lse.reshape(B, Hkv, g, Sq, 1)
    p = torch.where(_visible(Sq, Sk, causal, q.device), torch.exp(s - lse_g),
                    torch.zeros_like(s))
    dp = torch.matmul(dog, vf.transpose(-1, -2))
    ds = p * (dp - delta.reshape(B, Hkv, g, Sq, 1)) * sm_scale
    dq = torch.matmul(ds, kf).reshape(B, H, Sq, D)
    dk = torch.matmul(ds.transpose(-1, -2), qg).sum(dim=2)
    dv = torch.matmul(p.transpose(-1, -2), dog).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do):
    """delta = rowsum(dO * O) in fp32, (B, H, Sq)."""
    return (do.float() * o.float()).sum(dim=-1)


def _ref_backward(q, k, v, o, lse, do, causal, sm_scale):
    """The plain version of the whole backward: delta, then
    `_ref_backward_inner`."""
    return _ref_backward_inner(q, k, v, lse, _delta(o, do), do, causal,
                               sm_scale)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D "
                         "(B, H, S, D), got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if k.shape != v.shape:
        raise ValueError("flash_attention: k %s and v %s differ"
                         % (tuple(k.shape), tuple(v.shape)))
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("flash_attention: q %s and k %s disagree on batch "
                         "or head_dim" % (tuple(q.shape), tuple(k.shape)))
    if H % k.shape[1]:
        raise ValueError("flash_attention: %d query heads are not a "
                         "multiple of %d kv heads" % (H, k.shape[1]))
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError("flash_attention: the kernel takes float32 or "
                         "bfloat16 q, k, v of one dtype, got %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))
    if D not in _HEAD_DIMS:
        raise ValueError("flash_attention: the kernel takes head_dim %s, "
                         "got %d" % (_HEAD_DIMS, D))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: the kernel takes contiguous "
                         "q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel reads 16-byte "
                         "aligned q, k, v")


_SIGNATURES = {
    # C function -> number of pointer arguments before the int arguments
    "mx_flash_fwd": 5,
    "mx_flash_bwd_dq": 7,
    "mx_flash_bwd_dkv": 8,
}


def _kernel(name, fn_name):
    """The C entry point `fn_name` of kernel `name`'s library, typed."""
    lib = library(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # pointers, B, H, Hkv, Sq, Sk, D, causal, scale, dtype, stream
        fn.argtypes = [p] * _SIGNATURES[fn_name] + [i] * 7 \
            + [ctypes.c_float, i, p]
        fn.restype = i
        lib.mx_cuda_error_string.argtypes = [i]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(name, fn_name, tensors, q, k, causal, sm_scale):
    """Launch one kernel on q's device and current stream; count it."""
    lib, fn = _kernel(name, fn_name)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), B, H, Hkv, Sq, Sk, D,
                 int(bool(causal)), float(sm_scale), _DTYPES[q.dtype],
                 stream)
    if err:
        raise RuntimeError("flash_attention: %s launch failed: %s"
                           % (name, lib.mx_cuda_error_string(err).decode()))
    count_launch(name)


def _on_cuda(q):
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device (no kernel, and no plain version meant for it)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError("flash_attention: no kernel for device %s"
                         % q.device)
    return True


def _flash_forward(q, k, v, causal, sm_scale):
    """(o, lse): o (B, H, Sq, D) in q's dtype, lse (B, H, Sq) fp32 — the
    pair the backward kernels consume."""
    if not _on_cuda(q):
        return _ref_forward(q, k, v, causal, sm_scale)
    _check(q, k, v)
    B, H, Sq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse.fill_(_NEG_INF)
    if k.shape[2] == 0:
        raise ValueError("flash_attention: empty key sequence")
    _launch("flash_fwd", "mx_flash_fwd", (q, k, v, o, lse), q, k, causal,
            sm_scale)
    return o, lse


def _check_backward(q, k, v, lse, delta, do):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype \
            or do.device != q.device:
        raise ValueError("flash_attention: dO %s %s must match q %s %s"
                         % (tuple(do.shape), do.dtype, tuple(q.shape),
                            q.dtype))
    rows = q.shape[:3]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != rows or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError("flash_attention: %s must be float32 %s on "
                             "%s, got %s %s" % (name, tuple(rows), q.device,
                                                t.dtype, tuple(t.shape)))
    if not all(t.is_contiguous() for t in (do, lse, delta)):
        raise ValueError("flash_attention: the backward kernels take "
                         "contiguous dO, lse, delta")
    if any(t.data_ptr() % 16 for t in (do, lse, delta)):
        raise ValueError("flash_attention: the backward kernels read "
                         "16-byte aligned dO, lse, delta")


def _backward_inner(q, k, v, lse, delta, do, causal, sm_scale):
    """(dq, dk, dv) from a given (lse, delta) — the split of the JAX
    package's `_pallas_backward_inner`, kept so that ring attention can run
    per-block backwards against the global lse. On CUDA tensors: the dq
    kernel, then the dk/dv kernel (GQA group-sum inside it)."""
    if not _on_cuda(q):
        return _ref_backward_inner(q, k, v, lse, delta, do, causal, sm_scale)
    _check_backward(q, k, v, lse, delta, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _launch("flash_bwd_dq", "mx_flash_bwd_dq",
            (q, k, v, do, lse, delta, dq), q, k, causal, sm_scale)
    _launch("flash_bwd_dkv", "mx_flash_bwd_dkv",
            (q, k, v, do, lse, delta, dk, dv), q, k, causal, sm_scale)
    return dq, dk, dv


def _flash_backward(q, k, v, o, lse, do, causal, sm_scale):
    """(dq, dk, dv): delta = rowsum(dO * O) in fp32 (a plain reduction, as
    the JAX package leaves it to XLA), then `_backward_inner`."""
    return _backward_inner(q, k, v, lse, _delta(o, do), do, causal,
                           sm_scale)


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel saves (q, k, v, o,
    lse); the backward recomputes P from lse in the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = _flash_forward(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do.contiguous(),
                                     ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Fused scaled-dot-product attention, differentiable in q, k, v.

    q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), H divisible by Hkv.
    Returns (B, H, Sq, D) in q's dtype.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


def _gather_pages(pool, block_tables):
    """(N, Hkv, bs, D) pool pages named by (B, nb) tables -> (B, Hkv,
    nb*bs, D). Entries >= N (unallocated) are clamped onto the last block;
    the callers' length masks discard what they read."""
    N, Hkv, bs, D = pool.shape
    B, nb = block_tables.shape
    pages = pool[block_tables.clamp(max=N - 1)]        # (B, nb, Hkv, bs, D)
    return pages.permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bs, D)


def paged_attention_chunk(q, k_pool, v_pool, block_tables, q_lengths,
                          sm_scale=None):
    """Multi-query attention over a paged KV pool with per-query lengths
    (chunked prefill; `paged_attention` is its C=1 case).

    q:            (B, H, C, D) — C new query tokens per stream.
    k_pool/v_pool:(N, Hkv, bs, D) — the shared physical pool.
    block_tables: (B, nb) int — per-stream block ids (entries >= N are
                  unallocated; the length mask discards their rows).
    q_lengths:    (B, C) int — query c sees positions < q_lengths[b, c]
                  (its own KV already written). Padded queries pass 1.

    Returns (B, H, C, D) in q's dtype, with the fp32 softmax of
    `_ref_attention`.
    """
    B, H, C, D = q.shape
    Hkv = k_pool.shape[1]
    g = H // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    k = _gather_pages(k_pool, block_tables)
    v = _gather_pages(v_pool, block_tables)
    qg = q.reshape(B, Hkv, g, C, D).float()
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))
    logits = logits * sm_scale
    cols = torch.arange(k.shape[2], device=q.device)
    mask = cols[None, None, None, None, :] < q_lengths[:, None, None, :, None]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v[:, :, None])
    return out.reshape(B, H, C, D).to(q.dtype)


def paged_attention(q, k_pool, v_pool, block_tables, lengths, sm_scale=None):
    """Single-token attention over a paged KV pool (the decode path).

    q (B, H, 1, D); pools (N, Hkv, bs, D); block_tables (B, nb) int;
    lengths (B,) int — valid context per stream, >= 1. Returns
    (B, H, 1, D) in q's dtype.
    """
    return paged_attention_chunk(q, k_pool, v_pool, block_tables,
                                 lengths[:, None], sm_scale)
