"""Flash attention on the CUDA card (forward and backward), and the paged
attention of serving.

`flash_attention` is the port of `mxnet_tpu.parallel.flash_attention`'s
`flash_attention`: a `torch.autograd.Function` whose forward launches the
hand-written kernel in ``csrc/flash_fwd.cu`` (online softmax over K/V
tiles, fp32 accumulation, GQA, causal with the (Sk - Sq) diagonal offset,
any sequence length; `flash_fwd_plan` picks its variant, warp-specialised
wgmma for bf16 or FMA for fp32, and tile) and saves (q, k, v, o, lse); its
backward computes
delta = rowsum(dO * O) in PyTorch, as the JAX package leaves it to XLA, and
launches the two kernels of ``csrc/flash_bwd.cu``: dq, and dk/dv with the
GQA group-sum folded in. `flash_bwd_plan` picks their variant (warp-
specialised wgmma for bf16, FMA for fp32), tile and GQA group split from
the shape before the launch. On CPU tensors each kernel's plain PyTorch
version runs instead (`_ref_forward`, `_ref_backward_inner`). There is no
other route: a CUDA tensor a kernel does not take raises.

Under tensor parallelism (`models.llama` on a ``model`` axis) each rank
calls `flash_attention` on its own query heads and the KV heads they read
(H / model and Hkv / model: 16 and 4 of Llama-3-8B's 32 / 8 at model=2),
so the same kernels run at the local head counts; nothing here knows of
the split.

`paged_attention` and `paged_attention_chunk` stay plain PyTorch (a gather
plus two batched products), as the JAX package leaves them to XLA.

Shapes: q (B, H, Sq, D); k/v (B, Hkv, Sk, D) with H % Hkv == 0.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ..ops import count_launch
from ..ops._build import bind
from ..ops.fused_conv import H100_SMS, _sm_count

__all__ = ["flash_attention", "flash_fwd_plan", "FlashFwdPlan",
           "flash_bwd_plan", "FlashBwdPlan", "paged_attention",
           "paged_attention_chunk"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_VARIANTS = {"fma": 0, "wgmma": 1}      # the C entries' variant codes


def _ref_forward(q, k, v, causal, sm_scale):
    """Plain attention with an fp32 softmax: (o in q's dtype, lse fp32
    (B, H, Sq)). GQA runs as a grouped product over (kv_head, group), with
    no repeated copy of K/V. Masked logits are -1e30; a query row with no
    visible key (causal with Sq > Sk) reads o = 0 and lse = -1e30, as in
    the kernels (P = 0 on every masked entry)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D).float()
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))
    logits = logits * sm_scale
    probs = None
    if causal:
        visible = _visible(Sq, Sk, True, q.device)
        logits = torch.where(visible, logits,
                             torch.full_like(logits, _NEG_INF))
        if Sq > Sk:     # the first Sq - Sk rows see no key, not even 0
            probs = torch.where(visible[:, :1], torch.softmax(logits, -1),
                                torch.zeros_like(logits))
    lse = torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)
    if probs is None:
        probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v[:, :, None])
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


_P, _I = ctypes.c_void_p, ctypes.c_int
# B, H, Hkv, Sq, Sk, D, causal, scale, dtype
_SHAPE_ARGS = [_I] * 7 + [ctypes.c_float, _I]
_ARGTYPES = {
    # pointers, the shape, the variant's ints, the stream
    "mx_flash_fwd": [_P] * 5 + _SHAPE_ARGS + [_I] * 2 + [_P],
    "mx_flash_bwd_dq": [_P] * 7 + _SHAPE_ARGS + [_I] * 2 + [_P],
    "mx_flash_bwd_dkv": [_P] * 9 + _SHAPE_ARGS + [_I] * 3 + [_P],
}


def _launch(name, fn_name, tensors, q, k, causal, sm_scale, extra=(),
            variant=None):
    """Launch one kernel on q's device and current stream; count it (with
    its variant, where it has several). `tensors` may hold None for a
    pointer the kernel does not read; `extra` are the variant's ints."""
    lib, fn = bind(name, fn_name, _ARGTYPES[fn_name])
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in tensors),
                 B, H, Hkv, Sq, Sk, D, int(bool(causal)), float(sm_scale),
                 _DTYPES[q.dtype], *extra, stream)
    if err:
        raise RuntimeError("flash_attention: %s launch failed: %s"
                           % (name, lib.mx_cuda_error_string(err).decode()))
    count_launch(name, variant)


def _on_cuda(q):
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device (no kernel, and no plain version meant for it)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError("flash_attention: no kernel for device %s"
                         % q.device)
    return True


class FlashFwdPlan(collections.namedtuple("FlashFwdPlan",
                                          "variant rows block_k")):
    """The forward kernel's variant ("wgmma" or "fma"), the query rows of
    a work item and the key rows of a K/V tile."""

    @property
    def label(self):
        return "%s_%dx%d" % (self.variant, self.rows, self.block_k)


def flash_fwd_plan(B, H, Hkv, Sq, Sk, D, dtype):
    """The plan the forward kernel launches for q (B, H, Sq, D) and k/v
    (B, Hkv, Sk, D) of `dtype`.

    bf16 takes the wgmma kernel at every Sq and Sk, D 64 and 128 alike:
    work items of 128 query rows (two consumer warpgroups share each K/V
    tile) over K/V tiles of 128 rows, one persistent block an SM. fp32
    takes the FMA kernel (64 x 64 tiles). Raises ValueError for a shape or
    dtype the kernels do not take."""
    if D not in _HEAD_DIMS:
        raise ValueError("flash_fwd_plan: head_dim %s, got %d"
                         % (_HEAD_DIMS, D))
    if min(B, H, Hkv, Sq, Sk) < 1 or H % Hkv:
        raise ValueError("flash_fwd_plan: no kernel for B=%d H=%d Hkv=%d "
                         "Sq=%d Sk=%d" % (B, H, Hkv, Sq, Sk))
    if dtype == torch.float32:
        return FlashFwdPlan("fma", 64, 64)
    if dtype != torch.bfloat16:
        raise ValueError("flash_fwd_plan: float32 or bfloat16, got %s"
                         % dtype)
    return FlashFwdPlan("wgmma", 128, 128)


def _flash_forward(q, k, v, causal, sm_scale):
    """(o, lse): o (B, H, Sq, D) in q's dtype, lse (B, H, Sq) fp32 — the
    pair the backward kernels consume. On CUDA tensors: the kernel, in the
    variant and tile `flash_fwd_plan` picks."""
    if not _on_cuda(q):
        return _ref_forward(q, k, v, causal, sm_scale)
    _check(q, k, v)
    B, H, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse.fill_(_NEG_INF)
    if k.shape[2] == 0:
        raise ValueError("flash_attention: empty key sequence")
    plan = flash_fwd_plan(B, H, k.shape[1], Sq, k.shape[2], D, q.dtype)
    _launch("flash_fwd", "mx_flash_fwd", (q, k, v, o, lse), q, k, causal,
            sm_scale, (_VARIANTS[plan.variant], plan.rows), plan.label)
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


class FlashBwdPlan(collections.namedtuple(
        "FlashBwdPlan", "variant dq_rows dkv_rows split")):
    """The backward kernels' variant ("wgmma" or "fma"), the query rows of
    a dq block, the key rows of a dk/dv block, and the number of shares the
    GQA group is split into across dk/dv blocks (1: none)."""

    @property
    def dq_label(self):
        return "%s_%d" % (self.variant, self.dq_rows)

    @property
    def dkv_label(self):
        return "%s_%d_split%d" % (self.variant, self.dkv_rows, self.split)


def flash_bwd_plan(B, H, Hkv, Sq, Sk, D, dtype, sms=H100_SMS):
    """The plan the backward kernels launch for q (B, H, Sq, D) and k/v
    (B, Hkv, Sk, D) of `dtype` on a card with `sms` multiprocessors.

    bf16 takes the wgmma kernels at every Sq and Sk. dq blocks own 64
    query rows at D 64 (one consumer warpgroup: two blocks fit an SM) and
    128 at D 128 (two consumers); dk/dv blocks own 128 key rows at D 64
    and 64 at D 128 (the register budget of dk and dv). Where the dk/dv
    grid is under two waves and H > Hkv, the GQA group is split into the
    fewest shares that give one and a half waves (at most one head a
    share): each block writes fp32 partials and a second launch sums them
    in a fixed order. fp32 takes the FMA kernels (64 rows, no split). Raises
    ValueError for a shape or dtype the kernels do not take."""
    if D not in _HEAD_DIMS:
        raise ValueError("flash_bwd_plan: head_dim %s, got %d"
                         % (_HEAD_DIMS, D))
    if min(B, H, Hkv, Sq, Sk) < 1 or H % Hkv:
        raise ValueError("flash_bwd_plan: no kernel for B=%d H=%d Hkv=%d "
                         "Sq=%d Sk=%d" % (B, H, Hkv, Sq, Sk))
    if dtype == torch.float32:
        return FlashBwdPlan("fma", 64, 64, 1)
    if dtype != torch.bfloat16:
        raise ValueError("flash_bwd_plan: float32 or bfloat16, got %s"
                         % dtype)
    dq_rows = 64 if D == 64 else 128
    dkv_rows = 128 if D == 64 else 64
    group = H // Hkv
    blocks = -(-Sk // dkv_rows) * B * Hkv
    split = 1
    if group > 1 and blocks < 2 * sms:
        split = next(s for s in range(2, group + 1)
                     if group % s == 0 and (2 * blocks * s >= 3 * sms
                                            or s == group))
    return FlashBwdPlan("wgmma", dq_rows, dkv_rows, split)


def _device_plan(q, k):
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    return flash_bwd_plan(B, H, Hkv, Sq, Sk, D, q.dtype,
                          _sm_count(q.device.index))


def _launch_dq(q, k, v, do, lse, delta, dq, causal, sm_scale, plan):
    _launch("flash_bwd_dq", "mx_flash_bwd_dq", (q, k, v, do, lse, delta, dq),
            q, k, causal, sm_scale, (_VARIANTS[plan.variant], plan.dq_rows),
            plan.dq_label)


def _launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, sm_scale, plan):
    """The dk/dv kernel; with a split, the fp32 partials live in scratch
    that the stream reuses once both launches behind the entry are done."""
    partial = None
    if plan.split > 1:
        B, Hkv, Sk, D = k.shape
        partial = torch.empty((2, B, Hkv, plan.split, Sk, D),
                              dtype=torch.float32, device=k.device)
    _launch("flash_bwd_dkv", "mx_flash_bwd_dkv",
            (q, k, v, do, lse, delta, dk, dv, partial), q, k, causal,
            sm_scale, (_VARIANTS[plan.variant], plan.dkv_rows, plan.split),
            plan.dkv_label)


def _backward_inner(q, k, v, lse, delta, do, causal, sm_scale):
    """(dq, dk, dv) from a given (lse, delta) — the split of the JAX
    package's `_pallas_backward_inner`, kept so that ring attention can run
    per-block backwards against the global lse. On CUDA tensors: the dq
    kernel, then the dk/dv kernel (GQA group-sum inside it, or behind it
    where the plan splits the group), as `flash_bwd_plan` picks them."""
    if not _on_cuda(q):
        return _ref_backward_inner(q, k, v, lse, delta, do, causal, sm_scale)
    _check_backward(q, k, v, lse, delta, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    plan = _device_plan(q, k)
    _launch_dq(q, k, v, do, lse, delta, dq, causal, sm_scale, plan)
    _launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, sm_scale, plan)
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
