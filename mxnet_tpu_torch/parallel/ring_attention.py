"""Ring attention: sequence parallelism over the ranks of a ``seq`` group
(the port of `mxnet_tpu.parallel.ring_attention`).

Each rank holds one contiguous chunk of the sequence: q (B, H, S/n, D) and
k, v (B, Hkv, S/n, D). The K/V chunks travel the ring (rank r sends to
r+1 and receives from r-1, `torch.distributed.batch_isend_irecv`), only at
their Hkv heads, and each step's exchange runs while the current block
computes. Every block is the flash kernel #1 through its (o, lse) form:
full blocks non-causal, the diagonal block causal, the blocks after the
diagonal skipped under a causal mask; the partials merge by their
logsumexps (`_merge_blocks`, the JAX package's). The backward is a second
ring pass through kernels #2/#3 (`flash_attention._backward_inner`)
against the global lse: dq accumulates at home, and the dk/dv
accumulators travel with their K/V chunks and arrive home after n steps.

The exchange is injectable (``comm=``): `RingExchange` over a process
group by default; anything with ``world``, ``rank`` and ``shift(tensors)
-> handle`` (``handle.wait()`` returns what came from the previous rank)
serves, so an in-process fleet of threads can drive the same code on one
card.
"""
from __future__ import annotations

import torch

from .flash_attention import _backward_inner, _delta, _flash_forward

__all__ = ["ring_attention", "RingExchange"]

_NEG_INF = -1e30


class _Done:
    __slots__ = ("_out",)

    def __init__(self, out):
        self._out = out

    def wait(self):
        return self._out


class _Posted:
    __slots__ = ("_reqs", "_out")

    def __init__(self, reqs, out):
        self._reqs, self._out = reqs, out

    def wait(self):
        for r in self._reqs:
            r.wait()
        self._reqs = ()
        return self._out


class RingExchange:
    """The ring of `axis_name`'s group (a name of the current mesh, a
    ProcessGroup, or None for the world)."""

    def __init__(self, axis_name="seq"):
        from .collectives import resolve_group
        self.group, self.world, self.rank = resolve_group(axis_name)
        self._ranks = None
        if self.world > 1:
            import torch.distributed as tdist
            self._ranks = (tdist.get_process_group_ranks(self.group)
                           if self.group is not None
                           else list(range(self.world)))

    def shift(self, tensors):
        """Post the sends of `tensors` to the next rank and the receives
        from the previous one; returns a handle."""
        if self.world == 1:
            return _Done(list(tensors))
        import torch.distributed as tdist
        nxt = self._ranks[(self.rank + 1) % self.world]
        prv = self._ranks[(self.rank - 1) % self.world]
        outs = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, o in zip(tensors, outs):
            ops.append(tdist.P2POp(tdist.isend, t.contiguous(), nxt,
                                   self.group))
            ops.append(tdist.P2POp(tdist.irecv, o, prv, self.group))
        return _Posted(tdist.batch_isend_irecv(ops), outs)


def _merge_blocks(o_run, lse_run, o_blk, lse_blk):
    """Two normalized partials combined by their logsumexps (fp32)."""
    m = torch.maximum(lse_run, lse_blk)
    wa = torch.exp(lse_run - m)
    wb = torch.exp(lse_blk - m)
    l = wa + wb
    o = (o_run * wa[..., None] + o_blk * wb[..., None]) / l[..., None]
    return o, m + torch.log(l)


def _kind(src, my, causal):
    """"full", "diag" or "skip" for the block of chunk `src` seen from
    chunk `my`."""
    if not causal or src < my:
        return "full"
    return "diag" if src == my else "skip"


def _ring_forward(q, k, v, causal, sm_scale, comm):
    n, my = comm.world, comm.rank
    B, H, Sq, _ = q.shape
    o_run = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_run = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32,
                         device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (my - step) % n
        pending = comm.shift([k_cur, v_cur]) if step < n - 1 else None
        kind = _kind(src, my, causal)
        if kind != "skip":
            o_blk, lse_blk = _flash_forward(q, k_cur, v_cur, kind == "diag",
                                            sm_scale)
            o_run, lse_run = _merge_blocks(o_run, lse_run, o_blk.float(),
                                           lse_blk)
        if pending is not None:
            k_cur, v_cur = pending.wait()
    return o_run.to(q.dtype), lse_run


def _ring_backward(q, k, v, o, lse, do, causal, sm_scale, comm):
    n, my = comm.world, comm.rank
    delta = _delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (my - step) % n
        pending = comm.shift([k_cur, v_cur]) if step < n - 1 else None
        kind = _kind(src, my, causal)
        if kind != "skip":
            dq_b, dk_b, dv_b = _backward_inner(q, k_cur, v_cur, lse, delta,
                                               do, kind == "diag", sm_scale)
            dq += dq_b.float()
            dk += dk_b.float()
            dv += dv_b.float()
        # dk/dv travel with their chunk and are home after n shifts
        dk, dv = comm.shift([dk, dv]).wait()
        if pending is not None:
            k_cur, v_cur = pending.wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, comm):
        o, lse = _ring_forward(q, k, v, causal, sm_scale, comm)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.sm_scale, ctx.comm = causal, sm_scale, comm
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, o, lse, do.contiguous(),
                                    ctx.causal, ctx.sm_scale, ctx.comm)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, axis_name="seq", causal=False, sm_scale=None,
                   comm=None, return_lse=False):
    """Attention of this rank's q chunk over the whole ring's K/V,
    differentiable in q, k, v.

    q: (B, H, S/n, D); k, v: (B, Hkv, S/n, D), chunk r of the sequence on
    rank r of `axis_name`'s group (or of `comm`). Returns o (B, H, S/n, D)
    in q's dtype, and with `return_lse` the fp32 (B, H, S/n) logsumexp.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if comm is None:
        comm = RingExchange(axis_name)
    if q.shape[2] != k.shape[2]:
        raise ValueError("ring_attention: q and k chunks differ in length "
                         "(%d vs %d)" % (q.shape[2], k.shape[2]))
    o, lse = _RingAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                  comm)
    return (o, lse) if return_lse else o
