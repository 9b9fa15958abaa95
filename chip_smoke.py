"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (one JSON line each; any failure exits non-zero):

1. build       — nvcc builds every kernel source of the paths from csrc/
                 (one nvcc per source, all started together).
2. kernel      — the forward kernel against its plain PyTorch version on
                 the card, at the main path's shapes and a few edge shapes,
                 with timings beside its bound and a library call's time.
   kernel_bwd  — the two backward kernels (dq; dk/dv) against the plain
                 backward, likewise, at the training shapes and edge shapes.
3. forward     — llama_110m (bf16, full width, 12 layers, seeded random
                 weights): llama_forward on 4 x 512 tokens through the
                 flash-attention kernel, against the same model with the
                 plain attention.
4. prefill     — llama_prefill_paged of one 300-token prompt into the pool.
5. serve       — InferenceServer (batch 8, 512 KV blocks of 16): 16
                 requests, ~2/3 sharing a 48-token system prompt, 32 new
                 tokens each, plus 2 oversized requests that must be shed.
6. consistency — the same traffic at fp32: every greedy token equals the
                 argmax of the kernel-backed llama_forward, except where
                 the top-2 margin is under 1e-3 (counted and printed).
7. train       — llama_110m bf16, full width and depth: ShardedTrainStep
                 (llama_loss, adamw, lr 3e-4), 6 steps on one seeded
                 8 x 1025 token batch; then one step split into
                 forward+loss / backward / optimizer by CUDA events, and the
                 loss gradient: at bf16 through the backward kernels vs the
                 plain backward, at fp32 through all kernels vs plain
                 attention, and both bf16 paths vs the fp32 gradient.
8. train_gqa   — llama3_8b_dry (8B widths, 2 layers, GQA 32/8, D 128,
                 remat, one-hot embedding): 3 steps on 2 x 513 tokens.
   train_profile — torch.profiler over 2 more steps: device time by
                 kernel group and the device's idle share of the window.
9. checkpoint  — the train phase's state saved after steps 5 and 6,
                 restored bit-equal, one more step from each copy equal; a
                 corrupted step 6 falls back to step 5.

Two main paths, each with its own expected kernels, counts set to 0 just
before and read just after: serving (phases 3-5: flash_fwd) and training
(phase 7's 6 steps: flash_fwd, flash_bwd_dq, flash_bwd_dkv). Then the
card's name and power limit, the `kernels` line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

BF16_ATOL = BF16_RTOL = 2e-2    # bf16 o: p is rounded to bf16 in the plain
FP32_ATOL = 1e-4                # fp32 o: summation order only
LSE_ATOL = 1e-3
LOGITS_REL = 2e-2               # ||a - b|| / ||b|| of bf16 model logits
MARGIN = 1e-3                   # fp32 consistency: near-ties exempt
BWD_BF16_REL = 2e-2             # ||a - b|| / ||b|| of bf16 dq, dk, dv: P is
                                # rounded to bf16 as an mma operand, and the
                                # outputs to bf16
BWD_FP32_ATOL = 1e-4            # fp32 dq, dk, dv: summation order only
GRAD_REL = 2e-2                 # per-leaf ||a - b|| / ||b|| of model
                                # gradients: bf16 with the backward kernels
                                # vs the plain backward (same forward), and
                                # fp32 with all kernels vs plain attention
SERVE_KERNELS = ("flash_fwd",)
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def check(cond, phase, msg):
    if not cond:
        fail(phase, msg)


def time_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype):
    """(ms, "operations" | "bytes"): the larger of the two least times."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(B, H, Hkv, Sq, Sk, D, causal, dtype):
    flops = 4.0 * B * H * Sq * Sk * D * (0.5 if causal else 1.0)
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * D * (2 * B * H * Sq + 2 * B * Hkv * Sk)
    return bound(flops, nbytes, dtype)


def backward_bounds(B, H, Hkv, Sq, Sk, D, causal, dtype):
    """{kernel: (ms, by)}. dq recomputes S and dP and forms dS K: 3
    products; dk/dv recompute S and dP and form P^T dO and dS^T Q: 4; each
    2 * B * H * Sq * Sk * D flops, halved when causal. Bytes: each input
    read once (q, dO, k, v; lse and delta fp32), each output written once
    (dq; dk and dv)."""
    prod = 2.0 * B * H * Sq * Sk * D * (0.5 if causal else 1.0)
    size = torch.tensor([], dtype=dtype).element_size()
    q_rows, kv_rows = size * D * B * H * Sq, size * D * B * Hkv * Sk
    rows = 4 * 2 * B * H * Sq
    return {"flash_bwd_dq": bound(3 * prod, 3 * q_rows + 2 * kv_rows + rows,
                                  dtype),
            "flash_bwd_dkv": bound(4 * prod,
                                   2 * q_rows + 4 * kv_rows + rows, dtype)}


def phase_build():
    from mxnet_tpu_torch.ops import KERNELS
    from mxnet_tpu_torch.ops._build import build, build_log
    t0 = time.perf_counter()
    seconds = build(list(KERNELS))
    sources = sorted({source for source, _ in KERNELS.values()})
    ptxas = {src: [ln.strip() for ln in (build_log(src) or "").splitlines()
                   if "registers" in ln or "spill" in ln]
             for src in sources}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": seconds, "ptxas": ptxas})


def phase_kernel(gen):
    """flash_attention kernel vs _ref_forward; returns the kernels-line
    entry measured at the forward phase's shape."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.parallel.flash_attention import (_flash_forward,
                                                          _ref_forward)
    shapes = [
        # name, B, H, Hkv, Sq, Sk, D, causal, dtype, timed
        ("forward_path", 4, 12, 12, 512, 512, 64, True, torch.bfloat16, True),
        ("llama_110m_s1024", 4, 12, 12, 1024, 1024, 64, True,
         torch.bfloat16, True),
        ("llama3_8b_layer_gqa", 1, 32, 8, 2048, 2048, 128, True,
         torch.bfloat16, True),
        ("prefill_path", 1, 12, 12, 304, 304, 64, True, torch.bfloat16,
         False),
        ("fp32_77x301", 2, 4, 2, 77, 301, 64, False, torch.float32, False),
        ("fp32_77x301_causal", 2, 4, 2, 77, 301, 128, True, torch.float32,
         False),
    ]
    entry = None
    for name, B, H, Hkv, Sq, Sk, D, causal, dtype, timed in shapes:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
        q, k, v = rnd(B, H, Sq, D), rnd(B, Hkv, Sk, D), rnd(B, Hkv, Sk, D)
        sc = D ** -0.5
        o, lse = _flash_forward(q, k, v, causal, sc)
        o_ref, lse_ref = _ref_forward(q, k, v, causal, sc)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs()
        lse_err = (lse - lse_ref).abs().max().item()
        if dtype == torch.bfloat16:
            ok_o = bool((err <= BF16_ATOL
                         + BF16_RTOL * o_ref.float().abs()).all())
        else:
            ok_o = err.max().item() <= FP32_ATOL
        rec = {"phase": "kernel", "kernel": "flash_fwd", "shape": name,
               "B": B, "H": H, "Hkv": Hkv, "Sq": Sq, "Sk": Sk, "D": D,
               "causal": causal, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
               "finite": bool(torch.isfinite(o).all())}
        if timed:
            g = H // Hkv
            ke, ve = (k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)) \
                if g > 1 else (k, v)
            rec["ms"] = time_ms(lambda: _flash_forward(q, k, v, causal,
                                                          sc))
            rec["plain_ms"] = time_ms(lambda: _ref_forward(q, k, v,
                                                              causal, sc),
                                      iters=5)
            # yardstick only: the port never calls it
            rec["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                       is_causal=causal))
            rec["bound_ms"], rec["bound_by"] = attention_bound(
                B, H, Hkv, Sq, Sk, D, causal, dtype)
        emit(rec)
        check(rec["finite"] and ok_o and lse_err <= LSE_ATOL, "kernel",
              "flash_fwd disagrees with _ref_forward at %s" % name)
        if name == "forward_path":
            entry = rec
    return entry


def phase_kernel_bwd(gen):
    """The backward kernels vs the plain backward; returns {kernel: the
    kernels-line entry measured at the training path's shape}."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.parallel.flash_attention import (_delta, _launch,
                                                          _flash_backward,
                                                          _flash_forward,
                                                          _ref_backward)
    shapes = [
        # name, B, H, Hkv, Sq, Sk, D, causal, dtype, timed
        ("train_path", 8, 12, 12, 1024, 1024, 64, True, torch.bfloat16,
         True),
        ("llama3_8b_dry_gqa", 2, 32, 8, 512, 512, 128, True, torch.bfloat16,
         True),
        ("bf16_160_gqa", 2, 4, 2, 160, 160, 64, True, torch.bfloat16, False),
        ("bf16_200_d128", 1, 4, 4, 200, 200, 128, True, torch.bfloat16,
         False),
        ("bf16_130x70_causal", 1, 2, 2, 130, 70, 64, True, torch.bfloat16,
         False),
        ("fp32_77x301", 2, 4, 2, 77, 301, 64, False, torch.float32, False),
        ("fp32_77x301_causal", 2, 4, 2, 77, 301, 64, True, torch.float32,
         False),
        ("fp32_77x301_d128", 2, 4, 2, 77, 301, 128, False, torch.float32,
         False),
        ("fp32_77x301_causal_d128", 2, 4, 2, 77, 301, 128, True,
         torch.float32, False),
    ]
    entries = {}
    for name, B, H, Hkv, Sq, Sk, D, causal, dtype, timed in shapes:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
        q, k, v = rnd(B, H, Sq, D), rnd(B, Hkv, Sk, D), rnd(B, Hkv, Sk, D)
        do = rnd(B, H, Sq, D)
        sc = D ** -0.5
        o, lse = _flash_forward(q, k, v, causal, sc)
        got = _flash_backward(q, k, v, o, lse, do, causal, sc)
        want = _ref_backward(q, k, v, o, lse, do, causal, sc)
        torch.cuda.synchronize()
        rec = {"phase": "kernel_bwd", "shape": name, "B": B, "H": H,
               "Hkv": Hkv, "Sq": Sq, "Sk": Sk, "D": D, "causal": causal,
               "dtype": str(dtype).split(".")[-1]}
        ok = True
        for grad, a, b in zip(("dq", "dk", "dv"), got, want):
            a, b = a.float(), b.float()
            rec[grad + "_max_abs_err"] = (a - b).abs().max().item()
            rec[grad + "_rel_err"] = rel_err(a, b)
            rec[grad + "_norm"] = b.norm().item()
            finite = bool(torch.isfinite(a).all())
            if dtype == torch.bfloat16:
                ok &= finite and rec[grad + "_rel_err"] <= BWD_BF16_REL
            else:
                ok &= finite and rec[grad + "_max_abs_err"] <= BWD_FP32_ATOL
        if timed:
            delta = _delta(o, do)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            rec["ms"] = {
                "flash_bwd_dq": time_ms(lambda: _launch(
                    "flash_bwd_dq", "mx_flash_bwd_dq",
                    (q, k, v, do, lse, delta, dq), q, k, causal, sc)),
                "flash_bwd_dkv": time_ms(lambda: _launch(
                    "flash_bwd_dkv", "mx_flash_bwd_dkv",
                    (q, k, v, do, lse, delta, dk, dv), q, k, causal, sc))}
            # the plain version computes dq, dk and dv together
            rec["plain_ms"] = time_ms(lambda: _ref_backward(
                q, k, v, o, lse, do, causal, sc), iters=5)
            # yardstick only: the backward of PyTorch's own attention (dq,
            # dk and dv together; K/V repeated over the group beforehand)
            g = H // Hkv
            qs, ks, vs = (t.detach().clone().requires_grad_() for t in (
                q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)))
            out = F.scaled_dot_product_attention(qs, ks, vs,
                                                 is_causal=causal)
            rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
                out, (qs, ks, vs), do, retain_graph=True))
            rec["bound"] = backward_bounds(B, H, Hkv, Sq, Sk, D, causal,
                                           dtype)
        emit(rec)
        check(ok, "kernel_bwd",
              "backward kernels disagree with _ref_backward at %s" % name)
        if name == "train_path":
            for kern, err in (("flash_bwd_dq", rec["dq_max_abs_err"]),
                              ("flash_bwd_dkv", max(rec["dk_max_abs_err"],
                                                    rec["dv_max_abs_err"]))):
                entries[kern] = {
                    "max_abs_err": err, "ms": rec["ms"][kern],
                    "plain_ms": rec["plain_ms"],
                    "library_ms": rec["library_ms"],
                    "bound_ms": rec["bound"][kern][0],
                    "bound_by": rec["bound"][kern][1]}
    return entries


class _PlainBackward(torch.autograd.Function):
    """Attention whose backward is the backward kernels' plain version
    (`_ref_backward`, on dense fp32 tensors); the forward is `fwd`: the
    forward kernel or its plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, fwd):
        o, lse = fwd(q, k, v, causal, q.shape[-1] ** -0.5)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        from mxnet_tpu_torch.parallel.flash_attention import _ref_backward
        q, k, v, o, lse = ctx.saved_tensors
        return _ref_backward(q, k, v, o, lse, do, ctx.causal,
                             q.shape[-1] ** -0.5) + (None, None)


@contextlib.contextmanager
def _attention_as(fwd):
    from mxnet_tpu_torch.models import llama
    saved = llama.flash_attention
    llama.flash_attention = lambda q, k, v, causal=False: \
        _PlainBackward.apply(q, k, v, causal, fwd)
    try:
        yield
    finally:
        llama.flash_attention = saved


def plain_attention():
    """llama_forward, and its gradient, with the flash kernels' plain
    versions in their place."""
    from mxnet_tpu_torch.parallel.flash_attention import _ref_forward
    return _attention_as(_ref_forward)


def plain_backward():
    """The forward kernel with the backward kernels' plain version: the
    model's gradient then differs from the kernel path's only by the
    backward kernels."""
    from mxnet_tpu_torch.parallel.flash_attention import _flash_forward
    return _attention_as(_flash_forward)


def rel_err(a, b):
    return ((a - b).norm() / b.norm()).item()


def phase_forward(params, cfg, gen):
    from mxnet_tpu_torch.models.llama import llama_forward
    from mxnet_tpu_torch.ops import launch_counts
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                           device="cuda")
    before = launch_counts()["flash_fwd"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = llama_forward(params, tokens, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()["flash_fwd"] - before
    with plain_attention():
        ref = llama_forward(params, tokens, cfg)
    rel = rel_err(logits, ref)
    rec = {"phase": "forward", "tokens": [4, 512], "ms": ms,
           "launches": launches, "logits_shape": list(logits.shape),
           "max_abs_diff_vs_plain": (logits - ref).abs().max().item(),
           "rel_err_vs_plain": rel,
           "argmax_agree": (logits.argmax(-1) == ref.argmax(-1))
           .float().mean().item()}
    emit(rec)
    check(launches == cfg.n_layers, "forward",
          "expected %d flash launches, saw %d" % (cfg.n_layers, launches))
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (4, 512, cfg.vocab_size),
          "forward", "non-finite or misshapen logits")
    check(rel <= LOGITS_REL, "forward", "logits differ from the plain path")
    return tokens


def phase_prefill(params, cfg, tokens):
    from mxnet_tpu_torch.models.llama import (init_kv_pools, llama_forward,
                                              llama_prefill_paged)
    from mxnet_tpu_torch.ops import launch_counts
    bs, length, S = 16, 300, 304
    pools = init_kv_pools(cfg, 512, bs, device="cuda")
    prompt = tokens[0, :length]
    padded = torch.zeros(S, dtype=torch.long, device="cuda")
    padded[:length] = prompt
    table = torch.arange(S // bs, device="cuda") + 7     # any blocks do
    before = launch_counts()["flash_fwd"]
    logits, pools = llama_prefill_paged(params, pools, padded, length, table,
                                        cfg, bs)
    torch.cuda.synchronize()
    launches = launch_counts()["flash_fwd"] - before
    ref = llama_forward(params, prompt[None], cfg)[0, -1]
    written = int((pools["0"]["k"].abs().sum(dim=(1, 2, 3)) > 0).sum())
    rel = rel_err(logits, ref)
    emit({"phase": "prefill", "length": length, "launches": launches,
          "rel_err_vs_forward": rel, "blocks_written": written})
    check(launches == cfg.n_layers, "prefill",
          "expected %d flash launches, saw %d" % (cfg.n_layers, launches))
    check(written == -(-length // bs), "prefill", "pool writes wrong")
    check(rel <= LOGITS_REL, "prefill", "logits differ from llama_forward")


def traffic(cfg):
    rng = np.random.RandomState(0)
    sys_prompt = rng.randint(1, cfg.vocab_size - 1, size=48).tolist()
    out = []
    for i in range(16):
        tail = rng.randint(1, cfg.vocab_size - 1,
                           size=rng.randint(2, 9)).tolist()
        out.append((sys_prompt + tail) if i % 3 else tail)
    return out


def serve_once(params, cfg, phase):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import InferenceServer, Overloaded, Request
    telemetry.reset()
    server = InferenceServer(params, cfg, max_batch=8, kv_blocks=512,
                             block_size=16, device="cuda").warmup()
    prompts = traffic(cfg)
    handles = [server.submit(Request(p, max_new_tokens=32)) for p in prompts]
    shed = 0
    for big in ([1] * 600, [2] * 40):
        try:
            server.submit(Request(big, max_new_tokens=10000))
        except Overloaded as exc:
            shed += exc.reason == "too_large"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [h.result(timeout=0) for h in handles]
    snap = telemetry.snapshot()
    in_use_before_clear = server.pool.blocks_in_use
    prefix_blocks = server.pool.prefix_blocks
    server.pool.clear_prefix_cache()
    hist = snap["histograms"]
    rec = {"phase": phase, "requests": len(handles), "shed": shed,
           "tokens": sum(len(o) for o in outs), "wall_s": wall,
           "tokens_per_s": sum(len(o) for o in outs) / wall,
           "ttft_ms_p50": hist["serve.ttft_ms"]["p50"],
           "ttft_ms_p99": hist["serve.ttft_ms"]["p99"],
           "tpot_ms_p50": hist["serve.tpot_ms"]["p50"],
           "tpot_ms_p99": hist["serve.tpot_ms"]["p99"],
           "prefix_hits": snap["counters"].get("serve.prefix.hits", 0),
           "prefill_chunks": snap["counters"].get("serve.prefill_chunks", 0),
           "kv_blocks_peak": snap["gauges"]["serve.kv.blocks_in_use"]["max"],
           "free_blocks_after": server.pool.free_blocks}
    emit(rec)
    check(all(len(o) == 32 for o in outs), phase, "a request fell short")
    check(shed == 2, phase, "oversized requests were not shed")
    check(in_use_before_clear == prefix_blocks, phase,
          "blocks held after every stream retired")
    check(server.pool.free_blocks == server.pool.num_blocks, phase,
          "blocks missing from the free list")
    return prompts, outs


def to_fp32(tree):
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    return tree.float()


def phase_consistency(params, cfg):
    from mxnet_tpu_torch.models.llama import llama_forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = to_fp32(params)
    prompts, outs = serve_once(p32, cfg32, "consistency_serve")
    checked = near_ties = 0
    for prompt, out in zip(prompts, outs):
        ctx = torch.tensor([prompt + out[:-1]], device="cuda")
        logits = llama_forward(p32, ctx, cfg32)[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        want = logits.argmax(-1).tolist()
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        for got, w, m in zip(out, want, margin):
            checked += 1
            if got != w:
                check(m < MARGIN, "consistency",
                      "token %d != argmax %d (margin %.3g)" % (got, w, m))
                near_ties += 1
    emit({"phase": "consistency", "tokens_checked": checked,
          "near_tie_mismatches": near_ties})


def tree_dtypes(tree):
    if isinstance(tree, dict):
        return {k: tree_dtypes(v) for k, v in tree.items()}
    return str(tree.dtype) if torch.is_tensor(tree) else type(tree).__name__


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + "/" + k)
    elif torch.is_tensor(tree):
        yield prefix, tree


def trees_equal(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def launches_per_step(before, after, steps):
    return {k: (after[k] - before[k]) / steps for k in after}


def run_steps(step, params, state, batch, n, phase, expect, first=0,
              on_step=None):
    """n training steps, each synchronised and timed on the host clock,
    with its kernel launches read around it."""
    from mxnet_tpu_torch.ops import launch_counts
    losses, times = [], []
    for i in range(n):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, step_num=first + i)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per = launches_per_step(before, launch_counts(), 1)
        check(all(per[k] == expect.get(k, 0) for k in per), phase,
              "step %d launched %s, expected %s" % (first + i, per, expect))
        if on_step is not None:
            on_step(first + i + 1, params, state)
    return params, state, losses, times


def model_grads(params, batch, cfg, context=contextlib.nullcontext):
    """{leaf: fp32 gradient of llama_loss} with the attention `context`
    gives (default: the kernels)."""
    from mxnet_tpu_torch.models.llama import llama_loss
    names = [n for n, _ in leaves(params)]
    flat = [t for _, t in leaves(params)]
    for t in flat:
        t.requires_grad_(True)
    try:
        with context():
            got = torch.autograd.grad(llama_loss(params, batch, cfg), flat)
    finally:
        for t in flat:
            t.requires_grad_(False)
    return dict(zip(names, (g.float() for g in got)))


def leaf_errs(a, b):
    """(worst leaf, its ||a - b|| / ||b||, median over leaves)."""
    errs = {n: rel_err(a[n], b[n]) for n in b}
    worst = max(errs, key=errs.get)
    return worst, errs[worst], statistics.median(errs.values())


def phase_train(gen, ckpt_dir):
    """llama_110m bf16 training; returns (params, state, batch, step,
    launches on the path)."""
    from mxnet_tpu_torch.models.llama import CONFIGS, llama_init, llama_loss
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.parallel import ShardedTrainStep, save_train_state
    cfg = CONFIGS["llama_110m"]
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 1025),
                                     generator=gen, device="cuda")}
    step = ShardedTrainStep(lambda p, b: llama_loss(p, b, cfg), params,
                            optimizer="adamw", lr=3e-4)
    params, state = step.init()
    dtypes = (tree_dtypes(params), tree_dtypes(state))
    n = cfg.n_layers
    expect = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}

    def save(done, p, s):
        if done in (5, 6):
            save_train_state(ckpt_dir, p, s, step=done)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    params, state, losses, times = run_steps(step, params, state, batch, 6,
                                             "train", expect, on_step=save)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    rec = {"phase": "train", "config": "llama_110m", "dtype": "bfloat16",
           "tokens": [8, 1024], "losses": losses, "step_ms": times,
           "median_step_ms_2_6": med, "tokens_per_s": 8 * 1024 / med * 1e3,
           "launches": launches, "max_memory_allocated_bytes": peak}
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "train",
          "losses not finite or not decreasing: %s" % losses)
    check(launches == {k: 6 * v for k, v in expect.items()}, "train",
          "launches on the training path %s" % launches)
    check((tree_dtypes(params), tree_dtypes(state)) == dtypes, "train",
          "a leaf changed dtype")
    emit(rec)
    return cfg, step, batch, params, state, launches


def phase_train_split(cfg, step, batch, params, state):
    """One more step split into forward+loss, backward and optimizer by
    CUDA events, then the gradient parity checks."""
    from mxnet_tpu_torch.models.llama import llama_loss
    from mxnet_tpu_torch.parallel.train_step import _leaves, _tmap
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    flat = list(_leaves(params))      # the order _tmap rebuilds
    for t in flat:
        t.requires_grad_(True)
    ev[0].record()
    loss = llama_loss(params, batch, cfg)
    ev[1].record()
    grads = torch.autograd.grad(loss, flat)
    ev[2].record()
    for t in flat:
        t.requires_grad_(False)
    it = iter(grads)
    step._opt_update(params, _tmap(lambda _: next(it), params), state,
                     step.lr, **step.opt_kwargs)
    ev[3].record()
    torch.cuda.synchronize()
    split = {"forward_loss": ev[0].elapsed_time(ev[1]),
             "backward": ev[1].elapsed_time(ev[2]),
             "optimizer": ev[2].elapsed_time(ev[3])}
    # gradient parity. bf16: the model's gradient through the backward
    # kernels vs the same forward with the plain backward. fp32 (params
    # cast): the whole kernel path vs plain attention. Both paths at bf16
    # are also held against the fp32 plain gradient: two bf16 runs of the
    # model differ by about as much as either differs from fp32, so that
    # comparison is reported beside its fp32 reference, not checked.
    g_k = model_grads(params, batch, cfg)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    bwd = leaf_errs(g_k, model_grads(params, batch, cfg, plain_backward))
    g_p = model_grads(params, batch, cfg, plain_attention)
    full_bf16 = leaf_errs(g_k, g_p)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = to_fp32(params)
    g_32 = model_grads(p32, batch, cfg32, plain_attention)
    fp32 = leaf_errs(model_grads(p32, batch, cfg32), g_32)
    del p32
    names = ("leaf", "rel_err", "median_rel_err")
    emit({"phase": "train_split", "split_ms": split, "loss": loss.item(),
          "grad_batch": int(batch["tokens"].shape[0]),
          "grad_bf16_bwd_kernels_vs_plain_bwd": dict(zip(names, bwd)),
          "grad_fp32_kernels_vs_plain": dict(zip(names, fp32)),
          "grad_bf16_kernels_vs_plain": dict(zip(names, full_bf16)),
          "grad_bf16_kernels_vs_fp32": dict(zip(names, leaf_errs(g_k, g_32))),
          "grad_bf16_plain_vs_fp32": dict(zip(names, leaf_errs(g_p, g_32)))})
    check(finite and bwd[1] <= GRAD_REL, "train_split",
          "bf16 gradient through the backward kernels differs from the "
          "plain backward's at %s" % bwd[0])
    check(fp32[1] <= GRAD_REL, "train_split",
          "fp32 gradient differs from the plain-attention one at %s"
          % fp32[0])


def kernel_group(name):
    n = name.lower()
    if "flash_bwd" in n:
        return "flash_bwd"
    if "flash_fwd" in n:
        return "flash_fwd"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    if any(t in n for t in ("softmax", "log_softmax", "nll", "gather",
                            "scatter", "index")):
        return "loss_and_embedding"
    return "elementwise_and_other"


def phase_train_profile(step, batch, params, state):
    """Two training steps under torch.profiler: device time per kernel
    group (summed over the CUDA kernels of the window) against the
    window's wall time; idle share = 1 - device time / wall time (one
    stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2):
            params, state, _ = step(params, state, batch, step_num=8 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, {}
    for ev in prof.key_averages():
        # the kernels themselves (CUPTI sees the ctypes-launched ones too),
        # not the CPU-side ops that launched them
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        g = kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(groups.values())
    rec = {"phase": "train_profile", "steps": 2, "wall_ms": wall_ms,
           "device_ms": device_ms,
           "idle_share": 1.0 - device_ms / wall_ms,
           "device_ms_by_group": groups,
           "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                  [:12])}
    emit(rec)
    check(device_ms > 0, "train_profile", "the profiler saw no device time")


def phase_train_gqa(gen):
    from mxnet_tpu_torch.models.llama import CONFIGS, llama_init, llama_loss
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    cfg = CONFIGS["llama3_8b_dry"]
    params = llama_init(torch.Generator(device="cuda").manual_seed(1), cfg)
    batch = torch.randint(0, cfg.vocab_size, (2, 513), generator=gen,
                          device="cuda")
    step = ShardedTrainStep(lambda p, b: llama_loss(p, b, cfg), params,
                            optimizer="adamw", lr=3e-4)
    params, state = step.init()
    n = cfg.n_layers
    # remat: each layer's forward runs again in the backward
    expect = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    torch.cuda.reset_peak_memory_stats()
    params, state, losses, times = run_steps(step, params, state, batch, 3,
                                             "train_gqa", expect)
    emit({"phase": "train_gqa", "config": "llama3_8b_dry",
          "tokens": [2, 512], "losses": losses, "step_ms": times,
          "launches_per_step": expect,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    check(all(np.isfinite(losses)), "train_gqa", "non-finite loss")
    del params, state


def phase_checkpoint(step, batch, params, state, ckpt_dir):
    """Restore step 6 into fresh tensors: bit-equal to the live state after
    step 6; one more step from each copy gives the same loss; a corrupted
    step 6 falls back to step 5."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import latest_step, restore_train_state
    p6, s6, n6 = restore_train_state(ckpt_dir)
    same = trees_equal(p6, params) and trees_equal(s6, state)
    check(n6 == 6 and latest_step(ckpt_dir) == 6 and same, "checkpoint",
          "restore of step 6 is not bit-equal to the live state")
    _, _, la = step(params, state, batch, step_num=6)
    _, _, lb = step(p6, s6, batch, step_num=6)
    la, lb = la.item(), lb.item()
    del p6, s6
    payload = os.path.join(ckpt_dir, "6", "state.pt")
    with open(payload, "r+b") as f:
        f.seek(os.path.getsize(payload) // 2)
        chunk = f.read(64)
        f.seek(-len(chunk), 1)
        f.write(bytes(b ^ 0xFF for b in chunk))
    telemetry.reset()
    _, _, n_back = restore_train_state(ckpt_dir)
    corrupt = telemetry.counter_value("checkpoint.corrupt")
    emit({"phase": "checkpoint", "restored_step": n6, "bit_equal": same,
          "next_loss_live": la, "next_loss_restored": lb,
          "after_corruption_restored_step": n_back,
          "checkpoint_corrupt": corrupt})
    check(la == lb, "checkpoint", "losses differ after restore")
    check(n_back == 5 and corrupt == 1, "checkpoint",
          "corrupted step 6 did not fall back to step 5")


def check_path(launches, expected, phase):
    """Every kernel of the path launched, and no other."""
    check(all((launches[k] > 0) == (k in expected) for k in launches),
          phase, "kernels of the path %s, launched: %s"
          % (list(expected), launches))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from mxnet_tpu_torch.models.llama import CONFIGS, llama_init
    from mxnet_tpu_torch.ops import (KERNELS, launch_counts,
                                     reset_launch_counts)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = {"flash_fwd": phase_kernel(gen)}
    entries.update(phase_kernel_bwd(gen))

    cfg = CONFIGS["llama_110m"]
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    # main path 1: serving
    reset_launch_counts()
    tokens = phase_forward(params, cfg, gen)
    phase_prefill(params, cfg, tokens)
    serve_once(params, cfg, "serve")
    serve_launches = launch_counts()
    check_path(serve_launches, SERVE_KERNELS, "main_path_serve")
    phase_consistency(params, cfg)
    del params

    # main path 2: training (counts reset inside, read right after step 6)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        cfg, step, batch, tparams, tstate, train_launches = phase_train(
            gen, ckpt)
        check_path(train_launches, TRAIN_KERNELS, "main_path_train")
        phase_checkpoint(step, batch, tparams, tstate, ckpt)
    phase_train_split(cfg, step, batch, tparams, tstate)
    phase_train_profile(step, batch, tparams, tstate)
    del tparams, tstate, step
    torch.cuda.empty_cache()
    phase_train_gqa(gen)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = entries[name]
        # launches on the main paths that run the kernel
        launches = serve_launches[name] + train_launches[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/" + source, "replaces": replaces,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
