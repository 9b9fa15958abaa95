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
10. kernel_cbr — the fused conv3x3 + folded-BN + ReLU kernel against its
                 plain version at ResNet-50's four bottleneck 3x3 shapes
                 (batch 64; bf16 and fp32, with and without a residual) and
                 at edge shapes, with timings beside its bound and the
                 cuDNN conv alone.
11. resnet_infer — resnet50_v1(layout="NHWC") with MXNET_TPU_FUSED_CONVBN=1
                 at full width and depth, seeded random weights and running
                 statistics, bf16: one predict-mode forward of 64 images at
                 224x224, checked against the same net on the CPU (fp32 and
                 bf16, 4 images); the composed net (gate off) as a second
                 route; a .params round trip on the card.
12. resnet_throughput — images/s at batch 64 and 256, batch-1 latency
                 p50/p99, peak memory, and torch.profiler over 2 forwards.
13. kernel_cbr_train — the training conv + batch statistics kernel
                 (conv_bn_stats) and the BN + ReLU backward kernel
                 (cbr_train_bwd) against their plain versions at ResNet-50's
                 four bottleneck 3x3 shapes (batch 256) and edge shapes, bf16
                 and fp32, with and without a residual, with timings.
14. kernel_opt — the flat SGD and Adam kernels against their plain versions
                 over every flag combination (bit for bit), timed at 25.6M
                 elements and over one ResNet-50 step's parameters.
15. resnet_train — resnet50_v1 NHWC fused, bf16 with fp32 BatchNorm,
                 224x224: FusedTrainStep + Trainer("sgd", lr 0.1, momentum
                 0.9) + SoftmaxCrossEntropyLoss, 8 steps at batch 256; the
                 imperative loop (record, backward, trainer.step) with
                 "adam", 3 steps at batch 64; both routes from one state;
                 one step's gradients against the CPU (fp32 and bf16);
                 all with cuDNN's deterministic algorithms, so that every
                 run checks the same numbers.
16. resnet_train_throughput — images/s of FusedTrainStep at batch 256, the
                 imperative step's time, peak memory, and torch.profiler
                 over one step.

17. kernel_lamb — LAMB's two kernels (flat_lamb1: moments, direction and
                 per-key squared norms; flat_lamb2: the trust-ratio apply)
                 against their plain versions over clip, bias correction,
                 mp, scalar/vector wd and scale, with and without norms,
                 fp32/bf16/fp16 and sizes 1, 7, 4097, twelve 768-element
                 keys and the 23.4M-element word embedding: elementwise
                 outputs at 0 ulps, norms within 1e-5; timed over one bf16
                 BERT-base step's buckets and one 133.5M-element vector.
18. bert_train — bert_12_768_12 (bf16, dropout 0, batch 128 x seq 128):
                 record -> SoftmaxCrossEntropyLoss on the MLM logits ->
                 backward -> Trainer("lamb", lr 1e-3, wd 0.01,
                 kvstore="device", zero=True).step, 6 steps; the ZeRO and
                 per-parameter LAMB routes at fp32 (batch 8); one fp32
                 batch-8 step's gradients against the CPU; a .params round
                 trip; the functional bert_mlm_loss at bert_base (bf16,
                 128 x 128) through the flash kernels, non-causal, against
                 plain attention.
19. bert_train_throughput — step time (median of steps 2-6), tokens/s,
                 peak memory, and torch.profiler over one step.
20. kernel_segment_sum — the segment-sum kernel against its plain version
                 (on the CPU) bit for bit: fp32/bf16/fp16 values, int32/int64
                 ids, widths 1, 3, 16, 64, 65, 129 and rank-3 rows, sorted
                 and shuffled ids with many duplicates, negative ids, nnz 0;
                 timed at the main paths' shapes (8192 x 64 into 1,000,001
                 rows; 128 x 16 into 10,131,228) beside its bytes bound and
                 torch's index_add_.
21. sparse_embed — bench.py::bench_sparse's loop at its accelerator shape:
                 kv.create("local"), ShardedEmbedding(1,000,000, 64, sgd,
                 lr 0.1), init_embedding, 20 steps of a row-sparse push of
                 the step's unique zipf ids and a row_sparse_pull of 256 of
                 them; pushed rows/s, lookup p50/p99, retraces, peak memory,
                 a profile of 2 steps; the table and the last pull against
                 the same 20 steps on the CPU.
22. dlrm_train — DLRM at the Criteo Kaggle widths (facebookresearch/dlrm
                 bench/dlrm_s_criteo_kaggle.sh: 26 tables, 33,762,577 rows of
                 16, bottom 13-512-256-64-16, top 367-512-256-1), each table a
                 ShardedEmbedding (sgd, lr 0.1) through embed_fn, the towers
                 by SGD: 10 steps at batch 128 (loss falling), the first 3
                 against the CPU, a profile of 2 steps, and one forward at
                 batch 16384.

Six main paths, each with its own expected kernels, counts set to 0 just
before and read just after: serving (phases 3-5: flash_fwd), training
(phase 7's 6 steps: flash_fwd, flash_bwd_dq, flash_bwd_dkv), ResNet-50
inference (phase 11's forward: conv_bn_relu, 16 launches), ResNet-50
training (phase 15: 16 conv_bn_stats, 16 cbr_train_bwd and one flat_sgd
per trainable parameter in each FusedTrainStep step; one flat_adam per
trainable parameter in each Adam step) and BERT-base pretraining (phase
18's 6 steps: one flat_lamb1 and one flat_lamb2 per ZeRO bucket a step;
its functional step: 12 launches of each flash kernel) and sparse
embeddings (phase 21's 20 pushes: 2 segment_sum a push; phase 22's 10
steps: 2 segment_sum per table a step). Then the card's
name and power limit, the `kernels` line, and as the last line {"ok":
true, "device": {...}}. Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
RESNET_KERNELS = ("conv_bn_relu",)

CBR_FP32_REL = 1e-4             # fp32 conv_bn_relu: max abs error over the
                                # output's max abs (summation order only)
CBR_BF16_ATOL = CBR_BF16_RTOL = 2e-2    # bf16 conv_bn_relu: both round the
                                # same fp32 value once; order differs
CBR_STAGES = [
    # name, N, H, W, Cin, Cout, launches per resnet50_v1 forward: the
    # bottleneck 3x3 convs of the four stages at batch 64
    ("stage1_56x56x64", 64, 56, 56, 64, 64, 3),
    ("stage2_28x28x128", 64, 28, 28, 128, 128, 4),
    ("stage3_14x14x256", 64, 14, 14, 256, 256, 6),
    ("stage4_7x7x512", 64, 7, 7, 512, 512, 3),
]
CBR_EDGES = [
    ("cin3_cout12", 2, 5, 5, 3, 12),
    ("image_1x1", 4, 1, 1, 64, 64),
    ("batch1_7x7", 1, 7, 7, 64, 64),
    ("cin20_cout36", 3, 9, 11, 20, 36),
]
RESNET_BATCH, RESNET_IMAGE = 64, 224
RESNET_BF16_REL = 2e-2          # bf16 logits vs the same net on the CPU:
                                # every layer rounds to bf16 on both sides
RESNET_FP32_REL = 1e-5          # fp32 logits vs the CPU: both paths fp32
                                # (TF32 off), so only the summation order
                                # differs; measured 2.9e-7 on an H100


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
        ("bert_base_path", 128, 12, 12, 128, 128, 64, False, torch.bfloat16,
         False),
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
        ("bert_base_path", 128, 12, 12, 128, 128, 64, False, torch.bfloat16,
         False),
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
    from mxnet_tpu_torch.models import bert, llama
    saved = llama.flash_attention
    llama.flash_attention = bert.flash_attention = \
        lambda q, k, v, causal=False: _PlainBackward.apply(q, k, v, causal,
                                                           fwd)
    try:
        yield
    finally:
        llama.flash_attention = bert.flash_attention = saved


def plain_attention():
    """llama_forward and bert_forward, and their gradients, with the flash
    kernels' plain versions in their place."""
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
    check(launches == {k: 6 * expect.get(k, 0) for k in launches}, "train",
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
    # model differ by about as much as either differs from fp32, so the
    # kernel path may be no further from the fp32 gradient than the plain
    # bf16 path is (x1.5 at the median leaf, x2 at the worst), as
    # bert_train holds its functional step
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
    k_vs_32, p_vs_32 = leaf_errs(g_k, g_32), leaf_errs(g_p, g_32)
    median_limit = max(GRAD_REL, 1.5 * p_vs_32[2])
    max_limit = max(GRAD_REL, 2.0 * p_vs_32[1])
    names = ("leaf", "rel_err", "median_rel_err")
    emit({"phase": "train_split", "split_ms": split, "loss": loss.item(),
          "grad_batch": int(batch["tokens"].shape[0]),
          "grad_bf16_bwd_kernels_vs_plain_bwd": dict(zip(names, bwd)),
          "grad_fp32_kernels_vs_plain": dict(zip(names, fp32)),
          "grad_bf16_kernels_vs_plain": dict(zip(names, full_bf16)),
          "grad_bf16_kernels_vs_fp32": dict(zip(names, k_vs_32)),
          "grad_bf16_plain_vs_fp32": dict(zip(names, p_vs_32)),
          "grad_bf16_vs_fp32_median_limit": median_limit,
          "grad_bf16_vs_fp32_max_limit": max_limit})
    check(finite and bwd[1] <= GRAD_REL, "train_split",
          "bf16 gradient through the backward kernels differs from the "
          "plain backward's at %s" % bwd[0])
    check(fp32[1] <= GRAD_REL, "train_split",
          "fp32 gradient differs from the plain-attention one at %s"
          % fp32[0])
    check(k_vs_32[2] <= median_limit and k_vs_32[1] <= max_limit,
          "train_split", "bf16 gradient through the kernels is further from "
          "the fp32 gradient than the plain bf16 path: median %s > %s or "
          "worst %s (%s) > %s" % (k_vs_32[2], median_limit, k_vs_32[1],
                                  k_vs_32[0], max_limit))


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


def cbr_work(N, H, W, C, Cout, residual, dtype):
    """conv_bn_relu's (flops, bytes): 2*N*H*W*9*C*Cout flops; x, w, out
    (and the residual) in the working dtype plus scale and shift in fp32,
    each moved once."""
    size = torch.tensor([], dtype=dtype).element_size()
    pix = N * H * W
    nbytes = size * (pix * C + 9 * C * Cout
                     + pix * Cout * (2 if residual else 1)) + 8 * Cout
    return 2.0 * pix * 9 * C * Cout, nbytes


def phase_kernel_cbr(gen):
    """conv_bn_relu vs _ref_conv_bn_relu on the card at ResNet-50's four
    bottleneck 3x3 shapes (batch 64; bf16 and fp32, with and without a
    residual) and at edge shapes. Returns the kernels-line entry: the
    bf16, residual-free stage shapes weighted by their launches in one
    resnet50_v1 forward (3, 4, 6, 3 of 16)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.fused_conv import (_ref_conv_bn_relu,
                                                conv_bn_relu, fold_bn_params)
    weighted = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
                "bytes": 0.0, "max_abs_err": 0.0}
    shapes = [(name, N, H, W, C, Co, n, True) for name, N, H, W, C, Co, n
              in CBR_STAGES] + [(name, N, H, W, C, Co, 0, False)
                                for name, N, H, W, C, Co in CBR_EDGES]
    for name, N, H, W, C, Co, per_forward, timed in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") \
                    * scale
            x = rnd(N, H, W, C).to(dtype)
            w = rnd(3, 3, C, Co, scale=(9 * C) ** -0.5).to(dtype)
            scale, shift = fold_bn_params(
                torch.rand(Co, generator=gen, device="cuda") + 0.5,
                rnd(Co, scale=0.1), rnd(Co, scale=0.1),
                torch.rand(Co, generator=gen, device="cuda") + 0.5)
            lib_ms = None
            if timed:
                # yardstick only: the conv alone through cuDNN (no single
                # PyTorch call adds the BN affine and ReLU); the port never
                # calls it
                xl = x.permute(0, 3, 1, 2)
                wl = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                lib_ms = time_ms(lambda: F.conv2d(xl, wl, padding=1))
            for res in (None, rnd(N, H, W, Co).to(dtype)):
                out = conv_bn_relu(x, w, scale, shift, res)
                ref = _ref_conv_bn_relu(x, w, scale, shift, res)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                out_scale = ref.float().abs().max().item()
                if dtype == torch.bfloat16:
                    ok = bool((err <= CBR_BF16_ATOL + CBR_BF16_RTOL
                               * ref.float().abs()).all())
                else:
                    ok = err.max().item() <= CBR_FP32_REL * max(out_scale,
                                                                1.0)
                rec = {"phase": "kernel_cbr", "kernel": "conv_bn_relu",
                       "shape": name, "NHWC": [N, H, W, C], "Cout": Co,
                       "dtype": str(dtype).split(".")[-1],
                       "residual": res is not None,
                       "max_abs_err": err.max().item(),
                       "out_max_abs": out_scale,
                       "finite": bool(torch.isfinite(out).all())}
                if timed:
                    rec["ms"] = time_ms(lambda: conv_bn_relu(x, w, scale,
                                                             shift, res))
                    rec["plain_ms"] = time_ms(lambda: _ref_conv_bn_relu(
                        x, w, scale, shift, res), iters=5)
                    rec["library_ms"] = lib_ms
                    rec["library"] = "conv only (cuDNN)"
                    work = cbr_work(N, H, W, C, Co, res is not None, dtype)
                    rec["bound_ms"], rec["bound_by"] = bound(*work, dtype)
                    if dtype == torch.bfloat16 and res is None:
                        for key in ("ms", "plain_ms", "library_ms"):
                            weighted[key] += per_forward * rec[key] / 16
                        weighted["flops"] += per_forward * work[0]
                        weighted["bytes"] += per_forward * work[1]
                        weighted["max_abs_err"] = max(
                            weighted["max_abs_err"], rec["max_abs_err"])
                emit(rec)
                check(rec["finite"] and ok, "kernel_cbr",
                      "conv_bn_relu disagrees with _ref_conv_bn_relu at %s "
                      "%s residual=%s" % (name, dtype, res is not None))
    bms, by = bound(weighted["flops"] / 16, weighted["bytes"] / 16,
                    torch.bfloat16)
    return {"max_abs_err": weighted["max_abs_err"], "ms": weighted["ms"],
            "plain_ms": weighted["plain_ms"],
            "library_ms": weighted["library_ms"], "bound_ms": bms,
            "bound_by": by}


def resnet50(fused):
    """resnet50_v1(classes=1000, layout="NHWC") with the fused gate on or
    off, named as in a fresh process."""
    import mxnet_tpu_torch as mx
    os.environ["MXNET_TPU_FUSED_CONVBN"] = "1" if fused else "0"
    with mx.name.NameManager():
        return mx.gluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                     layout="NHWC")


def randomize(net, seed, ctx, image=RESNET_IMAGE):
    """Seeded weights (Xavier, gaussian, fan-in, magnitude 2) and seeded
    BN parameters and running statistics: gamma and running_var in
    [0.5, 1.5), beta and running_mean N(0, 0.1^2), so the fold is not the
    identity."""
    import mxnet_tpu_torch as mx
    mx.random.seed(seed)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx)
    with mx.autograd.predict_mode():      # resolve the deferred shapes
        net(mx.nd.zeros((1, image, image, 3), ctx=ctx))
    g = torch.Generator(device=ctx.torch_device).manual_seed(seed)
    for name, p in net.collect_params().items():
        shape = p.shape
        if name.endswith(("gamma", "running_var")):
            p.set_data(mx.nd.array(torch.rand(shape, generator=g,
                                              device=ctx.torch_device)
                                   + 0.5, ctx=ctx))
        elif name.endswith(("beta", "running_mean")):
            p.set_data(mx.nd.array(torch.randn(shape, generator=g,
                                               device=ctx.torch_device)
                                   * 0.1, ctx=ctx))


def logits_of(net, x, ctx):
    import mxnet_tpu_torch as mx
    with mx.autograd.predict_mode():
        return net(mx.nd.array(x, ctx=ctx)).data_torch.float().cpu()


def host_copy(fused, path, dtype):
    """The same net, with the same weights, on the CPU (plain paths)."""
    import mxnet_tpu_torch as mx
    cpu_net = resnet50(fused)
    cpu_net.load_parameters(path, ctx=mx.cpu())
    cpu_net.cast(dtype)
    return cpu_net


def compare_logits(got, want, limit, phase, what):
    rel = rel_err(got, want)
    top1 = bool((got.argmax(1) == want.argmax(1)).all())
    check(bool(torch.isfinite(got).all()) and rel <= limit and top1, phase,
          "%s: logits rel. error %.3g (limit %g), top-1 equal %s"
          % (what, rel, limit, top1))
    return rel


def phase_resnet_infer(gen, tmp, batch=RESNET_BATCH, image=RESNET_IMAGE):
    """Main path 3: resnet50_v1 NHWC with the fused gate, bf16, one
    predict-mode forward of `batch` images through the Gluon entry points,
    counts reset just before and read just after. Checked against the same
    net on the CPU (fp32 and bf16, first 4 images), the composed net (gate
    off) as a second route, and a .params round trip on the card. Returns
    (net, launches on the path)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    gpu = mx.gpu(0)
    net = resnet50(True)
    randomize(net, 0, gpu, image)
    path = os.path.join(tmp, "resnet50_fused.params")
    net.save_parameters(path)
    x = torch.randn((batch, image, image, 3), generator=gen, device="cuda")
    x4 = x[:4].cpu()
    rel32 = compare_logits(logits_of(net, x[:4], gpu),
                           logits_of(host_copy(True, path, "float32"),
                                     x4, mx.cpu()),
                           RESNET_FP32_REL, "resnet_infer", "fp32 vs CPU")
    net.cast("bfloat16")
    xb = mx.nd.array(x.to(torch.bfloat16), ctx=gpu)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with mx.autograd.predict_mode():
        out = net(xb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    check_path(launches, RESNET_KERNELS, "main_path_resnet")
    check(launches["conv_bn_relu"] == 16, "resnet_infer",
          "expected 16 conv_bn_relu launches, saw %s" % launches)
    logits = out.data_torch.float()
    check(tuple(logits.shape) == (batch, 1000)
          and bool(torch.isfinite(logits).all()), "resnet_infer",
          "non-finite or misshapen logits")
    rel16 = compare_logits(
        logits[:4].cpu(), logits_of(host_copy(True, path, "bfloat16"),
                                    x4.to(torch.bfloat16), mx.cpu()),
        RESNET_BF16_REL, "resnet_infer", "bf16 vs CPU")

    # the composed route: gate off, cuDNN convs, no kernel
    cnet = resnet50(False)
    randomize(cnet, 0, gpu, image)
    cpath = os.path.join(tmp, "resnet50_composed.params")
    cnet.save_parameters(cpath)
    cnet.cast("bfloat16")
    reset_launch_counts()
    with mx.autograd.predict_mode():
        cout = cnet(xb).data_torch.float()
    torch.cuda.synchronize()
    composed_launches = launch_counts()
    check(not any(composed_launches.values()), "resnet_infer",
          "the composed net launched %s" % composed_launches)
    rel_c = compare_logits(
        cout[:4].cpu(), logits_of(host_copy(False, cpath, "bfloat16"),
                                  x4.to(torch.bfloat16), mx.cpu()),
        RESNET_BF16_REL, "resnet_infer", "composed bf16 vs CPU")
    del cnet

    # .params round trip on the card, bit-equal
    rt = os.path.join(tmp, "resnet50_bf16.params")
    net.save_parameters(rt)
    back = resnet50(True)
    back.cast("bfloat16")
    back.load_parameters(rt, ctx=gpu)
    mine = net._collect_params_with_prefix()
    theirs = back._collect_params_with_prefix()
    same = sorted(mine) == sorted(theirs) and all(
        mine[k].data().data_torch.dtype == theirs[k].data().data_torch.dtype
        and torch.equal(mine[k].data().data_torch,
                        theirs[k].data().data_torch) for k in mine)
    check(same, "resnet_infer", ".params round trip is not bit-equal")
    del back
    emit({"phase": "resnet_infer", "config": "resnet50_v1 NHWC fused",
          "batch": batch, "image": image, "dtype": "bfloat16",
          "first_forward_ms": ms, "launches": launches,
          "logits_shape": list(logits.shape),
          "rel_err_fp32_vs_cpu": rel32, "rel_err_bf16_vs_cpu": rel16,
          "composed_launches": composed_launches,
          "rel_err_composed_bf16_vs_cpu": rel_c,
          "params_round_trip_bit_equal": same})
    return net, launches


def infer_kernel_group(name):
    n = name.lower()
    if "cbr_" in n:
        return "conv_bn_relu"
    if any(t in n for t in ("fprop", "conv", "cudnn", "dgrad", "xmma")):
        return "cudnn_conv"
    if any(t in n for t in ("gemm", "cutlass", "nvjet", "cublas")):
        return "gemm"
    if "pool" in n:
        return "pooling"
    return "bn_and_elementwise"


def phase_resnet_throughput(net, gen, batches=(64, 256), image=RESNET_IMAGE):
    """Images/s (median of 10 forwards after 3 warm-ups, CUDA events) at
    each batch; batch-1 latency p50/p99 over 20 forwards; peak memory; and
    torch.profiler over 2 forwards at the first batch: device time by
    kernel group and the idle share of the window."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile

    def run(x):
        with mx.autograd.predict_mode():
            return net(x)

    def forward_ms(x, n, warmup):
        for _ in range(warmup):
            run(x)
        out = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(x)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def images(b):
        return mx.nd.array(torch.randn((b, image, image, 3), generator=gen,
                                       device="cuda").to(torch.bfloat16),
                           ctx=mx.gpu(0))

    rec = {"phase": "resnet_throughput", "dtype": "bfloat16",
           "image": image}
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        med = statistics.median(forward_ms(images(b), 10, 3))
        rec["batch%d_ms" % b] = med
        rec["batch%d_images_per_s" % b] = b / med * 1e3
    rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    lat = forward_ms(images(1), 20, 3)
    rec["batch1_ms_p50"] = float(np.percentile(lat, 50))
    rec["batch1_ms_p99"] = float(np.percentile(lat, 99))

    x = images(batches[0])
    run(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            run(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        g = infer_kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(groups.values())
    rec.update({"profile_forwards": 2, "profile_batch": batches[0],
                "profile_wall_ms": wall_ms, "profile_device_ms": device_ms,
                "idle_share": 1.0 - device_ms / wall_ms,
                "device_ms_by_group": groups,
                "top_kernels_ms": dict(sorted(top.items(),
                                              key=lambda kv: -kv[1])[:10])})
    emit(rec)
    check(device_ms > 0, "resnet_throughput",
          "the profiler saw no device time")


# --------------------------------------------------------------------------
# ResNet-50 training: kernels #5-#8 and main path 4
# --------------------------------------------------------------------------
CBR_TRAIN_STAGES = [
    # name, N, H, W, Cin, Cout, launches per training step: the bottleneck
    # 3x3 convs of the four stages at batch 256
    ("stage1_56x56x64", 256, 56, 56, 64, 64, 3),
    ("stage2_28x28x128", 256, 28, 28, 128, 128, 4),
    ("stage3_14x14x256", 256, 14, 14, 256, 256, 6),
    ("stage4_7x7x512", 256, 7, 7, 512, 512, 3),
]
CBR_TRAIN_EDGES = [
    ("cin3_cout12", 2, 5, 5, 3, 12),
    ("image_1x1", 4, 1, 1, 64, 64),
    ("batch1_7x7", 1, 7, 7, 64, 64),
    ("cin20_cout36", 3, 9, 11, 20, 36),
]
TRAIN_FP32_REL = 1e-5           # fp32 kernel outputs (#5, #6): max abs error
                                # over the output's max abs; summation order
                                # only
RESNET_TRAIN_KERNELS = ("conv_bn_stats", "cbr_train_bwd", "flat_sgd")
RESNET_ADAM_KERNELS = ("conv_bn_stats", "cbr_train_bwd", "flat_adam")
TRAIN_BATCH, TRAIN_STEPS = 256, 8
ADAM_BATCH, ADAM_STEPS = 64, 3
CPU_BATCH = 8
GRAD_FP32_REL = 1e-3            # per-leaf ||a - b|| / ||b|| of one step's
                                # gradients, card vs CPU, fp32: the
                                # summation order differs (TF32 off); the
                                # limit, or twice the card's own spread
                                # under a one-ulp input change where that
                                # is larger (phase_resnet_train)
GRAD_BF16_REL = 5e-2            # bf16, against the fp32 step: every layer
                                # rounds its output to bf16; the limit, or
                                # what the CPU's plain bf16 path shows


def bf16_ulp(t):
    """One bf16 ulp at each value of t (fp32 tensor of bf16 values)."""
    a = t.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def ulps_apart(a, b):
    """Elementwise distance in units in the last place of a and b (same
    float dtype, finite): the difference of their ordered integer
    images."""
    ib = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
          torch.float16: torch.int16}[a.dtype]
    x, y = a.contiguous().view(ib).long(), b.contiguous().view(ib).long()
    top = {torch.int32: 0x7FFFFFFF, torch.int16: 0x7FFF}[ib]
    x = torch.where(x < 0, -(x & top), x)
    y = torch.where(y < 0, -(y & top), y)
    return (x - y).abs()


def close_rel(a, b, rel):
    """max |a - b| <= rel * max |b| (fp32 compare)."""
    a, b = a.float(), b.float()
    err = (a - b).abs().max().item() if a.numel() else 0.0
    scale = b.abs().max().item() if b.numel() else 0.0
    return err, err <= rel * max(scale, 1e-30)


def cbr_train_works(N, H, W, C, Cout, residual, dtype):
    """{kernel: (flops, bytes)} of one training block: conv_bn_stats reads
    x and w and writes the conv output and the (2, Cout) sums;
    cbr_train_bwd reads conv_out and dy (and the residual) and six
    (Cout,) fp32 vectors and writes the fp32 dconv (and dres) and the sums
    (about 20 operations an element, far under the bytes)."""
    size = torch.tensor([], dtype=dtype).element_size()
    pix = N * H * W
    stats = (2.0 * pix * 9 * C * Cout,
             size * (pix * C + 9 * C * Cout + pix * Cout) + 8 * Cout)
    res = pix * Cout * size if residual else 0
    bwd = (20.0 * pix * Cout,
           size * 2 * pix * Cout + 2 * res + 4 * pix * Cout + 32 * Cout)
    return {"conv_bn_stats": stats, "cbr_train_bwd": bwd}


def phase_kernel_cbr_train(gen):
    """conv_bn_stats (#5) and cbr_train_bwd (#6) against their plain
    versions on the card at ResNet-50's four bottleneck 3x3 shapes (batch
    256) and edge shapes, bf16 and fp32, with and without a residual.
    Compared: the op's out, mean and var, and dconv, dgamma, dbeta, dres.
    Returns {kernel: kernels-line entry}: the bf16, residual-free stage
    shapes, weighted by their launches in one resnet50_v1 step (3, 4, 6, 3
    of 16)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.fused_conv import (_conv3x3_backward,
                                                _normalize_relu,
                                                _ref_cbr_train_bwd,
                                                _ref_conv_bn_stats,
                                                cbr_train_bwd, conv_bn_stats)
    names = ("conv_bn_stats", "cbr_train_bwd")
    # the fused blocks' dx/dw: PyTorch's conv backward in full fp32 from
    # the fp32 dconv (the reference's numerics), per training step
    dxdw = {"ms": 0.0, "flops": 0.0}
    weighted = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    "flops": 0.0, "bytes": 0.0, "max_abs_err": 0.0}
                for k in names}
    weighted["cbr_train_bwd"]["library_ms"] = None
    shapes = [(n, N, H, W, C, Co, k, True) for n, N, H, W, C, Co, k
              in CBR_TRAIN_STAGES] + [(n, N, H, W, C, Co, 0, False)
                                      for n, N, H, W, C, Co
                                      in CBR_TRAIN_EDGES]
    eps = 1e-3
    for name, N, H, W, C, Co, per_step, timed in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") \
                    * scale
            x = rnd(N, H, W, C).to(dtype)
            w = rnd(3, 3, C, Co, scale=(9 * C) ** -0.5).to(dtype)
            gamma = torch.rand(Co, generator=gen, device="cuda") + 0.5
            beta = rnd(Co, scale=0.1)
            dy = rnd(N, H, W, Co).to(dtype)
            M = N * H * W

            def stats(conv_fn):
                conv, s, sq = conv_fn(x, w)
                mean = s / M
                var = torch.clamp_min(sq / M - mean * mean, 0.0)
                return conv, mean, var, torch.rsqrt(var + eps)

            got, want = stats(conv_bn_stats), stats(_ref_conv_bn_stats)
            lib_ms = None
            if timed:
                # yardstick only: the conv alone through cuDNN on
                # channels-last tensors; the port never calls it
                xl = x.permute(0, 3, 1, 2)
                wl = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                lib_ms = time_ms(lambda: F.conv2d(xl, wl, padding=1))
            for res in (None, rnd(N, H, W, Co).to(dtype)):
                rec = {"phase": "kernel_cbr_train", "shape": name,
                       "NHWC": [N, H, W, C], "Cout": Co,
                       "dtype": str(dtype).split(".")[-1],
                       "residual": res is not None}
                outs = []
                for conv, mean, _, invstd in (got, want):
                    _, y = _normalize_relu(conv, mean, invstd, gamma, beta,
                                           res)
                    outs.append(torch.relu(y).to(dtype))
                torch.cuda.synchronize()
                bad = []           # the outputs out of their bound
                if not bool(torch.isfinite(got[0].float()).all()):
                    bad.append("conv_out finite")
                # #5: the conv output, and the op's out, mean and var
                if dtype == torch.bfloat16:
                    # bf16: one ulp of the larger of the two values (each
                    # side rounds its fp32 value once), plus the fp32
                    # summation order's share, which decides the rounding
                    # of values near zero; for out also what the conv
                    # output's difference moves it by (|gamma * invstd *
                    # dconv|)
                    moved = (gamma * want[3]).abs() * (
                        got[0].float() - want[0].float()).abs()
                    for key, a, b, extra in (
                            ("conv_out", got[0], want[0], 0.0),
                            ("out", outs[0], outs[1], moved)):
                        a, b = a.float(), b.float()
                        err = (a - b).abs()
                        rec[key + "_max_abs_err"] = err.max().item()
                        lim = bf16_ulp(torch.maximum(a.abs(), b.abs())) \
                            + extra + TRAIN_FP32_REL * b.abs().max()
                        if not bool((err <= lim).all()):
                            bad.append(key)
                else:
                    for key, a, b in (("conv_out", got[0], want[0]),
                                      ("out", outs[0], outs[1])):
                        rec[key + "_max_abs_err"], good = close_rel(
                            a, b, TRAIN_FP32_REL)
                        if not good:
                            bad.append(key)
                for key, i in (("mean", 1), ("var", 2)):
                    rec[key + "_max_abs_err"], good = close_rel(
                        got[i], want[i], TRAIN_FP32_REL)
                    if not good:
                        bad.append(key)
                # #6 on the same (plain) saved tensors
                conv, mean, _, invstd = want
                kb = cbr_train_bwd(conv, dy, mean, invstd, gamma, beta, res)
                pb = _ref_cbr_train_bwd(conv, dy, mean, invstd, gamma, beta,
                                        res)
                torch.cuda.synchronize()
                for key, a, b in zip(("dconv", "dgamma", "dbeta"), kb, pb):
                    rec[key + "_max_abs_err"], good = close_rel(
                        a, b, TRAIN_FP32_REL)
                    rec[key + "_max_abs"] = b.abs().max().item()
                    if not (good and bool(torch.isfinite(a).all())):
                        bad.append(key)
                if res is not None:
                    rec["dres_equal"] = bool(torch.equal(kb[3], pb[3]))
                    if not rec["dres_equal"]:
                        bad.append("dres")
                rec["out_of_bound"] = bad
                if timed:
                    works = cbr_train_works(N, H, W, C, Co, res is not None,
                                            dtype)
                    rec["ms"] = {
                        "conv_bn_stats": time_ms(
                            lambda: conv_bn_stats(x, w)),
                        "cbr_train_bwd": time_ms(lambda: cbr_train_bwd(
                            conv, dy, mean, invstd, gamma, beta, res))}
                    rec["plain_ms"] = {
                        "conv_bn_stats": time_ms(
                            lambda: _ref_conv_bn_stats(x, w), iters=5),
                        "cbr_train_bwd": time_ms(
                            lambda: _ref_cbr_train_bwd(
                                conv, dy, mean, invstd, gamma, beta, res),
                            iters=5)}
                    rec["library_ms"] = {"conv_bn_stats": lib_ms,
                                         "cbr_train_bwd": None}
                    rec["bound"] = {k: bound(*works[k], dtype)
                                    for k in names}
                    if dtype == torch.bfloat16 and res is None:
                        errs = {"conv_bn_stats": max(
                            rec["mean_max_abs_err"], rec["var_max_abs_err"],
                            rec["out_max_abs_err"]),
                            "cbr_train_bwd": max(
                                rec["dconv_max_abs_err"],
                                rec["dgamma_max_abs_err"],
                                rec["dbeta_max_abs_err"])}
                        for k in names:
                            acc = weighted[k]
                            acc["ms"] += per_step * rec["ms"][k] / 16
                            acc["plain_ms"] += \
                                per_step * rec["plain_ms"][k] / 16
                            if rec["library_ms"][k] is not None:
                                acc["library_ms"] += \
                                    per_step * rec["library_ms"][k] / 16
                            acc["flops"] += per_step * works[k][0] / 16
                            acc["bytes"] += per_step * works[k][1] / 16
                            acc["max_abs_err"] = max(acc["max_abs_err"],
                                                     errs[k])
                        rec["dxdw_fp32_ms"] = time_ms(
                            lambda: _conv3x3_backward(x, w, pb[0]), iters=5)
                        dxdw["ms"] += per_step * rec["dxdw_fp32_ms"]
                        dxdw["flops"] += per_step * 2 * 2.0 * N * H * W \
                            * 9 * C * Co
                emit(rec)
                check(not bad, "kernel_cbr_train",
                      "conv_bn_stats/cbr_train_bwd disagree with their plain "
                      "versions at %s %s residual=%s: %s"
                      % (name, dtype, res is not None, bad))
    emit({"phase": "kernel_cbr_train", "dxdw_fp32_ms_per_step": dxdw["ms"],
          "dxdw_flops_per_step": dxdw["flops"],
          "dxdw_bound_ms_per_step": dxdw["flops"] / PEAK_FLOPS[
              torch.float32] * 1e3})
    out = {}
    for k in names:
        acc = weighted[k]
        bms, by = bound(acc["flops"], acc["bytes"], torch.bfloat16)
        out[k] = {"max_abs_err": acc["max_abs_err"], "ms": acc["ms"],
                  "plain_ms": acc["plain_ms"],
                  "library_ms": acc["library_ms"], "bound_ms": bms,
                  "bound_by": by}
    return out


def opt_inputs(kind, n, wdt, gdt, sdt, mp, vec, gen):
    """Seeded inputs of one flat update: weights N(0, 1), gradients N(0,
    1), momentum and Adam's mean N(0, 0.1^2), Adam's var made from squared
    gradients (as training makes it), lr/wd per element when `vec`."""
    def rnd(scale=1.0):
        return torch.randn(n, generator=gen, device="cuda") * scale
    w = rnd().to(wdt)
    t = {"w": w, "g": rnd().to(gdt),
         "master": w.float().clone() if mp else None}
    if kind == "sgd":
        t["mom"] = rnd(0.1).to(sdt)
    else:
        t["mean"] = rnd(0.1).to(sdt)
        t["var"] = (0.1 * rnd() ** 2 + 0.9 * rnd() ** 2).to(sdt)
    if vec:
        t["lr"] = torch.rand(n, generator=gen, device="cuda") * 0.1
        t["wd"] = torch.rand(n, generator=gen, device="cuda") * 1e-3
    else:
        t["lr"], t["wd"] = 0.05, 1e-4
    return t


def run_flat(kind, fn, t, mom_on, clip_on, mp):
    """One update by `fn` (the kernel wrapper or the plain version):
    returns the outputs (weight, states, master)."""
    if kind == "sgd":
        out = fn(t["w"], t["g"], t["mom"], t["master"], t["lr"], t["wd"],
                 0.9, 1.0 / 256, 0.5, mom_on, clip_on, mp)
        return [out[0]] + ([out[1]] if mom_on else []) + \
            ([out[2]] if mp else [])
    out = fn(t["w"], t["g"], t["mean"], t["var"], t["master"], t["lr"],
             t["wd"], 0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8, 1.0 / 256,
             0.5, clip_on, mp)
    return list(out[:3]) + ([out[3]] if mp else [])


def clone_inputs(t):
    return {k: (v.clone() if torch.is_tensor(v) else v) for k, v in t.items()}


def opt_bytes(t, kind, mom_on, mp):
    """Bytes one update must move: w, g (and state, master) read, w (and
    state, master) written, lr/wd vectors read."""
    def nb(x):
        return x.numel() * x.element_size() if torch.is_tensor(x) else 0
    states = ([t["mom"]] if mom_on else []) if kind == "sgd" \
        else [t["mean"], t["var"]]
    rw = [t["w"]] + states + ([t["master"]] if mp else [])
    return 2 * sum(nb(x) for x in rw) + nb(t["g"]) + nb(t["lr"]) \
        + nb(t["wd"])


def resnet50_param_shapes():
    """(shape, dtype) of every trainable parameter of resnet50_v1 NHWC
    with the fused gate, cast to bf16 (BN parameters stay fp32)."""
    import mxnet_tpu_torch as mx
    net = resnet50(True)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 32, 32, 3), ctx=mx.cpu()))
    net.cast("bfloat16")
    return [(p.shape, p.data().data_torch.dtype)
            for p in net.collect_params().values() if p.grad_req != "null"]


def phase_kernel_opt(gen):
    """flat_sgd (#7) and flat_adam (#8) against their plain versions on
    the card: momentum on/off, clip on/off, mp on/off, scalar and
    per-element lr/wd, fp32 and bf16 weights (and a bf16 gradient with an
    fp32 weight), n = 1, 7, 4097. fp32 and bf16 outputs must be bit-equal
    to the plain version's; a difference of 1 ulp is allowed and printed
    with its count. Then times at n = 25.6M (ResNet-50's parameter count,
    one launch) and over one ResNet-50 step's parameters (one launch per
    parameter, as the main path runs them): the kernels-line entries."""
    from mxnet_tpu_torch.ops.fused_optimizer import (_ref_flat_adam,
                                                     _ref_flat_sgd, flat_adam,
                                                     flat_sgd)
    fns = {"sgd": (flat_sgd, _ref_flat_sgd),
           "adam": (flat_adam, _ref_flat_adam)}
    f32, b16 = torch.float32, torch.bfloat16
    worst = {"flat_sgd": 0, "flat_adam": 0}
    ulp_cases = []
    n_cases = 0
    for kind in ("sgd", "adam"):
        kernel, plain = fns[kind]
        for mom_on in ((True, False) if kind == "sgd" else (True,)):
            for clip_on in (True, False):
                for mp in (False, True):
                    for vec in (False, True):
                        for wdt, gdt in ((f32, f32), (b16, b16), (f32, b16)):
                            for n in (1, 7, 4097):
                                t = opt_inputs(kind, n, wdt, gdt, wdt, mp,
                                               vec, gen)
                                k = run_flat(kind, kernel, clone_inputs(t),
                                             mom_on, clip_on, mp)
                                p = run_flat(kind, plain, t, mom_on,
                                             clip_on, mp)
                                torch.cuda.synchronize()
                                n_cases += 1
                                for i, (a, b) in enumerate(zip(k, p)):
                                    d = ulps_apart(a, b)
                                    m = d.max().item()
                                    worst["flat_" + kind] = max(
                                        worst["flat_" + kind], m)
                                    if m:
                                        ulp_cases.append(
                                            [kind, mom_on, clip_on, mp, vec,
                                             str(wdt)[6:], str(gdt)[6:], n,
                                             i, m, int((d > 0).sum())])
    emit({"phase": "kernel_opt", "cases": n_cases,
          "max_ulps": worst, "cases_with_ulp_differences": ulp_cases})
    check(max(worst.values()) <= 1, "kernel_opt",
          "flat kernels differ from their plain versions by more than 1 ulp: "
          "%s" % ulp_cases)

    entries = {}
    shapes = resnet50_param_shapes()
    for kind, name in (("sgd", "flat_sgd"), ("adam", "flat_adam")):
        kernel, plain = fns[kind]
        for wdt in (b16, f32):
            n = 25_600_000
            t = opt_inputs(kind, n, wdt, wdt, wdt, False, False, gen)
            kt = clone_inputs(t)
            nbytes = opt_bytes(t, kind, True, False)
            rec = {"phase": "kernel_opt", "kernel": name, "n": n,
                   "dtype": str(wdt)[6:],
                   "ms": time_ms(lambda: run_flat(kind, kernel, kt, True,
                                                  False, False)),
                   "plain_ms": time_ms(lambda: run_flat(
                       kind, plain, t, True, False, False), iters=10),
                   "library_ms": None}
            rec["bound_ms"], rec["bound_by"] = bound(0.0, nbytes, f32)
            emit(rec)
        # one ResNet-50 step: one launch per trainable parameter, bf16
        # conv/dense weights and fp32 BN parameters, states in the
        # weight's dtype
        params = [opt_inputs(kind, int(np.prod(shape)), dt, dt, dt, False,
                             False, gen) for shape, dt in shapes]
        kparams = [clone_inputs(t) for t in params]
        nbytes = sum(opt_bytes(t, kind, True, False) for t in params)
        err = 0
        for kt, t in zip(kparams, params):
            for a, b in zip(run_flat(kind, kernel, clone_inputs(kt), True,
                                     False, False),
                            run_flat(kind, plain, clone_inputs(t), True,
                                     False, False)):
                err = max(err, (a.float() - b.float()).abs().max().item())
        rec = {"phase": "kernel_opt", "kernel": name,
               "resnet50_step_params": len(shapes),
               "elements": sum(int(np.prod(s)) for s, _ in shapes),
               "max_abs_err": err,
               "ms": time_ms(lambda: [run_flat(kind, kernel, kt, True,
                                               False, False)
                                      for kt in kparams], iters=10),
               "plain_ms": time_ms(lambda: [run_flat(kind, plain, t, True,
                                                     False, False)
                                            for t in params], iters=3),
               "library_ms": None}
        rec["bound_ms"], rec["bound_by"] = bound(0.0, nbytes, f32)
        emit(rec)
        entries[name] = {k: rec[k] for k in ("max_abs_err", "ms",
                                             "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")}
    return entries


def check_path(launches, expected, phase):
    """Every kernel of the path launched, and no other."""
    check(all((launches[k] > 0) == (k in expected) for k in launches),
          phase, "kernels of the path %s, launched: %s"
          % (list(expected), launches))


def train_net(seed, ctx, image=RESNET_IMAGE, dtype="bfloat16"):
    """resnet50_v1 NHWC with the fused gate: Xavier (gaussian) weights from
    mx.random.seed(seed), shapes resolved by one predict-mode pass, cast
    to `dtype` (BatchNorm stays fp32) and hybridized."""
    import mxnet_tpu_torch as mx
    net = resnet50(True)
    mx.random.seed(seed)
    net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=ctx)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, image, image, 3), ctx=ctx))
    net.cast(dtype)
    net.hybridize(static_alloc=True)
    return net


def train_batch(batch, image, ctx, dtype="bfloat16", seed=0):
    """One fixed batch from numpy with a seed: N(0, 1) images, uniform
    labels over the 1000 classes."""
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((batch, image, image, 3)).astype(np.float32)
    y = rng.randint(0, 1000, batch).astype(np.float32)
    return mx.nd.array(x, ctx=ctx, dtype=dtype), mx.nd.array(y, ctx=ctx)


def snapshot(net):
    """{structural name: a copy of the parameter's tensor}."""
    return {k: p.data().data_torch.detach().clone()
            for k, p in net._collect_params_with_prefix().items()}


def n_trainable(net):
    return sum(p.grad_req != "null" for p in net.collect_params().values())


def imperative_step(mx, net, loss_fn, trainer, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def phase_resnet_train(gen, tmp, batch=TRAIN_BATCH, image=RESNET_IMAGE,
                       steps=TRAIN_STEPS, adam_batch=ADAM_BATCH,
                       cpu_batch=CPU_BATCH):
    """Main path 4 with cuDNN held to its deterministic algorithms (see
    resnet_train_checks); resnet_train_throughput times the default ones."""
    torch.backends.cudnn.deterministic = True
    try:
        return resnet_train_checks(gen, tmp, batch, image, steps,
                                   adam_batch, cpu_batch)
    finally:
        torch.backends.cudnn.deterministic = False


def resnet_train_checks(gen, tmp, batch, image, steps, adam_batch,
                        cpu_batch):
    """Main path 4: bench.py's headline training configuration. resnet50_v1
    NHWC, fused gate, bf16 with fp32 BatchNorm, 224x224:
    FusedTrainStep(net, SoftmaxCrossEntropyLoss, Trainer("sgd", lr 0.1,
    momentum 0.9)) for `steps` steps on one seeded batch, counts reset just
    before and read just after; then the imperative loop (record ->
    backward -> trainer.step) with "adam" at lr 1e-3, 3 steps at
    `adam_batch`, counted likewise. Checks the launches per step, a finite
    and falling loss, the dtypes, moved running statistics, the two routes
    agreeing from one state, and one step against the same step on the
    CPU. cuDNN's default weight-gradient algorithms add in a varying order,
    so without the deterministic ones every weight after step 1, and with it
    the card-vs-CPU comparison's sample of rounding, changes from run to
    run. Returns (net, loss_fn, {kernel: launches on the path})."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    gpu = mx.gpu(0)
    net = train_net(0, gpu, image)
    n_train = n_trainable(net)
    dtypes = {k: t.dtype for k, t in snapshot(net).items()}
    stats0 = {k: t for k, t in snapshot(net).items() if "running" in k}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    step = mx.gluon.FusedTrainStep(net, loss_fn, trainer)
    x, y = train_batch(batch, image, gpu)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(x, y).asnumpy().item() for _ in range(steps)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    sgd_launches = launch_counts()
    check_path(sgd_launches, RESNET_TRAIN_KERNELS, "main_path_resnet_train")
    want = {"conv_bn_stats": 16 * steps, "cbr_train_bwd": 16 * steps,
            "flat_sgd": n_train * steps, "conv_bn_relu": 0, "flat_adam": 0}
    check(all(sgd_launches[k] == v for k, v in want.items()),
          "resnet_train", "FusedTrainStep launches %s, expected %s"
          % (sgd_launches, want))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "resnet_train", "loss not finite or not falling: %s" % losses)
    after = snapshot(net)
    check(all(after[k].dtype == dt for k, dt in dtypes.items()),
          "resnet_train", "a parameter changed its dtype")
    moved = sum(not torch.equal(after[k], v) for k, v in stats0.items())
    check(moved == len(stats0), "resnet_train",
          "%d of %d running statistics moved" % (moved, len(stats0)))

    # the two routes from one state, 2 SGD steps each (cuDNN deterministic,
    # so that only the route differs)
    path = os.path.join(tmp, "resnet50_train.params")
    net.save_parameters(path)
    xs, ys = train_batch(adam_batch, image, gpu, seed=1)
    routes = []
    for fused in (True, False):
        rnet = resnet50(True)
        rnet.cast("bfloat16")
        rnet.load_parameters(path, ctx=gpu)
        rtr = mx.gluon.Trainer(rnet.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
        rstep = mx.gluon.FusedTrainStep(rnet, loss_fn, rtr)
        for _ in range(2):
            if fused:
                rstep(xs, ys)
            else:
                imperative_step(mx, rnet, loss_fn, rtr, xs, ys)
        routes.append(snapshot(rnet))
        del rnet, rtr, rstep
    route_diff = max((a.float() - routes[1][k].float()).abs().max().item()
                     for k, a in routes[0].items())
    route_equal = all(torch.equal(a, routes[1][k])
                      for k, a in routes[0].items())
    check(route_equal, "resnet_train",
          "FusedTrainStep and the imperative loop differ by %g" % route_diff)

    # the imperative loop with Adam, counted
    atrainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
    torch.cuda.synchronize()
    reset_launch_counts()
    adam_losses = [imperative_step(mx, net, loss_fn, atrainer, xs, ys)
                   .asnumpy().mean().item() for _ in range(ADAM_STEPS)]
    torch.cuda.synchronize()
    adam_launches = launch_counts()
    check_path(adam_launches, RESNET_ADAM_KERNELS, "main_path_resnet_adam")
    want = {"conv_bn_stats": 16 * ADAM_STEPS,
            "cbr_train_bwd": 16 * ADAM_STEPS,
            "flat_adam": n_train * ADAM_STEPS, "flat_sgd": 0,
            "conv_bn_relu": 0}
    check(all(adam_launches[k] == v for k, v in want.items()),
          "resnet_train", "Adam loop launches %s, expected %s"
          % (adam_launches, want))
    check(all(np.isfinite(adam_losses)), "resnet_train",
          "Adam loss not finite: %s" % adam_losses)
    del atrainer

    # one step on the card against the same step on the CPU (plain
    # paths): the gradients of every leaf, fp32 and bf16
    net.save_parameters(path)
    xc, yc = train_batch(cpu_batch, image, mx.cpu(), "float32", seed=2)

    def grads_of(ctx, dtype, x=xc):
        cnet = resnet50(True)
        cnet.load_parameters(path, ctx=ctx, cast_dtype=True)
        cnet.cast(dtype)
        with mx.autograd.record():
            loss = loss_fn(cnet(x.astype(dtype).as_in_context(ctx)),
                           yc.as_in_context(ctx))
        loss.backward()
        return {k: p.grad().data_torch.float().cpu()
                for k, p in cnet._collect_params_with_prefix().items()
                if p.grad_req != "null"}

    card = {dt: grads_of(gpu, dt) for dt in ("float32", "bfloat16")}
    host = {dt: grads_of(mx.cpu(), dt) for dt in ("float32", "bfloat16")}
    # the card at fp32 with every input moved by one ulp: how far rounding
    # alone moves a leaf. A ReLU or max-pool input within rounding of its
    # threshold flips, and in a channel of M = N*H*W pixels one flipped term
    # moves a BatchNorm beta or gamma gradient by about 1/sqrt(M) of itself
    nudged = grads_of(gpu, "float32", mx.nd.array(torch.nextafter(
        xc.data_torch, torch.tensor(float("inf"))), ctx=mx.cpu()))
    # every conv bias of ResNetV1 feeds a batch-statistics BatchNorm, so
    # its gradient is zero in exact arithmetic (the batch mean takes the
    # bias out) and the computed one is rounding noise on both sides: those
    # leaves are held apart, to be small against the median leaf
    null = {k for k in host["float32"] if k.endswith(".bias")
            and not k.startswith("output.")}
    med_norm = statistics.median(g.norm().item()
                                 for g in host["float32"].values())

    def leaf_stats(a, b):
        errs = {k: rel_err(g, b[k]) for k, g in a.items() if k not in null}
        return {"median": statistics.median(errs.values()),
                "max": max(errs.values()),
                "worst_leaves": dict(sorted(errs.items(),
                                            key=lambda kv: -kv[1])[:5])}

    vs_cpu, failures = {}, []
    for dtype, limit in (("float32", GRAD_FP32_REL),
                         ("bfloat16", GRAD_BF16_REL)):
        noise = max(max(card[dtype][k].norm().item(),
                        host[dtype][k].norm().item())
                    for k in null) / med_norm if null else 0.0
        rec = {"card_vs_cpu": leaf_stats(card[dtype], host[dtype]),
               "limit": limit, "zero_gradient_leaves": len(null),
               "their_max_norm_over_median": noise}
        if dtype == "float32":
            # the CPU differs from the card by rounding only: held to the
            # limit, or to twice the card's own one-ulp spread where that
            # is larger (median and worst leaf alike)
            rec["one_ulp_input"] = leaf_stats(card[dtype], nudged)
            held, yard = rec["card_vs_cpu"], rec["one_ulp_input"]
        else:
            # bf16 against the fp32 step on the CPU (the reference here):
            # the card's bf16 path must be no further from it than the
            # CPU's plain bf16 path is, within 1.5x (median) and 2x (worst
            # leaf), or within the limit
            rec["card_vs_cpu_fp32"] = leaf_stats(card[dtype], host["float32"])
            rec["cpu_vs_cpu_fp32"] = leaf_stats(host[dtype], host["float32"])
            held, yard = rec["card_vs_cpu_fp32"], rec["cpu_vs_cpu_fp32"]
        factor = {"float32": (2.0, 2.0), "bfloat16": (1.5, 2.0)}[dtype]
        rec["median_limit"] = max(limit, factor[0] * yard["median"])
        rec["max_limit"] = max(limit, factor[1] * yard["max"])
        vs_cpu[dtype] = rec
        if noise > limit:
            failures.append("%s: conv biases before BatchNorm have gradients "
                            "of %.3g of the median leaf's (limit %g)"
                            % (dtype, noise, limit))
        if held["median"] > rec["median_limit"] \
                or held["max"] > rec["max_limit"]:
            failures.append("%s gradients: median %g (limit %g), worst %s "
                            "(limit %g)" % (dtype, held["median"],
                                            rec["median_limit"],
                                            held["worst_leaves"],
                                            rec["max_limit"]))
    emit({"phase": "resnet_train_vs_cpu", "batch": cpu_batch,
          "card_vs_cpu": vs_cpu})

    emit({"phase": "resnet_train", "config": "resnet50_v1 NHWC fused, bf16 "
          "(BatchNorm fp32), FusedTrainStep + sgd(lr 0.1, momentum 0.9)",
          "batch": batch, "image": image, "steps": steps,
          "trainable_params": n_train, "losses": losses,
          "steps_wall_s": wall_s, "launches": sgd_launches,
          "running_stats_moved": moved,
          "routes_bit_equal": route_equal, "routes_max_abs_diff": route_diff,
          "adam": {"batch": adam_batch, "steps": ADAM_STEPS,
                   "losses": adam_losses, "launches": adam_launches},
          "card_vs_cpu_batch": cpu_batch,
          "card_vs_cpu_max_leaf_rel_err": {
              k: v["card_vs_cpu"]["max"] for k, v in vs_cpu.items()}})
    check(not failures, "resnet_train", "; ".join(failures))
    paths = {k: sgd_launches[k] + adam_launches[k] for k in sgd_launches}
    return net, loss_fn, paths


def train_kernel_group(name):
    n = name.lower()
    if "cbr_mma_kernel<true" in n or "cbr_fma_kernel<true" in n \
            or "stats_col_sum" in n:
        return "conv_bn_stats"
    if "cbr_bwd" in n or "bwd_col_sum" in n:
        return "cbr_train_bwd"
    if "flat_sgd" in n:
        return "flat_sgd"
    if "flat_adam" in n:
        return "flat_adam"
    if any(t in n for t in ("dgrad", "wgrad", "bprop", "backward_data",
                            "backward_filter")):
        return "cudnn_conv_backward"
    if any(t in n for t in ("fprop", "conv", "cudnn", "xmma", "implicit")):
        return "cudnn_conv_forward"
    if any(t in n for t in ("gemm", "cutlass", "nvjet", "cublas")):
        return "gemm"
    if "pool" in n:
        return "pooling"
    return "bn_and_elementwise"


def phase_resnet_train_throughput(net, loss_fn, batch=TRAIN_BATCH,
                                  image=RESNET_IMAGE):
    """Images/s of FusedTrainStep at `batch` (median step of steps 3-10 by
    CUDA events), the imperative loop's step time, peak device memory, and
    torch.profiler over one step: device time by kernel group and the
    device's idle share of the step."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    gpu = mx.gpu(0)
    x, y = train_batch(batch, image, gpu, seed=3)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    step = mx.gluon.FusedTrainStep(net, loss_fn, trainer)

    def step_ms(fn, n):
        out = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused = step_ms(lambda: step(x, y), 10)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(fused[2:])
    imp = step_ms(lambda: imperative_step(mx, net, loss_fn, trainer, x, y),
                  4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top, by_op = {}, {}, {}
    for ev in prof.key_averages():
        if ev.key in ("aten::convolution", "aten::convolution_backward"):
            # the device time of every kernel under the op, whatever the
            # kernels are named (fp32 dx/dw of the fused blocks included)
            us = getattr(ev, "device_time_total", None)
            by_op[ev.key] = (ev.cuda_time_total if us is None else us) / 1e3
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        g = train_kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(groups.values())
    emit({"phase": "resnet_train_throughput", "dtype": "bfloat16",
          "batch": batch, "image": image,
          "fused_step_ms_median_3_10": med, "fused_step_ms": fused,
          "images_per_s": batch / med * 1e3,
          "imperative_step_ms_median": statistics.median(imp[1:]),
          "max_memory_allocated_bytes": peak,
          "profile_wall_ms": wall_ms, "profile_device_ms": device_ms,
          "idle_share": 1.0 - device_ms / wall_ms,
          "device_ms_by_group": groups, "conv_device_ms_by_op": by_op,
          "top_kernels_ms": dict(sorted(top.items(),
                                        key=lambda kv: -kv[1])[:12])})
    check(device_ms > 0, "resnet_train_throughput",
          "the profiler saw no device time")


LAMB_KERNELS = ("flat_lamb1", "flat_lamb2")
LAMB_NORM_REL = 1e-5            # per-key squared norms, kernel vs plain:
                                # fp32 sums in another order
ZERO_RTOL, ZERO_ATOL = 5e-5, 5e-6   # ZeRO vs per-parameter LAMB at fp32:
                                # the norms are summed in another order
                                # (the reference's bound, test_zero.py)
BERT_BATCH, BERT_SEQ, BERT_STEPS = 128, 128, 6
BERT_VOCAB, BERT_FN_CONFIG = 30522, "bert_base"
BERT_ROUTE_BATCH = BERT_CPU_BATCH = 8
EMBED_ROWS = 30522 * 768        # BERT-base's word embedding, one key
LAMB_ARGS = (0.9, 0.1, 0.999, 1.0 - 0.999, 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3,
             1e-6, 1.0 / 256, 0.5)   # beta1, omb1, beta2, omb2, d1, d2,
                                     # eps, rescale, clip


def lamb_inputs(n, wdt, mp, vec, gen):
    """Seeded inputs of one LAMB update: weights and gradients N(0, 1),
    mean N(0, 0.1^2), var from squared gradients (as training makes it),
    the moments fp32 under mp (the ZeRO state rule), wd and scale per
    element when `vec`."""
    def rnd(scale=1.0):
        return torch.randn(n, generator=gen, device="cuda") * scale
    sdt = torch.float32 if mp else wdt
    w = rnd().to(wdt)
    g = rnd()
    return {"w": w, "g": g.to(wdt), "mean": rnd(0.1).to(sdt),
            "var": (0.1 * g * g + 0.9 * rnd() ** 2).to(sdt),
            "master": w.float() if mp else None,
            "wd": torch.rand(n, generator=gen, device="cuda") * 1e-2
            if vec else 0.01,
            "scale": torch.rand(n, generator=gen, device="cuda") * 1e-3
            if vec else 1e-3}


def lamb_segments(n):
    """Key segments covering most of n elements, the rest padding."""
    if n < 8:
        return ((0, 0, n),) if n < 4 else ((0, 0, 3), (1, 3, n - 4))
    a = min(768, n // 3)
    return ((0, 0, a), (1, a, n - a - 300), (2, n - 300, 298))


def lamb_pass1(fn, t, clip, bias, mp, segs):
    """Pass 1 by `fn` (kernel or plain) on copies of the moments:
    (direction, mean, var, norms)."""
    return fn(t["w"], t["g"], t["mean"].clone(), t["var"].clone(),
              t["master"], t["wd"], *LAMB_ARGS, clip, mp, bias, segs,
              0 if segs is None else max(k for k, _, _ in segs) + 1)


def lamb_pass2(fn, t, gdir, mp):
    w = t["w"].clone()
    master = t["master"].clone() if mp else None
    return fn(w, master, gdir, t["scale"], mp)


def lamb_bytes(t, mp, norms, n_chunks=0, n_keys=0):
    """Bytes each pass must move: #9 reads w (or the master), g, mean,
    var, wd and writes the direction, mean and var (and the partials and
    norms); #10 reads w (or the master), the direction and the scale and
    writes w (and the master)."""
    def nb(x):
        return x.numel() * x.element_size() if torch.is_tensor(x) else 0
    w = t["master"] if mp else t["w"]
    b1 = nb(w) + nb(t["g"]) + 2 * nb(t["mean"]) + 2 * nb(t["var"]) \
        + nb(t["wd"]) + 4 * t["w"].numel()
    if norms:
        b1 += 12 * n_chunks + 8 * n_keys
    b2 = nb(w) + 4 * t["w"].numel() + nb(t["scale"]) + nb(t["w"]) \
        + (nb(t["master"]) if mp else 0)
    return b1, b2


def bert_param_shapes():
    """[(key, shape)] of bert_12_768_12's parameters in the order the
    Trainer pushes them: reverse registration order, registration being
    the sorted parameter names."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import bert
    net = bert.bert_12_768_12(dropout=0.0)
    net.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 8), ctx=mx.cpu()))
    params = net.collect_params()
    names = sorted(params.keys())
    return [(str(i), params[names[i]].shape)
            for i in reversed(range(len(names)))]


def phase_kernel_lamb(gen):
    """flat_lamb1 (#9) and flat_lamb2 (#10) against their plain versions on
    the card, then their times over one bf16 BERT-base step's ZeRO buckets
    and over one 133.5M-element vector: the kernels-line entries."""
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ops.fused_optimizer import (_ref_flat_lamb1,
                                                     _ref_flat_lamb2,
                                                     flat_lamb1, flat_lamb2,
                                                     lamb_chunk_table)
    f32, b16, f16 = torch.float32, torch.bfloat16, torch.float16
    worst = {"flat_lamb1": 0, "flat_lamb2": 0}
    norm_err, bad, n_cases = 0.0, [], 0
    sizes = [(n, False) for n in (1, 7, 4097)] + [(12 * 768 + 3, True),
                                                  (EMBED_ROWS, True)]
    for wdt in (f32, b16, f16):
        for n, large in sizes:
            flag_sets = [(False, True, False, True, True)] if large else \
                list(itertools.product((False, True), repeat=5))
            for clip, bias, mp, vec, with_norms in flag_sets:
                t = lamb_inputs(n, wdt, mp, vec, gen)
                if not vec and with_norms:
                    # one fp32 value on the card (the per-parameter path's
                    # lr x trust ratio); else a host scalar or per element
                    t["scale"] = torch.tensor(1e-3, device="cuda")
                segs = None
                if with_norms:
                    segs = tuple((k, 768 * k, 768) for k in range(12)) \
                        if n == 12 * 768 + 3 else ((0, 0, n),) \
                        if n == EMBED_ROWS else lamb_segments(n)
                k1 = lamb_pass1(flat_lamb1, t, clip, bias, mp, segs)
                p1 = lamb_pass1(_ref_flat_lamb1, t, clip, bias, mp, segs)
                k2 = lamb_pass2(flat_lamb2, t, p1[0], mp)
                p2 = lamb_pass2(_ref_flat_lamb2, t, p1[0], mp)
                torch.cuda.synchronize()
                n_cases += 1
                case = [str(wdt)[6:], n, clip, bias, mp, vec, with_norms]
                for name, pairs in (("flat_lamb1", zip(k1[:3], p1[:3])),
                                    ("flat_lamb2", zip(k2, p2))):
                    for a, b in pairs:
                        if a is None:
                            continue
                        m = ulps_apart(a, b).max().item()
                        worst[name] = max(worst[name], m)
                        if m:
                            bad.append(case + [name, m])
                if with_norms:
                    rel = ((k1[3] - p1[3]).abs()
                           / p1[3].abs().clamp_min(1e-30)).max().item()
                    norm_err = max(norm_err, rel)
                del t, k1, p1, k2, p2
    emit({"phase": "kernel_lamb", "cases": n_cases, "max_ulps": worst,
          "norms_max_rel_err": norm_err, "cases_with_ulp_differences":
          bad[:20]})
    check(max(worst.values()) == 0 and norm_err <= LAMB_NORM_REL,
          "kernel_lamb", "LAMB kernels differ from their plain versions: "
          "%s ulps, norms %g (limit %g): %s" % (worst, norm_err,
                                                LAMB_NORM_REL, bad[:20]))

    # one bf16 BERT-base step: the ZeRO buckets the Trainer freezes
    shapes = bert_param_shapes()
    layout = engine.BucketLayout.from_entries(
        ((k, torch.empty(s, dtype=b16, device="meta")) for k, s in shapes),
        1, engine.bucket_bytes())
    buckets = []
    for spec in layout:
        by_key = {k: i for i, k in enumerate(spec.keys)}
        segs = tuple((by_key[k], s, ln) for k, s, ln, _
                     in spec.shard_segments(0))
        t = lamb_inputs(spec.shard, b16, False, True, gen)
        # the chunk table is built once per bucket, as ZeroUpdater does
        t["table"] = lamb_chunk_table(segs, len(segs), spec.shard, "cuda")
        buckets.append((t, segs, {"mean": t["mean"].clone(),
                                  "var": t["var"].clone()}))
    gdirs = [lamb_pass1(_ref_flat_lamb1, t, False, True, False, segs)[0]
             for t, segs, _ in buckets]

    def run1(fn):
        # in place on one set of moments per bucket: the real traffic
        return [fn(t["w"], t["g"], st["mean"], st["var"], None, t["wd"],
                   *LAMB_ARGS, False, False, True, segs, len(segs),
                   *([t["table"]] if fn is flat_lamb1 else []))
                for t, segs, st in buckets]

    def run2(fn):
        return [fn(t["w"], None, gd, t["scale"], False)
                for (t, _, _), gd in zip(buckets, gdirs)]

    b1 = b2 = 0
    for t, segs, _ in buckets:
        x1, x2 = lamb_bytes(t, False, True, t["table"][0].numel(), len(segs))
        b1, b2 = b1 + x1, b2 + x2
    elements = sum(t["w"].numel() for t, _, _ in buckets)
    step = {"buckets": len(layout), "keys": len(shapes),
            "elements": elements,
            "flat_lamb1_ms": time_ms(lambda: run1(flat_lamb1), iters=10),
            "flat_lamb1_plain_ms": time_ms(lambda: run1(_ref_flat_lamb1),
                                           iters=3),
            "flat_lamb2_ms": time_ms(lambda: run2(flat_lamb2), iters=10),
            "flat_lamb2_plain_ms": time_ms(lambda: run2(_ref_flat_lamb2),
                                           iters=3),
            "flat_lamb2_addcmul_ms": time_ms(lambda: [
                torch.addcmul(t["w"], t["scale"], gd, value=-1.0)
                for (t, _, _), gd in zip(buckets, gdirs)], iters=10)}
    step["flat_lamb1_bound_ms"], step["flat_lamb1_bound_by"] = \
        bound(0.0, b1, f32)
    step["flat_lamb2_bound_ms"], step["flat_lamb2_bound_by"] = \
        bound(0.0, b2, f32)
    emit(dict({"phase": "kernel_lamb", "what": "one bf16 BERT-base step's "
               "ZeRO buckets"}, **step))
    del buckets, gdirs

    # one 133.5M-element vector holding every key (one bucket, no cap)
    n = sum(int(np.prod(s)) for _, s in shapes)
    segs, off = [], 0
    for i, (_, s) in enumerate(shapes):
        segs.append((i, off, int(np.prod(s))))
        off += int(np.prod(s))
    segs = tuple(segs)
    t = lamb_inputs(n, b16, False, True, gen)
    table = lamb_chunk_table(segs, len(segs), n, "cuda")
    gd = lamb_pass1(_ref_flat_lamb1, t, False, True, False, segs)[0]
    x1, x2 = lamb_bytes(t, False, True, table[0].numel(), len(segs))
    whole = {"elements": n, "keys": len(segs),
             "flat_lamb1_ms": time_ms(lambda: flat_lamb1(
                 t["w"], t["g"], t["mean"], t["var"], None, t["wd"],
                 *LAMB_ARGS, False, False, True, segs, len(segs), table),
                 iters=10),
             "flat_lamb2_ms": time_ms(lambda: flat_lamb2(
                 t["w"], None, gd, t["scale"], False), iters=10),
             "flat_lamb2_addcmul_ms": time_ms(lambda: torch.addcmul(
                 t["w"], t["scale"], gd, value=-1.0), iters=10)}
    whole["flat_lamb1_bound_ms"], _ = bound(0.0, x1, f32)
    whole["flat_lamb2_bound_ms"], _ = bound(0.0, x2, f32)
    emit(dict({"phase": "kernel_lamb", "what": "one 133.5M-element vector"},
              **whole))
    del t, gd
    torch.cuda.empty_cache()
    return {"flat_lamb1": {"max_abs_err": float(worst["flat_lamb1"]),
                           "ms": step["flat_lamb1_ms"],
                           "plain_ms": step["flat_lamb1_plain_ms"],
                           "bound_ms": step["flat_lamb1_bound_ms"],
                           "bound_by": step["flat_lamb1_bound_by"],
                           "library_ms": None},
            "flat_lamb2": {"max_abs_err": float(worst["flat_lamb2"]),
                           "ms": step["flat_lamb2_ms"],
                           "plain_ms": step["flat_lamb2_plain_ms"],
                           "bound_ms": step["flat_lamb2_bound_ms"],
                           "bound_by": step["flat_lamb2_bound_by"],
                           "library_ms": step["flat_lamb2_addcmul_ms"]}}


def bert_net(ctx, dtype="bfloat16", path=None, seed=0):
    """bert_12_768_12 (dropout 0) on `ctx`: Normal(0.02) weights from
    mx.random.seed(seed) with the shapes resolved by one predict-mode pass,
    or the weights of `path`; cast to `dtype`."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import bert
    net = bert.bert_12_768_12(dropout=0.0)
    if path is None:
        mx.random.seed(seed)
        net.initialize(mx.init.Normal(0.02), ctx=ctx)
        with mx.autograd.predict_mode():
            net(mx.nd.zeros((1, 8), ctx=ctx))
        net.cast(dtype)
    else:
        net.cast(dtype)
        net.load_parameters(path, ctx=ctx, cast_dtype=True)
    net.hybridize(static_alloc=True)
    return net


def bert_batch(batch, ctx, seed=0):
    """BERT_SEQ token ids and MLM labels a row, uniform over the
    vocabulary, from numpy with a seed, as float32 arrays (bench.py's
    bench_bert_gluon)."""
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(seed)
    x = rng.randint(0, BERT_VOCAB, (batch, BERT_SEQ)).astype(np.float32)
    y = rng.randint(0, BERT_VOCAB, (batch, BERT_SEQ)).astype(np.float32)
    return mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)


def bert_step(mx, net, sce, trainer, x, y):
    with mx.autograd.record():
        loss = sce(net(x)[3], y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def bert_eval_loss(mx, net, sce, x, y):
    """The mean MLM loss in predict mode, its log-softmax on fp32 logits:
    a bf16 loss (ulp 0.0625 near ln(30522)) cannot show a few steps'
    progress."""
    with mx.autograd.predict_mode():
        out = net(x)[3].astype("float32")
        return sce(out, y).asnumpy().astype(np.float64).mean().item()


def lamb_trainer(mx, net, zero):
    return mx.gluon.Trainer(net.collect_params(), "lamb",
                            {"learning_rate": 1e-3, "wd": 0.01},
                            kvstore="device" if zero else None, zero=zero)


def bert_grads(mx, net, sce, x, y):
    with mx.autograd.record():
        loss = sce(net(x)[3], y)
    loss.backward()
    return {k: p.grad().data_torch.float().cpu()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def functional_bert_step(gen):
    """bert_mlm_loss at bert_base, bf16, batch x seq = 128 x 128, 15% of the
    positions predicted: forward, loss and backward through the flash
    kernels (causal=False), counted, against the same step with plain
    attention (bf16), and both against the plain step at fp32. Returns
    (record, launches)."""
    from mxnet_tpu_torch.models.bert import CONFIGS, bert_init, bert_mlm_loss
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = CONFIGS[BERT_FN_CONFIG]
    params = bert_init(gen, cfg, device=gen.device)
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (BERT_BATCH,
                                                       BERT_SEQ)),
             "targets": rng.randint(0, cfg.vocab_size, (BERT_BATCH,
                                                        BERT_SEQ)),
             "mask": (rng.rand(BERT_BATCH, BERT_SEQ) < 0.15)
             .astype(np.float32)}

    def grads(tree, context):
        names = [n for n, _ in leaves(tree)]
        flat = [t for _, t in leaves(tree)]
        for t in flat:
            t.requires_grad_(True)
        try:
            with context():
                loss = bert_mlm_loss(tree, batch, cfg)
                got = torch.autograd.grad(loss, flat)
        finally:
            for t in flat:
                t.requires_grad_(False)
        return loss.item(), dict(zip(names, (g.float() for g in got)))

    torch.cuda.synchronize()
    reset_launch_counts()
    loss, kern = grads(params, contextlib.nullcontext)
    torch.cuda.synchronize()
    launches = launch_counts()
    ploss, plain = grads(params, plain_attention)
    _, exact = grads(to_fp32(params), plain_attention)
    # the key bias adds q . bk to every score of a query row, which the
    # softmax takes out: its gradient is zero in exact arithmetic and
    # rounding noise on every path, so it is held apart (small against
    # the median leaf)
    null = [n for n in kern if n.endswith("bk")]
    med_norm = statistics.median(g.norm().item() for g in exact.values())
    noise = max(max(kern[n].norm().item(), plain[n].norm().item())
                for n in null) / med_norm
    for tree in (kern, plain, exact):
        for n in null:
            del tree[n]
    whole = rel_err(torch.cat([g.flatten() for g in kern.values()]),
                    torch.cat([plain[n].flatten() for n in kern]))

    def stats(a):
        errs = {n: rel_err(g, exact[n]) for n, g in a.items()}
        return {"median": statistics.median(errs.values()),
                "max": max(errs.values()),
                "worst_leaves": dict(sorted(errs.items(),
                                            key=lambda kv: -kv[1])[:4])}

    vs_fp32 = {"kernels": stats(kern), "plain": stats(plain)}
    rec = {"config": "%s bf16" % BERT_FN_CONFIG, "batch": BERT_BATCH,
           "seq": BERT_SEQ, "loss": loss, "plain_loss": ploss,
           "loss_rel_err": abs(loss - ploss) / abs(ploss),
           "grads_rel_err_vs_plain": whole,
           "grads_vs_fp32_step": vs_fp32,
           "median_limit": max(GRAD_REL,
                               1.5 * vs_fp32["plain"]["median"]),
           "max_limit": max(GRAD_REL, 2.0 * vs_fp32["plain"]["max"]),
           "key_bias_grad_norm_over_median": noise,
           "launches": {k: v for k, v in launches.items() if v}}
    return rec, launches


def phase_bert_train(gen, tmp):
    """Main path 5: BERT-base pretraining through Gluon with LAMB on the
    ZeRO updater. bert_12_768_12 (bf16, dropout 0), SoftmaxCrossEntropyLoss
    on the MLM logits (out[3]) over every position, Trainer("lamb", lr 1e-3,
    wd 0.01, kvstore="device", zero=True), BERT_STEPS steps on one seeded
    batch, counts reset just before and read just after; then the ZeRO and
    per-parameter routes at fp32, one step's gradients against the CPU, a
    .params round trip, and the functional bert_mlm_loss through the flash
    kernels. Returns (net, trainer, batch, {kernel: launches on the
    path})."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    gpu = mx.gpu(0)
    net = bert_net(gpu)
    dtypes = {k: t.dtype for k, t in snapshot(net).items()}
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = lamb_trainer(mx, net, True)
    x, y = bert_batch(BERT_BATCH, gpu)
    before = snapshot(net)
    eval_before = bert_eval_loss(mx, net, sce, x, y)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [bert_step(mx, net, sce, trainer, x, y).asnumpy().mean().item()
              for _ in range(BERT_STEPS)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    eval_after = bert_eval_loss(mx, net, sce, x, y)
    layout = trainer._kvstore._updater.layout
    check_path(launches, LAMB_KERNELS, "main_path_bert_train")
    want = {k: len(layout) * BERT_STEPS for k in LAMB_KERNELS}
    check(all(launches[k] == v for k, v in want.items()), "bert_train",
          "launches %s, expected %s a step for %d buckets"
          % (launches, want, len(layout)))
    check(all(np.isfinite(losses)) and eval_after < eval_before,
          "bert_train", "loss not finite or not falling: steps %s, fp32 "
          "loss before %r after %r" % (losses, eval_before, eval_after))
    after = snapshot(net)
    check(all(after[k].dtype == dt for k, dt in dtypes.items()),
          "bert_train", "a parameter changed its dtype")
    # a bf16 weight moves only where the step exceeds half its ulp
    moved = sum(int((after[k] != v).sum()) for k, v in before.items()) \
        / sum(v.numel() for v in before.values())
    del before
    path = os.path.join(tmp, "bert_base.params")
    net.save_parameters(path)

    # the .params round trip, bit for bit
    back = snapshot(bert_net(gpu, path=path))
    round_trip = sorted(back) == sorted(after) and all(
        torch.equal(t, back[k]) for k, t in after.items())
    del back
    check(round_trip, "bert_train", ".params round trip not bit-equal")

    # the ZeRO route against the per-parameter route (kvstore=None: #9 and
    # #10 once per parameter), fp32, 2 steps from one state
    xs, ys = bert_batch(BERT_ROUTE_BATCH, gpu, seed=1)
    routes, route_launches = [], []
    for zero in (True, None):
        rnet = bert_net(gpu, "float32", path)
        rtr = lamb_trainer(mx, rnet, zero)
        reset_launch_counts()
        for _ in range(2):
            bert_step(mx, rnet, sce, rtr, xs, ys)
        torch.cuda.synchronize()
        route_launches.append({k: v for k, v in launch_counts().items()
                               if v})
        routes.append(snapshot(rnet))
        del rnet, rtr
    excess = max(((a - routes[1][k]).abs() - ZERO_ATOL
                  - ZERO_RTOL * routes[1][k].abs()).max().item()
                 for k, a in routes[0].items())
    diff = max((a - routes[1][k]).abs().max().item()
               for k, a in routes[0].items())
    n_params = len(routes[0])
    check(excess <= 0, "bert_train", "ZeRO and per-parameter LAMB differ "
          "beyond rtol %g / atol %g (max abs %g)" % (ZERO_RTOL, ZERO_ATOL,
                                                     diff))
    check(route_launches[1].get("flat_lamb1") == 2 * n_params
          and route_launches[1].get("flat_lamb2") == 2 * n_params,
          "bert_train", "per-parameter route launches %s for %d parameters"
          % (route_launches[1], n_params))
    del routes
    torch.cuda.empty_cache()

    # one fp32 batch-8 step's gradients, card against CPU, held to the
    # card's own spread when every weight moves by one ulp
    xc, yc = bert_batch(BERT_CPU_BATCH, mx.cpu(), seed=2)
    card = bert_grads(mx, bert_net(gpu, "float32", path), sce,
                      xc.as_in_context(gpu), yc.as_in_context(gpu))
    nudged_net = bert_net(gpu, "float32", path)
    with torch.no_grad():
        for p in nudged_net.collect_params().values():
            d = p.data().data_torch
            d.copy_(torch.nextafter(d, torch.tensor(float("inf"),
                                                    device=d.device)))
    nudged = bert_grads(mx, nudged_net, sce, xc.as_in_context(gpu),
                        yc.as_in_context(gpu))
    del nudged_net
    host = bert_grads(mx, bert_net(mx.cpu(), "float32", path), sce, xc, yc)

    def stats(a, b):
        errs = {k: rel_err(g, b[k]) for k, g in a.items()
                if b[k].norm() > 0}
        return {"median": statistics.median(errs.values()),
                "max": max(errs.values()),
                "worst_leaves": dict(sorted(errs.items(),
                                            key=lambda kv: -kv[1])[:5])}

    vs_cpu, spread = stats(card, host), stats(card, nudged)
    median_limit = max(GRAD_FP32_REL, 2.0 * spread["median"])
    max_limit = max(GRAD_FP32_REL, 2.0 * spread["max"])
    del card, nudged, host
    torch.cuda.empty_cache()

    fn_rec, fn_launches = functional_bert_step(gen)
    emit({"phase": "bert_train", "config": "bert_12_768_12 bf16, dropout 0, "
          "Trainer(lamb lr 1e-3 wd 0.01, kvstore=device, zero=True)",
          "batch": BERT_BATCH, "seq": BERT_SEQ, "steps": BERT_STEPS,
          "losses": losses, "fp32_eval_loss_before": eval_before,
          "fp32_eval_loss_after": eval_after,
          "share_of_weights_moved": moved,
          "steps_wall_s": wall_s, "buckets": len(layout),
          "bucket_elements": [s.size for s in layout],
          "trainable_params": n_params, "launches": launches,
          "params_round_trip_bit_equal": round_trip,
          "zero_vs_per_parameter": {"batch": BERT_ROUTE_BATCH, "steps": 2,
                                    "max_abs_diff": diff,
                                    "max_excess_over_bound": excess,
                                    "launches": route_launches},
          "card_vs_cpu_fp32": {"batch": BERT_CPU_BATCH, "grads": vs_cpu,
                               "one_ulp_weights": spread,
                               "median_limit": median_limit,
                               "max_limit": max_limit},
          "functional_mlm_step": fn_rec})
    check(vs_cpu["median"] <= median_limit and vs_cpu["max"] <= max_limit,
          "bert_train", "fp32 gradients vs the CPU: median %g (limit %g), "
          "worst %s (limit %g)" % (vs_cpu["median"], median_limit,
                                   vs_cpu["worst_leaves"], max_limit))
    check(all(fn_launches[k] == 12 for k in TRAIN_KERNELS)
          and all(fn_launches[k] == 0 for k in fn_launches
                  if k not in TRAIN_KERNELS), "bert_train",
          "functional step launches %s, expected 12 of each flash kernel"
          % fn_launches)
    # bf16 query/key gradients of the deeper layers are rounding noise on
    # both paths (their fp32 step differs by several times their norm):
    # per leaf, the kernels may be no further from the fp32 step than the
    # plain bf16 path is (x1.5 median, x2 worst leaf), as resnet_train holds
    # bf16
    fk = fn_rec["grads_vs_fp32_step"]["kernels"]
    check(fn_rec["loss_rel_err"] <= GRAD_REL
          and fn_rec["grads_rel_err_vs_plain"] <= GRAD_REL
          and fk["median"] <= fn_rec["median_limit"]
          and fk["max"] <= fn_rec["max_limit"]
          and fn_rec["key_bias_grad_norm_over_median"] <= GRAD_REL,
          "bert_train", "functional step vs plain attention: %s" % fn_rec)
    paths = {k: launches[k] + fn_launches[k] for k in launches}
    return net, trainer, (x, y), paths


def bert_kernel_group(name):
    n = name.lower()
    if "lamb1" in n or "lamb_norms" in n:
        return "flat_lamb1"
    if "lamb2" in n:
        return "flat_lamb2"
    if any(t in n for t in ("gemm", "cutlass", "nvjet", "cublas", "xmma",
                            "sm90")):
        return "matmul"
    return "elementwise_ln_softmax_embedding_loss_copies"


def phase_bert_train_throughput(net, trainer, batch):
    """Step time of the main path (median of steps 2-6, CUDA events),
    tokens/s, peak memory, and torch.profiler over one step: device time by
    kernel group, the ZeRO legs (pack; update: #9, #10 and the trust-ratio
    scale, which is also timed alone; unpack) and the trainer's weight
    write-back by profiler range, and the idle share."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = batch
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(BERT_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        bert_step(mx, net, sce, trainer, x, y)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bert_step(mx, net, sce, trainer, x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = ("zero.pack", "zero.update", "zero.lamb_scale", "zero.unpack",
              "trainer.writeback")
    groups, top, legs = {}, {}, {}
    for ev in prof.key_averages():
        if ev.key in ranges:
            # the host-side range: the device time of the kernels launched
            # inside it, and its host time (the range also appears on the
            # device timeline as an annotation, which is no kernel)
            if ev.device_type == torch.autograd.DeviceType.CPU:
                us = getattr(ev, "device_time_total", None)
                legs[ev.key] = {
                    "kernels_device_ms": (ev.cuda_time_total if us is None
                                          else us) / 1e3,
                    "host_ms": ev.cpu_time_total / 1e3, "calls": ev.count}
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        g = bert_kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(groups.values())
    emit({"phase": "bert_train_throughput", "dtype": "bfloat16",
          "batch": BERT_BATCH, "seq": BERT_SEQ,
          "step_ms_median_2_6": med, "step_ms": times,
          "tokens_per_s": BERT_BATCH * BERT_SEQ / med * 1e3,
          "max_memory_allocated_bytes": peak,
          "profile_wall_ms": wall_ms, "profile_device_ms": device_ms,
          "idle_share": 1.0 - device_ms / wall_ms,
          "device_ms_by_group": groups, "zero_and_writeback_legs": legs,
          "top_kernels_ms": dict(sorted(top.items(),
                                        key=lambda kv: -kv[1])[:12])})
    check(device_ms > 0, "bert_train_throughput",
          "the profiler saw no device time")


# ---------------------------------------------------------------------------
# main path 6: sparse embeddings (kernel #11)
# ---------------------------------------------------------------------------
SPARSE_KERNELS = ("segment_sum",)
SPARSE_VOCAB, SPARSE_DIM, SPARSE_NNZ, SPARSE_STEPS = 1_000_000, 64, 8192, 20
SPARSE_REL = 1e-6               # table vs the CPU replay, over its max abs:
                                # each row takes one gradient a step, so the
                                # same fp32 ops give the same bits
DLRM_REL = 1e-5                 # loss, towers and tables vs the CPU: fp32
                                # matmuls sum in another order
# facebookresearch/dlrm bench/dlrm_s_criteo_kaggle.sh: the 26 Criteo Kaggle
# vocab sizes, --arch-sparse-feature-size=16, --arch-mlp-bot=13-512-256-64-16,
# --arch-mlp-top=512-256-1 (dot interaction: 16 + 27 * 26 / 2 = 367 wide),
# --mini-batch-size=128, --test-mini-batch-size=16384
KAGGLE_VOCABS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
                 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
                 7046547, 18, 15, 286181, 105, 142572)
DLRM_BATCH, DLRM_TEST_BATCH, DLRM_STEPS, DLRM_CPU_STEPS = 128, 16384, 10, 3
SEGSUM_MAIN = [
    # name, nnz, row, num_segments: the table update of a bench_sparse
    # push (8192 ascending ids into the 1,000,000 rows and the scratch
    # row) and of the largest Kaggle table at batch 128
    ("sparse_embed_update", 8192, (64,), SPARSE_VOCAB + 1),
    ("dlrm_largest_table", 128, (16,), KAGGLE_VOCABS[2] + 1),
]


def profile_window(fn):
    """fn() under torch.profiler: its wall time, the device time of its
    kernels, the idle share (one stream) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    top = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(top.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "top_kernels_ms": dict(sorted(top.items(),
                                          key=lambda kv: -kv[1])[:10])}


def segsum_ids(rng, nnz, segments, sort, low=0, unique=False):
    """Ids in [low, segments) with many duplicates, or ascending unique
    ids below the last segment (the main paths' case)."""
    if unique:
        return np.sort(rng.choice(segments - 1, size=nnz, replace=False))
    ids = rng.randint(low, segments, size=nnz)
    return np.sort(ids) if sort else ids


def phase_kernel_segment_sum(gen):
    """Kernel #11 against its plain version (run on the CPU, where it adds
    in occurrence order), bit for bit, over dtypes, id dtypes, widths,
    sorted and shuffled ids with many duplicates, negative ids and nnz 0;
    then at the main paths' shapes, timed beside its bound and torch's
    index_add_ (atomics) on the same non-negative ids."""
    from mxnet_tpu_torch.ops.sparse_ops import _segment_sum_plain, segment_sum
    rng = np.random.RandomState(0)
    cases, worst = [], 0.0

    def held(vals, ids, segments, what):
        nonlocal worst
        got = segment_sum(vals.cuda(), ids.cuda(), segments)
        torch.cuda.synchronize()
        want = _segment_sum_plain(vals, ids, segments)
        ok = got.shape == want.shape and got.dtype == want.dtype
        if ok and want.numel():
            got = got.cpu()
            worst = max(worst, (got.float() - want.float()).abs().max()
                        .item())
            ok = ulps_apart(got, want).max().item() == 0
        cases.append(what)
        check(ok, "kernel_segment_sum", "kernel differs from the plain "
              "version (%s)" % (what,))

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for id_dtype in (torch.int32, torch.int64):
            for row in ((1,), (3,), (16,), (64,), (65,), (129,), (3, 43)):
                for sort, low in ((True, 0), (False, -3)):
                    ids = torch.from_numpy(segsum_ids(rng, 4096, 600, sort,
                                                      low)).to(id_dtype)
                    vals = torch.randn((4096,) + row, generator=gen,
                                       device="cuda").cpu().to(dtype)
                    held(vals, ids, 1000, (str(dtype), str(id_dtype), row,
                                           sort, low))
            held(torch.zeros((0, 7), dtype=dtype),
                 torch.zeros((0,), dtype=id_dtype), 33, (str(dtype), "nnz 0"))
            held(torch.randn((300, 5), generator=gen, device="cuda").cpu()
                 .to(dtype), torch.full((300,), 4, dtype=id_dtype), 10 ** 6,
                 (str(dtype), "one run, segments far above the ids"))
    main = {}
    for name, nnz, row, segments in SEGSUM_MAIN:
        ids = torch.from_numpy(segsum_ids(rng, nnz, segments, True,
                                          unique=True)).to(torch.int32)
        vals = torch.randn((nnz,) + row, generator=gen, device="cuda")
        held(vals.cpu(), ids, segments, name)
        ids_c, ids64 = ids.cuda(), ids.cuda().long()
        # the output written once, the values and int32 ids read once
        nbytes = (segments + nnz) * row[0] * vals.element_size() + nnz * 4
        main[name] = {
            "nnz": nnz, "row": list(row), "num_segments": segments,
            "ms": time_ms(lambda: segment_sum(vals, ids_c, segments),
                          iters=20),
            "plain_ms": time_ms(lambda: _segment_sum_plain(
                vals, ids_c, segments), iters=20),
            "library_ms": time_ms(lambda: torch.zeros(
                (segments,) + row, device="cuda").index_add_(0, ids64, vals),
                iters=20),
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "bytes": nbytes}
    emit({"phase": "kernel_segment_sum", "cases": len(cases),
          "max_abs_err": worst, "main_shapes": main})
    head = main[SEGSUM_MAIN[0][0]]
    return {"max_abs_err": worst, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes"}


def sparse_traffic():
    """bench_sparse's traffic: zipf(1.3) ids modulo the vocab, unique per
    step, and fp32 gradient rows, from RandomState(0) in its order."""
    rng = np.random.RandomState(0)
    raw = rng.zipf(1.3, size=(SPARSE_STEPS, SPARSE_NNZ)).astype(np.int64) \
        % SPARSE_VOCAB
    batches = [np.unique(b).astype(np.int32) for b in raw]
    return [(ids, rng.randn(len(ids), SPARSE_DIM).astype(np.float32))
            for ids in batches]


def sparse_loop(mx, kv, ctx, traffic, lookup_ms=None):
    """bench_sparse's loop: push each step's row-sparse gradient, then
    row_sparse_pull its first 256 ids. Returns the last pull."""
    sp = mx.nd.sparse
    out = None
    for ids, grads in traffic:
        kv.push(0, sp.RowSparseNDArray(grads, ids,
                                       (SPARSE_VOCAB, SPARSE_DIM), ctx=ctx))
        out = sp.zeros("row_sparse", (SPARSE_VOCAB, SPARSE_DIM), ctx=ctx)
        t1 = time.perf_counter()
        kv.row_sparse_pull(0, out=out, row_ids=mx.nd.array(
            ids[:256], ctx=ctx, dtype="int32"))
        if lookup_ms is not None:
            torch.cuda.synchronize()
            lookup_ms.append((time.perf_counter() - t1) * 1e3)
    return out


def phase_sparse_embed():
    """bench.py::bench_sparse's loop at its accelerator shape on the card:
    kv.create("local"), ShardedEmbedding(1,000,000, 64, sgd, lr 0.1),
    init_embedding, 20 steps of push + row_sparse_pull; the table and the
    last pull held against the same 20 steps on the CPU. Returns the
    launches of the 20 steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.embedding import ShardedEmbedding
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    traffic = sparse_traffic()
    gpu = mx.gpu(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    table = ShardedEmbedding(SPARSE_VOCAB, SPARSE_DIM, optimizer="sgd",
                             learning_rate=0.1, name="bench.sparse")
    w0 = table.weight.cpu()
    kv = mx.kv.create("local")
    kv.init_embedding(0, table, max_batch=SPARSE_NNZ)
    telemetry.reset()
    lookup_ms = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    pulled = sparse_loop(mx, kv, gpu, traffic, lookup_ms)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    counters = telemetry.snapshot()["counters"]
    peak = torch.cuda.max_memory_allocated()
    got = table.gathered_weight().cpu()
    # the same 20 steps on the CPU, from the same table
    ctable = ShardedEmbedding(SPARSE_VOCAB, SPARSE_DIM, optimizer="sgd",
                              learning_rate=0.1, device="cpu", weight=w0)
    ckv = mx.kv.create("local")
    ckv.init_embedding(0, ctable, max_batch=SPARSE_NNZ)
    cpulled = sparse_loop(mx, ckv, mx.cpu(), traffic)
    want = ctable.gathered_weight()
    diff = (got - want).abs()
    err = diff.max().item()
    limit = SPARSE_REL * want.abs().max().item()
    worst_row = int(diff.max(dim=1).values.argmax())
    pushed = sum(len(ids) for ids, _ in traffic)
    prof = profile_window(lambda: sparse_loop(mx, kv, gpu, traffic[:2]))
    lookup_ms.sort()
    rec = {"phase": "sparse_embed", "vocab": SPARSE_VOCAB,
           "dim": SPARSE_DIM, "ids_per_step": SPARSE_NNZ,
           "steps": SPARSE_STEPS, "pushed_rows": pushed,
           "pushed_rows_per_s": pushed / dt, "seconds": dt,
           "lookup_ms_p50": lookup_ms[len(lookup_ms) // 2],
           "lookup_ms_p99": lookup_ms[min(len(lookup_ms) - 1,
                                          int(0.99 * len(lookup_ms)))],
           "serve_retraces": counters.get("serve.retrace", 0),
           "unique_rows": counters.get("embedding.push.unique_rows", 0),
           "launches": {k: v for k, v in launches.items() if v},
           "max_memory_allocated_bytes": peak,
           "table_vs_cpu_max_abs": err, "table_vs_cpu_limit": limit,
           "table_vs_cpu_ulps": ulps_apart(got, want).max().item(),
           "worst_row": worst_row, "profile_2_steps": prof}
    emit(rec)
    check(launches == {k: (2 * SPARSE_STEPS if k in SPARSE_KERNELS else 0)
                       for k in launches}, "sparse_embed",
          "launches %s, expected 2 segment_sum a push and nothing else"
          % launches)
    check(rec["serve_retraces"] == 0, "sparse_embed", "pulls retraced")
    check(rec["unique_rows"] == pushed, "sparse_embed",
          "unique rows %s, pushed %s" % (rec["unique_rows"], pushed))
    check(bool(torch.isfinite(got).all()) and err <= limit, "sparse_embed",
          "table differs from the CPU replay by %s (limit %s) at row %d"
          % (err, limit, worst_row))
    check(torch.equal(pulled._indices.cpu(), cpulled._indices)
          and torch.equal(pulled._values.cpu(), cpulled._values),
          "sparse_embed", "the last pull differs from the CPU replay's")
    check(prof["device_ms"] > 0, "sparse_embed",
          "the profiler saw no device time")
    return launches


def dlrm_batch(cfg, batch, seed, device):
    """Seeded dense features in [0, 1), zipf(1.3) ids per field modulo its
    vocab, Bernoulli(0.25) labels."""
    rng = np.random.RandomState(seed)
    dense = rng.rand(batch, cfg.dense_dim).astype(np.float32)
    ids = np.stack([rng.zipf(1.3, batch) % v for v in cfg.vocab_sizes],
                   axis=1).astype(np.int32)
    labels = (rng.rand(batch) < 0.25).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (dense, ids, labels))


def dlrm_leaves(towers):
    return [t for layer in towers["bottom"] + towers["top"]
            for t in layer.values()]


def dlrm_step(cfg, towers, tables, batch, lr=0.1):
    """One training step: look the rows up, forward and loss with the rows
    as leaves, backward, apply_grads for each table, SGD on the towers.
    Returns the loss (a 0-d tensor)."""
    from mxnet_tpu_torch.models.dlrm import dlrm_loss
    dense, ids, labels = batch
    rows = [t.lookup(ids[:, f]).requires_grad_()
            for f, t in enumerate(tables)]
    leaves = dlrm_leaves(towers)
    for p in leaves:
        p.requires_grad_(True)
    loss = dlrm_loss(towers, dense, ids, labels, cfg,
                     embed_fn=lambda f, _ids: rows[f])
    loss.backward()
    for f, t in enumerate(tables):
        t.apply_grads(ids[:, f], rows[f].grad)
    with torch.no_grad():
        for p in leaves:
            p -= lr * p.grad
            p.grad = None
    return loss.detach()


def phase_dlrm_train(gen):
    """DLRM at the Criteo Kaggle widths: 26 ShardedEmbedding tables (sgd,
    lr 0.1; 33,762,577 rows of 16) through embed_fn, the towers by plain
    SGD (lr 0.1), 10 steps on one seeded batch of 128; the first 3 steps
    held against the CPU; a forward at batch 16384. Returns the launches of
    the 10 steps."""
    from mxnet_tpu_torch.embedding import ShardedEmbedding
    from mxnet_tpu_torch.models.dlrm import (DLRMConfig, dlrm_forward,
                                             dlrm_init)
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = DLRMConfig(vocab_sizes=KAGGLE_VOCABS, embed_dim=16, dense_dim=13,
                     bottom_dims=(512, 256, 64), top_dims=(512, 256))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    towers = dlrm_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       with_tables=False)
    tables = [ShardedEmbedding(v, cfg.embed_dim, optimizer="sgd",
                               learning_rate=0.1, seed=f, name="t%d" % f)
              for f, v in enumerate(cfg.vocab_sizes)]
    table_bytes = sum(t._nbytes() for t in tables)
    cpu_towers = {part: [{k: v.to("cuda", copy=True).cpu()
                          for k, v in layer.items()}
                         for layer in towers[part]]
                  for part in ("bottom", "top")}
    cpu_w0 = [t.weight.cpu() for t in tables]
    batch = dlrm_batch(cfg, DLRM_BATCH, 0, "cuda")
    losses, times, after = [], [], None
    torch.cuda.synchronize()
    reset_launch_counts()
    for i in range(DLRM_STEPS):
        t0 = time.perf_counter()
        loss = dlrm_step(cfg, towers, tables, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        if i + 1 == DLRM_CPU_STEPS:
            # each step makes new tables, so these stay the step-3 ones
            after = ([t.weight for t in tables],
                     [p.detach().clone() for p in dlrm_leaves(towers)])
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    # the first 3 steps on the CPU, from the same towers and tables
    ctables = [ShardedEmbedding(v, cfg.embed_dim, optimizer="sgd",
                                learning_rate=0.1, device="cpu", weight=w)
               for v, w in zip(cfg.vocab_sizes, cpu_w0)]
    del cpu_w0
    cbatch = tuple(t.cpu() for t in batch)
    closses = [dlrm_step(cfg, cpu_towers, ctables, cbatch).item()
               for _ in range(DLRM_CPU_STEPS)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, closses))
    table_err, touched = 0.0, 0
    for f, (w_card, ct) in enumerate(zip(after[0], ctables)):
        rows = torch.unique(cbatch[1][:, f].long())
        scale = ct.weight[rows].abs().max().item()
        # over the whole table: the untouched rows must be equal too
        table_err = max(table_err, (w_card.cpu() - ct.weight).abs().max()
                        .item() / scale)
        touched += rows.numel()
    tower_err = max(rel_err(a.cpu(), b) for a, b in
                    zip(after[1], dlrm_leaves(cpu_towers)))
    del ctables, cpu_towers, after
    prof = profile_window(lambda: [dlrm_step(cfg, towers, tables, batch)
                                   for _ in range(2)])
    # one forward at the script's test batch
    tb = dlrm_batch(cfg, DLRM_TEST_BATCH, 1, "cuda")

    def forward():
        with torch.no_grad():
            return dlrm_forward(towers, tb[0], tb[1], cfg,
                                embed_fn=lambda f, ids: tables[f].lookup(ids))

    logits = forward()
    fwd_ms = time_ms(forward, iters=5, warmup=1)
    rec = {"phase": "dlrm_train", "config": "dlrm_s_criteo_kaggle",
           "tables": cfg.n_fields, "rows": sum(cfg.vocab_sizes),
           "table_bytes": table_bytes, "batch": DLRM_BATCH,
           "losses": losses, "step_ms": times, "step_ms_median_2_10": med,
           "examples_per_s": DLRM_BATCH / med * 1e3,
           "launches": {k: v for k, v in launches.items() if v},
           "max_memory_allocated_bytes": peak,
           "cpu_losses": closses, "loss_rel_err_vs_cpu": loss_err,
           "table_err_vs_cpu": table_err, "touched_rows_checked": touched,
           "tower_rel_err_vs_cpu": tower_err,
           "forward_batch": DLRM_TEST_BATCH, "forward_ms": fwd_ms,
           "forward_examples_per_s": DLRM_TEST_BATCH / fwd_ms * 1e3,
           "profile_2_steps": prof}
    emit(rec)
    per_step = 2 * cfg.n_fields
    check(launches == {k: (per_step * DLRM_STEPS if k in SPARSE_KERNELS
                           else 0) for k in launches}, "dlrm_train",
          "launches %s, expected %d segment_sum a step and nothing else"
          % (launches, per_step))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "dlrm_train", "losses not finite or not falling: %s" % losses)
    check(loss_err <= DLRM_REL and table_err <= DLRM_REL
          and tower_err <= DLRM_REL, "dlrm_train",
          "3 steps differ from the CPU: loss %s, tables %s, towers %s"
          % (loss_err, table_err, tower_err))
    check(logits.shape == (DLRM_TEST_BATCH,)
          and bool(torch.isfinite(logits).all()), "dlrm_train",
          "forward at batch %d: shape %s or not finite"
          % (DLRM_TEST_BATCH, tuple(logits.shape)))
    check(prof["device_ms"] > 0, "dlrm_train",
          "the profiler saw no device time")
    return launches


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
    torch.cuda.empty_cache()

    # main path 3: ResNet-50 Gluon inference (counts reset inside, read
    # right after the one forward)
    entries["conv_bn_relu"] = phase_kernel_cbr(gen)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resnet_") as tmp:
        net, resnet_launches = phase_resnet_infer(gen, tmp)
    phase_resnet_throughput(net, gen)
    del net
    torch.cuda.empty_cache()

    # main path 4: ResNet-50 Gluon training (counts reset inside, read
    # right after the FusedTrainStep steps and after the Adam loop)
    entries.update(phase_kernel_cbr_train(gen))
    entries.update(phase_kernel_opt(gen))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        net, loss_fn, train4_launches = phase_resnet_train(gen, tmp)
    phase_resnet_train_throughput(net, loss_fn)
    del net
    torch.cuda.empty_cache()

    # main path 5: BERT-base pretraining with LAMB on the ZeRO updater
    # (counts reset inside, read right after the 6 steps and around the
    # functional step)
    entries.update(phase_kernel_lamb(gen))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bert_") as tmp:
        net, trainer, batch, bert_launches = phase_bert_train(gen, tmp)
    phase_bert_train_throughput(net, trainer, batch)
    del net, trainer
    torch.cuda.empty_cache()

    # main path 6: sparse embeddings (counts reset inside, read right after
    # the 20 pushes and after the 10 DLRM steps)
    entries["segment_sum"] = phase_kernel_segment_sum(gen)
    sparse_launches = phase_sparse_embed()
    check_path(sparse_launches, SPARSE_KERNELS, "main_path_sparse_embed")
    dlrm_launches = phase_dlrm_train(gen)
    check_path(dlrm_launches, SPARSE_KERNELS, "main_path_dlrm_train")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = entries[name]
        # launches on the main paths that run the kernel
        launches = serve_launches[name] + train_launches[name] \
            + resnet_launches[name] + train4_launches[name] \
            + bert_launches[name] + sparse_launches[name] \
            + dlrm_launches[name]
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
