"""Times of the segment-sum kernel (#11), the BN + ReLU backward kernel
(#6) and the flat SGD and Adam kernels (#7/#8) at the main paths' shapes,
and the card's write rate, for the port found under --root.

Prints one JSON line per shape and per fill size, then the card's name
and power limit:
the wrapper's call by CUDA events (20 calls back to back, so the event
time is the larger of its host and device time) and its kernels' device
time under torch.profiler (each kernel's mean duration over the launches
the profiler saw, times its launches a call), with the launches seen.
#11: 8192 x 64 fp32 rows at ascending unique ids into 1,000,001 rows
(bench_sparse's table update), 128 x 16 into 10,131,228 (the largest
Criteo Kaggle table at batch 128), and the first shape with shuffled ids
(about two of each of 4000). #6: bf16 conv output and dy at ResNet-50's
four bottleneck 3x3 shapes at batch 256, no residual. #7/#8 (momentum
on, no clip, no master): one ResNet-50 step's 193 trainable tensors (bf16
weights, fp32 BatchNorm vectors, states and gradients in the weight's
dtype) as one multi-tensor call where the tree has `multi_sgd` /
`multi_adam`, and as one launch per tensor (the route of a tree without
them); and one launch over 25.6M elements at bf16 and fp32. Inputs are
seeded.
#11 is almost all zero fill, so its bound is the output's bytes over the
card's write rate: the fills are torch's zero_ and, where the tree's
segment-sum library has the entry, cudaMemsetAsync, from 32 MB (which L2
holds) to 4 GB, each also timed under the profiler right after an idle
spin on the device (so that L2 holds no dirty lines when it starts).
To compare two trees on one card, run it for each in turns in one call
(parent, change, change, parent):

    python tools/kernel_times.py --root path/to/parent
    python tools/kernel_times.py

Needs a CUDA card; builds the kernels it times from the tree under
--root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

SEGSUM = [("sparse_embed_update", 8192, 64, 1_000_001, "unique"),
          ("dlrm_largest_table", 128, 16, 10_131_228, "unique"),
          ("shuffled_8192x64", 8192, 64, 1_000_001, "shuffled")]
STAGES = [("stage1_56x56x64", 256, 56, 56, 64),
          ("stage2_28x28x128", 256, 28, 28, 128),
          ("stage3_14x14x256", 256, 14, 14, 256),
          ("stage4_7x7x512", 256, 7, 7, 512)]
FILL_MB = (32, 256, 648, 4096)


def event_ms(fn, iters=20, warmup=5):
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, calls=20, warmup=5):
    """(device ms a call, launches the profiler saw in `calls` calls)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms, seen = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or not ev.count:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        ms += us / 1e3 / ev.count * max(1, round(ev.count / calls))
        seen += ev.count
    return ms, seen


def fills(root):
    """One JSON line per fill size: each fill by events (TB/s beside it),
    by device time, and by device time right after an idle spin."""
    from mxnet_tpu_torch.ops._build import bind
    stream = torch.cuda.current_stream().cuda_stream
    try:
        _, memset = bind("segment_sum", "mx_memset_zero",
                         [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p])
    except AttributeError:      # a tree whose library has no such entry
        memset = None
    for mb in FILL_MB:
        n = mb * 2 ** 20
        buf = torch.empty(n, dtype=torch.uint8, device="cuda")
        rec = {"fill_bytes": n, "root": root}
        kinds = {"zero_": buf.zero_}
        if memset is not None:
            kinds["memset"] = lambda: memset(buf.data_ptr(), n, stream)
        for name, fn in kinds.items():
            ms = event_ms(fn)

            def after_idle(fn=fn):
                torch.cuda._sleep(200000)
                fn()
            # the spin's own time is the same in every window: subtract it
            spin = device_ms(lambda: torch.cuda._sleep(200000))[0]
            rec[name] = {"ms": ms, "TB_per_s": n / ms / 1e9,
                         "device_ms": device_ms(fn)[0],
                         "device_ms_after_idle":
                             device_ms(after_idle)[0] - spin}
        print(json.dumps(rec), flush=True)
        del buf


def resnet50_shapes():
    """(shape, dtype) of every trainable tensor of resnet50_v1 NHWC with
    the fused gate, cast to bf16 (BatchNorm's stay fp32)."""
    import mxnet_tpu_torch as mx
    os.environ["MXNET_TPU_FUSED_CONVBN"] = "1"
    with mx.name.NameManager():
        net = mx.gluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                    layout="NHWC")
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 32, 32, 3), ctx=mx.cpu()))
    net.cast("bfloat16")
    return [(p.shape, p.data().data_torch.dtype)
            for p in net.collect_params().values() if p.grad_req != "null"]


def opt_tensors(kind, n, dtype, gen):
    """w, g N(0, 1); momentum or mean N(0, 0.1^2); var from squares."""
    def rnd(scale=1.0):
        return (torch.randn(n, generator=gen, device="cuda") * scale).to(
            dtype)
    t = {"w": rnd(), "g": rnd()}
    if kind == "sgd":
        t["mom"] = rnd(0.1)
    else:
        t["mean"] = rnd(0.1)
        t["var"] = (0.1 * rnd().float() ** 2).to(dtype)
    return t


def optimizer_times(root):
    """#7/#8: one ResNet-50 step's tensors in one multi-tensor call (where
    the tree has one) and one launch per tensor, and one 25.6M launch."""
    import mxnet_tpu_torch.ops.fused_optimizer as fo
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = resnet50_shapes()

    def one(kind, t):
        if kind == "sgd":
            fo.flat_sgd(t["w"], t["g"], t["mom"], None, 0.05, 1e-4, 0.9,
                        1.0 / 256, 0.0, True, False, False)
        else:
            fo.flat_adam(t["w"], t["g"], t["mean"], t["var"], None, 1e-3,
                         1e-4, 0.9, 0.1, 0.999, 1.0 - 0.999, 1e-8,
                         1.0 / 256, 0.0, False, False)

    def multi(kind, ts):
        ws, gs = [t["w"] for t in ts], [t["g"] for t in ts]
        lrs, wds = [0.05] * len(ts), [1e-4] * len(ts)
        if kind == "sgd":
            fo.multi_sgd(ws, gs, [t["mom"] for t in ts], None, lrs, wds,
                         0.9, 1.0 / 256, 0.0, True, False, False)
        else:
            fo.multi_adam(ws, gs, [t["mean"] for t in ts],
                          [t["var"] for t in ts], None, lrs, wds, 0.9, 0.1,
                          0.999, 1.0 - 0.999, 1e-8, 1.0 / 256, 0.0, False,
                          False)

    for kind in ("sgd", "adam"):
        name = "flat_" + kind
        ts = [opt_tensors(kind, int(np.prod(s)), dt, gen)
              for s, dt in shapes]
        routes = {"per_tensor": lambda: [one(kind, t) for t in ts]}
        if hasattr(fo, "multi_" + kind):
            routes["multi"] = lambda: multi(kind, ts)
        for route, fn in routes.items():
            ms, seen = device_ms(fn, calls=10)
            print(json.dumps({"kernel": name, "shape": "resnet50_step_193",
                              "route": route, "root": root,
                              "ms": event_ms(fn, iters=20),
                              "device_ms": ms, "launches_seen": seen}),
                  flush=True)
        del ts
        for dt in (torch.bfloat16, torch.float32):
            t = opt_tensors(kind, 25_600_000, dt, gen)
            fn = lambda: one(kind, t)
            ms, seen = device_ms(fn)
            print(json.dumps({"kernel": name, "shape": "25.6M",
                              "dtype": str(dt)[6:], "root": root,
                              "ms": event_ms(fn, iters=50), "device_ms": ms,
                              "launches_seen": seen}), flush=True)
            del t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from mxnet_tpu_torch.ops.fused_conv import cbr_train_bwd
    from mxnet_tpu_torch.ops.sparse_ops import segment_sum
    rng = np.random.RandomState(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, nnz, dim, segments, kind in SEGSUM:
        if kind == "unique":
            ids = np.sort(rng.choice(segments - 1, size=nnz, replace=False))
        else:
            ids = rng.randint(0, 4000, size=nnz)
        ids = torch.from_numpy(ids).to(torch.int32).cuda()
        vals = torch.randn(nnz, dim, generator=gen, device="cuda")
        fn = lambda: segment_sum(vals, ids, segments)
        ms, seen = device_ms(fn)
        print(json.dumps({"kernel": "segment_sum", "shape": name,
                          "root": args.root, "ms": event_ms(fn),
                          "device_ms": ms, "launches_seen": seen}),
              flush=True)
    for name, N, H, W, C in STAGES:
        conv = torch.randn(N, H, W, C, generator=gen,
                           device="cuda").bfloat16()
        dy = torch.randn(N, H, W, C, generator=gen, device="cuda").bfloat16()
        mean = torch.randn(C, generator=gen, device="cuda") * 0.1
        invstd = torch.rand(C, generator=gen, device="cuda") + 0.5
        gamma = torch.rand(C, generator=gen, device="cuda") + 0.5
        beta = torch.randn(C, generator=gen, device="cuda") * 0.1
        fn = lambda: cbr_train_bwd(conv, dy, mean, invstd, gamma, beta)
        ms, seen = device_ms(fn)
        print(json.dumps({"kernel": "cbr_train_bwd", "shape": name,
                          "root": args.root, "ms": event_ms(fn, iters=50),
                          "device_ms": ms, "launches_seen": seen}),
              flush=True)
    optimizer_times(args.root)
    fills(args.root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
