"""Host cost of the port's flash-attention backward wrapper, and the
llama_110m training step, for the package of one checkout.

    python3 tools/flash_bwd_host.py [--root DIR] [--calls N] [--steps N]

`--root` names the checkout whose `mxnet_tpu_torch` is imported (default:
the one this script lies in), so that two trees can be compared on one
card in alternating processes. Needs a CUDA card. Prints one JSON line:

* `bwd_host_us`: host microseconds per `_backward_inner` call at the
  training path's shape (B 8, H 12, S 1024, D 64, causal, bf16), for
  `--calls` calls issued back to back without a synchronise (the card's
  queue does not fill in that many), one value per repetition;
* `plan_host_us`: the same for the wrapper's plan lookup alone, where the
  package has one (`_device_plan`), else null;
* `step_ms`: llama_110m training steps (batch 8 x 1024, adamw, as
  chip_smoke.py's `train` phase), each synchronised and timed on the host
  clock, after two warm-up steps, and their median.
"""
import argparse
import importlib
import json
import os
import statistics
import sys
import time


def host_us(fn, calls, reps=5):
    """Host microseconds per call of fn(), `calls` calls a repetition,
    the card synchronised between repetitions only."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_host: needs a CUDA card")
    from mxnet_tpu_torch.models.llama import CONFIGS, llama_init, llama_loss
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    fa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, S, D = 8, 12, 1024, 64
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    sc = D ** -0.5
    o, lse = fa._flash_forward(q, k, v, True, sc)
    delta = fa._delta(o, do)

    def bwd():
        fa._backward_inner(q, k, v, lse, delta, do, True, sc)

    for _ in range(20):
        bwd()
    rec = {"root": os.path.abspath(args.root),
           "bwd_host_us": host_us(bwd, args.calls),
           "plan_host_us": (host_us(lambda: fa._device_plan(q, k),
                                    args.calls)
                            if hasattr(fa, "_device_plan") else None)}

    cfg = CONFIGS["llama_110m"]
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 1025),
                                     generator=gen, device="cuda")}
    step = ShardedTrainStep(lambda p, b: llama_loss(p, b, cfg), params,
                            optimizer="adamw", lr=3e-4)
    params, state = step.init()
    times = []
    for i in range(args.steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, step_num=i)
        loss.item()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rec["step_ms"] = times[2:]
    rec["median_step_ms"] = statistics.median(times[2:])
    rec["bwd_host_us_median"] = statistics.median(rec["bwd_host_us"])
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
