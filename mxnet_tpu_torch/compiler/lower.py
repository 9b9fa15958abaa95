"""Whole-graph lowering: a bound Symbol graph as one function (the port
of `mxnet_tpu.compiler.lower`).

The executor's op-by-op route calls `nd.invoke` for every node, each call
wrapped, dispatched and recorded on the port's tape. This module walks the
graph once, runs the pass pipeline (`passes.run_pipeline`) and emits one
plain function over the executor's bound tensors, with every node's
registry function resolved once by `best_fn(on_gpu)` (a kernel's wrapper
on a card, as `nd.invoke` would pick):

* forward: (args..., aux...) -> (head outputs...);
* forward+backward: the same inputs -> (heads, the gradients of the
  arguments whose grad_req wants one), one `torch.autograd.grad` over the
  whole function with ones as the heads' cotangents (the default of
  `autograd.backward`), or the caller's head gradients. Ops with a
  hand-written gradient (SoftmaxOutput, the regression heads) keep it:
  it lives in their `torch.autograd.Function`.

BatchNorm nodes follow `symbol.bn_call`: a training run also returns each
node's batch statistics and the input positions of its moving statistics,
which the executor moves after the run.

Where the reference compiles the function with XLA, the port runs it
eagerly: the emitted function is the program. Programs are memoized in the
process by (graph hash, mode, input signature), so the executors of a
data-parallel group share one; the memo holds the function object itself.
Telemetry: `compiler.lower` / `compiler.lower_ms`, `compiler.compile`
(programs built: memo misses), `compiler.program_runs`, and the pass
counts under `compiler.pass.*`.
"""
from __future__ import annotations

import time

import torch

from .. import telemetry as _telem
from ..ops import registry as _reg
from . import passes as _passes

__all__ = ["GraphProgram", "UnsupportedGraphError"]

UnsupportedGraphError = _passes.UnsupportedGraphError

_MEMO = {}
_MEMO_MAX = 128


def _emit(ir, on_gpu):
    """forward(flat, train) -> (head outputs, BatchNorm statistics), a
    plain function of the flat inputs (args... then aux...)."""
    from ..symbol.symbol import bn_call, bn_output
    pos = {name: i for i, name in enumerate(
        list(ir.arg_names) + list(ir.aux_names))}
    node_fns = [None if n.op is None else _reg.get(n.op).best_fn(on_gpu)
                for n in ir.nodes]
    bn_op = _reg.get("BatchNorm")
    is_bn = [n.op is not None and _reg.get(n.op) is bn_op for n in ir.nodes]

    def moving_pos(node, k):
        j = node.inputs[k][0]
        return pos.get(ir.nodes[j].name) if ir.nodes[j].is_var else None

    bn_slots = {i: (moving_pos(n, 3), moving_pos(n, 4),
                    float(n.kwargs.get("momentum", 0.9)))
                for i, n in enumerate(ir.nodes) if is_bn[i]}
    consts = {}     # device -> constant tensors moved there

    def const_on(i, device):
        c = ir.nodes[i].const
        if not torch.is_tensor(c):
            return c
        per = consts.setdefault(device, {})
        if i not in per:
            per[i] = c.to(device)
        return per[i]

    def forward(flat, train):
        device = flat[0].device if flat else torch.device("cpu")
        vals = [None] * len(ir.nodes)
        stats = []
        for i, node in enumerate(ir.nodes):
            if node.is_const:
                vals[i] = const_on(i, device)
                continue
            if node.is_var:
                vals[i] = flat[pos[node.name]]
                continue
            ins = []
            for (j, slot) in node.inputs:
                v = vals[j]
                if isinstance(v, (tuple, list)):
                    v = v[slot]
                ins.append(v)
            if is_bn[i]:
                call, want = bn_call(node.kwargs, train)
                res = node_fns[i](*ins, **call)
                if want:
                    pm, pv, m = bn_slots[i]
                    stats.append((pm, pv, res[1], res[2], m))
                    res = bn_output(res, node.kwargs)
                vals[i] = res
            else:
                vals[i] = node_fns[i](*ins, **node.kwargs)
        outs = []
        for (j, slot) in ir.heads:
            v = vals[j]
            if isinstance(v, (tuple, list)):
                v = v[slot]
            outs.append(v)
        return tuple(outs), stats

    return forward


class GraphProgram:
    """The whole-graph programs of one bound symbol: lowered once per
    executor (a graph walk and the passes), a program per (mode, input
    signature) shared through the process memo."""

    def __init__(self, symbol, on_gpu=False, label=None):
        t0 = time.perf_counter()
        ir = _passes.from_symbol(symbol)
        ir, stats = _passes.run_pipeline(ir, on_gpu)
        self.ir = ir
        self.stats = stats
        self.on_gpu = on_gpu
        self.graph_hash = _passes.graph_hash(ir)
        self.label = label or (symbol.name or "graph")
        self.n_heads = len(ir.heads)
        self._forward = _emit(ir, on_gpu)
        _telem.inc("compiler.lower")
        _telem.observe("compiler.lower_ms", (time.perf_counter() - t0) * 1e3)
        for k, v in stats.items():
            if k != "ops" and v:
                _telem.inc("compiler.pass.%s" % k, v)

    def _fn_for(self, mode, wanted_idx):
        forward = self._forward
        if mode in ("fwd", "fwd_train"):
            train = mode == "fwd_train"

            def fwd(flat, cots=None):
                with torch.no_grad():
                    outs, stats = forward(flat, train)
                return outs, (), stats
            return fwd
        wanted = list(wanted_idx)

        def fwd_bwd(flat, cots=None):
            flat = list(flat)
            leaves = []
            for i in wanted:
                flat[i] = flat[i].detach().requires_grad_(True)
                leaves.append(flat[i])
            with torch.enable_grad():
                outs, stats = forward(flat, True)
                pairs = []
                for k, o in enumerate(outs):
                    if not o.requires_grad:
                        continue
                    c = torch.ones_like(o) if cots is None else \
                        cots[k].to(o.device, o.dtype)
                    pairs.append((o, c))
                grads = [None] * len(leaves)
                if pairs and leaves:
                    grads = torch.autograd.grad(
                        [o for o, _ in pairs], leaves,
                        [c for _, c in pairs], allow_unused=True)
            grads = tuple(torch.zeros_like(t) if g is None else g
                          for g, t in zip(grads, leaves))
            return tuple(o.detach() for o in outs), grads, stats
        return fwd_bwd

    def program(self, mode, raws, wanted_idx=()):
        """The program for `mode` at the signature of `raws`: from the
        process memo, or built and stored there."""
        sig = tuple((tuple(r.shape), str(r.dtype), str(r.device))
                    for r in raws)
        key = (self.graph_hash, mode, sig, tuple(wanted_idx), self.on_gpu)
        fn = _MEMO.get(key)
        if fn is None:
            fn = self._fn_for(mode, wanted_idx)
            _telem.inc("compiler.compile")
            if len(_MEMO) >= _MEMO_MAX:
                _MEMO.clear()
            _MEMO[key] = fn
        return fn

    def run_forward(self, raws, train=False):
        """(head outputs, BatchNorm statistics) of one run, with no
        gradient."""
        fn = self.program("fwd_train" if train else "fwd", raws)
        _telem.inc("compiler.program_runs")
        outs, _, stats = fn(raws)
        return outs, stats

    def run_fwd_bwd(self, raws, wanted_idx, head_cots=None):
        """(head outputs, gradients of the inputs at `wanted_idx`,
        BatchNorm statistics) of one training run; `head_cots` are the
        caller's head gradients (ones without them)."""
        mode = "fwdbwd" if head_cots is None else "fwdbwd_og"
        fn = self.program(mode, raws, wanted_idx)
        _telem.inc("compiler.program_runs")
        return fn(raws, head_cots)
