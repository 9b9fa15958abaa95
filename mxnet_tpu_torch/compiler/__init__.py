"""mx.compiler: the whole-graph route of the symbolic executor (the port
of `mxnet_tpu.compiler`'s `passes` and `lower`).

A bound Symbol graph lowers through a pass pipeline (constant folding,
CSE, dead-node elimination) into one function over the executor's bound
tensors, which `symbol/executor.py` runs in place of its op-by-op loop
(forward, or forward and backward with one `torch.autograd.grad`). Gated
by `MXNET_TPU_WHOLE_GRAPH` (on by default); a graph the pipeline cannot
lower falls back to the op-by-op route, counted as
`compiler.fallback.<reason>`.

Not ported: the reference's `compiler/cache.py`, which serializes XLA
executables across processes; the port runs its programs eagerly and has
no compiled artifact to store yet.
"""
from . import lower, passes
from .lower import GraphProgram, UnsupportedGraphError
from .passes import (GraphIR, eliminate_common_subexpr, eliminate_dead_nodes,
                     fold_constants, from_symbol, graph_hash, run_pipeline)

__all__ = [
    "lower", "passes", "GraphProgram", "UnsupportedGraphError",
    "GraphIR", "from_symbol", "fold_constants", "eliminate_common_subexpr",
    "eliminate_dead_nodes", "run_pipeline", "graph_hash",
]
