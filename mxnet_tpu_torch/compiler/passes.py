"""Graph-level passes over a Symbol graph (the port of
`mxnet_tpu.compiler.passes`).

A `Symbol` DAG lowers to a flat `GraphIR`, then

* constant folding: op nodes whose inputs are all literal constants run
  once at lower time, with the same registry functions the op-by-op
  executor calls, so folded values equal what eager execution computes;
* common-subexpression elimination: structurally identical op nodes
  (same op, same hyper-parameters, same input slots) merge into one;
* dead-node elimination: nodes the heads do not reach are dropped.

`graph_hash` is the reference's content hash, computed the same way, so a
symbol hashes to the same value in both packages.

What the pipeline cannot lower raises `UnsupportedGraphError` with a short
reason (`random_op:Dropout`, `unknown_op:Custom`); the executor counts it
and runs that graph op by op.
"""
from __future__ import annotations

import hashlib
import json

import numpy as _np
import torch

from ..base import dtype_name
from ..ops import registry as _reg

__all__ = ["GraphIR", "Node", "UnsupportedGraphError", "from_symbol",
           "fold_constants", "eliminate_common_subexpr",
           "eliminate_dead_nodes", "run_pipeline", "graph_hash"]


class UnsupportedGraphError(Exception):
    """The graph holds something the whole-graph route does not lower;
    `reason` is a short slug for the `compiler.fallback.<reason>`
    counter."""

    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


class Node:
    """One IR node: a variable (`op` None, `const` None), a constant (`op`
    None, `const` set: a float or a tensor) or an op node, whose `inputs`
    are (producer index, output slot) pairs."""

    __slots__ = ("op", "name", "inputs", "kwargs", "num_outputs", "const",
                 "is_aux")

    def __init__(self, op, name, inputs=(), kwargs=None, num_outputs=1,
                 const=None, is_aux=False):
        self.op = op
        self.name = name
        self.inputs = list(inputs)
        self.kwargs = dict(kwargs or {})
        self.num_outputs = num_outputs
        self.const = const
        self.is_aux = is_aux

    @property
    def is_var(self):
        return self.op is None and self.const is None

    @property
    def is_const(self):
        return self.op is None and self.const is not None

    def __repr__(self):
        if self.is_var:
            return "Var(%s)" % self.name
        if self.is_const:
            return "Const(%s)" % self.name
        return "Op(%s:%s)" % (self.op, self.name)


class GraphIR:
    """Topologically ordered nodes and the output heads."""

    def __init__(self, nodes, heads, arg_names, aux_names):
        self.nodes = nodes            # producers before users
        self.heads = heads            # [(node index, slot)]
        self.arg_names = arg_names    # the positional inputs: args...
        self.aux_names = aux_names    # ...then the auxiliary states

    def n_ops(self):
        return sum(1 for n in self.nodes if n.op is not None)


def _literal_const(sym_node):
    """A literal variable's value as the op-by-op route makes it: a Python
    float stays a float; zeros/ones/arange are float32 host tensors (moved
    to the inputs' device when the program runs)."""
    from ..context import cpu
    v = sym_node._literal_value(cpu())
    return v if isinstance(v, float) else v._data


def from_symbol(symbol):
    """Lower a Symbol DAG to GraphIR, or raise UnsupportedGraphError."""
    from ..symbol.symbol import _parse_attr
    index = {}
    nodes = []
    for n in symbol._topo():
        if n._op == "_group":
            continue  # structural: the heads are resolved through _heads()
        if n._op is None:
            if n._is_literal():
                node = Node(None, n._name, const=_literal_const(n))
            else:
                node = Node(None, n._name, is_aux=n._is_aux())
        else:
            try:
                op = _reg.get(n._op)
            except KeyError:
                raise UnsupportedGraphError("unknown_op:%s" % n._op)
            if op.random:
                # the op-by-op route draws from the context's generator in
                # its own order; one program could not replay those draws
                raise UnsupportedGraphError("random_op:%s" % n._op)
            ins = []
            for i in n._inputs:
                base = i._base_node()
                if id(base) not in index:
                    raise UnsupportedGraphError("disconnected_input:%s"
                                                % i._name)
                ins.append((index[id(base)], i._out_index or 0))
            kwargs = {k: _parse_attr(v) for k, v in n._kwargs.items()}
            node = Node(n._op, n._name, ins, kwargs,
                        num_outputs=n._num_outputs)
        index[id(n)] = len(nodes)
        nodes.append(node)
    heads = []
    for h in symbol._heads():
        hi = index[id(h._base_node())]
        if h._out_index is not None:
            heads.append((hi, h._out_index))
        elif h._num_outputs > 1:
            heads.extend((hi, s) for s in range(h._num_outputs))
        else:
            heads.append((hi, 0))
    return GraphIR(nodes, heads, symbol.list_arguments(),
                   symbol.list_auxiliary_states())


# ---------------------------------------------------------------------------
# passes: each returns (ir, n_changed)
# ---------------------------------------------------------------------------
def fold_constants(ir, on_gpu=False):
    """Run op nodes whose inputs are all constants, once, with the
    registry function the op-by-op route would call on the host (the
    constants live there until the program runs)."""
    folded = 0
    for node in ir.nodes:
        if node.op is None:
            continue
        producers = [ir.nodes[j] for j, _ in node.inputs]
        if not producers or not all(p.is_const for p in producers):
            continue
        ins = []
        for (j, slot) in node.inputs:
            v = ir.nodes[j].const
            if isinstance(v, (tuple, list)):
                v = v[slot]
            ins.append(v)
        try:
            with torch.no_grad():
                value = _reg.get(node.op).fn(*ins, **node.kwargs)
        except Exception:
            continue  # left in the program
        node.op, node.inputs, node.kwargs = None, [], {}
        node.const = value
        folded += 1
    return ir, folded


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


def eliminate_common_subexpr(ir):
    """Merge structurally identical op nodes. Variables stay keyed by
    name and constants are left alone; op nodes key on (op, hyper-
    parameters, remapped input slots), so chains of duplicates collapse
    in one sweep."""
    remap = {}
    seen = {}
    new_nodes = []
    for i, node in enumerate(ir.nodes):
        if node.op is None:
            remap[i] = len(new_nodes)
            new_nodes.append(node)
            continue
        inputs = [(remap[j], s) for j, s in node.inputs]
        key = (node.op, _hashable(node.kwargs), tuple(inputs))
        hit = seen.get(key)
        if hit is not None:
            remap[i] = hit
            continue
        node.inputs = inputs
        remap[i] = len(new_nodes)
        seen[key] = len(new_nodes)
        new_nodes.append(node)
    merged = len(ir.nodes) - len(new_nodes)
    ir.nodes = new_nodes
    ir.heads = [(remap[j], s) for j, s in ir.heads]
    return ir, merged


def eliminate_dead_nodes(ir):
    """Drop nodes the heads do not reach. The positional inputs (arg_names
    + aux_names) stay as they are, so the executor feeds the same
    arrays."""
    live = set()
    stack = [j for j, _ in ir.heads]
    while stack:
        j = stack.pop()
        if j in live:
            continue
        live.add(j)
        stack.extend(k for k, _ in ir.nodes[j].inputs)
    if len(live) == len(ir.nodes):
        return ir, 0
    remap = {}
    new_nodes = []
    for i, node in enumerate(ir.nodes):
        if i not in live:
            continue
        node.inputs = [(remap[j], s) for j, s in node.inputs]
        remap[i] = len(new_nodes)
        new_nodes.append(node)
    removed = len(ir.nodes) - len(new_nodes)
    ir.nodes = new_nodes
    ir.heads = [(remap[j], s) for j, s in ir.heads]
    return ir, removed


def run_pipeline(ir, on_gpu=False):
    """fold, CSE, DCE. Returns (ir, stats); the stats go to telemetry
    (`compiler.pass.*`)."""
    ir, folded = fold_constants(ir, on_gpu)
    ir, merged = eliminate_common_subexpr(ir)
    ir, removed = eliminate_dead_nodes(ir)
    return ir, {"folded": folded, "cse_merged": merged,
                "dce_removed": removed, "ops": ir.n_ops()}


# ---------------------------------------------------------------------------
# signature
# ---------------------------------------------------------------------------
def _const_record(c):
    """[shape, dtype name, value digest] of a constant, as the reference
    writes it (dtype by its numpy name, arrays by the sha256 of their
    bytes, scalars by repr)."""
    if isinstance(c, (int, float)):
        return [[], type(c).__name__, repr(c)]
    t = c.detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    raw = t.view(torch.int16).numpy() if name == "bfloat16" else t.numpy()
    return [list(t.shape), name,
            hashlib.sha256(_np.ascontiguousarray(raw).tobytes()).hexdigest()]


def graph_hash(ir):
    """Content hash of the optimized graph. Constants hash by value: they
    are baked into the program, so two graphs that differ only in a
    constant's contents never share a memo slot."""
    items = []
    for node in ir.nodes:
        if node.is_var:
            items.append(["var", node.name, bool(node.is_aux)])
        elif node.is_const:
            items.append(["const"] + _const_record(node.const))
        else:
            items.append(["op", node.op,
                          sorted((str(k), repr(v))
                                 for k, v in node.kwargs.items()),
                          node.inputs])
    blob = json.dumps([items, ir.heads, ir.arg_names, ir.aux_names],
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()
