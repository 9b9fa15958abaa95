"""Symbol: the declarative graph API (the port of `mxnet_tpu.symbol.symbol`).

A Symbol is a small DAG node that refers to the same op registry as
`mx.nd`: one definition per op, visible in both namespaces. `bind` and
`simple_bind` make an `Executor`, which runs the graph op by op under the
port's autograd or as one whole-graph program (`mx.compiler`).

Shape inference runs each op's plain PyTorch version on ``meta`` tensors
(shapes and dtypes, no data) where the reference runs ``jax.eval_shape``;
the op's `shape_hint` fills parameter shapes from data shapes first. A
kernel's wrapper (`cuda_fn`) never runs there.

JSON: `tojson()` writes the reference's NNVM layout (nodes, arg_nodes,
node_row_ptr, heads, attrs), so each package loads the other's
``-symbol.json``.

BatchNorm follows upstream MXNet, not the reference (which leaves the
moving statistics alone and normalizes by the batch's statistics in
inference too): evaluated for training it normalizes by the batch's
statistics and reports them, so the executor can move the moving ones;
evaluated for inference it normalizes by the moving statistics.
`use_global_stats=True` takes the moving ones in both.
"""
from __future__ import annotations

import ast
import json

import numpy as _np
import torch

from .. import autograd
from .. import ndarray as nd
from ..base import MXNetError, dtype_name, torch_dtype
from ..context import cpu
from ..name import NameManager
from ..ops import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "arange"]

_AUX_SUFFIXES = ("moving_mean", "moving_var", "running_mean", "running_var")


class _MetaContext:
    """The context shape inference hands a creation op (eye, linspace, the
    draws): its output lands on `meta`, so nothing is allocated, and no
    generator is drawn from."""
    torch_device = torch.device("meta")


def bn_call(kwargs, train):
    """(kwargs to call the BatchNorm op with, whether the call reports the
    batch statistics for the moving-average update). Training without
    `use_global_stats` asks the op for (out, mean, var); everything else
    normalizes by the moving statistics."""
    if train and not kwargs.get("use_global_stats", False):
        return dict(kwargs, output_mean_var=True), True
    return dict(kwargs, use_global_stats=True), False


def bn_output(res, kwargs):
    """The node's value from a training-mode BatchNorm call (out, mean,
    var): all three when the graph asked for them, else out."""
    return res if kwargs.get("output_mean_var", False) else res[0]


def moving_update(moving, batch, momentum):
    """moving * m + batch * (1 - m), from the batch statistic cut from the
    graph, in the moving statistic's dtype (the Gluon layer's formula)."""
    with torch.no_grad():
        moving.copy_(moving * momentum + batch.detach().to(moving.dtype)
                     * (1 - momentum))


class Symbol:
    """A node (or one output of a node) in the symbolic graph."""

    def __init__(self, op=None, name=None, inputs=None, attrs=None,
                 kwargs=None, num_outputs=1, out_index=None):
        self._op = op                # None for variables
        self._name = name
        self._inputs = inputs or []  # list[Symbol]
        self._attrs = dict(attrs or {})   # user attrs (__shape__, lr_mult..)
        self._kwargs = dict(kwargs or {})  # op hyper-parameters
        self._num_outputs = num_outputs
        self._out_index = out_index  # int: this symbol is one output slice
        self._base_ref = None        # sliced symbols: the real base object

    @property
    def name(self):
        if self._out_index is not None and self._num_outputs > 1:
            return "%s_output%d" % (self._name, self._out_index)
        return self._name

    @property
    def op(self):
        return self._op

    def __repr__(self):
        return "<Symbol %s>" % self.name

    def __iter__(self):
        return (self[i] for i in range(len(self.list_outputs())))

    def __getitem__(self, index):
        outputs = self.list_outputs()
        if isinstance(index, str):
            return self[outputs.index(index)]
        if isinstance(index, slice):
            return Group([self[i] for i in range(*index.indices(
                len(outputs)))])
        if self._op == "_group":
            return self._inputs[index]
        if index >= self._num_outputs:
            raise IndexError("Index: %d exceeds the number of outputs: %d."
                             % (index, self._num_outputs))
        if self._num_outputs == 1:
            return self
        sliced = Symbol(self._op, self._name, self._inputs, self._attrs,
                        self._kwargs, self._num_outputs, out_index=index)
        # keep the real base object, so the graph walk sees one node
        # however many slices refer to it
        sliced._base_ref = self if self._out_index is None \
            else self._base_node()
        return sliced

    def __len__(self):
        return len(self.list_outputs())

    # -- graph traversal --------------------------------------------------
    def _topo(self):
        """Post-order list of the unique nodes (out_index None)."""
        seen = set()
        order = []

        def visit(s):
            base = s._base_node()
            if id(base) in seen:
                return
            seen.add(id(base))
            for i in base._inputs:
                visit(i)
            order.append(base)
        visit(self)
        return order

    def _base_node(self):
        if self._out_index is None:
            return self
        if self._base_ref is not None:
            return self._base_ref
        base = Symbol(self._op, self._name, self._inputs, self._attrs,
                      self._kwargs, self._num_outputs)
        self._base_ref = base
        return base

    def _heads(self):
        """The output symbols (a group's members)."""
        if self._op == "_group":
            out = []
            for s in self._inputs:
                out.extend(s._heads())
            return out
        return [self]

    def list_arguments(self):
        """The free variables, in graph order, without the auxiliary
        states and the literal constants."""
        return [s._name for s in self._topo()
                if s._op is None and not s._is_aux() and not s._is_literal()]

    def _is_literal(self):
        return any(k.startswith("__literal") for k in self._attrs)

    def list_auxiliary_states(self):
        """The non-differentiable op states (BatchNorm's moving
        statistics)."""
        return [s._name for s in self._topo() if s._op is None and
                s._is_aux()]

    def _is_aux(self):
        if self._attrs.get("__aux__") == "True":
            return True
        return str(self._name or "").endswith(_AUX_SUFFIXES)

    def list_inputs(self):
        return [s._name for s in self._topo() if s._op is None]

    def list_outputs(self):
        outs = []
        for h in self._heads():
            if h._num_outputs == 1 or h._out_index is not None:
                outs.append(h.name if h._op else h._name)
            else:
                outs.extend("%s_output%d" % (h._name, i)
                            for i in range(h._num_outputs))
        return outs

    def get_internals(self):
        """Every node's outputs as one group."""
        outs = []
        for n in self._topo():
            if n._op is None:
                outs.append(n)
            else:
                for i in range(n._num_outputs):
                    outs.append(n[i] if n._num_outputs > 1 else n)
        return Group(outs)

    def get_children(self):
        base = self._base_node()
        if not base._inputs:
            return None
        return Group(list(base._inputs))

    # -- attributes -------------------------------------------------------
    def attr(self, key):
        return self._attrs.get(key)

    def list_attr(self):
        return {k: str(v) for k, v in self._attrs.items()}

    def attr_dict(self):
        """{node name: its attributes and hyper-parameters as strings}."""
        ret = {}
        for n in self._topo():
            d = {k: str(v) for k, v in n._attrs.items()}
            d.update({k: str(v) for k, v in n._kwargs.items()})
            if d:
                ret[n._name] = d
        return ret

    def _set_attr(self, **kwargs):
        self._attrs.update({k: str(v) for k, v in kwargs.items()})

    # -- composition ------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Substitute this symbol's free variables (Symbol::Compose)."""
        name = kwargs.pop("name", None)
        if args and kwargs:
            raise TypeError(
                "compose only accept input Symbols either as positional or "
                "keyword arguments, not both")
        arg_names = self.list_arguments()
        if args:
            if len(args) > len(arg_names):
                raise ValueError("too many positional arguments")
            mapping = dict(zip(arg_names, args))
        else:
            mapping = {}
            for k, v in kwargs.items():
                if not isinstance(v, Symbol):
                    raise TypeError("Compose expect `Symbol` as arguments")
                mapping[k] = v
        out = self._compose_with(mapping)
        if name is not None:
            out._name = name
        return out

    def _compose_with(self, mapping):
        """A copy of the graph with variables substituted by name."""
        memo = {}

        def rebuild(s):
            base = s._base_node()
            new_base = memo.get(id(base))
            if new_base is None:
                if base._op is None and base._name in mapping:
                    new_base = mapping[base._name]._base_node()
                else:
                    new_base = Symbol(
                        base._op, base._name,
                        [rebuild(i) for i in base._inputs],
                        base._attrs, base._kwargs, base._num_outputs)
                memo[id(base)] = new_base
            if s._out_index is not None:
                return new_base[s._out_index]
            return new_base
        return rebuild(self)

    # -- shape and type inference ----------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the shapes given by
        position or by name."""
        try:
            return self._infer_shape_impl(False, *args, **kwargs)
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError("infer_shape error: %s" % e) from e

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known = {}
        if args:
            for n, s in zip(arg_names, args):
                if s is not None:
                    known[n] = tuple(s)
        else:
            for k, v in kwargs.items():
                if v is not None:
                    known[k] = tuple(v)

        shapes = {}   # node name -> tuple, or a list of tuples
        dtypes = {}
        for n in self._topo():
            if n._op == "_group":
                continue
            if n._op is None:
                if n._is_literal():
                    lit = n._literal_value(cpu())
                    shapes[n._name] = () if isinstance(lit, float) \
                        else lit.shape
                    dtypes[n._name] = torch.float32
                elif n._name in known:
                    shapes[n._name] = known[n._name]
                    dtypes[n._name] = torch.float32
                else:
                    sh = n._attrs.get("__shape__")
                    if sh is not None:
                        sh = ast.literal_eval(sh) if isinstance(sh, str) \
                            else sh
                        if sh and all(d for d in sh):
                            shapes[n._name] = tuple(sh)
                            dtypes[n._name] = torch_dtype(
                                n._attrs.get("__dtype__", "float32"))
                            continue
                    # left open: a consumer's shape hint may fill it
                    shapes[n._name] = None
                continue

            def in_shape(i):
                s_in = shapes.get(i._name)
                if isinstance(s_in, list):
                    s_in = s_in[i._out_index or 0]
                return s_in
            in_shapes = [in_shape(i) for i in n._inputs]
            op = _reg.get(n._op)
            if any(s is None for s in in_shapes) and \
                    op.shape_hint is not None:
                filled = op.shape_hint(list(in_shapes), n._kwargs)
                for i, new, old in zip(n._inputs, filled, in_shapes):
                    if old is None and new is not None:
                        shapes[i._name] = tuple(new)
                in_shapes = [in_shape(i) for i in n._inputs]
            if any(s is None for s in in_shapes):
                if partial:
                    shapes[n._name] = None
                    continue
                missing = [i._name for i, s in zip(n._inputs, in_shapes)
                           if s is None]
                raise MXNetError(
                    "cannot infer shape: op %s (%s) has inputs with unknown "
                    "shapes: %s" % (n._name, n._op, missing))
            metas = [torch.empty(s, dtype=dtypes.get(i._name, torch.float32),
                                 device="meta")
                     for i, s in zip(n._inputs, in_shapes)]
            kw = {k: _parse_attr(v) for k, v in n._kwargs.items()}
            if op.creation:     # no input to take a device from
                kw["ctx"] = _MetaContext()
            with torch.no_grad(), autograd.pause(train_mode=False):
                out = op.fn(*metas, **kw)
            if isinstance(out, (tuple, list)):
                shapes[n._name] = [tuple(o.shape) for o in out]
                dtypes[n._name] = out[0].dtype
            else:
                shapes[n._name] = tuple(out.shape)
                dtypes[n._name] = out.dtype

        arg_shapes = [shapes.get(n) for n in arg_names]
        aux_shapes = [shapes.get(n) for n in aux_names]
        out_shapes = []
        for h in self._heads():
            sh = shapes.get(h._name)
            if isinstance(sh, list):
                if h._out_index is not None:
                    out_shapes.append(sh[h._out_index])
                else:
                    out_shapes.extend(sh)
            else:
                out_shapes.append(sh)
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """The reference's simplified dtype propagation: every argument and
        output takes the first dtype given (float32 by default), the
        auxiliary states float32."""
        dt = _np.float32
        if args:
            for a in args:
                if a is not None:
                    dt = _np.dtype(dtype_name(a))
                    break
        elif kwargs:
            dt = _np.dtype(dtype_name(list(kwargs.values())[0]))
        return ([dt] * len(self.list_arguments()),
                [dt] * len(self.list_outputs()),
                [_np.float32] * len(self.list_auxiliary_states()))

    # -- evaluation and binding ------------------------------------------
    def eval_with(self, feed, ctx=None, train=False, bn_updates=None):
        """Evaluate through `nd` ops (recorded when autograd records).
        `train` picks BatchNorm's statistics; each training-mode BatchNorm
        appends (moving_mean, moving_var, mean, var, momentum) NDArrays to
        `bn_updates` where given. Returns one NDArray or a list."""
        vals = {}
        for n in self._topo():
            if n._op == "_group":
                continue
            if n._op is None:
                lit = n._literal_value(ctx)
                if lit is not None:
                    vals[n._ident()] = lit
                elif n._name not in feed:
                    raise MXNetError("eval is missing input %s" % n._name)
                else:
                    vals[n._ident()] = feed[n._name]
                continue
            ins = []
            for i in n._inputs:
                v = vals[i._ident()]
                if isinstance(v, list) and i._out_index is not None:
                    v = v[i._out_index]
                elif isinstance(v, list) and len(v) == 1:
                    v = v[0]
                ins.append(v)
            kw = {k: _parse_attr(v) for k, v in n._kwargs.items()}
            if _reg.get(n._op) is _reg.get("BatchNorm"):
                call, stats = bn_call(kw, train)
                res = nd.invoke(n._op, *ins, ctx=ctx, **call)
                if stats:
                    if bn_updates is not None:
                        bn_updates.append((ins[3], ins[4], res[1], res[2],
                                           float(kw.get("momentum", 0.9))))
                    res = bn_output(res, kw)
                vals[n._ident()] = res
            else:
                vals[n._ident()] = nd.invoke(n._op, *ins, ctx=ctx, **kw)
        outs = []
        for h in self._heads():
            v = vals[h._ident()]
            if isinstance(v, list):
                if h._out_index is not None:
                    outs.append(v[h._out_index])
                else:
                    outs.extend(v)
            else:
                outs.append(v)
        return outs[0] if len(outs) == 1 else outs

    def _ident(self):
        # a base node's identity: (op, name) is unique in a graph
        return (self._op, self._name)

    def _literal_value(self, ctx=None):
        """A literal constant variable's value: a float, or a float32
        NDArray on `ctx`; None for any other variable."""
        a = self._attrs
        if "__literal__" in a:
            return float(a["__literal__"])
        if "__literal_zeros__" in a:
            return nd.zeros(ast.literal_eval(a["__literal_zeros__"]), ctx=ctx)
        if "__literal_ones__" in a:
            return nd.ones(ast.literal_eval(a["__literal_ones__"]), ctx=ctx)
        if "__literal_arange__" in a:
            start, stop, step = ast.literal_eval(a["__literal_arange__"])
            return nd.arange(start, stop, step, ctx=ctx)
        return None

    def eval(self, ctx=None, **kwargs):
        """Evaluate for inference with the arrays given by name; a list of
        NDArrays."""
        out = self.eval_with(kwargs, ctx)
        return out if isinstance(out, list) else [out]

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None,
             compile_graph=None):
        """An Executor over the given arrays. `compile_graph` pins the
        whole-graph route on or off (None: the MXNET_TPU_WHOLE_GRAPH
        gate)."""
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        compile_graph=compile_graph)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, compile_graph=None,
                    **kwargs):
        """Allocate zero arrays on `ctx` from the inferred shapes and
        bind them."""
        from .executor import Executor
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        type_dict = type_dict or {}
        var_dtypes = {n._name: n._attrs["__dtype__"] for n in self._topo()
                      if n._op is None and "__dtype__" in n._attrs}
        args = {}
        for name, shape in zip(arg_names, arg_shapes):
            if shape is None:
                raise MXNetError("simple_bind could not infer shape for "
                                 "argument %s" % name)
            args[name] = nd.zeros(shape, ctx=ctx, dtype=type_dict.get(
                name, var_dtypes.get(name, "float32")))
        aux = {name: nd.zeros(shape, ctx=ctx, dtype=type_dict.get(
            name, var_dtypes.get(name, "float32")))
            for name, shape in zip(aux_names, aux_shapes)}
        args_grad = None
        if grad_req != "null":
            args_grad = {name: nd.zeros(a.shape, ctx=ctx, dtype=a.dtype)
                         for name, a in args.items()}
        return Executor(self, ctx, args, args_grad, grad_req, aux,
                        compile_graph=compile_graph)

    # -- serialization (nnvm saveload_json) -------------------------------
    def tojson(self, remove_amp_cast=True):
        # a group is structural: its members are the heads (the reference
        # writes the group as an op node, which no loader can read back)
        nodes_list = [n for n in self._topo() if n._op != "_group"]
        index = {n._ident(): i for i, n in enumerate(nodes_list)}
        nodes = []
        arg_nodes = []
        for i, n in enumerate(nodes_list):
            if n._op is None:
                arg_nodes.append(i)
                entry = {"op": "null", "name": n._name, "inputs": []}
                if n._attrs:
                    entry["attrs"] = {k: str(v) for k, v in n._attrs.items()}
            else:
                entry = {
                    "op": n._op, "name": n._name,
                    "attrs": {k: str(v) for k, v in n._kwargs.items()},
                    "inputs": [[index[i_._ident()], i_._out_index or 0, 0]
                               for i_ in n._inputs]}
            nodes.append(entry)
        heads = [[index[h._ident()], h._out_index or 0, 0]
                 for h in self._heads()]
        graph = {"nodes": nodes, "arg_nodes": arg_nodes,
                 "node_row_ptr": list(range(len(nodes) + 1)),
                 "heads": heads,
                 "attrs": {"mxnet_version": ["int", 10900]}}
        return json.dumps(graph, indent=2)

    def save(self, fname, remove_amp_cast=True):
        """Write `tojson()` to `fname` (a ``-symbol.json``)."""
        with open(fname, "w") as f:
            f.write(self.tojson(remove_amp_cast=remove_amp_cast))

    # -- operators through the registry ----------------------------------
    def __add__(self, other):
        return _make_op("broadcast_add")(self, other)

    def __radd__(self, other):
        return _make_op("broadcast_add")(self, other)

    def __sub__(self, other):
        return _make_op("broadcast_sub")(self, other)

    def __rsub__(self, other):
        return _make_op("broadcast_sub")(other, self)

    def __mul__(self, other):
        return _make_op("broadcast_mul")(self, other)

    def __rmul__(self, other):
        return _make_op("broadcast_mul")(self, other)

    def __truediv__(self, other):
        return _make_op("broadcast_div")(self, other)

    def __rtruediv__(self, other):
        return _make_op("broadcast_div")(other, self)

    def __neg__(self):
        return _make_op("negative")(self)

    def __eq__(self, other):
        return _make_op("broadcast_equal")(self, other)

    def __ne__(self, other):
        return _make_op("broadcast_not_equal")(self, other)

    def __lt__(self, other):
        return _make_op("broadcast_lesser")(self, other)

    def __le__(self, other):
        return _make_op("broadcast_lesser_equal")(self, other)

    def __gt__(self, other):
        return _make_op("broadcast_greater")(self, other)

    def __ge__(self, other):
        return _make_op("broadcast_greater_equal")(self, other)

    __hash__ = object.__hash__

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape") is not None:
            shape = tuple(kwargs["shape"])
        return _make_op("reshape")(self, shape=shape)

    def sum(self, axis=None, keepdims=False):
        return _make_op("sum")(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return _make_op("mean")(self, axis=axis, keepdims=keepdims)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _make_op("transpose")(self, axes=axes if axes else None)

    def swapaxes(self, dim1, dim2):
        return _make_op("swapaxes")(self, dim1=dim1, dim2=dim2)

    def astype(self, dtype):
        return _make_op("cast")(self, dtype=dtype_name(dtype))

    def slice_axis(self, axis, begin, end):
        return _make_op("slice_axis")(self, axis=axis, begin=begin, end=end)

    def flatten(self):
        return _make_op("flatten")(self)

    def square(self):
        return _make_op("square")(self)

    def sqrt(self):
        return _make_op("sqrt")(self)

    def exp(self):
        return _make_op("exp")(self)

    def log(self):
        return _make_op("log")(self)

    def abs(self):
        return _make_op("abs")(self)

    def softmax(self, axis=-1):
        return _make_op("softmax")(self, axis=axis)

    def log_softmax(self, axis=-1):
        return _make_op("log_softmax")(self, axis=axis)

    def dot(self, other, **kwargs):
        return _make_op("dot")(self, other, **kwargs)

    @property
    def T(self):
        return self.transpose()


def _parse_attr(v):
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """A symbolic variable."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable `name`")
    from ..attribute import current as _attr_current
    attrs = _attr_current()       # the AttrScope's; explicit ones win
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if init is not None:
        if not isinstance(init, str):
            init = init.dumps()
        attrs["__init__"] = init
    if stype is not None:
        attrs["__storage_type__"] = str(stype)
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            attrs[k] = str(v)
    return Symbol(op=None, name=name, attrs=attrs)


var = Variable


def Group(symbols):
    """Several symbols as one multi-output symbol."""
    if not symbols or any(not isinstance(s, Symbol) for s in symbols):
        raise TypeError("Expected a list of symbols as input")
    return Symbol(op="_group", name="_group", inputs=list(symbols))


def load_json(json_str):
    """A Symbol from NNVM JSON (the reference's or upstream's)."""
    graph = json.loads(json_str)
    built = []
    for entry in graph["nodes"]:
        if entry["op"] == "null":
            built.append(Variable(entry["name"],
                                  attr=entry.get("attrs", {})))
            continue
        ins = []
        for (src, out_i, _) in entry["inputs"]:
            s = built[src]
            # slot 0 of a multi-output node still needs slicing: the bare
            # symbol is the whole output group
            if s._num_outputs > 1:
                s = s[out_i]
            ins.append(s)
        kwargs = {k: _parse_attr(v) for k, v in entry.get("attrs",
                                                          {}).items()}
        op = _reg.get(entry["op"])
        n_out = op.num_outputs or int(kwargs.get(
            "num_outputs", kwargs.get("num_weights", 1)))
        built.append(Symbol(entry["op"], entry["name"], ins, kwargs=kwargs,
                            num_outputs=n_out))
    heads = []
    for (idx, out_i, _) in graph["heads"]:
        s = built[idx]
        if s._num_outputs > 1:
            s = s[out_i]
        heads.append(s)
    return heads[0] if len(heads) == 1 else Group(heads)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------------------
# the op namespace, generated from the registry
# ---------------------------------------------------------------------------
# Tensor-input parameter names: the reference's NNVM registration lists an
# op's tensor arguments; here they are the leading parameters of the
# registered function whose names are in this set.
_TENSOR_PARAMS = frozenset([
    "data", "weight", "bias", "gamma", "beta", "moving_mean", "moving_var",
    "label", "lhs", "rhs", "parameters", "state", "state_cell", "grid",
    "indices", "index", "condition", "x", "y", "a", "b", "positive",
    "negative", "input1", "input2", "query", "key_arr", "value", "mean",
    "var", "mom", "weight32", "grad", "loc", "rois", "anchors", "score"])


def _op_tensor_slots(op):
    """Ordered tensor-input slot names from the function's signature;
    None for variadic ops."""
    import inspect
    try:
        sig = inspect.signature(op.fn)
    except (ValueError, TypeError):
        return None
    slots = []
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            return None
        if p.name in _TENSOR_PARAMS:
            slots.append(p.name)
        else:
            break
    return slots


def _auto_var_skip(op_name, slot, kwargs):
    """Slots the reference's ListArguments leaves out."""
    if slot == "bias" and kwargs.get("no_bias"):
        return True
    if op_name == "LeakyReLU" and slot == "gamma" and \
            kwargs.get("act_type", "leaky") != "prelu":
        return True
    return False


def _make_op(op_name):
    op = _reg.get(op_name)
    # a creation op takes no array: `loc` is _random_normal's mean, not
    # an input (the reference makes it an auto-variable, so its
    # sym.random.normal cannot infer a shape)
    slots = [] if op.creation else _op_tensor_slots(op)

    def sym_op(*args, name=None, attr=None, **kwargs):
        sym_kwargs = {}
        filled = {}
        extras = []
        pos_inputs = []
        for a in args:
            if isinstance(a, Symbol) or a is None:
                pos_inputs.append(a)
            else:
                pos_inputs.append(_scalar_const(a))
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                if slots and k in slots:
                    filled[k] = v
                else:
                    extras.append(v)
            elif v is not None:
                sym_kwargs[k] = v
        name = NameManager.current.get(name, op_name.lower().strip("_"))
        if not slots:
            inputs = [i for i in pos_inputs if i is not None] + extras
        else:
            # positional arguments fill the slots in order; a slot left
            # empty gets the reference's auto-variable `{name}_{slot}`
            for i, a in enumerate(pos_inputs):
                if a is not None and i < len(slots):
                    filled.setdefault(slots[i], a)
                elif a is not None:
                    extras.append(a)
            inputs = []
            for slot in slots:
                if slot in filled:
                    inputs.append(filled[slot])
                elif _auto_var_skip(op_name, slot, sym_kwargs):
                    continue
                else:
                    v = Variable("%s_%s" % (name, slot))
                    if slot in ("moving_mean", "moving_var"):
                        v._attrs["__aux__"] = "True"
                    inputs.append(v)
            inputs.extend(extras)
        # ops with a data-dependent output count register num_outputs=0
        n_out = op.num_outputs or int(sym_kwargs.get(
            "num_outputs", sym_kwargs.get("num_weights", 1)))
        from ..attribute import current as _attr_current
        merged = _attr_current()
        merged.update(attr or {})
        return Symbol(op_name, name, inputs, attrs=merged, kwargs=sym_kwargs,
                      num_outputs=n_out)

    sym_op.__name__ = op_name.lstrip("_") or op_name
    sym_op.__doc__ = op.doc or ("%s (symbolic, from the op registry)"
                                % op_name)
    return sym_op


_SCALAR_COUNT = [0]


def _scalar_const(value):
    """A Python scalar operand as a literal variable."""
    name = "_scalarconst%d" % _SCALAR_COUNT[0]
    _SCALAR_COUNT[0] += 1
    v = Variable(name)
    v._attrs["__literal__"] = str(float(value))
    return v


def populate(namespace, names=None):
    for op_name in (names or _reg.list_ops()):
        namespace.setdefault(op_name, _make_op(op_name))
    return namespace


def zeros(shape, dtype=None, **kwargs):
    v = Variable(NameManager.current.get(None, "zeros"))
    v._attrs["__literal_zeros__"] = str(
        (shape,) if isinstance(shape, int) else tuple(shape))
    return v


def ones(shape, dtype=None, **kwargs):
    v = Variable(NameManager.current.get(None, "ones"))
    v._attrs["__literal_ones__"] = str(
        (shape,) if isinstance(shape, int) else tuple(shape))
    return v


def arange(start, stop=None, step=1.0, ctx=None, dtype=None, **kwargs):
    v = Variable(NameManager.current.get(None, "arange"))
    v._attrs["__literal_arange__"] = str((start, stop, step))
    return v
