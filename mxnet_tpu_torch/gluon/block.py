"""Gluon Block / HybridBlock (the port of `mxnet_tpu.gluon.block`).

Kept from the reference: child registration by attribute, prefix scoping
(so parameter names match the reference's), parameter collection, both
`.params` file forms of `save_parameters`/`load_parameters`, `cast`,
`initialize`, and the `hybrid_forward(F, x, *args, **params)` calling
convention with deferred parameter shapes resolved from the first input.

Forward hooks (`register_forward_pre_hook`, `register_forward_hook`) run
in `Block.__call__`, so they fire for a hybridized block too, and
`summary` prints the reference's per-layer table through them.

Auxiliary states (BatchNorm's running statistics) change through
`record_aux_update`: written at once outside the graph, or collected while
a `FusedTrainStep` runs and written after its update.

A HybridBlock called on a `Symbol` runs `hybrid_forward` with F the
`mx.sym` namespace and its parameters as variables (`Parameter.var`), so a
network traces to a graph: `export` writes it with the parameters
(``path-symbol.json``, ``path-%04d.params``), `SymbolBlock` wraps a graph
as a block and `SymbolBlock.imports` loads an exported model.

Deviation: `hybridize` records its flags and the forward stays eager. The
reference traces the block into one compiled program (its CachedOp); the
port's counterpart, capturing the training step as one CUDA graph, is
later work.
"""
from __future__ import annotations

import re
import threading
import warnings
from collections import OrderedDict

import numpy as _np
import torch

from .. import ndarray as nd
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "record_aux_update"]

# per thread: a stack of lists that collect (aux array, new value) pairs
# while a FusedTrainStep runs its forward
_AUX_COLLECTOR = threading.local()


def record_aux_update(aux_nd, new_value):
    """Set an auxiliary state (e.g. BatchNorm's running mean) to
    `new_value`, a tensor computed from detached statistics. Outside a
    `FusedTrainStep` it is written at once, under ``torch.no_grad()``, so
    the running statistics never enter the graph; inside one the update is
    collected and written after the step (reference:
    `gluon.block.record_aux_update`)."""
    stack = getattr(_AUX_COLLECTOR, "stack", None)
    if stack:
        stack[-1].append((aux_nd, new_value))
        return
    with torch.no_grad():
        aux_nd._data.copy_(new_value)


class _BlockScope:
    """Name scoping for Blocks."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """Create prefix and params for a new Block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from ..name import NameManager
                prefix = NameManager.current.get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        from ..name import Prefix
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


def is_symbol(x):
    """Whether `x` is a `mx.sym.Symbol` (a block traced to a graph)."""
    from ..symbol import Symbol
    return isinstance(x, Symbol)


def _flatten(args, inout_str):
    """A nested list/tuple of arrays -> (flat list, format for
    `_regroup`)."""
    if isinstance(args, nd.NDArray):
        return [args], 0
    if args is None:
        return [None], None
    if not isinstance(args, (list, tuple)):
        raise ValueError("HybridBlock %s must be (nested) list of NDArray, "
                         "but got %s of type %s"
                         % (inout_str, str(args), str(type(args))))
    flat, fmts = [], []
    for i in args:
        arg, fmt = _flatten(i, inout_str)
        flat.extend(arg)
        fmts.append(fmt)
    return flat, fmts


def _regroup(args, fmt):
    """The inverse of `_flatten`: (nested value, rest of `args`)."""
    if isinstance(fmt, int):
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    if fmt is None:
        return None, args[1:]
    ret = []
    for i in fmt:
        res, args = _regroup(args, i)
        ret.append(res)
    return ret, args


class _HookHandle:
    """Returned by the hook registrations; `detach` removes the hook."""

    _next_id = [0]

    def __init__(self, hooks_dict):
        self._hooks_dict = hooks_dict
        self.id = _HookHandle._next_id[0]
        _HookHandle._next_id[0] += 1

    def detach(self):
        self._hooks_dict.pop(self.id, None)


def _indent(s, num_spaces):
    lines = s.split("\n")
    return "\n".join([lines[0]] + [num_spaces * " " + ln
                                   for ln in lines[1:]])


class Block:
    """Base building block."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}
        self._forward_pre_hooks = OrderedDict()
        self._forward_hooks = OrderedDict()

    def __repr__(self):
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=_indent(repr(block), 2))
            for key, block in self.__dict__.items()
            if isinstance(block, Block))
        return "{name}(\n{modstr}\n)".format(name=self.__class__.__name__,
                                             modstr=modstr)

    def __setattr__(self, name, value):
        """Registers parameters and children by assignment."""
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError(
                    "Changing attribute type for {name} from {type1} to "
                    "{type2} is not allowed.".format(
                        name=name, type1=type(existing), type2=type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if name in self._reg_params:
                raise AssertionError(
                    "Overriding Parameter attribute %s is not allowed. To "
                    "share parameters between blocks, pass them through "
                    "`params` at Block construction." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """`with self.name_scope():` prefixes the children made inside."""
        return self._scope

    @property
    def params(self):
        """Direct parameters only (no children)."""
        return self._params

    def collect_params(self, select=None):
        """All parameters of self and its descendants, optionally filtered
        by a regular expression."""
        self._check_container_with_block()
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def _check_container_with_block(self):
        children = set(self._children.values())
        for k, v in self.__dict__.items():
            if isinstance(v, (list, tuple, dict)) and k != "_children":
                it = v.values() if isinstance(v, dict) else v
                for item in it:
                    if isinstance(item, Block) and item not in children:
                        warnings.warn(
                            "'%s' is an unregistered container with Blocks. "
                            "Blocks inside a list, tuple or dict are not "
                            "registered automatically; use register_child() "
                            "or nn.Sequential/nn.HybridSequential." % k,
                            stacklevel=3)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_pre_hook(self, hook):
        """`hook(block, args)` runs before each forward; returns a handle
        whose `detach` removes it."""
        handle = _HookHandle(self._forward_pre_hooks)
        self._forward_pre_hooks[handle.id] = hook
        return handle

    def register_forward_hook(self, hook):
        """`hook(block, args, outputs)` runs after each forward; returns a
        handle whose `detach` removes it."""
        handle = _HookHandle(self._forward_hooks)
        self._forward_hooks[handle.id] = hook
        return handle

    def apply(self, fn):
        """Apply fn recursively to the children, then self."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from .. import initializer as _init
        if init is None:
            init = _init.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def save_parameters(self, filename, deduplicate=False):
        """Save parameters under their structural names (``features.0.
        weight``), loadable by any instance of the same architecture."""
        params = self._collect_params_with_prefix()
        if deduplicate:
            reverse = {}
            for k, v in params.items():
                reverse.setdefault(id(v), []).append(k)
            params = {ks[0]: params[ks[0]] for ks in reverse.values()}
        nd.save(filename, {k: v._reduce() for k, v in params.items()})

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a `.params` file in either form: structural names from
        `save_parameters`, or full prefixed names from
        `ParameterDict.save`. Without `ctx`, uninitialized parameters go to
        the current context."""
        loaded = nd.load(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in i for i in loaded.keys()):
            # ParameterDict.save format with full prefixes
            del loaded
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix,
                cast_dtype=cast_dtype, dtype_source=dtype_source)
            return
        if not allow_missing:
            for name in params.keys():
                if name not in loaded:
                    raise AssertionError(
                        "Parameter '%s' is missing in file '%s', which "
                        "contains parameters: %s. Set allow_missing=True to "
                        "ignore missing parameters."
                        % (name, filename, ", ".join(sorted(loaded.keys()))))
        for name in loaded:
            if not ignore_extra and name not in params:
                raise ValueError(
                    "Parameter '%s' loaded from file '%s' is not present in "
                    "this block, which contains parameters %s. Set "
                    "ignore_extra=True to ignore." %
                    (name, filename, ", ".join(sorted(params.keys()))))
            if name in params:
                params[name]._load_init(loaded[name], ctx,
                                        cast_dtype=cast_dtype,
                                        dtype_source=dtype_source)

    def cast(self, dtype):
        """Cast every parameter (layers may keep some in fp32)."""
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def zero_grad(self):
        """Zero the gradients of every parameter of the block."""
        self.collect_params().zero_grad()

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Run one forward on `inputs` and print each layer's output shape
        and parameter counts (total, trainable, shared), as the reference
        prints them. Parameters whose shape waits for the first input are
        counted after it. The block must not be hybridized."""
        summary = OrderedDict()
        seen = set()
        hooks = []

        def shape_str(args):
            flat, fmts = _flatten(args, "input")
            shapes = [x.shape if isinstance(x, nd.NDArray) else x
                      for x in flat]
            return str(_regroup(shapes, fmts)[0]).replace("'", "")

        def add_hook(block):
            if isinstance(block, HybridBlock) and block._active:
                raise AssertionError(
                    "\"{}\" must not be hybridized to print summary."
                    .format(block.name))

            def hook(block, _, outputs):
                key = "%s-%i" % (block.__class__.__name__, len(summary))
                row = summary[key] = OrderedDict()
                row["output_shape"] = shape_str(outputs)
                row["n_params"] = row["trainable"] = row["shared"] = 0
                for p in block.params.values():
                    size = p.data().size
                    row["n_params"] += size
                    row["trainable"] += 0 if p.grad_req == "null" else size
                    if id(p) in seen:
                        row["shared"] += size
                    else:
                        seen.add(id(p))

            from .nn.basic_layers import HybridSequential, Sequential
            if not isinstance(block, (Sequential, HybridSequential)):
                hooks.append(block.register_forward_hook(hook))

        summary["Input"] = OrderedDict(output_shape=shape_str(inputs),
                                       n_params=0, trainable=0, shared=0)
        try:
            self.apply(add_hook)
            self(*inputs)
            line_format = "{:>20}  {:>42} {:>15}"
            print("-" * 80)
            print(line_format.format("Layer (type)", "Output Shape",
                                     "Param #"))
            print("=" * 80)
            total = trainable = shared = 0
            for layer, row in summary.items():
                print(line_format.format(layer, str(row["output_shape"]),
                                         row["n_params"]))
                total += row["n_params"]
                trainable += row["trainable"]
                shared += row["shared"]
            print("=" * 80)
            print("Parameters in forward computation graph, duplicate "
                  "included")
            print("   Total params: " + str(total))
            print("   Trainable params: " + str(trainable))
            print("   Non-trainable params: " + str(total - trainable))
            print("Shared params in forward computation graph: "
                  + str(shared))
            print("Unique parameters in model: " + str(total - shared))
            print("-" * 80)
        finally:
            for h in hooks:
                h.detach()

    def __call__(self, *args):
        """Run the forward pre-hooks, `forward`, then the forward hooks."""
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        """Override to define computation."""
        raise NotImplementedError


class HybridBlock(Block):
    """Block whose computation is `hybrid_forward(F, x, *args, **params)`,
    with F the `nd` namespace and this block's parameters passed as
    keyword NDArrays on the input's context."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (str(block), str(type(block))))
        super().register_child(block, name)

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Record the flags, here and in the children. The forward stays
        eager in the port."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        for cld in self._children.values():
            cld.hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _infer_param_shapes(self, *args):
        """Resolve deferred shapes from the input (the layer's
        `_shape_from_input`), then finish their initialization."""
        hook = getattr(self, "_shape_from_input", None)
        if hook is not None:
            hook(*args)
        for p in self._reg_params.values():
            p._finish_deferred_init()

    def forward(self, x, *args):
        """Eager on NDArrays; on Symbols, `hybrid_forward` with F the
        symbol namespace and the parameters as variables."""
        if is_symbol(x):
            return self._symbolic_forward(x, *args)
        if not isinstance(x, nd.NDArray):
            raise ValueError("HybridBlock input must be NDArray or Symbol, "
                             "got %s" % type(x))
        self._cached_graph_inputs = [x.shape] + [
            a.shape for a in args if isinstance(a, nd.NDArray)]
        ctx = x.context
        try:
            params = {k: v.data(ctx) for k, v in self._reg_params.items()}
        except DeferredInitializationError:
            self._infer_param_shapes(x, *args)
            params = {k: v.data(ctx) for k, v in self._reg_params.items()}
        return self.hybrid_forward(nd, x, *args, **params)

    def _symbolic_forward(self, *syms):
        """forward() on Symbol inputs."""
        from .. import symbol
        params = {k: v.var() for k, v in self._reg_params.items()}
        return self.hybrid_forward(symbol, *syms, **params)

    def _trace_symbol(self, n_inputs=1):
        """This block as a graph over inputs named data, data1, ..."""
        from .. import symbol
        data = [symbol.var("data%d" % i if i else "data")
                for i in range(n_inputs)]
        out = self._symbolic_forward(*data)
        if isinstance(out, (list, tuple)):
            out = symbol.Group(list(out))
        return out

    def infer_shape(self, *args):
        """Resolve the parameters' unknown dims from input arrays by
        symbolic shape inference over the traced graph."""
        out = self._trace_symbol(len(args))
        known = {("data%d" % i if i else "data"): a.shape
                 for i, a in enumerate(args)}
        arg_shapes, _, aux_shapes = out.infer_shape(**known)
        params = self.collect_params()
        for name, shape in zip(out.list_arguments() +
                               out.list_auxiliary_states(),
                               arg_shapes + aux_shapes):
            if name in params and shape is not None:
                params[name].shape = shape

    def infer_type(self, *args):
        """Give the parameters that are not initialized yet the dtype the
        traced graph infers for them (the reference's simplified rule: the
        first input's dtype, float32 for auxiliary states)."""
        out = self._trace_symbol(len(args))
        arg_types, _, aux_types = out.infer_type(*[a.dtype for a in args])
        params = self.collect_params()
        for name, dt in zip(out.list_arguments() +
                            out.list_auxiliary_states(),
                            arg_types + aux_types):
            if name in params and params[name]._data is None:
                params[name].dtype = _np.dtype(dt).name

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write the traced graph to ``path-symbol.json`` and the
        parameters to ``path-%04d.params`` (``arg:``/``aux:`` keys, so
        `SymbolBlock.imports` and `Module.load` read them). The block must
        be hybridized and have run forward once."""
        if not self._active:
            raise RuntimeError(
                "Please first call block.hybridize() and then run forward "
                "with this block at least once before calling export.")
        inputs = getattr(self, "_cached_graph_inputs", None)
        if inputs is None:
            raise RuntimeError(
                "Please run forward with this block at least once before "
                "calling export.")
        out = self._trace_symbol(len(inputs))
        out.save("%s-symbol.json" % path, remove_amp_cast=remove_amp_cast)
        aux = set(out.list_auxiliary_states())
        arg_dict = {("aux:%s" if name in aux else "arg:%s") % name:
                    param._reduce()
                    for name, param in self.collect_params().items()}
        nd.save("%s-%04d.params" % (path, epoch), arg_dict)
        return "%s-symbol.json" % path, "%s-%04d.params" % (path, epoch)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """Override to define computation."""
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A symbol graph as a block: every argument that is not an input, and
    every auxiliary state, becomes a parameter (deferred until loaded or
    initialized). On NDArrays the graph runs op by op under the port's
    autograd; BatchNorm takes the batch's statistics and moves the moving
    ones while `autograd.is_training()`, the moving ones otherwise. On
    Symbols it composes."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from an exported ``-symbol.json`` and, optionally,
        its ``.params`` (on `ctx`, default the current context)."""
        from .. import symbol
        out = symbol.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(out, [symbol.var(i) for i in input_names])
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx, cast_dtype=True,
                                      dtype_source="saved")
        elif ctx is not None:
            ret.collect_params().reset_ctx(ctx)
        return ret

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=None)
        self._prefix = ""
        self._params = ParameterDict("", params)
        from .. import symbol
        if is_symbol(inputs):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = symbol.Group(list(outputs))
        self._input_names = [s.name for s in inputs]
        self._output = outputs
        for name in outputs.list_arguments():
            if name not in self._input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            self.params.get(name, grad_req="null", allow_deferred_init=True)

    def forward(self, x, *args):
        from .. import autograd
        if is_symbol(x):
            return self._output._compose_with(
                dict(zip(self._input_names, [x] + list(args))))
        ctx = x.context
        feed = dict(zip(self._input_names, [x] + list(args)))
        for name, p in self.params.items():
            if p._data is not None:
                feed[name] = p.data(ctx)
        updates = []
        out = self._output.eval_with(feed, ctx, train=autograd.is_training(),
                                     bn_updates=updates)
        for mm, mv, mean, var, m in updates:
            for moving, batch in ((mm, mean), (mv, var)):
                record_aux_update(moving, moving.data_torch * m +
                                  batch.data_torch.to(moving._data.dtype)
                                  * (1 - m))
        return out

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
