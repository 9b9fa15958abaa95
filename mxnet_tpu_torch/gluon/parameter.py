"""Gluon Parameter / ParameterDict (the port of
`mxnet_tpu.gluon.parameter`).

Kept from the reference: deferred shape initialization (0-dims resolved on
the first forward), per-context copies, shared parameters through
ParameterDict prefixes, the `.params` load rules (shape and dtype checks,
`cast_dtype`), gradient buffers by `grad_req` ("write" overwrites, "add"
accumulates, "null" has none): each context's data array is marked as a
variable of the tape (`autograd.mark_variable`) with a zero buffer of its
shape and dtype beside it, which `autograd.backward` fills. Row-sparse
parameters: ``grad_stype="row_sparse"`` makes that buffer a
`RowSparseNDArray` (the rows a backward touched; none after `zero_grad`),
and ``stype="row_sparse"`` a weight that its `Trainer` keeps on a store:
`row_sparse_data` pulls the rows a batch needs from that store into the
replica (dense on each context here, densified when saved, as in the
reference).

Deviation: a parameter that is loaded or initialized without a context
goes to the current context (`gpu(0)` by default), not to `cpu(0)`; see
`mxnet_tpu_torch.context`.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd, initializer
from .. import ndarray as nd
from ..base import MXNetError, dtype_name
from ..context import Context, cpu, current_context
from ..ndarray.ndarray import _zero_buffer
from ..numpy.multiarray import np_view
from ..numpy_extension import is_np_array

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


_STYPES = ("default", "row_sparse", "csr")


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its deferred shape is known."""


class Parameter:
    """A weight or auxiliary tensor held by Blocks."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._data = None          # OrderedDict[Context, NDArray]
        self._grad = None          # OrderedDict[Context, NDArray] or None
        self._deferred_init = ()
        self.name = name
        self._differentiable = differentiable
        self._grad_req = None
        self.grad_req = grad_req
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        for name_, st in (("stype", stype), ("grad_stype", grad_stype)):
            if st not in _STYPES:
                raise ValueError("invalid %s %s for Parameter '%s'; valid "
                                 "are %s" % (name_, st, name, _STYPES))
        self._stype = stype
        self._grad_stype = grad_stype
        self._trainer = None       # weakref to the Trainer that updates it
        self._var = None           # the symbolic variable, made once

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                       self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write/add/null, got %s" % req)
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if self._data is not None:
            self._init_grad()

    @property
    def stype(self):
        return self._stype

    @property
    def grad_stype(self):
        return self._grad_stype

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        # only unknown (0) dims may be refined
        if len(self._shape) != len(new_shape) or any(
                s != n and s != 0 for s, n in zip(self._shape, new_shape)):
            raise AssertionError(
                "Expected shape %s is incompatible with given shape %s for "
                "Parameter %s" % (str(new_shape), str(self._shape),
                                  self.name))
        self._shape = tuple(new_shape)

    def _check_and_get(self, arr_dict, ctx):
        if arr_dict is not None:
            if ctx is list:
                return list(arr_dict.values())
            if ctx is None:
                if len(arr_dict) == 1:
                    return list(arr_dict.values())[0]
                ctx = current_context()
            if ctx in arr_dict:
                return arr_dict[ctx]
            for c, v in arr_dict.items():
                if c.device_type == ctx.device_type:
                    return v
            raise RuntimeError(
                "Parameter '%s' was not initialized on context %s. It was "
                "only initialized on %s." % (self.name, ctx,
                                             list(arr_dict.keys())))
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass." % self.name)
        raise RuntimeError(
            "Parameter '%s' has not been initialized. You should initialize "
            "parameters with Block.collect_params() instead of Block.params "
            "because the later does not include Parameters of nested child "
            "Blocks" % self.name)

    def _load_init(self, data, ctx, cast_dtype=False,
                   dtype_source="current"):
        """Set data from a loaded checkpoint (an NDArray)."""
        if self.shape:
            for s, d in zip(self.shape, data.shape):
                if s != 0 and s != d:
                    raise AssertionError(
                        "Failed loading Parameter '%s' from saved params: "
                        "shape incompatible expected %s vs saved %s"
                        % (self.name, str(self.shape), str(data.shape)))
            self._shape = tuple(data.shape)
        saved = dtype_name(data.dtype)
        if cast_dtype and saved != self.dtype:
            if dtype_source == "current":
                data = data.astype(self.dtype)
            else:
                self.dtype = saved
        elif saved != self.dtype:
            raise AssertionError(
                "Failed loading Parameter '%s' from saved params: dtype "
                "incompatible expected %s vs saved %s. Set cast_dtype=True "
                "to cast the dtype of saved params." % (self.name,
                                                        self.dtype, saved))
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is None:
            if self._deferred_init:
                if ctx is not None and \
                        set(ctx) != set(self._deferred_init[1]):
                    raise AssertionError(
                        "Failed to load Parameter '%s' on %s because it was "
                        "previous initialized on %s." %
                        (self.name, str(ctx), str(self.list_ctx())))
                ctx = self._deferred_init[1]
            elif ctx is None:
                ctx = [current_context()]
            self._init_impl(data, ctx)
        else:
            for arr in self._check_and_get(self._data, list):
                arr[:] = data
        self._deferred_init = ()

    def _finish_deferred_init(self):
        """Run the stored init once the shape is fully known."""
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        self._deferred_init = ()
        if self._shape is None or any(d == 0 for d in self._shape):
            raise ValueError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s." % (self.name, str(self._shape)))
        if data is None:
            data = nd.zeros(self._shape, dtype=self.dtype, ctx=cpu())
            initializer.create(default_init)(
                initializer.InitDesc(self.name, {
                    "__init__": init.dumps() if init else ""}), data)
        self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        if not isinstance(data, nd.NDArray):
            data = nd.array(np.asarray(data), dtype=self.dtype, ctx=cpu())
        self._data = OrderedDict(
            (ctx, data.copyto(ctx)) for ctx in ctx_list)
        self._init_grad()

    def _init_grad(self):
        """A zero gradient buffer beside each context's data, and the data
        marked as a variable of the tape (or unmarked for "null")."""
        if self.grad_req == "null":
            self._grad = None
            for d in self._data.values():
                d._grad = None
                autograd.mark_variable(d, "null")
            return
        self._grad = OrderedDict()
        for ctx, d in self._data.items():
            g = nd.sparse.zeros(
                "row_sparse" if self._grad_stype == "row_sparse"
                else "default", d.shape, ctx=ctx,
                dtype=dtype_name(d._data.dtype))
            self._grad[ctx] = g
            d._grad = g
            autograd.mark_variable(d, self.grad_req)

    def _reduce(self):
        """The data on the host (used by save), dense whatever the stype;
        the mean over contexts when there are several."""
        blocks = self._check_and_get(self._data, list)
        if len(blocks) == 1:
            return blocks[0].copyto(cpu())
        acc = blocks[0].copyto(cpu()).astype("float64")
        for b in blocks[1:]:
            acc = acc + b.copyto(cpu())
        return (acc / len(blocks)).astype(self.dtype)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize on `ctx` (default the current context); deferred
        while the shape has unknown (0) dims."""
        if default_init is None:
            default_init = initializer.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if init is None:
            init = default_init if self.init is None else self.init
        init = initializer.create(init) if isinstance(init, str) else init
        if self._shape is None or any(d == 0 for d in self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, None)
                return
            raise ValueError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s. Please specify in_units, in_channels, etc for "
                "`Block`s." % (self.name, str(self._shape)))
        self._deferred_init = (init, ctx, default_init, None)
        self._finish_deferred_init()

    def set_data(self, data):
        """Overwrite the data on every context (or the pending data of a
        deferred init)."""
        self.shape = data.shape
        if self._data is None:
            if not self._deferred_init:
                raise AssertionError(
                    "Parameter '%s' has not been initialized" % self.name)
            self._deferred_init = self._deferred_init[:3] + (
                data if isinstance(data, nd.NDArray)
                else nd.array(data, ctx=cpu()),)
            return
        for arr in self._check_and_get(self._data, list):
            arr[:] = data

    def data(self, ctx=None):
        """The data on `ctx`; refused for a row-sparse stype, whose rows
        come through `row_sparse_data`. Under `npx.set_np()` it is an
        `mx.np.ndarray` view over the same tensor and gradient buffer (one
        view per payload, so every use site of the parameter feeds one
        gradient)."""
        if self._stype != "default":
            raise RuntimeError(
                "Cannot return a copy of Parameter '%s' on ctx %s via data() "
                "because its storage type is %s. Please use row_sparse_data() "
                "instead." % (self.name, str(ctx), self._stype))
        out = self._check_and_get(self._data, ctx)
        if not is_np_array():
            return out
        cache = self.__dict__.get("_np_views")
        if cache is None:
            cache = self.__dict__["_np_views"] = {}
        view = cache.get(id(out))
        if view is None or view[0] is not out or view[1]._data is not \
                out._data:
            view = cache[id(out)] = (out, np_view(out))
        v = view[1]
        # attach_grad / zero_grad may have swapped the tensor or buffer
        v._grad, v._grad_req = out._grad, out._grad_req
        return v

    def _set_trainer(self, trainer):
        """Note the Trainer that updates this parameter; a row-sparse
        weight lives on that Trainer's store, so it takes only one."""
        if self._stype != "default" and self._trainer is not None \
                and trainer is not None and self._trainer() is not trainer:
            raise RuntimeError(
                "Failed to set the trainer for Parameter '%s' because it was "
                "already set. More than one trainers for a %s Parameter is "
                "not supported." % (self.name, self._stype))
        self._trainer = weakref.ref(trainer) if trainer is not None else None

    def _get_row_sparse(self, ctx, row_id):
        """The replica(s) on `ctx` (None: `row_id`'s context) with the rows
        `row_id` pulled from the Trainer's store (upstream MXNet's
        `_get_row_sparse`; the other rows keep what they held)."""
        if not isinstance(row_id, nd.NDArray):
            raise TypeError("row_id must have NDArray type, but %s is given"
                            % type(row_id))
        trainer = self._trainer() if self._trainer is not None else None
        if trainer is None:
            raise RuntimeError(
                "Cannot get row_sparse data for Parameter '%s' when no "
                "Trainer is created with it." % self.name)
        arrs = self._check_and_get(self._data, ctx or row_id.context)
        for arr in (arrs if isinstance(arrs, list) else [arrs]):
            rows = nd.sparse.zeros("row_sparse", arr.shape, ctx=arr.context,
                                   dtype=arr.dtype)
            trainer._row_sparse_pull(self, rows, row_id)
            with torch.no_grad():
                arr._data[rows._indices.long()] = rows._values
        return arrs

    def row_sparse_data(self, row_id):
        """The data on `row_id`'s context, for a row-sparse stype, with the
        rows `row_id` names pulled from its Trainer's store (which updated
        them). The JAX reference's version calls `data()`, which refuses
        this stype, so it always raises there; this is upstream MXNet's."""
        if self._stype != "row_sparse":
            raise RuntimeError(
                "Cannot return a copy of Parameter %s via row_sparse_data() "
                "because its storage type is %s" % (self.name, self._stype))
        return self._get_row_sparse(None, row_id)

    def list_row_sparse_data(self, row_id):
        """The data on every context, for a row-sparse stype, with the rows
        `row_id` names pulled as in `row_sparse_data`."""
        if self._stype != "row_sparse":
            raise RuntimeError(
                "Cannot return copies of Parameter '%s' on all contexts via "
                "list_row_sparse_data() because its storage type is %s"
                % (self.name, self._stype))
        return self._get_row_sparse(list, row_id)

    def list_data(self):
        return self._check_and_get(self._data, list)

    def grad(self, ctx=None):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)
        return self._check_and_get(self._grad, ctx)

    def list_grad(self):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)
        return self._check_and_get(self._grad, list)

    def zero_grad(self):
        """Zero the gradients (a row-sparse buffer keeps no rows)."""
        if self._grad is None:
            return
        for g in self._grad.values():
            _zero_buffer(g)

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise RuntimeError("Parameter '%s' has not been initialized"
                               % self.name)
        return list(self._data.keys())

    def var(self):
        """The symbolic variable of this parameter (a Gluon block's inputs
        when it is traced to a symbol), with its shape (0 for an unknown
        dim), dtype, initializer, multipliers and storage type as
        attributes."""
        if self._var is None:
            from .. import symbol
            self._var = symbol.var(self.name, shape=self.shape,
                                   dtype=self.dtype, init=self.init,
                                   lr_mult=self.lr_mult, wd_mult=self.wd_mult,
                                   stype=self._stype)
        return self._var

    def reset_ctx(self, ctx):
        """Place the data (or the pending deferred init) on `ctx` (default
        the current context)."""
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data:
            self._init_impl(self._reduce(), ctx)
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)
        else:
            raise ValueError("Cannot reset context for Parameter '%s' because "
                             "it has not been initialized." % self.name)

    def cast(self, dtype):
        """Cast the data (and future loads) to `dtype`."""
        self.dtype = dtype_name(dtype)
        if self._data is None:
            return
        self._data = OrderedDict(
            (c, d.astype(self.dtype)) for c, d in self._data.items())
        self._init_grad()


class Constant(Parameter):
    """Non-trainable constant."""

    def __init__(self, name, value):
        if not isinstance(value, nd.NDArray):
            value = nd.array(np.asarray(value), ctx=cpu())
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype,
                         init=initializer.Constant(value.asnumpy().tolist()))


class ParameterDict:
    """Prefix-scoped dict of Parameters with sharing."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "{name}(\n{content}\n)".format(name=name, content="\n".join(
            "  " + repr(v) for v in self.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """Get-or-create `prefix+name`, checking attribute compatibility."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if not hasattr(param, k) or getattr(param, k) is None:
                setattr(param, k, v)
                continue
            existing = getattr(param, k)
            if k == "shape" and v is not None:
                v = tuple(v) if not isinstance(v, int) else (v,)
                if len(v) == len(existing) and all(
                        a == b or a == 0 or b == 0
                        for a, b in zip(v, existing)):
                    param.shape = tuple(a if a != 0 else b
                                        for a, b in zip(existing, v))
                    continue
            elif k == "dtype" and dtype_name(v) == existing:
                continue
            elif v is None or existing == v:
                continue
            raise AssertionError(
                "Cannot retrieve Parameter '%s' because desired attribute "
                "does not match with stored for attribute '%s': desired "
                "'%s' vs stored '%s'." % (name, k, str(v), str(existing)))
        return param

    def update(self, other):
        """Merge (share) parameters from another dict."""
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise ValueError(
                        "Cannot update self with other because they have "
                        "different Parameters with the same name '%s'" % k)
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = initializer.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False,
             dtype_source="current"):
        """Load a `.params` file saved under full names."""
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise AssertionError(
                        "restore_prefix is '%s' but Parameters name '%s' "
                        "does not start with '%s'" % (restore_prefix, name,
                                                      restore_prefix))
        lprefix = len(restore_prefix)
        arg_dict = {}
        for k, v in nd.load(filename).items():
            k = k[4:] if k.startswith(("arg:", "aux:")) else k
            arg_dict[restore_prefix + k] = v
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise AssertionError(
                        "Parameter '%s' is missing in file '%s', which "
                        "contains parameters: %s. Set allow_missing=True to "
                        "ignore missing parameters."
                        % (name[lprefix:], filename,
                           ", ".join(sorted(arg_dict.keys()))))
        for name in arg_dict:
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in ParameterDict, which contains parameters %s. Set "
                        "ignore_extra=True to ignore."
                        % (name[lprefix:], filename,
                           ", ".join(sorted(self._params.keys()))))
                continue
            self[name]._load_init(arg_dict[name], ctx, cast_dtype=cast_dtype,
                                  dtype_source=dtype_source)
