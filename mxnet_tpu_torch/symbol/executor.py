"""Executor: a bound symbolic graph (the port of
`mxnet_tpu.symbol.executor`).

Two routes, as in the reference:

* whole-graph (`MXNET_TPU_WHOLE_GRAPH`, on by default): `forward` runs one
  `mx.compiler.GraphProgram` over the bound tensors (forward, or forward
  and backward together for training) and `backward` writes the gradients
  it computed;
* op by op: `forward` evaluates the graph through `nd` ops under the
  port's autograd (recording when training) and `backward` runs
  `autograd.backward` into the bound gradient arrays.

Only `UnsupportedGraphError` (a random op, an unknown op, sparse storage,
AMP on) moves an executor to the op-by-op route, counted as
`compiler.fallback.<reason>`. The reference also falls back on any other
exception; the port lets it raise, so a failing kernel or launch on the
card is never hidden behind the slower route.

BatchNorm follows upstream MXNet on both routes: a training forward
normalizes by the batch's statistics and moves the bound moving
statistics, ``moving = moving * momentum + batch * (1 - momentum)``; an
inference forward normalizes by the moving statistics.
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import ndarray as nd
from .. import telemetry as _telem
from ..base import MXNetError, get_env
from .symbol import moving_update

__all__ = ["Executor"]


class Executor:
    """reference: python/mxnet/executor.py (Executor)."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, compile_graph=None):
        self._symbol = symbol
        self._ctx = ctx
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()

        if isinstance(args, (list, tuple)):
            if len(args) != len(self._arg_names):
                raise MXNetError("bind: expected %d args, got %d" %
                                 (len(self._arg_names), len(args)))
            self.arg_dict = dict(zip(self._arg_names, args))
        else:
            self.arg_dict = dict(args)
        self.arg_arrays = [self.arg_dict[n] for n in self._arg_names]

        if args_grad is None:
            self.grad_dict = {}
        elif isinstance(args_grad, (list, tuple)):
            self.grad_dict = dict(zip(self._arg_names, args_grad))
        else:
            self.grad_dict = dict(args_grad)
        self.grad_arrays = [self.grad_dict.get(n) for n in self._arg_names]

        if aux_states is None:
            self.aux_dict = {}
        elif isinstance(aux_states, (list, tuple)):
            self.aux_dict = dict(zip(self._aux_names, aux_states))
        else:
            self.aux_dict = dict(aux_states)
        self.aux_arrays = [self.aux_dict[n] for n in self._aux_names]

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self._arg_names, grad_req))
        else:
            self._grad_req = dict(grad_req)

        self.outputs = []
        self._output_names = symbol.list_outputs()
        self._recorded_heads = None

        # whole-graph state: the program once built; `_wg_failed` holds the
        # counted reason that pins this executor to the op-by-op route
        self._compile_graph = compile_graph
        self._wg_program = None
        self._wg_failed = None
        self._wg_grads = None       # name -> gradient tensor of the run
        self._wg_raws = None        # the inputs of the last training run

    # -- the whole-graph route -------------------------------------------
    def _wg_enabled(self):
        if self._compile_graph is not None:
            return bool(self._compile_graph)
        return bool(get_env("MXNET_TPU_WHOLE_GRAPH"))

    def _wg_fallback(self, reason):
        """Pin this executor to the op-by-op route, the reason counted."""
        self._wg_failed = reason
        self._wg_program = None
        _telem.inc("compiler.fallback")
        _telem.inc("compiler.fallback.%s" % reason)

    def _wg_inputs(self):
        """The flat tensors in the program's order (args, then aux), read
        at call time so `forward(**kwargs)` and `copy_params_from` show."""
        return tuple([self.arg_dict[n]._data for n in self._arg_names] +
                     [self.aux_dict[n]._data for n in self._aux_names])

    def _wg_wanted(self):
        """(names, flat indices) of the arguments whose gradient the bound
        grad_req asks for."""
        names, idx = [], []
        for i, n in enumerate(self._arg_names):
            if self._grad_req.get(n, "null") != "null" and \
                    self.grad_dict.get(n) is not None:
                names.append(n)
                idx.append(i)
        return names, idx

    def _wg_forward(self, is_train):
        from .. import compiler as _compiler
        from ..ndarray import ndarray as _nd_mod
        if _nd_mod._AMP_WRAP is not None:
            # AMP casts at the dispatch point, which the program's direct
            # calls would pass by: stay op by op while it is on
            raise _compiler.UnsupportedGraphError("amp_active")
        for arr in list(self.arg_dict.values()) + \
                list(self.aux_dict.values()) + list(self.grad_dict.values()):
            if arr is not None and arr.stype != "default":
                raise _compiler.UnsupportedGraphError("sparse_storage")
        if self._wg_program is None:
            self._wg_program = _compiler.GraphProgram(
                self._symbol, on_gpu=self._ctx.device_type == "gpu",
                label=self._symbol.name)
        prog = self._wg_program
        raws = self._wg_inputs()
        names, idx = self._wg_wanted() if is_train else ([], [])
        if names:
            outs, grads, stats = prog.run_fwd_bwd(raws, idx)
            self._wg_grads = dict(zip(names, grads))
            self._wg_raws = raws
        else:
            outs, stats = prog.run_forward(raws, train=is_train)
            self._wg_grads = None
            self._wg_raws = None
        for pm, pv, mean, var, m in stats:
            if pm is not None:
                moving_update(raws[pm], mean, m)
            if pv is not None:
                moving_update(raws[pv], var, m)
        self.outputs = [nd.NDArray(o, ctx=self._ctx) for o in outs]
        self._recorded_heads = self.outputs if is_train else None
        return self.outputs

    def _wg_backward(self, out_grads):
        """Write the program's gradients into the bound gradient arrays,
        by grad_req (write or add)."""
        grads = self._wg_grads
        if out_grads is not None:
            # the caller's head gradients: forward and backward again with
            # them (the rerun's batch statistics are dropped: the moving
            # ones moved with the first run)
            if isinstance(out_grads, nd.NDArray):
                out_grads = [out_grads]
            cots = [g._data if isinstance(g, nd.NDArray) else g
                    for g in out_grads]
            names, idx = self._wg_wanted()
            _, flat, _ = self._wg_program.run_fwd_bwd(self._wg_raws, idx,
                                                      head_cots=cots)
            grads = dict(zip(names, flat))
        for name, cot in grads.items():
            buf = self.grad_dict.get(name)
            if buf is None:
                continue
            with torch.no_grad():
                if self._grad_req.get(name) == "add":
                    buf._data.add_(cot.to(buf._data.dtype))
                else:
                    buf._data.copy_(cot)
        self._wg_grads = None
        self._wg_raws = None

    # -- both routes -------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        """Run the graph; keyword arrays are copied into the bound
        arguments first."""
        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("Unknown argument %s" % name)
            dst = self.arg_dict[name]
            if isinstance(val, nd.NDArray):
                val.copyto(dst)
            else:
                dst[:] = val

        if self._wg_enabled() and self._wg_failed is None:
            from ..compiler import UnsupportedGraphError
            try:
                return self._wg_forward(is_train)
            except UnsupportedGraphError as e:
                self._wg_fallback(e.reason)

        feed = dict(self.arg_dict)
        feed.update(self.aux_dict)
        updates = []
        if is_train:
            for name, arr in self.arg_dict.items():
                req = self._grad_req.get(name, "null")
                if req != "null" and self.grad_dict.get(name) is not None:
                    arr._grad = self.grad_dict[name]
                    autograd.mark_variable(arr, req)
            with autograd.record():
                out = self._symbol.eval_with(feed, self._ctx, train=True,
                                             bn_updates=updates)
        else:
            with autograd.pause():
                out = self._symbol.eval_with(feed, self._ctx)
        for mm, mv, mean, var, m in updates:
            moving_update(mm._data, mean._data, m)
            moving_update(mv._data, var._data, m)
        self.outputs = out if isinstance(out, list) else [out]
        self._recorded_heads = self.outputs if is_train else None
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward into the bound gradient
        arrays; `out_grads` are the heads' gradients (ones by default)."""
        if self._recorded_heads is None:
            raise MXNetError("backward called before forward(is_train=True)")
        if self._wg_grads is not None:
            return self._wg_backward(out_grads)
        if out_grads is None:
            head_grads = None
        else:
            if isinstance(out_grads, nd.NDArray):
                out_grads = [out_grads]
            head_grads = list(out_grads)
        autograd.backward(self._recorded_heads, head_grads)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, array in arg_params.items():
            if name in self.arg_dict:
                if isinstance(array, nd.NDArray):
                    array.copyto(self.arg_dict[name])
                else:
                    self.arg_dict[name][:] = array
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "arguments" % name)
        if aux_params is None:
            return
        for name, array in aux_params.items():
            if name in self.aux_dict:
                array.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise ValueError("Find name %s that is not in the auxiliary "
                                 "states" % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor at the given input shapes: arrays whose shape
        holds are shared, the others are new zeros."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def keep_or_new(old, sh):
            if tuple(old.shape) == tuple(sh):
                return old
            return nd.zeros(sh, ctx=self._ctx, dtype=old.dtype)
        new_args = {n: keep_or_new(self.arg_dict[n], sh)
                    for n, sh in zip(self._arg_names, arg_shapes)}
        new_grads = None
        if self.grad_dict:
            new_grads = {n: keep_or_new(g, new_args[n].shape)
                         for n, g in self.grad_dict.items() if g is not None}
        new_aux = {n: keep_or_new(self.aux_dict[n], sh)
                   for n, sh in zip(self._aux_names, aux_shapes)}
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self._grad_req, new_aux,
                        compile_graph=self._compile_graph)

    @property
    def output_dict(self):
        return dict(zip(self._output_names, self.outputs))
