"""Module: symbolic training over data-parallel executors (the port of
`mxnet_tpu.module.module`).

`bind` makes one executor per context with `simple_bind`; `update` runs the
optimizer per context through an `Updater` or on the kvstore, with the
reference's decision (`_create_kvstore`): one context with ``local`` has
no store and updates each parameter through the `Updater` (SGD's
``sgd_mom_update``: kernel #7 on a card, one launch per parameter); several
contexts sum their gradients in the port's `KVStoreLocal`.

Deviation: the default context is `gpu(0)` (the port's default), not
`cpu(0)`. The host copies of the parameters (`get_params`, checkpoints)
live on `cpu()`.
"""
from __future__ import annotations

import logging

from .. import context as ctx_mod
from .. import kvstore as kvs
from .. import ndarray as nd
from .. import optimizer as opt
from ..io.io import DataDesc
from ..model import load_checkpoint, save_checkpoint
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """reference: module/module.py (Module)."""

    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None,
                 group2ctxs=None, compression_params=None,
                 compile_graph=None):
        super().__init__(logger=logger)
        # True/False pins the whole-graph route on/off for this module's
        # executors; None defers to the MXNET_TPU_WHOLE_GRAPH gate
        self._compile_graph = compile_graph
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = context
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        assert len(work_load_list) == len(self._context)
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = [n for n in label_names if n in arg_names]
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, self._label_names, "label", False)
        _check_input_names(symbol, self._state_names, "state", True)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._compression_params = compression_params
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """reference: Module.load — from save_checkpoint files."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """reference: Module.save_checkpoint."""
        self._symbol.save("%s-symbol.json" % prefix,
                          remove_amp_cast=remove_amp_cast)
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, None, arg_params, aux_params)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._exec_group.get_output_shapes()

    # ------------------------------------------------------------------
    def get_params(self):
        """reference: Module.get_params."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """reference: Module.init_params."""
        from .. import initializer as _init
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = _init.Uniform(0.01)

        if self._arg_params is None:
            self._arg_params = {
                name: nd.zeros(arr[0].shape, dtype=arr[0].dtype,
                               ctx=ctx_mod.cpu())
                for name, arr in zip(self._param_names,
                                     self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: nd.zeros(arr[0].shape, dtype=arr[0].dtype,
                               ctx=ctx_mod.cpu())
                for name, arr in zip(self._aux_names,
                                     self._exec_group.aux_arrays)}

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    cache_arr = cache[name]
                    if cache_arr is not arr:
                        cache_arr.copyto(arr)
                else:
                    if not allow_missing:
                        raise RuntimeError(
                            "%s is not presented" % name)
                    if initializer is not None:
                        initializer(name, arr)
            else:
                initializer(name, arr)

        attrs = self._symbol.attr_dict()
        for name, arr in sorted(self._arg_params.items()):
            desc = _init.InitDesc(name, attrs.get(name, None))
            _impl(desc, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            desc = _init.InitDesc(name, attrs.get(name, None))
            _impl(desc, arr, aux_params)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """reference: Module.set_params (fast path w/o initializer)."""
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """reference: Module.bind."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        assert not for_training or data_shapes is not None

        self._data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                             for x in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [x if isinstance(x, DataDesc)
                                  else DataDesc(*x) for x in label_shapes]
        else:
            self._label_shapes = None

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group=None,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names,
            compile_graph=self._compile_graph)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self._exec_group.set_params(self._arg_params, self._aux_params)
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    def reshape(self, data_shapes, label_shapes=None):
        """reference: Module.reshape."""
        assert self.binded
        self._data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                             for x in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [x if isinstance(x, DataDesc)
                                  else DataDesc(*x) for x in label_shapes]
        else:
            self._label_shapes = None
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """reference: Module.init_optimizer."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        kvstore_obj, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if kvstore_obj and "dist" in kvstore_obj.type and \
                "_sync" in kvstore_obj.type:
            batch_size *= kvstore_obj.num_workers
        rescale_grad = 1.0 / batch_size

        idx2name = {}
        if update_on_kvstore:
            idx2name.update(enumerate(self._exec_group.param_names))
        else:
            for k in range(len(self._context)):
                idx2name.update(
                    {i * len(self._context) + k: n
                     for i, n in enumerate(self._exec_group.param_names)})
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s). Is this intended?",
                    optimizer.rescale_grad, rescale_grad)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()

        self._optimizer = optimizer
        self._kvstore = kvstore_obj
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        if kvstore_obj:
            if self._compression_params:
                kvstore_obj.set_gradient_compression(self._compression_params)
            if update_on_kvstore:
                kvstore_obj.set_optimizer(self._optimizer)
            for idx, name in enumerate(self._exec_group.param_names):
                kvstore_obj.init(idx, self._arg_params[name])
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

        if hasattr(self, "_preload_opt_states") and self._preload_opt_states:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def forward(self, data_batch, is_train=None):
        """reference: Module.forward."""
        assert self.binded and self.params_initialized
        curr_data_shapes = tuple(i.shape for i in self._data_shapes)
        if isinstance(data_batch, list):
            new_data_shapes = tuple(i.data[0].shape for i in data_batch)
        else:
            new_data_shapes = tuple(i.shape for i in data_batch.data)
        if curr_data_shapes != new_data_shapes:
            if hasattr(data_batch, "provide_data") and data_batch.provide_data:
                new_dshape = data_batch.provide_data
            else:
                new_dshape = [
                    DataDesc(i.name, shape, i.dtype, i.layout)
                    for i, shape in zip(self._data_shapes, new_data_shapes)]
            if hasattr(data_batch, "provide_label") and \
                    data_batch.provide_label:
                new_lshape = data_batch.provide_label
            elif hasattr(data_batch, "label") and data_batch.label:
                new_lshape = [
                    DataDesc(i.name, j.shape, i.dtype, i.layout)
                    for i, j in zip(self._label_shapes, data_batch.label)]
            else:
                new_lshape = None
            self.reshape(new_dshape, new_lshape)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        """reference: Module.backward."""
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Gradient aggregation + optimizer step.
        reference: Module.update (+ model.py _update_params)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if self._update_on_kvstore:
            for idx, (name, grads, weights) in enumerate(zip(
                    self._exec_group.param_names,
                    self._exec_group.grad_arrays,
                    self._exec_group.param_arrays)):
                valid = [g for g in grads if g is not None]
                if not valid:
                    continue
                self._kvstore.push(idx, valid)
                self._kvstore.pull(idx, weights)
        else:
            if self._kvstore:
                for idx, (name, grads) in enumerate(zip(
                        self._exec_group.param_names,
                        self._exec_group.grad_arrays)):
                    valid = [g for g in grads if g is not None]
                    if not valid:
                        continue
                    self._kvstore.push(idx, valid)
                    self._kvstore.pull(idx, valid)
            num_device = len(self._context)
            for i, (weights, grads) in enumerate(zip(
                    self._exec_group.param_arrays,
                    self._exec_group.grad_arrays)):
                for k, (w, g) in enumerate(zip(weights, grads)):
                    if g is None:
                        continue
                    index = i * num_device + k
                    self._updater(index, g, w)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)

    def _sync_params_from_devices(self):
        """reference: Module._sync_params_from_devices."""
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        """reference: Module.save_optimizer_states."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """reference: Module.load_optimizer_states."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def install_monitor(self, mon):
        """Let `mon` read every executor's arrays (upstream MXNet's
        Module.install_monitor; the reference's does nothing)."""
        assert self.binded
        for exe in self._exec_group.execs:
            mon.install(exe)

    def prepare(self, data_batch, sparse_row_id_fn=None):
        if sparse_row_id_fn is not None and self._kvstore is not None:
            row_ids = sparse_row_id_fn(data_batch)
            for idx, name in enumerate(self._exec_group.param_names):
                if name in row_ids:
                    self._kvstore.row_sparse_pull(
                        idx, out=self._exec_group.param_arrays[
                            self._exec_group.param_names.index(name)],
                        row_ids=row_ids[name])


def _create_kvstore(kvstore, num_device, arg_params):
    """(store or None, update_on_kvstore). reference: python/mxnet/model.py
    (_create_kvstore)."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(_np_prod(p.shape) for p in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _np_prod(shape):
    p = 1
    for d in shape:
        p *= d
    return p
