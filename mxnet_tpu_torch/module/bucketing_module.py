"""BucketingModule: variable-length training with one Module per bucket
key, bound at that bucket's shapes, sharing the default bucket's
parameters and optimizer (the port of
`mxnet_tpu.module.bucketing_module`)."""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


def _inherit_optimizer(module, source):
    """Share one optimizer/kvstore/updater across bucket modules (one
    parameter set, many executors)."""
    module.optimizer_initialized = True
    module._optimizer = source._optimizer
    module._kvstore = source._kvstore
    module._update_on_kvstore = source._update_on_kvstore
    module._updater = source._updater


class BucketingModule(BaseModule):
    """reference: module/bucketing_module.py (BucketingModule)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        datas, labels, _ = sym_gen(default_bucket_key)
        self._default_names = (datas, labels)
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._context = context
        self._work_load_list = work_load_list
        self._compression_params = compression_params
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self._grad_req = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _call_sym_gen(self, bucket_key):
        return self._sym_gen(bucket_key)

    def _gen_symbol(self, key):
        symbol, data_names, label_names = self._call_sym_gen(key)
        return symbol, data_names, label_names

    def get_params(self):
        """reference: BucketingModule.get_params."""
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Binds the default bucket. reference: BucketingModule.bind."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req

        symbol, data_names, label_names = self._gen_symbol(
            self._default_bucket_key)
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names,
                        compression_params=self._compression_params)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=self._grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """reference: BucketingModule.switch_bucket."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._gen_symbol(bucket_key)
            module = Module(symbol, data_names, label_names,
                            logger=self.logger, context=self._context,
                            work_load_list=self._work_load_list,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names,
                            compression_params=self._compression_params)
            module.bind(data_shapes, label_shapes, self._curr_module.
                        for_training, self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key],
                        grad_req=self._grad_req)
            # a bucket created AFTER init_optimizer must inherit the shared
            # optimizer/updater, or its update() would assert (reference:
            # switch_bucket borrows the default bucket's optimizer state)
            if self.optimizer_initialized:
                _inherit_optimizer(module,
                                   self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                _inherit_optimizer(mod, self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch, sparse_row_id_fn=None):
        assert self.binded
        bucket_key = data_batch.bucket_key
        original_bucket_key = self._curr_bucket_key
        data_shapes = data_batch.provide_data
        label_shapes = data_batch.provide_label
        self.switch_bucket(bucket_key, data_shapes, label_shapes)
        self.switch_bucket(original_bucket_key, None, None)

    def forward(self, data_batch, is_train=None):
        """reference: BucketingModule.forward — switches bucket first."""
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        # share current params into the new bucket's executors
        if self._curr_module is not self._buckets[self._default_bucket_key]:
            arg_p, aux_p = self._buckets[self._default_bucket_key].get_params()
            self._curr_module.set_params(arg_p, aux_p)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()
        # propagate updated params back to the default bucket
        if self._curr_module is not self._buckets[self._default_bucket_key]:
            arg_p, aux_p = self._curr_module.get_params()
            self._buckets[self._default_bucket_key].set_params(arg_p, aux_p)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)
