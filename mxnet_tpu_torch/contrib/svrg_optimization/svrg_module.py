"""SVRGModule: Module with Stochastic Variance Reduced Gradient updates.

reference: python/mxnet/contrib/svrg_optimization/svrg_module.py —
SVRGModule(symbol, ..., update_freq) keeps a second executor at the
snapshot parameters w0; `update_full_grads(train_data)` accumulates
mu = mean_batch g(w0, batch); each training step rewrites the gradient
buffers to g(w, b) - g(w0, b) + mu before the ordinary optimizer update.

The port of `mxnet_tpu.contrib.svrg_optimization.svrg_module`, on the
port's `Module`: the snapshot executor's gradients and the primary's are
read through `_exec_group.param_names` / `grad_arrays`.
"""
import logging

from ...module.module import Module
from ... import metric as _metric


class SVRGModule(Module):
    """reference: svrg_module.py (SVRGModule). `update_freq` is the number
    of epochs between full-gradient snapshots."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None,
                 update_freq=2):
        super().__init__(symbol, data_names, label_names, logger=logger,
                         context=context, work_load_list=work_load_list,
                         fixed_param_names=fixed_param_names,
                         state_names=state_names, group2ctxs=group2ctxs,
                         compression_params=compression_params)
        if not isinstance(update_freq, int) or update_freq < 1:
            raise ValueError("update_freq must be a positive int, got %r"
                             % (update_freq,))
        self.update_freq = update_freq
        self._mod_aux = Module(symbol, data_names, label_names,
                               logger=logger, context=context,
                               work_load_list=work_load_list,
                               fixed_param_names=fixed_param_names,
                               state_names=state_names, group2ctxs=group2ctxs,
                               compression_params=compression_params)
        self._full_grads = None          # name -> mu NDArray (host of truth)

    # -- lifecycle ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        super().bind(data_shapes, label_shapes, for_training,
                     inputs_need_grad, force_rebind, shared_module, grad_req)
        if for_training:
            self._mod_aux.bind(data_shapes, label_shapes, for_training,
                               inputs_need_grad, force_rebind, shared_module,
                               grad_req)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        super().init_params(initializer=initializer, arg_params=arg_params,
                            aux_params=aux_params,
                            allow_missing=allow_missing,
                            force_init=force_init, allow_extra=allow_extra)
        if self._mod_aux.binded:
            args, auxs = self.get_params()
            self._mod_aux.init_params(arg_params=args, aux_params=auxs,
                                      allow_missing=False, force_init=True)

    # -- SVRG core ----------------------------------------------------------
    def update_full_grads(self, train_data):
        """Snapshot w0 <- w and accumulate mu = (1/nbatch) sum g(w0, b).
        reference: SVRGModule.update_full_grads."""
        assert self.binded and self.params_initialized
        args, auxs = self.get_params()
        self._mod_aux.set_params(arg_params=args, aux_params=auxs)
        train_data.reset()
        accum = {}
        nbatch = 0
        for batch in train_data:
            self._mod_aux.forward(batch, is_train=True)
            self._mod_aux.backward()
            for name, grads in zip(self._mod_aux._exec_group.param_names,
                                   self._mod_aux._exec_group.grad_arrays):
                total = None
                for g in grads:
                    if g is None:
                        continue
                    total = (g + 0.0) if total is None else total + g
                if total is None:
                    continue
                if name in accum:
                    accum[name] = accum[name] + total
                else:
                    accum[name] = total
            nbatch += 1
        assert nbatch > 0, "update_full_grads: empty data iterator"
        self._full_grads = {name: a / float(nbatch)
                            for name, a in accum.items()}

    def _svrg_grads_updated(self):
        return self._full_grads is not None

    def forward_backward(self, data_batch):
        """forward+backward on BOTH executors, then rewrite the primary
        grad buffers to the variance-reduced form.
        reference: SVRGModule.forward_backward + _update_svrg_gradients."""
        super().forward(data_batch, is_train=True)
        super().backward()
        if not self._svrg_grads_updated():
            return
        self._mod_aux.forward(data_batch, is_train=True)
        self._mod_aux.backward()
        for name, grads, grads0 in zip(
                self._exec_group.param_names,
                self._exec_group.grad_arrays,
                self._mod_aux._exec_group.grad_arrays):
            mu = self._full_grads.get(name)
            if mu is None:
                continue
            for g, g0 in zip(grads, grads0):
                if g is None or g0 is None:
                    continue
                g[:] = g - g0 + mu.as_in_context(g.context)

    # -- training loop ------------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The base fit loop with a full-gradient snapshot every
        `update_freq` epochs. reference: SVRGModule.fit."""
        assert num_epoch is not None, "please specify number of epochs"
        from ... import initializer as _init
        if initializer is None:
            initializer = _init.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            if (epoch - begin_epoch) % self.update_freq == 0:
                self.update_full_grads(train_data)
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                if isinstance(data_batch, list):
                    self.update_metric(eval_metric,
                                       [db.label for db in data_batch],
                                       pre_sliced=True)
                else:
                    self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    from ...model import BatchEndParam
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for cb in (batch_end_callback
                               if isinstance(batch_end_callback,
                                             (list, tuple))
                               else [batch_end_callback]):
                        cb(params)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in (epoch_end_callback
                           if isinstance(epoch_end_callback, (list, tuple))
                           else [epoch_end_callback]):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
