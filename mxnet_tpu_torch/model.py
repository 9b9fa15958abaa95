"""Checkpoint helpers, `BatchEndParam` and `FeedForward` (the port of
`mxnet_tpu.model`).

A checkpoint is ``prefix-symbol.json`` and ``prefix-%04d.params`` with
``arg:``/``aux:`` keys, in the reference's formats, so either package
reads the other's. `FeedForward` (deprecated in the reference in favour
of `mx.mod.Module`) is a thin layer over `Module`.
"""
from __future__ import annotations

from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params", "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Save `prefix-symbol.json` (unless `symbol` is None) and
    `prefix-%04d.params`."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix, remove_amp_cast=remove_amp_cast)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_params(prefix, epoch):
    """(arg_params, aux_params) of `prefix-%04d.params`, on the host."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class FeedForward:
    """The pre-Module training API over `mx.mod.Module`: the constructor,
    `fit`, `predict`, `score`, `save`/`load` and `FeedForward.create`."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        import warnings
        warnings.warn("FeedForward is deprecated. Use mx.mod.Module.",
                      DeprecationWarning, stacklevel=2)
        from . import initializer as _init
        self.symbol = symbol
        self.ctx = ctx if isinstance(ctx, (list, tuple)) else \
            [ctx] if ctx is not None else None
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or _init.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=shuffle)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from .module import Module
        train = self._as_iter(X, y, shuffle=True)
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        mod_kw = {"context": self.ctx}
        if logger is not None:
            mod_kw["logger"] = logger
        if work_load_list is not None:
            mod_kw["work_load_list"] = work_load_list
        self._module = Module(self.symbol, **mod_kw)
        self._module.fit(
            train, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer, optimizer_params=self.kwargs or {},
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback,
            monitor=monitor, initializer=self.initializer,
            arg_params=self.arg_params, aux_params=self.aux_params,
            allow_missing=self.allow_extra_params,
            begin_epoch=self.begin_epoch, num_epoch=self.num_epoch or 1)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def _bound_for_inference(self, data, with_label):
        from .module import Module
        if self.arg_params is None:
            raise RuntimeError("call fit() or load() before predicting")
        if self._module is None:
            self._module = Module(self.symbol, context=self.ctx,
                                  label_names=None if not with_label
                                  else ("softmax_label",))
        self._module.bind(data.provide_data,
                          data.provide_label if with_label else None,
                          for_training=False, force_rebind=True)
        self._module.set_params(self.arg_params or {}, self.aux_params or {},
                                allow_missing=True)

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        import numpy as _np
        data = self._as_iter(X)
        if reset and hasattr(data, "reset"):
            data.reset()
        self._bound_for_inference(data, False)
        outs, datas, labels = [], [], []
        for i, batch in enumerate(data):
            if num_batch is not None and i >= num_batch:
                break
            self._module.forward(batch, is_train=False)
            out = self._module.get_outputs()[0].asnumpy()
            n = out.shape[0] - (getattr(batch, "pad", 0) or 0)
            outs.append(out[:n])
            if return_data:
                datas.append(batch.data[0].asnumpy()[:n])
                labels.append(batch.label[0].asnumpy()[:n]
                              if batch.label else None)
        preds = _np.concatenate(outs, axis=0)
        if return_data:
            return preds, _np.concatenate(datas, axis=0), (
                _np.concatenate(labels, axis=0)
                if labels and labels[0] is not None else None)
        return preds

    def score(self, X, eval_metric="acc", num_batch=None, reset=True,
              **kwargs):
        from . import metric as _metric
        data = self._as_iter(X)
        if reset and hasattr(data, "reset"):
            data.reset()
        m = _metric.create(eval_metric)
        self._bound_for_inference(data, True)
        for i, batch in enumerate(data):
            if num_batch is not None and i >= num_batch:
                break
            self._module.forward(batch, is_train=False)
            m.update(batch.label, self._module.get_outputs())
        return m.get()[1]

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None
                        else (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Build and fit in one call."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        return model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, logger=logger,
                         work_load_list=work_load_list,
                         eval_end_callback=eval_end_callback,
                         eval_batch_end_callback=eval_batch_end_callback)
