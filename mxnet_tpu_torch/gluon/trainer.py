"""Gluon Trainer, on one context (the port of `mxnet_tpu.gluon.trainer`).

`step(batch_size)` sets ``rescale_grad = scale / batch_size`` (the
gradients are of the loss *sum* over the batch), reduces the gradients
across contexts (nothing to do on one) and runs the optimizer: one update
per trainable parameter, through the `Updater`, which on a card launches
the flat SGD or Adam kernel once per parameter. A kvstore on one context
resolves to none, as the reference's `_init_kvstore` does there; a
distributed store, `update_on_kvstore=True`, several contexts, ZeRO,
readiness-ordered communication and gradient compression raise
NotImplementedError: they come with the port's communication slice.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..context import current_context
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_COMM = "the port's communication slice"


class Trainer:
    """Applies an optimizer to a set of Parameters."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, zero=None, comm_ready=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(list(params.keys()))]
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params)))
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
            self._param2idx[param.name] = i
            self._params.append(param)
        for name, value in (("zero", zero), ("comm_ready", comm_ready),
                            ("compression_params", compression_params)):
            if value:
                raise NotImplementedError("Trainer(%s=...) comes with %s"
                                          % (name, _COMM))
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        if len(self._contexts) != 1:
            raise NotImplementedError(
                "Trainer over %d contexts comes with %s"
                % (len(self._contexts), _COMM))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx() if param._data is not None or \
                param._deferred_init else [current_context()]
            assert contexts is None or contexts == ctx, \
                "All Parameters must be initialized on the same set of " \
                "contexts, but Parameter %s is initialized on %s while " \
                "previous Parameters are initialized on %s." % (
                    param.name, str(ctx), str(contexts))
            contexts = ctx
        return contexts or [current_context()]

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an Optimizer " \
                "instance"
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]

    def _init_kvstore(self):
        """One context and dense parameters: no store (the reference's
        single-device short cut). Anything that needs one raises."""
        name = self._kvstore_params["kvstore"]
        if name and (not isinstance(name, str) or name.startswith("dist")):
            raise NotImplementedError("kvstore %r comes with %s"
                                      % (name, _COMM))
        if self._kvstore_params["update_on_kvstore"]:
            raise NotImplementedError("update_on_kvstore=True comes with %s"
                                      % _COMM)
        self._kvstore = None
        self._update_on_kvstore = False
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update: gradients (of the loss sum) scaled by
        ``scale / batch_size``, reduced across contexts, then the
        optimizer."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients across contexts: nothing to do on one."""
        if not self._kv_initialized:
            self._init_kvstore()

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone (the gradients already reduced)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                upd(i, grad, arr)

    def save_states(self, fname):
        """Write the optimizer and its states (pickled)."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param
                                      in enumerate(self._params)}
