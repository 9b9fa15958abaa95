"""One Gluon training step behind one call (the port of
`mxnet_tpu.gluon.fused_step`, single context):

    step = gluon.FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                trainer)
    loss = step(data, label)        # the mean loss; parameters updated

A call runs the forward and the loss under `autograd.record()`, takes the
gradients of the loss *sum* over the batch (the reference's cotangent of
ones) with respect to the trainable parameters, updates every parameter
in one `multi_sgd` / `multi_adam` call with ``rescale_grad = scale /
batch_size`` and the optimizer's own lr/wd bookkeeping (the reference's
host functions, `_sgd_host` and `_bias_corrected_host`), and then writes
the auxiliary updates (BatchNorm's running statistics) that the forward
collected, once each, outside the graph. On a card the update is one
launch of the flat SGD or Adam kernel over all the parameters, and each
fused conv block's forward and backward launch theirs. Adam's 1 - beta
is computed in double here, as the reference's step (which calls the
per-parameter op's function) computes it; `Trainer.step` takes the
reference's aggregated route, which computes it in fp32.

Semantics match `loss.backward(); trainer.step(batch_size)`, so the two
routes leave the same parameters and running statistics. The optimizer
state is the step's own (created by the optimizer, as the reference's
is). Only "sgd" and "adam" are fused (`_FUSABLE`); `multi_precision` is
refused as in the reference.

Deviation: the step runs eagerly, one kernel at a time. Capturing it as
one CUDA graph is later work; every kernel already launches on the current
stream and allocates through `torch.empty`, as capture needs. `mesh`,
`bucket_mb`, the integrity sentinel and the compile cache of the reference
are not ported.
"""
from __future__ import annotations

import math

import torch

from .. import autograd
from ..ndarray import NDArray
from ..ops.fused_optimizer import multi_adam, multi_sgd
from .block import _AUX_COLLECTOR

__all__ = ["FusedTrainStep"]


def _count_and_lrs(opt, indices):
    for i in indices:
        opt._update_count(i)
    return opt._get_lrs(indices), opt._get_wds(indices)


def _sgd_host(opt, indices):
    lrs, wds = _count_and_lrs(opt, indices)
    return {"lrs": lrs, "wds": wds}


def _bias_corrected_host(opt, indices):
    """Adam: fold sqrt(1 - beta2^t) / (1 - beta1^t) into each lr, in Python
    double, exactly as `Adam.update` does."""
    lrs, wds = _count_and_lrs(opt, indices)
    for j, i in enumerate(indices):
        t = opt._index_update_count[i]
        lrs[j] *= math.sqrt(1.0 - opt.beta2 ** t) / (1.0 - opt.beta1 ** t)
    return {"lrs": lrs, "wds": wds}


def _clip(opt):
    """(clip value, clip on) as the per-parameter ops read
    clip_gradient."""
    c = opt.clip_gradient
    on = c is not None and c >= 0
    return (c if on else 0.0), on


def _sgd_device(opt, ws, gs, states, sc, rescale):
    clip, clip_on = _clip(opt)
    mom_on = states[0] is not None
    multi_sgd(ws, gs, states if mom_on else [], None, sc["lrs"], sc["wds"],
              opt.momentum, rescale, clip, mom_on, clip_on, False)


def _adam_device(opt, ws, gs, states, sc, rescale):
    clip, clip_on = _clip(opt)
    # 1 - beta in Python double, as the reference's step computes it
    multi_adam(ws, gs, [s[0] for s in states], [s[1] for s in states], None,
               sc["lrs"], sc["wds"], opt.beta1, 1.0 - opt.beta1, opt.beta2,
               1.0 - opt.beta2, opt.epsilon, rescale, clip, clip_on, False)


# optimizer name -> (host function: per-step scalars, device function: the
# update of every parameter in one call)
_FUSABLE = {
    "sgd": (_sgd_host, _sgd_device),
    "adam": (_bias_corrected_host, _adam_device),
}


def _raw(state):
    """An optimizer state (None, an NDArray or a tuple of them) as
    tensors."""
    if state is None or isinstance(state, NDArray):
        return None if state is None else state._data
    return tuple(s._data for s in state)


class FusedTrainStep:
    """Forward + loss + backward + optimizer update as one call. net: a
    (Hybrid)Block; loss: a Loss block or a callable (pred, label) -> one
    loss per sample; trainer: a `gluon.Trainer` over the net's
    parameters, with an optimizer in `_FUSABLE`."""

    def __init__(self, net, loss, trainer, donate=True, mesh=None,
                 rules=None, batch_spec=None, bucket_mb=None):
        for name, value in (("mesh", mesh), ("rules", rules),
                            ("batch_spec", batch_spec),
                            ("bucket_mb", bucket_mb)):
            if value is not None:
                raise NotImplementedError(
                    "FusedTrainStep(%s=...): multi-device steps come with "
                    "the port's communication slice" % name)
        self._net = net
        self._loss = loss
        self._trainer = trainer
        self._built = False

    def _build(self, ctx, args):
        trainer = self._trainer
        opt = trainer._optimizer
        kind = type(opt).__name__.lower()
        if kind not in _FUSABLE:
            raise NotImplementedError(
                "FusedTrainStep supports optimizers %s; %r updates must use "
                "the imperative Trainer.step path" % (sorted(_FUSABLE), kind))
        self._host_fn, self._dev_fn = _FUSABLE[kind]
        if getattr(opt, "multi_precision", False):
            raise NotImplementedError(
                "FusedTrainStep: multi_precision state layout not wired; "
                "bf16 training needs no master copy")
        if len(trainer._contexts) != 1:
            raise NotImplementedError("FusedTrainStep is single-context")
        if not trainer._kv_initialized:
            trainer._init_kvstore()
        # deferred shapes: one predict-mode pass, which moves no running
        # statistics
        if any(p._data is None for p in self._net.collect_params().values()):
            with autograd.pause(train_mode=False):
                self._net(*args)
        self._train_params = [p for p in trainer._params
                              if p.grad_req != "null"]
        self._train_idx = [trainer._param2idx[p.name]
                           for p in self._train_params]
        self._states = [opt.create_state_multi_precision(i, p.data(ctx))
                        for i, p in zip(self._train_idx, self._train_params)]
        self._built = True

    def __call__(self, data, label):
        """One step; returns the mean loss over the batch (an NDArray)."""
        args = list(data) if isinstance(data, (list, tuple)) else [data]
        ctx = args[0].context
        if not self._built:
            self._build(ctx, args)
        trainer = self._trainer
        opt = trainer._optimizer
        opt.rescale_grad = trainer._scale / args[0].shape[0]
        scal = self._host_fn(opt, self._train_idx)

        aux = []
        if not hasattr(_AUX_COLLECTOR, "stack"):
            _AUX_COLLECTOR.stack = []
        _AUX_COLLECTOR.stack.append(aux)
        try:
            with autograd.record(train_mode=True):
                lvec = self._loss(self._net(*args), label)
        finally:
            _AUX_COLLECTOR.stack.pop()
        weights = [p.data(ctx)._data for p in self._train_params]
        grads = torch.autograd.grad(lvec._data.sum(), weights,
                                    allow_unused=True)

        # a parameter that the loss does not reach gets a zero gradient
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(weights, grads)]
        with torch.no_grad():
            self._dev_fn(opt, weights, grads,
                         [_raw(s) for s in self._states], scal,
                         opt.rescale_grad)
            for target, value in aux:
                target._data.copy_(value)
        loss = lvec._data.detach()
        return NDArray(loss.float().mean().to(loss.dtype), ctx=ctx)
