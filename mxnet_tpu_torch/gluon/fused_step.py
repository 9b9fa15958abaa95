"""One Gluon training step behind one call (the port of
`mxnet_tpu.gluon.fused_step`, single context):

    step = gluon.FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                trainer)
    loss = step(data, label)        # the mean loss; parameters updated

A call runs the forward and the loss under `autograd.record()`, takes the
gradients of the loss *sum* over the batch (the reference's cotangent of
ones) with respect to the trainable parameters, updates every parameter
with ``rescale_grad = scale / batch_size`` and the optimizer's own lr/wd
bookkeeping (the reference's host functions: `_sgd_host`,
`_bias_corrected_host`, `_adamax_host`, `_t_host`, `_nadam_host`,
`_lars_host`), and then writes the auxiliary updates (BatchNorm's running
statistics) that the forward collected, once each, outside the graph.

The update takes the reference's 16 fusable optimizers (`_FUSABLE`). SGD
and Adam update every parameter in one `multi_sgd` / `multi_adam` call:
on a card one launch of the flat SGD or Adam kernel over all the
parameters (Adam's 1 - beta in double, as the reference's step computes
it; `Trainer.step` takes the reference's aggregated route, which computes
it in fp32). The others loop over the parameters with the op that the
imperative `Trainer.step` calls (`apply_op`: the op's kernel on a card
where it has one, as LAMB's #9/#10 and LARS's #7, else its torch
version), so the
two routes compute the same thing. As in the reference, the per-step
scalars are float32 here (lr, wd, the update count, Nadam's m_schedule)
where the imperative route keeps them in double; FTML's and Nadam's
schedules differ between the routes by about 1e-7 relative. LARS computes
its rates on the device. SGLD is refused (its noise stream), as is
`multi_precision`.

Semantics match `loss.backward(); trainer.step(batch_size)`, so the two
routes leave the same parameters and running statistics. The optimizer
state is the step's own (created by the optimizer, as the reference's
is).

Deviation: the step runs eagerly, one kernel at a time. Capturing it as
one CUDA graph is later work; every kernel already launches on the current
stream and allocates through `torch.empty`, as capture needs. The update
runs inside a ``fused_step.update`` profiler range. The compile cache of
the reference is not ported.

Integrity (``MXNET_TPU_INTEGRITY=1``): the gradients and the loss are
checked finite (`resilience.integrity`, site ``fused_step``, one host
read) before any write, so a tripped step raises `DivergenceError` and
leaves parameters, states and running statistics as they were. Off, the
step reads nothing back. Each call passes the ``train.step`` fault site
first.

Data parallelism (``mesh``, a `parallel.mesh.Mesh`): every rank passes
its own slice of the batch over the mesh's ``("data", "fsdp")`` axes
(``batch_spec``, default that; a replicated batch, ``P()``, works too),
the gradients of the local loss sums are summed over those ranks (one
all-reduce per flat bucket of at most ``bucket_mb``, default the engine's
cap; 0 sends them one by one) and rescaled by ``scale / (local batch x
ranks)``, and the returned loss is the mean over the global batch. As in
the reference's one GSPMD program, every training-mode BatchNorm (the
`BatchNorm` op, Gluon's `BatchNorm` and `contrib.nn.SyncBatchNorm`, and
the fused conv-BN-ReLU training op with #5's sums) normalizes with the
global batch's statistics: the forward runs inside
`collectives.batch_stats_scope` over the batch ranks, the per-channel
sums are all-reduced before normalizing and their cotangents in the
backward (the fused op's #6 takes its split route in two calls around
that all-reduce), and every rank writes the same running statistics from
them. Over one rank the all-reduce is a copy and nothing is reduced, so
the step is the single-card step bit for bit. `rules` are accepted; each
rank keeps every parameter whole (the parameters of a ``model`` or
``fsdp`` split compute the same values whole, and ranks that differ only
on ``model`` compute the same step).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from .. import autograd
from ..ndarray import NDArray
from ..ops.fused_optimizer import multi_adam, multi_sgd
from ..optimizer.optimizer import _clip as _off
from ..optimizer.optimizer import apply_op
from ..optimizer.optimizer import dcasgd_update
from ..parallel import collectives as _coll
from ..resilience import faults as _faults
from ..resilience import integrity as _integrity
from .block import _AUX_COLLECTOR

__all__ = ["FusedTrainStep"]


def _count_and_lrs(opt, indices):
    """Advance each index's update count; its lr and wd as float32 arrays
    (the reference ships every per-step scalar as float32)."""
    for i in indices:
        opt._update_count(i)
    return (np.asarray(opt._get_lrs(indices), np.float32),
            np.asarray(opt._get_wds(indices), np.float32))


def _sgd_host(opt, indices):
    lrs, wds = _count_and_lrs(opt, indices)
    return {"lrs": lrs, "wds": wds}


def _bias_corrected_host(opt, indices):
    """Adam and AdamW: fold sqrt(1 - beta2^t) / (1 - beta1^t) into each
    lr, as `Adam.update` does (the correction in double, the lr float32)."""
    lrs, wds = _count_and_lrs(opt, indices)
    for j, i in enumerate(indices):
        t = opt._index_update_count[i]
        lrs[j] *= math.sqrt(1.0 - opt.beta2 ** t) / (1.0 - opt.beta1 ** t)
    return {"lrs": lrs, "wds": wds}


def _adamax_host(opt, indices):
    """Adamax folds only the first moment's correction (`Adamax.update`)."""
    lrs, wds = _count_and_lrs(opt, indices)
    for j, i in enumerate(indices):
        t = opt._index_update_count[i]
        lrs[j] /= (1.0 - opt.beta1 ** t)
    return {"lrs": lrs, "wds": wds}


def _t_host(opt, indices):
    """FTML and LAMB: the update count t enters the op, as float32."""
    lrs, wds = _count_and_lrs(opt, indices)
    ts = np.asarray([opt._index_update_count[i] for i in indices],
                    np.float32)
    return {"lrs": lrs, "wds": wds, "ts": ts}


def _nadam_host(opt, indices):
    """Nadam: t and the running m_schedule product, advanced per index in
    update order, exactly as `Nadam.update` keeps them."""
    lrs, wds = _count_and_lrs(opt, indices)
    ts, mscheds = [], []
    for i in indices:
        t = opt._index_update_count[i]
        ts.append(t)
        mscheds.append(opt.m_schedule)
        momentum_t = opt.beta1 * (
            1.0 - 0.5 * 0.96 ** (t * opt.schedule_decay))
        opt.m_schedule = opt.m_schedule * momentum_t
    return {"lrs": lrs, "wds": wds, "ts": np.asarray(ts, np.float32),
            "mscheds": np.asarray(mscheds, np.float32)}


def _lars_host(opt, indices):
    """LARS skips the rate scaling of gamma/beta/bias parameters by name
    (the index as a string where idx2name has none): a 0/1 mask."""
    lrs, wds = _count_and_lrs(opt, indices)
    mask = np.asarray(
        [0.0 if opt.idx2name.get(i, str(i)).endswith(
            ("gamma", "beta", "bias")) else 1.0 for i in indices],
        np.float32)
    return {"lrs": lrs, "wds": wds, "lars_masks": mask}


def _clip(opt):
    """(clip value, clip on) as the per-parameter ops read
    clip_gradient."""
    c = opt.clip_gradient
    on = c is not None and c >= 0
    return (c if on else 0.0), on


def _sgd_device(opt, ws, gs, states, sc, rescale):
    clip, clip_on = _clip(opt)
    mom_on = states[0] is not None
    multi_sgd(ws, gs, states if mom_on else [], None, list(sc["lrs"]),
              list(sc["wds"]), opt.momentum, rescale, clip, mom_on, clip_on,
              False)


def _adam_device(opt, ws, gs, states, sc, rescale):
    clip, clip_on = _clip(opt)
    # 1 - beta in Python double, as the reference's step computes it
    multi_adam(ws, gs, [s[0] for s in states], [s[1] for s in states], None,
               list(sc["lrs"]), list(sc["wds"]), opt.beta1, 1.0 - opt.beta1,
               opt.beta2, 1.0 - opt.beta2, opt.epsilon, rescale, clip,
               clip_on, False)


# --- one parameter at a time, through the op that the imperative route
# calls (`apply_op`) ---------------------------------------------------------
def _clipv(opt):
    return _off(opt.clip_gradient)


def _nag_device(opt, w, g, state, sc, rescale):
    kw = dict(lr=sc["lrs"], wd=sc["wds"], rescale_grad=rescale,
              clip_gradient=_clipv(opt))
    if state is None:
        apply_op("sgd_update", w, g, (), **kw)
    else:
        apply_op("nag_mom_update", w, g, (state,), momentum=opt.momentum, **kw)


def _adamw_device(opt, w, g, state, sc, rescale):
    apply_op("adamw_update", w, g, state, lr=sc["lrs"], wd=sc["wds"],
             beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon,
             eta=opt.eta, rescale_grad=rescale, clip_gradient=_clipv(opt))


def _signum_device(opt, w, g, state, sc, rescale):
    kw = dict(lr=sc["lrs"], wd=sc["wds"], rescale_grad=rescale,
              clip_gradient=_clipv(opt))
    if state is None:
        apply_op("signsgd_update", w, g, (), **kw)
    else:
        apply_op("signum_update", w, g, (state,), momentum=opt.momentum,
                 wd_lh=opt.wd_lh, **kw)


def _ftml_device(opt, w, g, state, sc, rescale):
    apply_op("ftml_update", w, g, state, lr=sc["lrs"], wd=sc["wds"],
             beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon,
             rescale_grad=rescale, clip_grad=_clipv(opt), t=sc["ts"])


def _adagrad_device(opt, w, g, state, sc, rescale):
    apply_op("adagrad_update", w, g, (state,), lr=sc["lrs"], wd=sc["wds"],
             epsilon=opt.float_stable_eps, rescale_grad=rescale,
             clip_gradient=_clipv(opt))


def _adadelta_device(opt, w, g, state, sc, rescale):
    apply_op("adadelta_update", w, g, state, rho=opt.rho, epsilon=opt.epsilon,
             wd=sc["wds"], rescale_grad=rescale, clip_gradient=_clipv(opt))


def _adamax_device(opt, w, g, state, sc, rescale):
    apply_op("adamax_update", w, g, state, lr=sc["lrs"], wd=sc["wds"],
             beta1=opt.beta1, beta2=opt.beta2, rescale_grad=rescale,
             clip_gradient=_clipv(opt))


def _nadam_device(opt, w, g, state, sc, rescale):
    apply_op("nadam_update", w, g, state, lr=sc["lrs"], wd=sc["wds"],
             beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon,
             schedule_decay=opt.schedule_decay, rescale_grad=rescale,
             clip_gradient=_clipv(opt), t=sc["ts"], m_schedule=sc["mscheds"])


def _rmsprop_device(opt, w, g, state, sc, rescale):
    kw = dict(lr=sc["lrs"], wd=sc["wds"], gamma1=opt.gamma1,
              epsilon=opt.epsilon, rescale_grad=rescale,
              clip_gradient=_clipv(opt),
              clip_weights=_off(opt.clip_weights))
    if not opt.centered:
        apply_op("rmsprop_update", w, g, (state,), **kw)
    else:
        apply_op("rmspropalex_update", w, g, state, gamma2=opt.gamma2, **kw)


def _ftrl_device(opt, w, g, state, sc, rescale):
    apply_op("ftrl_update", w, g, state, lr=sc["lrs"], wd=sc["wds"],
             lamda1=opt.lamda1, beta=opt.beta, rescale_grad=rescale,
             clip_gradient=_clipv(opt))


def _lamb_device(opt, w, g, state, sc, rescale):
    """`LAMB.update`'s two phases (kernels #9 and #10 on a card)."""
    mean, var = state
    opt.update_tensors(w, g, mean, var, sc["lrs"], sc["wds"], sc["ts"],
                       rescale)


def _lars_device(opt, w, g, state, sc, rescale):
    """`LARS.update` with its layer rate eta * ||w|| / (||g|| + wd * ||w||
    + eps) on the raw gradient computed on the device (no host sync),
    skipped where the mask is 0, then the SGD ops. On a card the rate
    reaches kernel #7 as per-element lr and wd vectors."""
    lr, wd = sc["lrs"], sc["wds"]
    if sc["lars_masks"] > 0.0:
        w_norm = torch.linalg.vector_norm(w.float())
        g_norm = torch.linalg.vector_norm(g.float())
        lars = torch.where((w_norm > 0.0) & (g_norm > 0.0),
                           opt.eta * w_norm / (g_norm + wd * w_norm
                                               + opt.eps),
                           torch.ones_like(w_norm))
        lr = lars * lr
        if w.is_cuda:
            lr = lr.expand(w.shape).contiguous()
            wd = torch.full(w.shape, wd, dtype=torch.float32,
                            device=w.device)
    kw = dict(lr=lr, wd=wd, rescale_grad=rescale, clip_gradient=_clipv(opt))
    if state is None:
        apply_op("sgd_update", w, g, (), **kw)
    else:
        apply_op("sgd_mom_update", w, g, (state,), momentum=opt.momentum, **kw)


def _dcasgd_device(opt, w, g, state, sc, rescale):
    mom, prev = state
    dcasgd_update(w, g, mom, prev, sc["lrs"], sc["wds"], opt.momentum,
                  opt.lamda, rescale, opt.clip_gradient)


def _each(update):
    """A device function over the list that runs `update(opt, w, g,
    state, sc, rescale)` on each parameter in turn, with that parameter's
    scalars: lr and wd as Python floats of their float32 values, the
    update count and Nadam's m_schedule as 0-d float32 tensors (so that
    their powers and products compute in float32, as the reference's
    traced scalars do)."""
    def dev(opt, ws, gs, states, sc, rescale):
        host = {k: v for k, v in sc.items() if k in ("lrs", "wds",
                                                     "lars_masks")}
        traced = {k: torch.from_numpy(v) for k, v in sc.items()
                  if k not in host}
        for j, (w, g, s) in enumerate(zip(ws, gs, states)):
            one = {k: float(v[j]) for k, v in host.items()}
            one.update((k, v[j]) for k, v in traced.items())
            update(opt, w, g, s, one, rescale)
    return dev


# optimizer name -> (host function: per-step scalars, device function: the
# update of every parameter in one call). SGD and Adam update the whole
# list in one multi-tensor launch; the others loop over the parameters.
_FUSABLE = {
    "sgd": (_sgd_host, _sgd_device),
    "nag": (_sgd_host, _each(_nag_device)),
    "adam": (_bias_corrected_host, _adam_device),
    "adamw": (_bias_corrected_host, _each(_adamw_device)),
    "signum": (_sgd_host, _each(_signum_device)),
    "signsgd": (_sgd_host, _each(_signum_device)),
    "ftml": (_t_host, _each(_ftml_device)),
    "adagrad": (_sgd_host, _each(_adagrad_device)),
    "adadelta": (_sgd_host, _each(_adadelta_device)),
    "adamax": (_adamax_host, _each(_adamax_device)),
    "nadam": (_nadam_host, _each(_nadam_device)),
    "rmsprop": (_sgd_host, _each(_rmsprop_device)),
    "ftrl": (_sgd_host, _each(_ftrl_device)),
    "lamb": (_t_host, _each(_lamb_device)),
    "lars": (_lars_host, _each(_lars_device)),
    "dcasgd": (_sgd_host, _each(_dcasgd_device)),
}
# SGLD stays imperative-only, as in the reference: its Langevin noise
# draws from the generator on every update call, and a fused step could
# not keep that stream's imperative-path reproducibility.


def _raw(state):
    """An optimizer state (None, an NDArray or a tuple of them, with None
    allowed inside) as tensors."""
    if state is None or isinstance(state, NDArray):
        return None if state is None else state._data
    return tuple(_raw(s) for s in state)


class FusedTrainStep:
    """Forward + loss + backward + optimizer update as one call. net: a
    (Hybrid)Block; loss: a Loss block or a callable (pred, label) -> one
    loss per sample; trainer: a `gluon.Trainer` over the net's
    parameters, with an optimizer in `_FUSABLE`.

    `outputs` holds the net's output of the last step, cut from the tape,
    for a metric (a port addition: the reference's compiled step returns
    the loss only)."""

    def __init__(self, net, loss, trainer, donate=True, mesh=None,
                 rules=None, batch_spec=None, bucket_mb=None):
        from ..parallel.train_step import _as_rules, _data_mesh
        self._mesh = _data_mesh(mesh)
        self._rules = _as_rules(rules)
        self._batch_spec = batch_spec
        self._bucket_mb = bucket_mb
        self._donate = donate
        self._net = net
        self._loss = loss
        self._trainer = trainer
        self._built = False
        self.outputs = None

    def rebuild_for_mesh(self, mesh):
        """A new, unbuilt step over the same net, loss and trainer on
        `mesh` (the rebuild after the set of ranks changed); the caller
        carries the optimizer states across."""
        return FusedTrainStep(self._net, self._loss, self._trainer,
                              donate=self._donate, mesh=mesh,
                              rules=self._rules, batch_spec=self._batch_spec,
                              bucket_mb=self._bucket_mb)

    _BATCH = ("data", "fsdp")

    def _data_group(self):
        return None if self._mesh is None else self._mesh.group(self._BATCH)

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
        _faults.check("train.step")
        args = list(data) if isinstance(data, (list, tuple)) else [data]
        ctx = args[0].context
        if not self._built:
            self._build(ctx, args)
        trainer = self._trainer
        opt = trainer._optimizer
        group = self._data_group()
        n_data = 1 if self._mesh is None \
            else self._mesh.axes_size(self._BATCH)
        opt.rescale_grad = trainer._scale / (args[0].shape[0] * n_data)
        scal = self._host_fn(opt, self._train_idx)

        aux = []
        if not hasattr(_AUX_COLLECTOR, "stack"):
            _AUX_COLLECTOR.stack = []
        _AUX_COLLECTOR.stack.append(aux)
        stats = group if n_data > 1 else None
        try:
            with autograd.record(train_mode=True), \
                    _coll.batch_stats_scope(stats):
                out = self._net(*args)
                lvec = self._loss(out, label)
        finally:
            _AUX_COLLECTOR.stack.pop()
        weights = [p.data(ctx)._data for p in self._train_params]
        grads = torch.autograd.grad(lvec._data.sum(), weights,
                                    allow_unused=True)

        # a parameter that the loss does not reach gets a zero gradient
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(weights, grads)]
        if group is not None:
            with record_function("fused_step.allreduce"):
                grads = _coll.psum_bucketed(grads, group, self._bucket_mb)
        if _integrity.enabled():
            _integrity.check_scalar(
                _integrity.finite_scalar(grads + [lvec._data]),
                site="fused_step",
                keys=[p.name for p in self._train_params])
        with torch.no_grad():
            with record_function("fused_step.update"):
                self._dev_fn(opt, weights, grads,
                             [_raw(s) for s in self._states], scal,
                             opt.rescale_grad)
            for target, value in aux:
                target._data.copy_(value)
        self.outputs = out.detach() if isinstance(out, NDArray) else out
        loss = lvec._data.detach()
        mean = loss.float().mean()
        if group is not None:
            mean = _coll.all_reduce(mean, group) / n_data
        return NDArray(mean.to(loss.dtype), ctx=ctx)
