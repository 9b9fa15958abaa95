"""Optimizers (the port of `mxnet_tpu.optimizer.optimizer`): the
reference's 19 registered optimizers, SGD, Signum, SignSGD, FTML, LARS,
DCASGD, NAG, SGLD, Adam, AdaGrad, AdaDelta, Adamax, Nadam, RMSProp, Ftrl,
LAMB, AdamW, LBSGD and Test.

Kept from the reference: the registry (`Optimizer.register`, `create`),
the state protocol (`create_state`, `update`, fp32 master copies for
float16 weights under `multi_precision`), `lr_mult`/`wd_mult` resolution,
the per-index update counts that drive `lr_scheduler` and the bias
corrections (folded into lr, in Python double), each optimizer's host
bookkeeping (Nadam's m_schedule, LBSGD's warm-up multiplier, LARS's name
mask and host norms), `rescale_grad` and `clip_gradient`, and the
picklable `Updater` that `Trainer.save_states` writes.

A single update runs one registered optimizer op per parameter through
`_run_op`: on a GPU context the op's `cuda_impl` where it has one (SGD,
Adam and LAMB's ops, and so LARS's and LBSGD's: the hand-written flat
kernels, updating the weight and state in place), else the op's plain
version, whose new tensors are copied in. DCASGD's and SGLD's rules are
written inline here, as in the reference; SGLD draws its noise from the
weight context's seeded `torch.Generator` (`random.generator`), not from
the reference's JAX stream. As in the reference, an `Updater` with
``aggregate_num > 0`` (which `Trainer` sets from
``MXNET_OPTIMIZER_AGGREGATION_SIZE``, default 4) that is given a list of
parameters hands exactly-SGD or exactly-Adam updates of dense, non-float16
parameters to `fused_update`: one launch of kernel #7 or #8 over the whole
list (`ops.fused_optimizer.multi_sgd` / `multi_adam`). Like the
reference's `_fused_fn`, Adam's aggregated route computes 1 - beta in
fp32, where its per-parameter op computes it in double. The reference's
flat-shard update (`_fused_flat_fn`) is `ops.fused_optimizer.flat_update_fn`
here, and the ZeRO updater (`optimizer.zero`) runs it per bucket.

LAMB's two phases go through the registry too: on a GPU context
phase 1 launches kernel #9 and phase 2 kernel #10 once per parameter. The
reference's `LAMB.update` calls the ops' plain functions directly, so its
imperative LAMB never reached its TPU kernels (ROADMAP Queue C); the
formulas are the reference's.
"""
from __future__ import annotations

import copyreg
import math
import pickle
import warnings

import numpy as np
import torch

from .. import ndarray as nd
from .. import random as _random
from ..ndarray import NDArray
from ..ops import fused_optimizer as _fo
from ..ops import registry as _reg

__all__ = ["Optimizer", "create", "register", "get_updater", "Updater",
           "SGD", "Signum", "SignSGD", "FTML", "LARS", "DCASGD", "NAG",
           "SGLD", "Adam", "AdaGrad", "AdaDelta", "Adamax", "Nadam",
           "RMSProp", "Ftrl", "LAMB", "AdamW", "LBSGD", "Test"]


def _op_fn(name, weight):
    """The implementation of optimizer op `name` for `weight`'s context:
    the op's kernel on a GPU, its plain version on the CPU."""
    return _reg.get(name).best_fn(weight.context.device_type == "gpu")


def _run_op(name, *arrays, **kwargs):
    """Run optimizer op `name` on (weight, grad, *states) NDArrays and
    write the updated weight and states back into them (the reference's
    out=weight convention). A GPU context takes the op's kernel, which
    updates in place; the plain version's new tensors are copied in.

    A row-sparse gradient with ``lazy_update`` takes the reference's lazy
    path: the op runs on the gradient's rows alone (the weight's and
    states' rows gathered, updated, and written back), so the state of
    the absent rows does not decay. Any other row-sparse gradient is read
    dense."""
    from ..ndarray.sparse import RowSparseNDArray
    fn = _op_fn(name, arrays[0])
    grad = arrays[1] if len(arrays) > 1 else None
    targets = [arrays[0]] + list(arrays[2:])
    with torch.no_grad():
        if isinstance(grad, RowSparseNDArray) and kwargs.get("lazy_update") \
                and grad._indices.shape[0] < grad.shape[0]:
            idx = grad._indices.long()
            fulls = [t._data for t in targets]
            rows = [f[idx] for f in fulls]
            out = fn(rows[0], grad._values, *rows[1:], **kwargs)
            if not isinstance(out, tuple):
                out = (out,)
            assert len(targets) == len(out)
            for full, new in zip(fulls, out):
                full[idx] = new.to(full.dtype)
            return
        apply_op(name, arrays[0]._data, grad._data,
                 [a._data for a in arrays[2:]], **kwargs)


def apply_op(name, w, g, states, **kwargs):
    """Run optimizer op `name` on the tensors (w, g, *states) with the
    implementation of w's device (on a card the op's kernel where it has
    one, which updates in place) and copy what it returns into w and the
    states (the imperative and the fused route both run this)."""
    out = _reg.get(name).best_fn(w.is_cuda)(w, g, *states, **kwargs)
    if not isinstance(out, tuple):
        out = (out,)
    targets = [w] + list(states)
    assert len(targets) == len(out), \
        "optimizer op %s returned %d outputs for %d targets" % (
            name, len(out), len(targets))
    for target, new in zip(targets, out):
        if new.data_ptr() != target.data_ptr():
            target.copy_(new)


class Optimizer:
    """Base optimizer."""

    opt_registry = {}

    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0):
        # a symbol's __lr_mult__/__wd_mult__ attributes set the multipliers
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._all_index_update_counts = {0: {}}
        self._index_update_count = self._all_index_update_counts[0]
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            "param_idx2name should be a dict of param indexes to names."
        self.idx2name = param_idx2name.copy()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def register(klass):
        """Register an optimizer class under its lowercased name."""
        assert isinstance(klass, type)
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            warnings.warn("WARNING: New optimizer %s.%s is overriding "
                          "existing optimizer %s" %
                          (klass.__module__, klass.__name__, name))
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = name.lower()
        if key in Optimizer.opt_registry:
            return Optimizer.opt_registry[key](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """(fp32 master copy, state) for a float16 weight under
        multi_precision, else the plain state."""
        if self.multi_precision and weight.dtype == np.float16:
            master = weight.astype(np.float32)
            return (master, self.create_state(index, master))
        if weight.dtype == np.float16 and not self.multi_precision:
            warnings.warn("Accumulating with float16 in optimizer can lead "
                          "to poor accuracy or slow convergence. Consider "
                          "using multi_precision=True option of the "
                          "optimizer")
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        """Update the fp32 master of a float16 weight under
        multi_precision and round it into the weight; else `update`."""
        if self.multi_precision and weight.dtype == np.float16:
            master, original_state = state
            self.update(index, master, grad.astype(np.float32),
                        original_state)
            with torch.no_grad():
                weight._data.copy_(master._data)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can "
                              "mutate the value of the learning rate of the "
                              "optimizer only when the LRScheduler of the "
                              "optimizer is undefined.")
        self.lr = lr

    def _sym_mults(self, key):
        """{argument: float(attr)} of the symbol's `key` attributes."""
        if not self.sym_info:
            return {}
        attr, arg_names = self.sym_info
        return {n: float(attr[n][key]) for n in arg_names
                if n in attr and key in attr[n]}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Names that do not end in ``_weight`` default to wd_mult 0
        (biases, gammas, betas), as in the reference; a symbol's
        ``__wd_mult__`` attributes come next."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not n.endswith("_weight"):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _set_current_context(self, device_id):
        if device_id not in self._all_index_update_counts:
            self._all_index_update_counts[device_id] = {}
        self._index_update_count = self._all_index_update_counts[device_id]

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lrs(self, indices):
        """The scheduler's (or the fixed) lr times each index's lr_mult."""
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        lrs = [lr for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                lrs[i] *= self.param_dict[index].lr_mult
            elif index in self.lr_mult:
                lrs[i] *= self.lr_mult[index]
            elif index in self.idx2name:
                lrs[i] *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lrs

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wds(self, indices):
        wds = [self.wd for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                wds[i] *= self.param_dict[index].wd_mult
            elif index in self.wd_mult:
                wds[i] *= self.wd_mult[index]
            elif index in self.idx2name:
                wds[i] *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wds

    def _get_wd(self, index):
        return self._get_wds([index])[0]

    def __getstate__(self):
        # the parameters are the trainer's (it sets param_dict again after
        # loading), not part of the optimizer's state
        ret = self.__dict__.copy()
        del ret["_all_index_update_counts"]
        ret["param_dict"] = {}
        return ret

    def __setstate__(self, state):
        self.__dict__ = state
        self._all_index_update_counts = {0: self._index_update_count}


register = Optimizer.register


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return Optimizer.create_optimizer(name, **kwargs)


def _clip(v):
    return -1.0 if v is None else v


def _zeros(weight, dtype=None):
    return nd.zeros(weight.shape, ctx=weight.context,
                    dtype=weight.dtype if dtype is None else dtype)


def _norm(v):
    """||v||_2 of an NDArray as a Python float (the reference's
    ``v.norm().asscalar()``: a host sync)."""
    return torch.linalg.vector_norm(v._data.float()).item()


def dcasgd_update(w, g, mom, prev, lr, wd, momentum, lamda, rescale_grad,
                  clip_gradient):
    """DCASGD's delay-compensated step on tensors, in place: step = -lr *
    (g + wd * w + lamda * g * g * (w - prev)), through the momentum where
    there is one; prev takes the old w. fp32 arithmetic, each output
    rounded once (the imperative and the fused route both run this)."""
    g32 = g.float() * rescale_grad
    if clip_gradient is not None:
        g32 = torch.clamp(g32, -clip_gradient, clip_gradient)
    w32 = w.float()
    step = -lr * (g32 + wd * w32
                  + lamda * g32 * g32 * (w32 - prev.float()))
    if mom is not None:
        step = momentum * mom.float() + step
        mom.copy_(step)
    prev.copy_(w)
    w.copy_(w32 + step)


def _sgld_noise(weight, lr):
    """Standard normal noise of the weight's shape times sqrt(lr), fp32,
    from the weight context's seeded generator."""
    noise = torch.empty(weight.shape, dtype=torch.float32,
                        device=weight._data.device)
    noise.normal_(generator=_random.generator(weight.context))
    return noise * math.sqrt(lr)


@register
class SGD(Optimizer):
    """SGD with momentum and multi-precision: the state is the momentum
    buffer (None without momentum), or (fp32 master, momentum) for a
    float16 weight under multi_precision."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, multi_precision=False)

    def update_multi_precision(self, index, weight, grad, state):
        use_mp = self.multi_precision and weight.dtype == np.float16
        self._update_impl(index, weight, grad, state, multi_precision=use_mp)

    def fused_update(self, indices, weights, grads, states):
        """The reference's aggregated step (`multi_sgd_update` /
        `multi_sgd_mom_update`): every parameter of the list in one
        `multi_sgd` call, one launch on a card."""
        for i in indices:
            self._update_count(i)
        clip = self.clip_gradient
        mom_on = self.momentum != 0.0
        with torch.no_grad():
            _fo.multi_sgd([w._data for w in weights],
                          [g._data for g in grads],
                          [s._data for s in states] if mom_on else [], None,
                          self._get_lrs(indices), self._get_wds(indices),
                          self.momentum, self.rescale_grad,
                          0.0 if clip is None else clip, mom_on,
                          clip is not None, False)

    def _update_impl(self, index, weight, grad, state, multi_precision=False):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=_clip(self.clip_gradient),
                      lazy_update=self.lazy_update)
        if not multi_precision:
            if state is not None:
                _run_op("sgd_mom_update", weight, grad, state,
                        momentum=self.momentum, **kwargs)
            else:
                _run_op("sgd_update", weight, grad, **kwargs)
        else:
            w32, mom = state
            if mom is not None:
                _run_op("mp_sgd_mom_update", weight, grad, mom, w32,
                        momentum=self.momentum, **kwargs)
            else:
                _run_op("mp_sgd_update", weight, grad, w32, **kwargs)


@register
class Signum(Optimizer):
    """The sign of the momentum as the step (signsgd without momentum)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=_clip(self.clip_gradient))
        if state is not None:
            _run_op("signum_update", weight, grad, state,
                    momentum=self.momentum, wd_lh=self.wd_lh, **kwargs)
        else:
            _run_op("signsgd_update", weight, grad, **kwargs)


@register
class SignSGD(Signum):
    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class FTML(Optimizer):
    """Follow the moving leader; the update count t enters the op."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        d, v, z = state
        _run_op("ftml_update", weight, grad, d, v, z, lr=self._get_lr(index),
                wd=self._get_wd(index), beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, rescale_grad=self.rescale_grad,
                clip_grad=_clip(self.clip_gradient), t=t)


@register
class LARS(Optimizer):
    """Layer-wise rate scaling on SGD(-momentum): lr times eta * ||w|| /
    (||g|| + wd * ||w|| + eps) from the raw gradient's norm, on the host,
    except for parameters whose name (``idx2name``, else the index as a
    string) ends in gamma, beta or bias."""

    def __init__(self, momentum=0.0, lazy_update=True, eta=0.001, eps=1e-8,
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
        self.eta = eta
        self.eps = eps

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def _get_lars(self, i, weight, g, lr, wd):
        name = self.idx2name.get(i, str(i))
        if name.endswith("gamma") or name.endswith("beta") or \
                name.endswith("bias"):
            return lr
        w_norm = _norm(weight)
        g_norm = _norm(g)
        if w_norm > 0.0 and g_norm > 0.0:
            lars = self.eta * w_norm / (g_norm + wd * w_norm + self.eps)
        else:
            lars = 1.0
        return lars * lr

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        lr = self._get_lars(index, weight, grad, self._get_lr(index), wd)
        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=_clip(self.clip_gradient))
        if state is not None:
            _run_op("sgd_mom_update", weight, grad, state,
                    momentum=self.momentum, **kwargs)
        else:
            _run_op("sgd_update", weight, grad, **kwargs)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD; the state is (momentum or
    None, the previous weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros(weight), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mom, previous_weight = state
        with torch.no_grad():
            dcasgd_update(weight._data, grad._data,
                          None if mom is None else mom._data,
                          previous_weight._data, self._get_lr(index),
                          self._get_wd(index), self.momentum, self.lamda,
                          self.rescale_grad, self.clip_gradient)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD, with the multi-precision branch."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, multi_precision=False)

    def update_multi_precision(self, index, weight, grad, state):
        use_mp = self.multi_precision and weight.dtype == np.float16
        self._update_impl(index, weight, grad, state, multi_precision=use_mp)

    def _update_impl(self, index, weight, grad, state, multi_precision=False):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=_clip(self.clip_gradient))
        if not multi_precision:
            if state is not None:
                _run_op("nag_mom_update", weight, grad, state,
                        momentum=self.momentum, **kwargs)
            else:
                _run_op("sgd_update", weight, grad, **kwargs)
        else:
            w32, mom = state
            if mom is not None:
                _run_op("mp_nag_mom_update", weight, grad, mom, w32,
                        momentum=self.momentum, **kwargs)
            else:
                _run_op("mp_sgd_update", weight, grad, w32, **kwargs)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w -= lr / 2 * (g + wd * w),
    plus N(0, lr) noise (`_sgld_noise`). No fused route takes it."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        with torch.no_grad():
            g = grad._data.float() * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            w = weight._data.float()
            weight._data.copy_(w - lr / 2 * (g + wd * w)
                               + _sgld_noise(weight, lr))


@register
class Adam(Optimizer):
    """Adam; the bias correction sqrt(1 - beta2^t) / (1 - beta1^t) is
    folded into lr in Python double, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) * math.sqrt(1. - self.beta2 ** t) / \
            (1. - self.beta1 ** t)
        mean, var = state
        _run_op("adam_update", weight, grad, mean, var, lr=lr,
                wd=self._get_wd(index), beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient),
                lazy_update=self.lazy_update)

    def fused_update(self, indices, weights, grads, states):
        """The reference's aggregated step: the bias correction folded into
        each lr in double, then every parameter of the list in one
        `multi_adam` call, one launch on a card. 1 - beta is computed in
        fp32, as the reference's `_fused_fn` computes it."""
        lrs, wds = [], []
        for i in indices:
            self._update_count(i)
            t = self._index_update_count[i]
            lrs.append(self._get_lr(i) * math.sqrt(1. - self.beta2 ** t)
                       / (1. - self.beta1 ** t))
            wds.append(self._get_wd(i))
        one = np.float32(1.0)
        clip = self.clip_gradient
        with torch.no_grad():
            _fo.multi_adam([w._data for w in weights],
                           [g._data for g in grads],
                           [s[0]._data for s in states],
                           [s[1]._data for s in states], None, lrs, wds,
                           self.beta1, float(one - np.float32(self.beta1)),
                           self.beta2, float(one - np.float32(self.beta2)),
                           self.epsilon, self.rescale_grad,
                           0.0 if clip is None else clip, clip is not None,
                           False)


@register
class AdaGrad(Optimizer):
    """AdaGrad; the constructor's ``eps`` is the op's epsilon."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _run_op("adagrad_update", weight, grad, state, lr=self._get_lr(index),
                wd=self._get_wd(index), epsilon=self.float_stable_eps,
                rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient))


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        acc_g, acc_delta = state
        _run_op("adadelta_update", weight, grad, acc_g, acc_delta,
                rho=self.rho, epsilon=self.epsilon, wd=self._get_wd(index),
                rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient))


@register
class Adamax(Optimizer):
    """Adamax; 1 / (1 - beta1^t) is folded into lr in Python double."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1. - self.beta1 ** t)
        mean, u = state
        _run_op("adamax_update", weight, grad, mean, u, lr=lr,
                wd=self._get_wd(index), beta1=self.beta1, beta2=self.beta2,
                rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient))


@register
class Nadam(Optimizer):
    """Nesterov Adam. As in the reference, the m_schedule product advances
    once per parameter update, not once per step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 **
                                   (t * self.schedule_decay))
        _run_op("nadam_update", weight, grad, mean, var,
                lr=self._get_lr(index), wd=self._get_wd(index),
                beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                schedule_decay=self.schedule_decay,
                rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient), t=t,
                m_schedule=self.m_schedule)
        self.m_schedule = self.m_schedule * momentum_t


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered=True`` takes Graves's (2013) centered form."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      gamma1=self.gamma1, epsilon=self.epsilon,
                      rescale_grad=self.rescale_grad,
                      clip_gradient=_clip(self.clip_gradient),
                      clip_weights=_clip(self.clip_weights))
        if not self.centered:
            _run_op("rmsprop_update", weight, grad, state, **kwargs)
        else:
            n, g, delta = state
            _run_op("rmspropalex_update", weight, grad, n, g, delta,
                    gamma2=self.gamma2, **kwargs)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        _run_op("ftrl_update", weight, grad, z, n, lr=self._get_lr(index),
                wd=self._get_wd(index), lamda1=self.lamda1, beta=self.beta,
                rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient))


@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer: Adam's moments give a
    direction (plus wd * w), scaled per parameter by the trust ratio
    ||w|| / ||direction|| (||w|| clipped into [lower_bound, upper_bound]
    where given). The bias correction divides the moments; it is not folded
    into lr."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        with torch.no_grad():
            self.update_tensors(weight._data, grad._data, mean._data,
                                var._data, self._get_lr(index),
                                self._get_wd(index),
                                self._index_update_count[index],
                                self.rescale_grad)

    def update_tensors(self, w, g, mean, var, lr, wd, t, rescale_grad):
        """Both phases on tensors, in place (the imperative and the fused
        route both run this): the direction and the moments, the norms on
        w's device, then the trust-ratio step."""
        gdir, new_mean, new_var = _reg.get("lamb_update_phase1").best_fn(
            w.is_cuda)(w, g, mean, var, beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, t=t,
                       bias_correction=self.bias_correction, wd=wd,
                       rescale_grad=rescale_grad,
                       clip_gradient=_clip(self.clip_gradient))
        for target, new in ((mean, new_mean), (var, new_var)):
            if new.data_ptr() != target.data_ptr():
                target.copy_(new)
        apply_op("lamb_update_phase2", w, gdir, (),
                 r1=torch.linalg.vector_norm(w.float()),
                 r2=torch.linalg.vector_norm(gdir), lr=lr,
                 lower_bound=_clip(self.lower_bound),
                 upper_bound=_clip(self.upper_bound))


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (``eta`` scales the whole step);
    the bias correction is folded into lr in Python double, as Adam's."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.eta = eta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) * math.sqrt(1. - self.beta2 ** t) / \
            (1. - self.beta1 ** t)
        mean, var = state
        _run_op("adamw_update", weight, grad, mean, var, lr=lr,
                wd=self._get_wd(index), beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, eta=self.eta,
                rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient))


@register
class LBSGD(Optimizer):
    """Large-batch SGD(-momentum): lr times a warm-up multiplier (linear,
    power2 or sqrt over warmup_epochs, up to batch_scale), or with
    ``warmup_strategy="lars"`` the LARS rate of the weight and gradient
    (host norms)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        strategy = self.warmup_strategy
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            mult = maxmult
        elif nwup <= 1:
            mult = 1.0
        elif strategy == "linear":
            mult = 1.0 + (maxmult - 1) * nup / nwup
        elif strategy == "power2":
            mult = 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        elif strategy == "sqrt":
            mult = 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        else:
            mult = 1.0
        return mult

    def _get_lars(self, weight, g, wd):
        w = weight._data.float()
        gr = g._data.float()
        weight2 = float((w * w).sum())
        grad2 = float((gr * gr).sum())
        lars = math.sqrt(weight2 / (grad2 + wd * weight2 + 1e-18))
        return min(max(lars, 0.01), 100.0)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        if self.warmup_strategy == "lars":
            self.lbmult = self._get_lars(weight, grad, wd)
        else:
            self.lbmult = self._get_lbmult(self.num_update
                                           + self.init_updates)
        kwargs = dict(lr=lr * self.lbmult, wd=wd,
                      rescale_grad=self.rescale_grad,
                      clip_gradient=_clip(self.clip_gradient))
        if state is not None:
            _run_op("sgd_mom_update", weight, grad, state,
                    momentum=self.momentum, **kwargs)
        else:
            _run_op("sgd_update", weight, grad, **kwargs)


@register
class Test(Optimizer):
    """The trivial optimizer of the reference's unit tests: w -= g *
    rescale_grad."""

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, ctx=weight.context)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._data.copy_(weight._data.float()
                               - grad._data.float() * self.rescale_grad)


class Updater:
    """The per-(index, grad, weight) update function object, with the
    optimizer's states; picklable (`get_states`/`set_states`). Given lists
    and an optimizer with ``aggregate_num > 0``, it takes the aggregated
    route where `_can_fuse` allows it, as the reference's does."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        indices = index if isinstance(index, (list, tuple)) else [index]
        grads = grad if isinstance(grad, (list, tuple)) else [grad]
        weights = weight if isinstance(weight, (list, tuple)) else [weight]
        for idx, w in zip(indices, weights):
            if idx not in self.states:
                self.states[idx] = \
                    self.optimizer.create_state_multi_precision(idx, w)
                self.states_synced[idx] = True
            elif not self.states_synced[idx]:
                self.states[idx] = self.sync_state_context(self.states[idx],
                                                           w.context)
                self.states_synced[idx] = True
        if len(indices) > 1 and self.aggregate_updates and \
                self._can_fuse(weights, grads):
            self.optimizer.fused_update(indices, weights, grads,
                                        [self.states[i] for i in indices])
            return
        for idx, g, w in zip(indices, grads, weights):
            self.optimizer.update_multi_precision(idx, w, g,
                                                  self.states[idx])

    def _can_fuse(self, weights, grads):
        """The aggregated route takes exactly SGD or Adam (a subclass may
        change the update), dense gradients and no float16 weight (those
        take the multi-precision path)."""
        from ..ndarray.sparse import BaseSparseNDArray
        if type(self.optimizer) not in (SGD, Adam):
            return False
        if any(isinstance(g, BaseSparseNDArray) for g in grads):
            return False
        return all(w.dtype != np.float16 for w in weights)

    def sync_state_context(self, state, context):
        if isinstance(state, NDArray):
            return state.as_in_context(context)
        if isinstance(state, (tuple, list)):
            synced = [self.sync_state_context(i, context) for i in state]
            return tuple(synced) if isinstance(state, tuple) else synced
        return state

    def set_states(self, states):
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


def get_updater(optimizer):
    return Updater(optimizer)


# NDArrays pickle as (bits, dtype name, context): bfloat16 keeps its bits
def _ndarray_reduce(arr):
    from ..ndarray.ndarray import _record
    data, name = _record(arr)
    return (_ndarray_rebuild, (data, name, arr.context.device_type,
                               arr.context.device_id))


def _ndarray_rebuild(data, name, dev_type, dev_id):
    from ..context import Context
    from ..ndarray.ndarray import _from_record
    return _from_record(data, name).as_in_context(Context(dev_type, dev_id))


copyreg.pickle(NDArray, _ndarray_reduce)
