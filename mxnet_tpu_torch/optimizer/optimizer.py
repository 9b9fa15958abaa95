"""Optimizers (the port of the SGD/Adam/LAMB part of
`mxnet_tpu.optimizer.optimizer`).

Kept from the reference: the registry (`Optimizer.register`, `create`),
the state protocol (`create_state`, `update`, fp32 master copies for
float16 weights under `multi_precision`), `lr_mult`/`wd_mult` resolution,
the per-index update counts that drive `lr_scheduler` and Adam's bias
correction (folded into lr, in Python double), `rescale_grad` and
`clip_gradient`, and the picklable `Updater` that `Trainer.save_states`
writes.

Every update runs one registered optimizer op per parameter through
`_run_op`: on a GPU context the op's `cuda_impl`, which launches the
hand-written flat SGD or Adam kernel once and updates the weight and state
in place; on a CPU context the plain version. The reference's aggregated
multi-parameter path (`fused_update`, `aggregate_num`) computes the same
fp32-then-round numbers in one jitted call; the port runs it as one launch
per parameter (a multi-tensor launch is later work), so `aggregate_num` is
kept for the API only. The reference's flat-shard update
(`_fused_flat_fn`) is `ops.fused_optimizer.flat_update_fn` here, and
the ZeRO updater (`optimizer.zero`) runs it per bucket.

LAMB's two phases go through the registry too (`_op_fn`): on a GPU context
phase 1 launches kernel #9 and phase 2 kernel #10 once per parameter. The
reference's `LAMB.update` calls the ops' plain functions directly, so its
imperative LAMB never reached its TPU kernels (ROADMAP Queue C); the
formulas are the reference's.

SGD, Adam and LAMB are ported; creating any other optimizer of the
reference raises NotImplementedError naming the slice that brings it.
"""
from __future__ import annotations

import copyreg
import math
import pickle
import warnings

import numpy as np
import torch

from .. import ndarray as nd
from ..ndarray import NDArray
from ..ops import registry as _reg

__all__ = ["Optimizer", "create", "register", "get_updater", "Updater",
           "SGD", "Adam", "LAMB"]

# the reference's other optimizers, and the slice of the port that brings
# each
_LATER = dict.fromkeys(
    ("signum", "signsgd", "ftml", "lars", "dcasgd", "nag", "sgld", "adagrad",
     "adadelta", "adamax", "nadam", "rmsprop", "ftrl", "adamw", "lbsgd",
     "test"), "a later slice of the port")


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
        out = fn(*(a._data for a in arrays), **kwargs)
        if not isinstance(out, tuple):
            out = (out,)
        assert len(targets) == len(out), \
            "optimizer op %s returned %d outputs for %d targets" % (
                name, len(out), len(targets))
        for target, new in zip(targets, out):
            if new is not target._data:
                target._data.copy_(new)


class Optimizer:
    """Base optimizer."""

    opt_registry = {}

    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0):
        if sym is not None:
            raise NotImplementedError("Optimizer(sym=...): symbols are not "
                                      "ported")
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
        if key in _LATER:
            raise NotImplementedError(
                "optimizer %r is not ported yet; it comes with %s (ported: "
                "%s)" % (name, _LATER[key], sorted(Optimizer.opt_registry)))
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

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Names that do not end in ``_weight`` default to wd_mult 0
        (biases, gammas, betas), as in the reference."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not n.endswith("_weight"):
                self.wd_mult[n] = 0.0
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
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        mean, var = state
        with torch.no_grad():
            gdir, new_mean, new_var = _op_fn("lamb_update_phase1", weight)(
                weight._data, grad._data, mean._data, var._data,
                beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                t=t, bias_correction=self.bias_correction, wd=wd,
                rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient))
            for target, new in ((mean, new_mean), (var, new_var)):
                if new.data_ptr() != target._data.data_ptr():
                    target._data.copy_(new)
            r1 = torch.linalg.vector_norm(weight._data.float())
            r2 = torch.linalg.vector_norm(gdir)
            new_w = _op_fn("lamb_update_phase2", weight)(
                weight._data, gdir, r1, r2, lr=lr,
                lower_bound=_clip(self.lower_bound),
                upper_bound=_clip(self.upper_bound))
            if new_w.data_ptr() != weight._data.data_ptr():
                weight._data.copy_(new_w)


class Updater:
    """The per-(index, grad, weight) update function object, with the
    optimizer's states; picklable (`get_states`/`set_states`)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        indices = index if isinstance(index, (list, tuple)) else [index]
        grads = grad if isinstance(grad, (list, tuple)) else [grad]
        weights = weight if isinstance(weight, (list, tuple)) else [weight]
        for idx, g, w in zip(indices, grads, weights):
            if idx not in self.states:
                self.states[idx] = \
                    self.optimizer.create_state_multi_precision(idx, w)
                self.states_synced[idx] = True
            elif not self.states_synced[idx]:
                self.states[idx] = self.sync_state_context(self.states[idx],
                                                           w.context)
                self.states_synced[idx] = True
            self.optimizer.update_multi_precision(idx, w, g,
                                                  self.states[idx])

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
