"""Gluon Trainer (the port of `mxnet_tpu.gluon.trainer`).

`step(batch_size)` sets ``rescale_grad = scale / batch_size`` (the
gradients are of the loss *sum* over the batch), reduces the gradients
through the kvstore where there is one and runs the optimizer.

Without a store (one context, weights of the default stype and no
``update_on_kvstore=True``: the reference's single-device short cut) the
optimizer runs every trainable parameter through the `Updater` in one
call, which for SGD and Adam is the reference's aggregated update (on by
default, ``MXNET_OPTIMIZER_AGGREGATION_SIZE``): one launch of the flat
kernel over all of them on a card. With a store
and ``update_on_kvstore`` the optimizer runs on the store: the gradients
go in one multi-key push in reverse registration order (about the order
backward finishes them) and the updated weights are pulled back into the
parameters. ``zero=True`` makes the store's updater the ZeRO-1
`optimizer.zero.ZeroUpdater` (SGD, Adam, LAMB over gradient buckets). A
weight of row-sparse stype makes a store on one context too, updating on
it by default, as in the reference: the step pulls back only the dense
weights, and `_row_sparse_pull` the rows a batch needs of the others
(`Parameter.row_sparse_data`). Row-sparse gradients of dense weights
(`Embedding(sparse_grad=True)`) need no store: the `Updater` runs each
through the optimizer's lazy path, which touches only their rows.

Several contexts in one process make a ``device`` store that sums the
replicas' gradients (the reference's local reduction) and, by default,
one `Updater` per context. A ``dist*`` store sums across processes and,
by default, updates on the store (the reference's server-side
optimizer); ``compression_params`` turn on its 2-bit compression, and
``zero=True`` its ZeRO-1 updater over the process group.

Readiness-ordered communication (``comm_ready=True``, or the pinned or
autotuned `engine.CommSchedule`, or ``MXNET_TPU_COMM_READY=1``, in that
order): a grad-ready hook (`autograd.add_grad_ready_hook`) pushes each
parameter into a `kvstore.ReadyPushSession` as soon as backward has
finished all its replicas, so exchanges start during backward; `step`
then only completes the round. A round that cannot complete (a
parameter backward never reached, a second backward before the step,
"add" gradients, sparse or compressed stores) is dropped, having written
nothing, and the step takes the registration path.
"""
from __future__ import annotations

import os
import time
import warnings
import weakref

from torch.profiler import record_function

from .. import autograd
from .. import engine as _engine
from .. import kvstore as kvs
from .. import optimizer as opt
from .. import telemetry as _telem
from ..context import current_context
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


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
            param._set_trainer(self)
        self._compression_params = compression_params
        self._zero = opt.zero_enabled(zero)
        if self._zero:
            if not kvstore:
                raise ValueError(
                    "zero=True needs a kvstore (the sharded update runs on "
                    "the store); got kvstore=%r" % (kvstore,))
            if update_on_kvstore is False:
                raise ValueError(
                    "zero=True updates ON the kvstore; "
                    "update_on_kvstore=False contradicts it")
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._distributed = False
        self._params_to_init = list(self._params)
        self._comm_ready = comm_ready
        self._ready_sess = None
        self._ready_round = -1
        self._ready_blocked = False
        self._ready_leaf_map = {}
        self._ready_pending = {}
        self._ready_expected = set()
        self._ready_warned = False
        self._autotune = None
        self._ready_hook = None
        self._maybe_install_ready_hook()

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
        if self._optimizer.aggregate_num == 0:
            # the reference's Trainer turns on the aggregated update, sized
            # by MXNET_OPTIMIZER_AGGREGATION_SIZE (0 turns it off)
            self._optimizer.aggregate_num = int(
                os.environ.get("MXNET_OPTIMIZER_AGGREGATION_SIZE", "4"))
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]

    def _reset_kvstore(self):
        """Drop the store, so that the next step makes it again from the
        parameters as they are (a restore wrote them)."""
        if self._kvstore and "dist" in self._kvstore.type:
            raise RuntimeError("Cannot reset distributed KVStore.")
        self._kv_initialized = False
        self._kvstore = None
        self._distributed = None
        self._update_on_kvstore = None
        self._params_to_init = list(self._params)

    def _init_kvstore(self):
        """Make the store and decide update_on_kvstore (reference:
        `Trainer._init_kvstore`): one context with dense weights, no
        ``dist*`` store and no explicit update_on_kvstore=True needs no
        store."""
        name = self._kvstore_params["kvstore"]
        update_on_kvstore = self._kvstore_params["update_on_kvstore"]
        sparse_params = any(p.stype != "default" for p in self._params)
        if self._zero:
            if sparse_params:
                raise ValueError("zero=True requires dense parameters")
            update_on_kvstore = True
        kvstore = None
        if name and (not isinstance(name, str) or update_on_kvstore is True
                     or sparse_params or name.startswith("dist")
                     or len(self._contexts) > 1):
            kvstore = kvs.create(name) if isinstance(name, str) else name
        self._distributed = kvstore is not None and "dist" in kvstore.type
        if kvstore is not None:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            if update_on_kvstore is None:
                # the reference's default: on the store for distributed
                # stores and sparse weights
                update_on_kvstore = self._distributed or sparse_params
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer, zero=self._zero)
            self._kvstore = kvstore
            self._update_on_kvstore = bool(update_on_kvstore)
        else:
            self._kvstore = None
            self._update_on_kvstore = False
        self._kv_initialized = True

    def _init_params(self):
        """Put each initialized parameter into the store (a deferred one
        waits for its shape); when the store updates, the dense parameters
        take the stored weights."""
        waiting = []
        for param in self._params_to_init:
            if param._deferred_init:
                waiting.append(param)
                continue
            idx = self._param2idx[param.name]
            arrays = param.list_data()
            self._kvstore.init(idx, arrays[0])
            if self._update_on_kvstore and param.stype == "default":
                self._kvstore.pull(idx, arrays, priority=-idx)
        self._params_to_init = waiting

    def _ensure_store(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None and self._params_to_init:
            self._init_params()

    def _row_sparse_pull(self, parameter, out, row_id, full_idx=False):
        """Pull the rows `row_id` of `parameter`'s stored weight into the
        row-sparse `out` (every row with `full_idx`: a plain pull)."""
        self._ensure_store()
        idx = self._param2idx[parameter.name]
        if full_idx:
            self._kvstore.pull(idx, out=out, ignore_sparse=False)
        else:
            self._kvstore.row_sparse_pull(idx, out=out, row_ids=row_id)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- readiness-ordered communication ---------------------------------
    def _comm_autotuner(self):
        """The schedule autotuner when ``MXNET_TPU_COMM_AUTOTUNE`` asks
        for one; a schedule pinned process-wide (a restored checkpoint, or
        another trainer's sweep) makes it a finished one."""
        if not _engine.autotune_enabled():
            return None
        if self._autotune is None or not self._autotune.done:
            sched = _engine.current_schedule()
            if sched is not None and (
                    self._autotune is None
                    or sched is not self._autotune.current()):
                self._autotune = _engine.ScheduleAutotuner.restored(sched)
                sched.apply()
            elif self._autotune is None:
                self._autotune = _engine.ScheduleAutotuner()
                self._autotune.current().apply()
        return self._autotune

    def _comm_policy(self):
        """The flush policy of the next round: `comm_ready` > the
        autotuner's candidate or pinned schedule >
        ``MXNET_TPU_COMM_READY`` > registration order."""
        if self._comm_ready is not None:
            return "ready" if self._comm_ready else "registration"
        tuner = self._comm_autotuner()
        if tuner is not None:
            return tuner.current().policy
        sched = _engine.current_schedule()
        if sched is not None:
            return sched.policy
        return "ready" if _engine.autotune.ready_env() else "registration"

    def _maybe_install_ready_hook(self):
        """Install the grad-ready hook only when readiness may be chosen,
        so that a registration-only trainer costs backward nothing."""
        if self._ready_hook is not None:
            return
        sched = _engine.current_schedule()
        want = (self._comm_ready is True
                or (self._comm_ready is None and (
                    _engine.autotune_enabled()
                    or (sched is not None and sched.policy == "ready")
                    or _engine.autotune.ready_env())))
        if not want:
            return
        ref = weakref.ref(self)

        def _hook(leaf):
            tr = ref()
            if tr is None:
                autograd.remove_grad_ready_hook(_hook)
                return
            tr._on_grad_ready(leaf)

        self._ready_hook = autograd.add_grad_ready_hook(_hook)

    def _ready_supported(self):
        """A dense, uncompressed store with every parameter in it, and no
        "add" gradients (accumulation syncs at step time)."""
        if (self._kvstore is None or not self._kv_initialized
                or self._params_to_init or self._compression_params):
            return False
        for p in self._params:
            if p.grad_req == "add":
                return False
            if p.grad_req != "null" and (p.stype != "default"
                                         or p.grad_stype != "default"):
                return False
        return True

    def _arm_ready_session(self):
        entries = [p for p in self._params if p.grad_req != "null"]
        if not entries:
            return
        canonical = [str(self._param2idx[p.name]) for p in reversed(entries)]
        self._ready_leaf_map = {}
        self._ready_pending = {}
        for p in entries:
            ids = set()
            for d in p.list_data():
                self._ready_leaf_map[id(d)] = p
                ids.add(id(d))
            self._ready_pending[p.name] = ids
        self._ready_expected = set(canonical)
        self._ready_sess = self._kvstore.ready_session(
            canonical_keys=canonical)

    def _abort_ready(self):
        self._ready_sess = None
        self._ready_blocked = True
        _telem.inc("comm.ready.aborted")

    def _on_grad_ready(self, leaf):
        """The grad-ready hook: push a parameter once all its replicas
        have reported. Any anomaly drops the round (its launches wrote
        nothing), and the step falls back to registration order."""
        rnd = autograd.backward_round()
        if rnd != self._ready_round:
            if self._ready_sess is not None \
                    and not self._ready_sess.finished:
                # a second backward before step(): sync at step time
                self._abort_ready()
            self._ready_round = rnd
            if not self._ready_blocked and self._comm_policy() == "ready" \
                    and self._ready_supported():
                self._arm_ready_session()
        sess = self._ready_sess
        if sess is None or sess.finished:
            return
        param = self._ready_leaf_map.get(id(leaf))
        if param is None:
            return
        pend = self._ready_pending.get(param.name)
        if pend is None:
            self._abort_ready()
            return
        pend.discard(id(leaf))
        if pend:
            return
        del self._ready_pending[param.name]
        try:
            sess.push(self._param2idx[param.name], param.list_grad())
        except Exception as exc:  # noqa: BLE001 - the round is dropped
            self._abort_ready()
            if not self._ready_warned:
                self._ready_warned = True
                warnings.warn("readiness comm disabled for this step "
                              "(falling back to registration order): %s"
                              % (exc,))

    def _autotune_advance(self):
        tuner = self._comm_autotuner()
        if tuner is None or tuner.done:
            self._maybe_install_ready_hook()
            return
        tuner.on_step_end()
        if not tuner.done:
            tuner.current().apply()

    def step(self, batch_size, ignore_stale_grad=False):
        """One update: gradients (of the loss sum) scaled by
        ``scale / batch_size``, reduced through the store, then the
        optimizer (on the store when it updates). Records a
        ``trainer.step`` span and the ``trainer.step_ms`` histogram."""
        ts = _telem.span_clock()
        t0 = time.perf_counter()
        try:
            self._check_and_rescale_grad(self._scale / batch_size)
            self._ensure_store()
            self._allreduce_grads()
            self._update(ignore_stale_grad)
        finally:
            dur = time.perf_counter() - t0
            _telem.observe("trainer.step_ms", dur * 1e3)
            _telem.record_span("trainer.step", "step", ts, dur)
            self._autotune_advance()

    def _check_and_rescale_grad(self, scale):
        if self._update_on_kvstore and self._distributed and \
                self._kv_initialized and \
                self._optimizer.rescale_grad != scale:
            raise UserWarning(
                "Possible change in the `batch_size` from previous `step` "
                "detected. Optimizer gradient normalizing factor will not "
                "change w.r.t new batch_size when update_on_kvstore=True")
        self._optimizer.rescale_grad = scale

    def allreduce_grads(self):
        """Reduce the gradients through the store without an update."""
        self._ensure_store()
        assert not (self._kvstore and self._update_on_kvstore), \
            "allreduce_grads() when parameters are updated on kvstore is " \
            "not supported. Try setting `update_on_kvstore` to False when " \
            "creating trainer."
        self._allreduce_grads()

    def _allreduce_grads(self):
        if not self._kvstore:
            return
        sess, self._ready_sess = self._ready_sess, None
        self._ready_blocked = False
        if sess is not None and not sess.finished:
            if not self._ready_pending \
                    and set(sess.pushed) == self._ready_expected:
                outs = None
                if not self._update_on_kvstore:
                    outs = [(str(self._param2idx[p.name]), p.list_grad())
                            for p in self._params if p.grad_req != "null"]
                sess.finish(outs=outs)
                _telem.inc("comm.ready.rounds")
                return
            # a parameter never reported: the launches wrote nothing
            _telem.inc("comm.ready.aborted")
        entries = [(i, p) for i, p in enumerate(self._params)
                   if p.grad_req != "null"]
        # ZeRO always takes the multi-key path: its updater needs every key
        # of the step in one call; sparse weights go one key at a time
        if entries and (_engine.bucket_bytes() or self._zero) \
                and (len(entries) > 1 or self._zero) \
                and all(p.stype == "default" for _, p in entries):
            keys, grads = [], []
            for _, param in reversed(entries):
                keys.append(self._param2idx[param.name])
                grads.append(param.list_grad())
            if self._update_on_kvstore:
                self._kvstore.push(keys, grads, priority=0)
            else:
                self._kvstore.pushpull(keys, grads, out=grads, priority=0)
            return
        for i, param in entries:
            idx = self._param2idx[param.name]
            grad_list = param.list_grad()
            self._kvstore.push(idx, grad_list, priority=-i)
            if not self._update_on_kvstore:
                self._kvstore.pull(idx, grad_list, priority=-i,
                                   ignore_sparse=False)

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone (the gradients already reduced)."""
        self._ensure_store()
        assert not (self._kvstore and self._update_on_kvstore), \
            "update() when parameters are updated on kvstore is not " \
            "supported. Try setting `update_on_kvstore` to False when " \
            "creating trainer."
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        # each updater slot's parameters in one call, so that the
        # aggregated update takes the whole step (the reference's batching)
        batched = [[] for _ in self._updaters]
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if self._kvstore and self._update_on_kvstore:
                # the store updated its weights: write the dense ones back
                if param.stype == "default":
                    with record_function("trainer.writeback"):
                        self._kvstore.pull(self._param2idx[param.name],
                                           param.list_data(), priority=-i)
                continue
            for slot, (arr, grad) in enumerate(zip(param.list_data(),
                                                   param.list_grad())):
                batched[slot].append((i, grad, arr))
        for upd, entries in zip(self._updaters, batched):
            if len(entries) == 1:
                upd(*entries[0])
            elif entries:
                idxs, grads, arrs = zip(*entries)
                upd(list(idxs), list(grads), list(arrs))

    def save_states(self, fname):
        """Write the optimizer and its states (pickled): the store's when
        it updates, else the Updater's."""
        self._ensure_store()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        self._ensure_store()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._updaters[0].optimizer
            self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param
                                      in enumerate(self._params)}
