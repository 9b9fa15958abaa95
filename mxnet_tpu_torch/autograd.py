"""Autograd (the port of `mxnet_tpu.autograd`): the mode state
(`is_training`, `is_recording`, and the `record`, `pause`, `train_mode` and
`predict_mode` scopes, per thread) and the tape, which is torch.autograd.

Recording means that torch records: `ndarray.invoke` runs an op with
torch's grad mode on exactly when `is_recording()` and the op is
`differentiable`, and `mark_variable` makes an array's tensor a leaf that
requires grad. `backward` asks torch for the gradients of the heads with
respect to every live marked array and writes them into the arrays'
`.grad` buffers by `grad_req` ("write" overwrites, "add" accumulates);
`grad` returns them without touching the buffers. An array that took no
part in the graph keeps its buffer as it was, as in the reference.

Row-sparse cotangents (the reference's ``RowSparseRows``): an op whose
weight gradient is naturally row-sparse, `Embedding(sparse_grad=True)`,
returns an uncoalesced ``torch.sparse_coo_tensor`` for its dense weight,
one row per lookup. Torch adds two of them by concatenation and a sparse
one to a dense one densely, as the reference's ``_add_cot`` does. At the
leaf, a row-sparse buffer (``attach_grad(stype="row_sparse")``, a
Parameter's ``grad_stype="row_sparse"``) takes the rows merged by
`ndarray.sparse.merge_rows` (sorted unique ids, duplicates summed in
occurrence order: kernel #11 on a card), ``grad_req="add"`` the union
with the rows it holds; a dense buffer takes them densified; `grad`
returns a `RowSparseNDArray`.

`Function` is a differentiable function with a hand-written backward: its
`forward` and `backward` run inside one `torch.autograd.Function`, as
custom ops do (`operator._CustomFn`).

Grad-ready hooks (`add_grad_ready_hook`): while one is installed,
`backward` runs ``torch.autograd.backward`` over the marked leaves with a
``register_post_accumulate_grad_hook`` on each, so each leaf's `.grad`
buffer is written, and the hooks called with its array, the moment torch
has accumulated its last contribution, while the rest of backward still
runs. That feeds the readiness-ordered kvstore push. On a CUDA tensor
torch calls the hook on its device thread, so `in_backward` and
`backward_round` are process-wide, not per thread.
"""
from __future__ import annotations

import functools
import threading
import weakref

import torch

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "record", "pause", "train_mode", "predict_mode", "backward",
           "grad", "mark_variable", "Function", "add_grad_ready_hook",
           "remove_grad_ready_hook", "in_backward", "backward_round"]

_state = threading.local()

# backward's progress and the grad-ready hooks, shared with torch's device
# threads (which run the leaf hooks of CUDA tensors)
_BWD = {"depth": 0, "round": 0}
_GRAD_READY_HOOKS = []


def in_backward():
    """True while `backward` runs (a hook that launches work tells by it
    whether the launch beat the end of backward)."""
    return _BWD["depth"] > 0


def backward_round():
    """The number of `backward` calls so far: a grad-ready consumer sees a
    second backward before the step (gradient accumulation) by it."""
    return _BWD["round"]


def add_grad_ready_hook(fn):
    """Call ``fn(array)`` the moment a marked array's gradient is final
    during `backward`, right after its `.grad` buffer is written."""
    _GRAD_READY_HOOKS.append(fn)
    return fn


def remove_grad_ready_hook(fn):
    """Unregister a hook (no-op if it is not installed)."""
    try:
        _GRAD_READY_HOOKS.remove(fn)
    except ValueError:
        pass


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    """Set the recording flag; returns the previous value."""
    st = _st()
    prev, st.recording = st.recording, bool(is_record)
    return prev


def set_training(train_mode_):
    """Set the training flag; returns the previous value."""
    st = _st()
    prev, st.training = st.training, bool(train_mode_)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode_):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode_
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, ptype, value, trace):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# arrays marked by `mark_variable` (attach_grad, Parameter gradients) that
# are still alive, by id (an `mx.np.ndarray` has no hash): the leaves
# `backward` differentiates with respect to
_marked = {}


def _unmark(key, ref):
    if _marked.get(key) is ref:
        del _marked[key]


def _live_marked():
    return [nd for nd in (r() for r in list(_marked.values()))
            if nd is not None]


def mark_variable(nd, grad_req="write"):
    """Make `nd` a variable of the tape with `grad_req` (reference:
    Imperative::MarkVariables): its tensor becomes a leaf that requires
    grad (the same storage), or stops requiring it for "null"."""
    if grad_req not in ("write", "add", "null"):
        raise ValueError("grad_req must be write/add/null, got %s" % grad_req)
    nd._grad_req = grad_req
    t = nd._data.detach()
    if grad_req == "null":
        ref = _marked.get(id(nd))
        if ref is not None and ref() is nd:
            del _marked[id(nd)]
    else:
        if not t.is_floating_point():
            raise ValueError("mark_variable: only floating arrays take "
                             "gradients, got %s" % t.dtype)
        t.requires_grad_(True)
        if id(nd) not in _marked or _marked[id(nd)]() is not nd:
            _marked[id(nd)] = weakref.ref(
                nd, functools.partial(_unmark, id(nd)))
    nd._data = t


def _heads_and_cots(heads, head_grads):
    heads = heads if isinstance(heads, (list, tuple)) else [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    outs, cots = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue      # not recorded: contributes nothing
        if hg is None:
            cot = torch.ones_like(t)
        else:
            cot = hg._data if hasattr(hg, "_data") else torch.as_tensor(hg)
            cot = cot.to(t.device, t.dtype)
        outs.append(t)
        cots.append(cot)
    return outs, cots


def _merged_rows(cot, dtype, extra=None):
    """(sorted unique int32 ids, summed rows) of an uncoalesced sparse
    cotangent, after the rows of `extra` (a RowSparseNDArray's) where
    given, as the reference's ``_canonical_rows``."""
    from .ndarray.sparse import merge_rows
    ids, vals = cot._indices()[0], cot._values().to(dtype)
    if extra is not None and extra._indices.shape[0]:
        ids = torch.cat([ids, extra._indices.to(ids.dtype)])
        vals = torch.cat([vals, extra._values.to(dtype)])
    return merge_rows(ids, vals)


def _densify(cot):
    """A sparse cotangent as a dense tensor, its rows added in occurrence
    order (`segment_sum`)."""
    from .ops.sparse_ops import segment_sum
    return segment_sum(cot._values(), cot._indices()[0], cot.shape[0])


def _write_leaf_grad(nd, cot):
    """Write one leaf's gradient into its `.grad` buffer: "write"
    overwrites, "add" accumulates. A sparse cotangent keeps a row-sparse
    buffer row-sparse and is densified for a dense one."""
    from .ndarray.ndarray import zeros
    from .ndarray.sparse import RowSparseNDArray
    if nd._grad is None:
        nd._grad = zeros(nd.shape, ctx=nd._ctx, dtype=nd.dtype)
    if isinstance(nd._grad, RowSparseNDArray):
        gbuf = nd._grad
        dt = nd._data.dtype
        with torch.no_grad():
            if cot.is_sparse:
                extra = gbuf if nd._grad_req == "add" else None
                ids, vals = _merged_rows(cot, dt, extra)
                gbuf._set_rows(vals, ids)
            elif nd._grad_req == "add":
                gbuf._write(gbuf._dense() + cot.to(dt))
            else:
                gbuf._write(cot.to(dt))
        return
    if cot.is_sparse:
        cot = _densify(cot)
    buf = nd._grad._data
    with torch.no_grad():
        if nd._grad_req == "add":
            buf.add_(cot.to(buf.dtype))
        else:
            buf.copy_(cot)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of `heads` (cotangents `head_grads`, default ones) into the
    `.grad` buffers of the marked arrays the heads depend on (reference:
    autograd.backward)."""
    outs, cots = _heads_and_cots(heads, head_grads)
    if not outs:
        return
    leaves = [nd for nd in _live_marked()
              if nd._grad_req != "null" and nd._data.requires_grad]
    if not leaves:
        return
    _BWD["round"] += 1
    _BWD["depth"] += 1
    try:
        hooks = list(_GRAD_READY_HOOKS)
        if hooks:
            _backward_ready(outs, cots, leaves, hooks, retain_graph)
            return
        grads = torch.autograd.grad(outs, [nd._data for nd in leaves], cots,
                                    retain_graph=retain_graph,
                                    allow_unused=True)
        for nd, g in zip(leaves, grads):
            if g is not None:
                _write_leaf_grad(nd, g)
    finally:
        _BWD["depth"] -= 1


def _backward_ready(outs, cots, leaves, hooks, retain_graph):
    """Backward that writes each leaf's gradient, and calls `hooks`, as
    soon as torch has accumulated it (a leaf the heads do not reach keeps
    its buffer and calls no hook)."""
    handles = []
    tensors = [nd._data for nd in leaves]

    def ready(nd):
        def on_accumulated(t):
            g, t.grad = t.grad, None
            _write_leaf_grad(nd, g)
            for h in hooks:
                h(nd)
        return on_accumulated

    for nd, t in zip(leaves, tensors):
        t.grad = None
        handles.append(t.register_post_accumulate_grad_hook(ready(nd)))
    try:
        torch.autograd.backward(outs, cots, retain_graph=retain_graph,
                                inputs=tensors)
    finally:
        for h in handles:
            h.remove()


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of `heads` with respect to `variables` (reference:
    autograd.grad); the variables' `.grad` buffers are not touched. With
    `create_graph` the gradients are recorded themselves. A variable the
    heads do not depend on gets zeros."""
    from .ndarray.ndarray import NDArray
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    if retain_graph is None:
        retain_graph = create_graph
    outs, cots = _heads_and_cots(heads, head_grads)
    live = [v for v in variables if v._data.requires_grad]
    got = {}
    if outs and live:
        grads = torch.autograd.grad(outs, [v._data for v in live], cots,
                                    retain_graph=retain_graph,
                                    create_graph=create_graph,
                                    allow_unused=True)
        got = {id(v): g for v, g in zip(live, grads) if g is not None}
    res = []
    for v in variables:
        g = got.get(id(v))
        if g is None:
            g = torch.zeros_like(v._data, requires_grad=False)
        elif g.is_sparse:
            from .ndarray.sparse import RowSparseNDArray
            ids, vals = _merged_rows(g.detach(), v._data.dtype)
            res.append(RowSparseNDArray(vals, ids, v.shape, ctx=v._ctx))
            continue
        elif not create_graph:
            g = g.detach()
        res.append(NDArray(g.to(v._data.dtype), ctx=v._ctx))
    return res[0] if single else res


class _FunctionFn(torch.autograd.Function):
    """Forward and backward through a user's `Function`."""

    @staticmethod
    def forward(ctx, fn, nd_ctx, *tensors):
        from .ndarray.ndarray import NDArray
        outs = fn.forward(*[NDArray(t, ctx=nd_ctx) for t in tensors])
        ctx.fn, ctx.nd_ctx = fn, nd_ctx
        fn._single = not isinstance(outs, (list, tuple))
        return tuple(o._data for o in ([outs] if fn._single else outs))

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            in_grads = ctx.fn.backward(*[NDArray(g.contiguous(),
                                                 ctx=ctx.nd_ctx)
                                         for g in grads])
        if not isinstance(in_grads, (list, tuple)):
            in_grads = [in_grads]
        return (None, None) + tuple(
            g._data if isinstance(g, NDArray) else g for g in in_grads)


class Function:
    """A differentiable function with a hand-written gradient: subclass it,
    define `forward(*inputs)` and `backward(*output_grads)` over NDArrays
    (one output or several; `backward` returns one gradient per input),
    and call an instance on the inputs. `save_for_backward` keeps arrays
    for `backward` as `saved_tensors`."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            return self.forward(*inputs)
        nd_ctx = inputs[0].context
        with torch.enable_grad():
            outs = _FunctionFn.apply(self, nd_ctx,
                                     *(a._data for a in inputs))
        outs = [NDArray(o, ctx=nd_ctx) for o in outs]
        return outs[0] if self._single else outs
