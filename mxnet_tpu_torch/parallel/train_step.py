"""The functional training step of the port: one CUDA card, or data
parallel over the ranks of a mesh.

The port of `mxnet_tpu.parallel.train_step`: `ShardedTrainStep` takes
``loss_fn(params, batch) -> scalar`` and a parameter dict, and each call
runs forward, backward (`torch.autograd`; the attention backward is the
flash backward kernels) and the optimizer update. The optimizers (sgd with
momentum, adam, adamw) work on nested dicts of tensors with the same
arithmetic, in the same order, as the JAX package's tree-mapped ones,
which are plain XLA there and plain PyTorch here: no fused optimizer
kernel runs on this path in either package.

Two deliberate differences:

* Updates are in place: parameters and optimizer state are overwritten
  and the same dicts are returned (JAX donates the old buffers instead).
* Each leaf keeps its dtype. In the JAX package the fp32 bias corrections
  of adam promote ``p - step`` to fp32, so bf16 parameters silently become
  fp32 after one step (and the adam moments after two). Here every new
  value is computed in fp32, with the formulas and order of the JAX
  package, and rounded once to the leaf's own dtype. For fp32 leaves that
  is the JAX arithmetic. For bf16 leaves it also avoids a second reference
  quirk: JAX rounds the Python hyperparameters to the leaf's dtype, so
  ``beta2 = 0.999`` becomes 1.0 and the second moment never decays.

Parallelism over a `parallel.mesh.Mesh` of ranks (one process a card;
`parallel.create_mesh(data=..., fsdp=..., model=...)`), computing what
the reference's one GSPMD program computes:

* The batch splits over ``("data", "fsdp")``: every rank passes its own
  slice of the global batch, slice ``d * fsdp + f`` on rank (d, f)
  (`shard_batch` cuts it). Ranks that differ only on ``model`` (or
  ``seq``, ``expert``) take the same slice.
* Each parameter is kept as this rank's block under `rules`
  (`sharding.shard_pytree`: `LLAMA_RULES`, `BERT_RULES` or the caller's),
  and so is its optimizer state.
* On use, in the forward, every split of a leaf is gathered
  (`collectives.gather_on_use`) except a ``model`` split that
  `rules.local` names: the model consumes that one in place (Megatron's
  column and row products in `models.llama`). The gather over ``data``
  or ``fsdp`` has the reduce-scatter as its backward (the ranks computed
  different slices of the batch); over another axis, the slice of the
  cotangent (the ranks computed the same thing). The whole tree is
  gathered ahead of the forward, so the peak memory of the policy is this
  rank's blocks plus one gathered copy of every leaf (its ``model`` block
  where the model consumes it in place) and that copy's gradient, which
  the backward reduce-scatters as each gather's cotangent completes.
* Each gradient is then summed over the batch axes that its gathers did
  not already sum over, in flat buckets of at most ``bucket_mb`` (default
  the engine's cap; 0 sends them one by one), and divided by the number of
  batch slices; the loss is the global mean. A replicated leaf has the
  same gradient on every ``model`` rank: where the model reads it in
  ``model`` slices it sums the gradient over ``model`` itself
  (`collectives.copy_to_group`, as `models.bert` does for the biases
  beside column-parallel weights).
* ``zero=True`` composes the ``data`` axis onto the rules as the
  reference's `_zero_spec` does: the optimizer state of a leaf whose
  dimension 0 is unsplit and divides by ``data`` holds only this rank's
  ``data`` block of it; the update runs on that block of the parameter,
  and the blocks are all-gathered back over ``data``.

The updates are elementwise, so each block is updated exactly as the
whole leaf would be. A mesh given as a list of several devices raises:
the port runs one process per card (`mxnet_tpu_torch.launch`).

Snapshots and elastic re-layout (`resilience.ResilientRunner`):
`adopt(params, opt_state)` takes back this step's own blocks from host
copies, `rebuild_for_mesh(mesh)` is the same step over another mesh of
ranks, and `place(params, opt_state)` lays whole trees out as that step's
blocks. Each call passes the ``train.step`` fault site first.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch
from torch.utils.checkpoint import checkpoint

from .. import telemetry as _telem
from ..resilience import faults as _faults
from . import collectives as _coll
from .mesh import mesh_scope
from .sharding import (P, ShardingRules, _map_named, entry_axes,
                       gather_pytree, register_block, shard_pytree)

__all__ = ["ShardedTrainStep", "sgd_init", "adam_init", "zero_leaf_names"]


def _tmap(f, *trees):
    """Map `f` over the leaves of nested dicts with the same keys."""
    if isinstance(trees[0], dict):
        return {k: _tmap(f, *(t[k] for t in trees)) for k in trees[0]}
    return f(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def _f32(x):
    """A Python float holding `x` rounded to fp32, the precision of the
    JAX package's 0-d fp32 arrays."""
    return torch.tensor(x, dtype=torch.float32).item()


# ---------------------------------------------------------------- optimizers
def sgd_init(params, momentum=0.0):
    if momentum:
        return {"mom": _tmap(torch.zeros_like, params)}
    return {}


@torch.no_grad()
def _sgd_update(params, grads, state, lr, momentum=0.0, wd=0.0):
    """In place: mom = momentum * mom + (g + wd * p); p -= lr * mom, each
    computed in fp32 and stored in the leaf's dtype."""
    def upd(p, g, m=None):
        g = g.float()
        if wd:
            g = g + wd * p.float()
        if m is not None:
            m.copy_(momentum * m.float() + g)
            g = m.float()
        p.copy_(p.float() - lr * g)

    if momentum:
        _tmap(upd, params, grads, state["mom"])
    else:
        _tmap(upd, params, grads)
    return params, state


def adam_init(params):
    return {"m": _tmap(torch.zeros_like, params),
            "v": _tmap(torch.zeros_like, params), "t": 0}


@torch.no_grad()
def _adam_update(params, grads, state, lr, beta1=0.9, beta2=0.999,
                 eps=1e-8, wd=0.0, adamw=False):
    """In place. Moments and step in fp32 (the bias corrections are fp32,
    as in the JAX package); m, v and the parameter are each rounded once
    to the leaf's dtype."""
    t = state["t"] + 1
    bc1 = _f32(1 - _f32(beta1) ** _f32(t))
    bc2 = _f32(1 - _f32(beta2) ** _f32(t))

    def upd(p, m, v, g):
        g = g.float()
        if wd and not adamw:
            g = g + wd * p.float()
        m.copy_(beta1 * m.float() + (1 - beta1) * g)
        v.copy_(beta2 * v.float() + (1 - beta2) * g * g)
        m32, v32 = m.float(), v.float()
        step = lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if adamw and wd:
            step = step + lr * wd * p.float()
        # the JAX package returns this fp32 difference as the new leaf
        # (bf16 leaves turn fp32); the port keeps the leaf's dtype
        p.copy_(p.float() - step)

    _tmap(upd, params, state["m"], state["v"], grads)
    state["t"] = t
    return params, state


_OPTS = {
    "sgd": (lambda p, **kw: sgd_init(p, kw.get("momentum", 0.0)), _sgd_update),
    "adam": (lambda p, **kw: adam_init(p), _adam_update),
    "adamw": (lambda p, **kw: adam_init(p),
              functools.partial(_adam_update, adamw=True)),
}


def _data_mesh(mesh):
    """`mesh` as a rank `Mesh` (None for one device). Anything else (a
    sequence of devices, an object with a ``devices`` array) names one
    process's devices, which must be one."""
    from .mesh import Mesh
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    devices = getattr(mesh, "devices", mesh)
    n = int(getattr(devices, "size", None) or len(devices))
    if n > 1:
        raise NotImplementedError(
            "ShardedTrainStep: a mesh of %d devices in one process; the "
            "port runs one process per card (start the ranks with `python "
            "-m mxnet_tpu_torch.launch`, then parallel.create_mesh)" % n)
    return None


def _as_rules(rules):
    """`rules` as a ShardingRules (a list of (regex, spec) pairs is
    accepted); replication without any."""
    if rules is not None and not isinstance(rules, ShardingRules):
        rules = ShardingRules(rules)
    return rules or ShardingRules([])


BATCH_AXES = ("data", "fsdp")


def zero_leaf_names(params, rules, mesh):
    """The names of the leaves whose optimizer state a ``zero=True`` step
    on `mesh` keeps as its ``data`` block along dimension 0 (the
    reference's `_zero_spec`): dimension 0 unsplit by the rules and
    divisible by ``data``, and ``data`` unused elsewhere."""
    if mesh is None or mesh.axis_size("data") == 1:
        return set()
    n = mesh.axis_size("data")
    out = set()
    for name, leaf in _named_leaves(params):
        shape = tuple(leaf.shape)
        spec = rules.spec_for(name, shape, mesh)
        used = {a for e in spec for a in entry_axes(e)}
        if shape and shape[0] % n == 0 and "data" not in used \
                and not (spec and spec[0] is not None):
            out.add(name)
    return out


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _named_leaves(tree[k],
                                     "%s/%s" % (prefix, k) if prefix
                                     else str(k))
    else:
        yield prefix, tree


class ShardedTrainStep:
    """loss_fn + optimizer as one training step on one CUDA card, or over
    the ranks of a mesh (see the module docstring).

    loss_fn(params, batch) -> scalar loss tensor; batch is a tensor (or
    numpy array) or a dict of them, with the batch on the leading dim.

    Usage::

        step = ShardedTrainStep(loss_fn, params, mesh, rules=LLAMA_RULES,
                                optimizer="adamw", lr=1e-3)
        params, opt_state = step.init()      # this rank's blocks
        for batch in data:
            params, opt_state, loss = step(params, opt_state,
                                           step.shard_batch(batch))
        full = step.gather(params)           # whole leaves, every rank
    """

    def __init__(self, loss_fn, params, mesh=None, optimizer="adamw",
                 lr=1e-3, grad_accum=1, remat=False, rules=None,
                 bucket_mb=None, zero=False, **opt_kwargs):
        self.mesh = _data_mesh(mesh)
        self.rules = _as_rules(rules)
        self.bucket_mb = bucket_mb
        self.zero = bool(zero)
        if int(grad_accum) < 1:
            raise ValueError("ShardedTrainStep: grad_accum must be >= 1")
        self.loss_fn = loss_fn
        self._init_params = params
        if isinstance(optimizer, str):
            self._opt_init, self._opt_update = _OPTS[optimizer]
        else:
            self._opt_init, self._opt_update = optimizer
        self.lr = lr
        self.opt_kwargs = opt_kwargs
        self.grad_accum = int(grad_accum)
        self._remat = bool(remat)
        self.specs = _tmap(lambda _: P(), params) if self.mesh is None \
            else self.rules.tree_specs(params, self.mesh)
        # ZeRO: the leaves whose state takes a ``data`` block of dim 0
        self._zero_leaves = zero_leaf_names(params, self.rules, self.mesh) \
            if self.zero else set()

    @property
    def _n_batch(self):
        """The number of batch slices: ``data`` x ``fsdp``."""
        return 1 if self.mesh is None else self.mesh.axes_size(BATCH_AXES)

    def _scope(self):
        return mesh_scope(self.mesh) if self.mesh is not None \
            else contextlib.nullcontext()

    def shard_batch(self, batch):
        """This rank's slice of a global batch (a tensor, an array or a
        dict of them; the batch on the leading dim)."""
        if self.mesh is None:
            return batch
        idx, n = self.mesh.batch_index(BATCH_AXES)

        def cut(x):
            x = torch.as_tensor(x)
            per = x.shape[0] // n
            return x[idx * per:(idx + 1) * per]

        return {k: cut(v) for k, v in batch.items()} \
            if isinstance(batch, dict) else cut(batch)

    def init(self):
        """(params, opt_state): this rank's block of each initial leaf and
        a fresh optimizer state beside it (with ``zero=True``, beside its
        ``data`` block where the leaf takes one), each block recorded so
        that `save_train_state` writes the whole leaf."""
        params = self._init_params
        if self.mesh is None:
            return params, self._opt_init(params, **self.opt_kwargs)
        params = shard_pytree(params, self.rules, self.mesh)
        opt_state = self._opt_init(self._opt_view(params), **self.opt_kwargs)
        self._register(params, opt_state)
        return params, opt_state

    def _register(self, params, opt_state):
        for name, leaf in _named_leaves(params):
            register_block(leaf, self.mesh, self._spec(name))
        for slot in opt_state.values():
            if isinstance(slot, dict):
                for name, leaf in _named_leaves(slot):
                    register_block(leaf, self.mesh, self._spec(name),
                                   zero=name in self._zero_leaves)

    def place(self, params, opt_state):
        """Whole `params` and `opt_state` trees (a restored snapshot, on
        any device) laid out as this step's: each rank's block of every
        leaf, on the parameters' device, and of every per-parameter
        optimizer slot (its ``data`` block under ``zero=True``), recorded
        as blocks; scalar slots are kept. `init` for a state that already
        has values."""
        device = next(_leaves(self._init_params)).device

        def on(tree):
            return _tmap(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                         else x, tree)

        params = on(params)
        opt_state = {k: on(v) if isinstance(v, dict) else v
                     for k, v in opt_state.items()}
        if self.mesh is None:
            return params, opt_state
        # each block its own storage: the caller's whole tree is not kept
        params = _tmap(torch.clone, shard_pytree(params, self.rules,
                                                 self.mesh))
        opt_state = {k: _tmap(torch.clone, self._opt_view(
                         shard_pytree(v, self.rules, self.mesh)))
                     if isinstance(v, dict) else v
                     for k, v in opt_state.items()}
        self._register(params, opt_state)
        return params, opt_state

    def adopt(self, params, opt_state):
        """This step's own blocks back from a snapshot of them (host
        copies of what `init` or a step left): moved to the parameters'
        device and recorded as blocks."""
        device = next(_leaves(self._init_params)).device

        def on(tree):
            return _tmap(lambda x: x.to(device), tree)

        params = on(params)
        opt_state = {k: on(v) if isinstance(v, dict) else v
                     for k, v in opt_state.items()}
        if self.mesh is not None:
            self._register(params, opt_state)
        return params, opt_state

    def rebuild_for_mesh(self, mesh):
        """A new step with the same loss, rules, optimizer and settings
        over `mesh` (the elastic path: the set of ranks changed); `place`
        then lays the state out on it."""
        return ShardedTrainStep(
            self.loss_fn, self._init_params, mesh,
            optimizer=(self._opt_init, self._opt_update), lr=self.lr,
            grad_accum=self.grad_accum, remat=self._remat, rules=self.rules,
            bucket_mb=self.bucket_mb, zero=self.zero, **self.opt_kwargs)

    def gather(self, params):
        """Whole leaves on every rank from this rank's blocks (the
        checkpoint's and the tests' view)."""
        if self.mesh is None:
            return params
        return gather_pytree(params, self.specs, self.mesh)

    def _spec(self, name):
        return _lookup_leaf(self.specs, name)

    def _opt_view(self, tree):
        """`tree` with each ZeRO leaf replaced by its ``data`` block (a
        view: the update writes through it)."""
        if not self._zero_leaves:
            return tree
        n = self.mesh.axis_size("data")
        i = self.mesh.axis_index("data")

        def view(name, x):
            if name not in self._zero_leaves:
                return x
            per = x.shape[0] // n
            return x.narrow(0, i * per, per)
        return _map_named(view, tree)

    def _on_use(self, params):
        """Each leaf as the loss sees it: every split gathered except a
        ``model`` split the rules let the model consume in place."""
        if self.mesh is None:
            return params

        def use(name, x):
            for d, entry in enumerate(self._spec(name)):
                axes = entry_axes(entry)
                if axes == ("model",) and self.rules.is_local(name):
                    continue
                for a in reversed(axes):
                    x = _coll.gather_on_use(x, a, d,
                                            summed=a in BATCH_AXES)
            return x
        return _map_named(use, params)

    def _reduce(self, grads):
        """Each gradient summed over the batch axes its gathers did not
        sum over, divided by the number of batch slices."""
        if self.mesh is None:
            return grads
        n = self._n_batch
        named = list(_named_leaves(grads))
        by_axes = {}
        for name, g in named:
            used = {a for e in self._spec(name) for a in entry_axes(e)}
            rest = tuple(a for a in BATCH_AXES if a not in used
                         and self.mesh.axis_size(a) > 1)
            by_axes.setdefault(rest, []).append(name)
        out = dict(named)
        for rest, names in by_axes.items():
            if rest:
                red = _coll.psum_bucketed([out[k] for k in names],
                                          self.mesh.group(rest),
                                          self.bucket_mb)
                out.update(zip(names, red))
        if n > 1:
            out = {k: v / n for k, v in out.items()}
        return _map_named(lambda name, _: out[name], grads)

    def _loss_of(self, params, batch):
        with self._scope():
            return self.loss_fn(params, batch)

    def _value_and_grad(self, params, batch):
        leaves = list(_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        try:
            with self._scope():
                used = self._on_use(params)
                if self._remat:
                    loss = checkpoint(self._loss_of, used, batch,
                                      use_reentrant=False)
                else:
                    loss = self.loss_fn(used, batch)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(grads)
        return loss.detach(), _tmap(lambda _: next(it), params)

    @torch.no_grad()
    def _update(self, params, grads, opt_state, lr):
        params_v = self._opt_view(params)
        self._opt_update(params_v, self._opt_view(grads), opt_state, lr,
                         **self.opt_kwargs)
        if self._zero_leaves:
            with self._scope():
                for name, p in _named_leaves(params):
                    if name in self._zero_leaves:
                        block = _lookup_leaf(params_v, name)
                        p.copy_(_coll.all_gather(block, "data", axis=0))
        return params, opt_state

    def _split(self, batch):
        """The batch cut into `grad_accum` micro-batches on its leading
        dim."""
        n = self.grad_accum

        def cut(x):
            x = torch.as_tensor(x)
            if x.shape[0] % n:
                raise ValueError("ShardedTrainStep: batch of %d does not "
                                 "split into grad_accum=%d" % (x.shape[0], n))
            return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))

        if isinstance(batch, dict):
            parts = {k: cut(v) for k, v in batch.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return list(cut(batch))

    def __call__(self, params, opt_state, batch, step_num=0):
        """One step on this rank's slice of the batch: (params, opt_state,
        loss), the first two updated in place, the loss the global mean.
        `train_step.step_ms` observes the host's time for the call
        (PyTorch returns before the card finishes, so in a steady state it
        measures enqueueing, as the JAX metric of the same name does). The
        ``train.step`` fault site fires before anything changes."""
        t0 = time.perf_counter()
        _faults.check("train.step")
        if self.grad_accum > 1:
            loss = 0.0
            grads = _tmap(torch.zeros_like, params)
            for mb in self._split(batch):
                l, g = self._value_and_grad(params, mb)
                loss = loss + l
                grads = _tmap(torch.add, grads, g)
            loss = loss / self.grad_accum
            grads = _tmap(lambda g: g / self.grad_accum, grads)
        else:
            loss, grads = self._value_and_grad(params, batch)
        lr = self.lr(step_num) if callable(self.lr) else self.lr
        if self._n_batch > 1:
            with self._scope():
                loss = _coll.all_reduce(loss, BATCH_AXES) / self._n_batch
        grads = self._reduce(grads)
        params, opt_state = self._update(params, grads, opt_state, lr)
        _telem.observe("train_step.step_ms", (time.perf_counter() - t0) * 1e3)
        return params, opt_state, loss


def _lookup_leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree
