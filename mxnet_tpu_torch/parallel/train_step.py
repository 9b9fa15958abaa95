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

Data parallelism: with a `parallel.mesh.Mesh` whose ``data`` axis holds n
ranks, every rank passes its own shard of the batch, and the gradients
(and the loss) are averaged over the ``data`` group: summed by
all-reduce in flat buckets of at most ``bucket_mb`` (default the engine's
cap; 0 sends them one by one), then divided by n. ``zero=True`` is ZeRO-1
over ``data``: the optimizer state lives only for this rank's shard of
each gradient bucket, the summed
gradients are reduce-scattered, the shard is updated with the same
optimizer (on a flat one-leaf tree) and the weights all-gathered. Its
`init()` state is then ``{"zero": [per-bucket state]}``. Parameters
replicate over ``data``; `rules` are checked against the mesh, and a rule
that keeps a parameter dimension on any axis of size > 1 (tensor or
FSDP parallelism) raises NotImplementedError naming ROADMAP Queue A 5b.
A mesh given as a list of several devices raises too: the port runs one
process per card (`mxnet_tpu_torch.launch`).
"""
from __future__ import annotations

import functools
import time

import torch
from torch.utils.checkpoint import checkpoint

from .. import engine as _engine
from .. import telemetry as _telem
from . import collectives as _coll
from .sharding import TENSOR_PARALLEL, ShardingRules, _prune_spec

__all__ = ["ShardedTrainStep", "sgd_init", "adam_init"]


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


def _check_rules(rules, mesh):
    """`rules` as a ShardingRules, refused when one splits a parameter on
    `mesh` (parameters replicate over `data` in this slice)."""
    if rules is not None and not isinstance(rules, ShardingRules):
        rules = ShardingRules(rules)
    rules = rules or ShardingRules([])
    for _, spec in rules.rules + [(None, rules.default)]:
        if any(e is not None for e in _prune_spec(spec, mesh)):
            raise NotImplementedError(
                "rule %s splits parameters on this mesh; parameters "
                "replicate over `data` here, and %s"
                % (spec, TENSOR_PARALLEL))
    return rules


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _named_leaves(tree[k],
                                     "%s/%s" % (prefix, k) if prefix
                                     else str(k))
    else:
        yield prefix, tree


class ShardedTrainStep:
    """loss_fn + optimizer as one training step on one CUDA card.

    loss_fn(params, batch) -> scalar loss tensor; batch is a tensor (or
    numpy array) or a dict of them, with the batch on the leading dim.

    Usage::

        step = ShardedTrainStep(loss_fn, params, optimizer="adamw", lr=1e-3)
        params, opt_state = step.init()
        for batch in data:
            params, opt_state, loss = step(params, opt_state, batch)
    """

    def __init__(self, loss_fn, params, mesh=None, optimizer="adamw",
                 lr=1e-3, grad_accum=1, remat=False, rules=None,
                 bucket_mb=None, zero=False, **opt_kwargs):
        self.mesh = _data_mesh(mesh)
        self.rules = _check_rules(rules, self.mesh)
        self.bucket_mb = bucket_mb
        self.zero = bool(zero)
        self._layout = None
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

    @property
    def _n_data(self):
        return 1 if self.mesh is None else self.mesh.axis_size("data")

    def _group(self):
        """The ``data`` group, or None when there is nothing to reduce."""
        if self.mesh is None:
            return None
        return self.mesh.group("data")

    def init(self):
        """(params, opt_state): the initial parameters as given and a
        fresh optimizer state beside them (with ``zero=True``, the state
        of this rank's shard of each bucket)."""
        if not self.zero:
            return self._init_params, self._opt_init(self._init_params,
                                                     **self.opt_kwargs)
        leaves = list(_named_leaves(self._init_params))
        self._layout = _engine.BucketLayout.from_entries(
            leaves, self._n_data, _engine.bucket_bytes(self.bucket_mb))
        by_name = dict(leaves)
        states = []
        for spec in self._layout:
            w = self._own(spec, by_name)
            states.append(self._opt_init({"w": w}, **self.opt_kwargs))
        return self._init_params, {"zero": states}

    def _own(self, spec, by_name):
        """This rank's shard of a bucket's flat vector of `by_name`."""
        flat = _engine.pack_flat(spec, [by_name[k] for k in spec.keys])
        lo = (0 if self.mesh is None else self.mesh.axis_index("data")) \
            * spec.shard
        return flat[lo:lo + spec.shard].clone()

    def _average(self, grads):
        """The gradients summed over ``data`` and divided by its size."""
        n = self._n_data
        group = self._group()
        if group is None:
            return grads
        names = [k for k, _ in _named_leaves(grads)]
        red = _coll.psum_bucketed([g for _, g in _named_leaves(grads)],
                                  group, self.bucket_mb)
        by_name = {k: r / n for k, r in zip(names, red)}
        it = iter(names)
        return _tmap(lambda _: by_name[next(it)], grads)

    @torch.no_grad()
    def _zero_update(self, params, grads, opt_state, lr):
        """ZeRO-1 over ``data``: per bucket, reduce-scatter the gradient
        sum, update this rank's shard, all-gather the weights."""
        group = self._group()
        n = self._n_data
        p_by = dict(_named_leaves(params))
        g_by = dict(_named_leaves(grads))
        for spec, st in zip(self._layout, opt_state["zero"]):
            flat_g = _engine.pack_flat(spec, [g_by[k] for k in spec.keys])
            g = _coll.reduce_scatter(flat_g, group) / n \
                if group is not None else flat_g
            w = self._own(spec, p_by)
            self._opt_update({"w": w}, {"w": g}, st, lr, **self.opt_kwargs)
            full = _coll.all_gather(w, group) if group is not None else w
            for k, part in zip(spec.keys, _engine.unpack_flat(spec, full)):
                p_by[k].copy_(part)
        return params, opt_state

    def _value_and_grad(self, params, batch):
        leaves = list(_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss_fn = self.loss_fn
            if self._remat:
                loss_fn = functools.partial(checkpoint, self.loss_fn,
                                            use_reentrant=False)
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(grads)
        return loss.detach(), _tmap(lambda _: next(it), params)

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
        """One step: (params, opt_state, loss), the first two updated in
        place. `train_step.step_ms` observes the host's time for the call
        (PyTorch returns before the card finishes, so in a steady state it
        measures enqueueing, as the JAX metric of the same name does)."""
        t0 = time.perf_counter()
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
        group = self._group()
        if group is not None:
            loss = _coll.all_reduce(loss, group) / self._n_data
        if self.zero:
            if self._layout is None:
                raise RuntimeError("ShardedTrainStep(zero=True): call "
                                   "init() for the sharded state first")
            params, opt_state = self._zero_update(params, grads, opt_state,
                                                  lr)
        else:
            grads = self._average(grads)
            params, opt_state = self._opt_update(params, grads, opt_state,
                                                 lr, **self.opt_kwargs)
        _telem.observe("train_step.step_ms", (time.perf_counter() - t0) * 1e3)
        return params, opt_state, loss
