"""Meshes over ranks (the port of `mxnet_tpu.parallel.mesh`).

In the JAX package a mesh is a named array of the devices one program
drives. Here every device has a process of its own (one rank per card,
`mxnet_tpu_torch.launch`), so a `Mesh` is a named array of RANKS, and each
named axis carries a torch process group: the ranks that share every
other coordinate with this one. Collectives name an axis
(`parallel.collectives.all_reduce(x, "data")`) and run on its group.

The axis names and order are the reference's: ``data`` (data parallel),
``fsdp``, ``seq`` (ring attention), ``model`` and ``expert``. Groups are
made when the mesh is made (`torch.distributed.new_group` is collective:
every rank builds the same meshes in the same order). A process that runs
alone has meshes of size 1 and no groups.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from dataclasses import dataclass

import numpy as np

from . import dist

__all__ = ["MeshConfig", "Mesh", "create_mesh", "local_mesh", "auto_mesh",
           "current_mesh", "mesh_scope"]

_STATE = threading.local()


@dataclass
class MeshConfig:
    """Declarative mesh shape; axes of size 1 are kept so that rules may
    always name them."""
    data: int = 1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1
    axis_order: tuple = ("data", "fsdp", "seq", "model", "expert")

    def sizes(self):
        return tuple(getattr(self, a) for a in self.axis_order)

    @property
    def n_devices(self):
        return int(np.prod(self.sizes()))


class Mesh:
    """A named array of ranks. `devices` holds the ranks (the JAX name is
    kept, so `mesh.devices.shape` and `.size` read as there); `shape` maps
    each axis name to its size."""

    def __init__(self, ranks, axis_names):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("mesh of shape %s needs %d axis names, got %s"
                             % (self.devices.shape, self.devices.ndim,
                                self.axis_names))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self._groups = {}

    @property
    def size(self):
        return int(self.devices.size)

    def axis_size(self, axis):
        return int(self.shape.get(axis, 1))

    def coords(self, rank=None):
        """This rank's (or `rank`'s) index along every axis."""
        r = dist.rank() if rank is None else int(rank)
        hit = np.argwhere(self.devices == r)
        if not len(hit):
            raise ValueError("rank %d is not in the mesh %s" % (r, self))
        return dict(zip(self.axis_names, (int(i) for i in hit[0])))

    def axis_index(self, axis):
        """This rank's position along `axis` (0 for an absent axis)."""
        if axis not in self.shape:
            return 0
        return self.coords()[axis]

    def axis_ranks(self, axis):
        """The ranks of this rank's `axis` group, in axis order."""
        c = self.coords()
        idx = tuple(slice(None) if a == axis else c[a]
                    for a in self.axis_names)
        return [int(r) for r in np.atleast_1d(self.devices[idx])]

    def _make_groups(self):
        """One process group per axis and per line of that axis; every
        rank makes every group, in the same order (new_group is
        collective), and keeps the lines it lies on."""
        import torch.distributed as tdist
        me = dist.rank()
        for ai, axis in enumerate(self.axis_names):
            others = [range(n) for i, n in enumerate(self.devices.shape)
                      if i != ai]
            for rest in itertools.product(*others):
                idx = list(rest)
                idx.insert(ai, slice(None))
                ranks = [int(r) for r in self.devices[tuple(idx)]]
                group = tdist.new_group(ranks)
                if me in ranks:
                    self._groups[axis] = group

    def group(self, axis):
        """The process group of this rank's `axis` line (None when the
        process runs alone)."""
        if axis not in self.shape:
            raise ValueError("mesh has no axis %r (axes %s)"
                             % (axis, self.axis_names))
        return self._groups.get(axis)

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%s=%d" % (a, n)
                                      for a, n in self.shape.items())


def create_mesh(config=None, devices=None, **axes):
    """A mesh over the first `n` ranks (or the given `devices` ranks),
    shaped by a `MeshConfig` or axis keywords: ``create_mesh(data=4)``.
    The world must hold the ranks; the groups are made here."""
    if config is None:
        config = MeshConfig(**axes)
    n = config.n_devices
    ranks = list(range(dist.num_workers())) if devices is None \
        else [int(d) for d in devices]
    if n > len(ranks):
        raise ValueError(
            "mesh needs %d ranks but only %d are in the world (one rank "
            "per card: start them with `python -m mxnet_tpu_torch.launch "
            "-n %d`)" % (n, len(ranks), n))
    mesh = Mesh(np.asarray(ranks[:n]).reshape(config.sizes()),
                config.axis_order)
    if dist.has_group():
        mesh._make_groups()
    return mesh


def local_mesh(n_devices=None, axis="data"):
    """A 1-D mesh over the first `n_devices` ranks (default all): the
    analog of the reference's ``kvstore='device'`` set of cards."""
    n = dist.num_workers() if n_devices is None else int(n_devices)
    if n > dist.num_workers():
        raise ValueError("mesh needs %d ranks but only %d are in the world"
                         % (n, dist.num_workers()))
    mesh = Mesh(np.arange(n), (axis,))
    if dist.has_group():
        mesh._make_groups()
    return mesh


def auto_mesh(model_parallel=1, seq_parallel=1, fsdp=False):
    """A mesh over every rank: the rest of the world after `model` x
    `seq` goes to data (or fsdp) parallelism."""
    n = dist.num_workers()
    rest = n // (model_parallel * seq_parallel)
    if rest * model_parallel * seq_parallel != n:
        raise ValueError("%d ranks not divisible by model=%d x seq=%d"
                         % (n, model_parallel, seq_parallel))
    return create_mesh(MeshConfig(
        data=1 if fsdp else rest, fsdp=rest if fsdp else 1,
        model=model_parallel, seq=seq_parallel))


def current_mesh():
    """The innermost `mesh_scope` mesh, or None."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def mesh_scope(mesh):
    """``with mesh_scope(mesh):`` makes `mesh` the one that axis names
    resolve against."""
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()
