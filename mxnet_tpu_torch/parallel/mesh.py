"""Meshes over ranks (the port of `mxnet_tpu.parallel.mesh`).

In the JAX package a mesh is a named array of the devices one program
drives. Here every device has a process of its own (one rank per card,
`mxnet_tpu_torch.launch`), so a `Mesh` is a named array of RANKS, and each
named axis carries a torch process group: the ranks that share every
other coordinate with this one. Collectives name an axis
(`parallel.collectives.all_reduce(x, "data")`) and run on its group. A
tuple of axes names the group of the ranks that share every coordinate
outside it: ``mesh.group(("data", "fsdp"))`` is the batch group, whose
ranks (d, f) take slice ``d * fsdp + f`` of the global batch, the order of
the reference's ``P(("data", "fsdp"))`` (`batch_index`).

The axis names and order are the reference's: ``data`` (data parallel),
``fsdp``, ``seq`` (ring attention), ``model`` and ``expert``. Groups are
made when the mesh is made (`torch.distributed.new_group` is collective:
every rank builds the same meshes in the same order): one per axis, and
one per set of two or more axes of size > 1. A process that runs alone has
meshes of size 1 and no groups.
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

    def _lines(self, axes):
        """Every line of the axes `axes` (indices into axis_names): the
        ranks that share every other coordinate, in mesh order."""
        shape = self.devices.shape
        others = [i for i in range(len(shape)) if i not in axes]
        moved = np.moveaxis(self.devices, list(axes),
                            list(range(len(axes))))
        flat = moved.reshape((-1,) + tuple(shape[i] for i in others))
        for rest in itertools.product(*(range(shape[i]) for i in others)):
            yield [int(r) for r in flat[(slice(None),) + rest]]

    def _make_groups(self):
        """One process group per axis and per line of that axis, then one
        per set of two or more axes of size > 1 and per line of that set;
        every rank makes every group, in the same order (new_group is
        collective), and keeps the lines it lies on."""
        import torch.distributed as tdist
        me = dist.rank()
        big = [i for i, n in enumerate(self.devices.shape) if n > 1]
        sets = [(i,) for i in range(len(self.axis_names))]
        sets += [c for k in range(2, len(big) + 1)
                 for c in itertools.combinations(big, k)]
        for axes in sets:
            key = tuple(self.axis_names[i] for i in axes)
            for ranks in self._lines(axes):
                group = tdist.new_group(ranks)
                if me in ranks:
                    self._groups[key if len(key) > 1 else key[0]] = group

    def _key(self, axis):
        """`axis` (a name or a tuple of names) as the key of its group: a
        name as it is, a tuple as the axes of size > 1 it names (axes the
        mesh lacks have size 1), in mesh order; None when it names
        none."""
        if not isinstance(axis, (tuple, list)):
            if axis not in self.shape:
                raise ValueError("mesh has no axis %r (axes %s)"
                                 % (axis, self.axis_names))
            return axis
        names = tuple(axis)
        kept = tuple(a for a in self.axis_names
                     if a in names and self.shape[a] > 1)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    def group(self, axis):
        """The process group of this rank's line of `axis` (a name or a
        tuple of names; None when the process runs alone or the axes have
        size 1 together)."""
        key = self._key(axis)
        return None if key is None else self._groups.get(key)

    def axes_size(self, axes):
        """The number of ranks in a line of `axes` (a name or a tuple)."""
        names = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
        return int(np.prod([self.axis_size(a) for a in names]))

    def batch_index(self, axes=("data", "fsdp")):
        """(this rank's slice of the batch, the number of slices) over
        `axes`, the first axis major: rank (d, f) holds slice
        ``d * fsdp + f``."""
        idx, n = 0, 1
        for a in axes:
            idx = idx * self.axis_size(a) + self.axis_index(a)
            n *= self.axis_size(a)
        return idx, n

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
