"""Checkpoints of the port's functional trainer and of sharded trees (the
port of `mxnet_tpu.parallel.checkpoint`).

Each step is a directory ``<path>/<step>/`` holding ``torch.save`` of the
tree (the JAX package writes orbax), written under a temporary name and
renamed into place, so a crash never leaves a half-written step under a
step's name. `save_train_state` writes ``{"params", "opt_state",
"step"}``; `save_sharded` any nested dict of tensors and Python scalars;
`save_zero_state` a `ZeroUpdater`'s world-size-independent state.

Integrity, as in the JAX package: beside each step a leaf-wise sha256
sidecar ``<path>/<step>.sha256.json`` digests every leaf's (dtype, shape,
bytes), and an atomic ``LATEST`` marker commits strictly after both. A
restore re-digests what it loaded; a mismatch or a torn file counts
``checkpoint.corrupt`` and falls back to the next-oldest step (counting
``checkpoint.corrupt_fallbacks``), and `CheckpointCorruptError` is raised
only when no step verifies. A step without a sidecar restores unverified.

Sharded states. The blocks a `ShardedTrainStep` keeps on a mesh are
recorded (`sharding.register_block`); a save gathers each of them to its
whole leaf (every rank calls it: the gathers are collective) and the
first rank writes, so a step directory always holds whole leaves and
never a block in a leaf's place. A restore with ``mesh=`` and ``rules=``
lays the whole leaves out again: each rank keeps its block of every
parameter and of every per-parameter optimizer slot (``m``, ``v``,
``mom``), and of a ``zero=True`` state's slots its ``data`` block, as the
step that saved them held them.

Coordinated commit (``coordinated=True``): after the payload is durable
the ranks elect the minimum of their steps (`resilience.commit`) and the
marker names the elected step; `restore_sharded(coordinated=True)`
restores the step the ranks elect from their committed markers, so a
rank that crashed mid-commit a step ahead rejoins at the agreed one.
`latest_committed_step` is the marker-only view. The ``checkpoint.save``
fault site sits between the durable payload and the marker (the
mid-commit crash), ``checkpoint.restore`` on the way into a restore.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil

import torch

from .. import telemetry as _telem
from ..base import resolve_device
from ..resilience import faults as _faults
from ..resilience.errors import CheckpointCorruptError
from ..util import atomic_write, read_latest_marker, write_latest_marker
from . import dist
from .sharding import _place, block_layout, gather_block, register_block

__all__ = ["save_sharded", "restore_sharded", "latest_step",
           "latest_committed_step", "save_train_state",
           "restore_train_state", "save_zero_state", "restore_zero_state"]

_PAYLOAD = "state.pt"


def _step_dir(root, step):
    return os.path.join(root, str(int(step)))


def _sidecar(root, step):
    return os.path.join(root, "%d.sha256.json" % int(step))


def _steps(root):
    """Committed steps under `root`, newest first (temporary directories of
    a save in flight are not named as integers and are not listed)."""
    if not os.path.isdir(root):
        return []
    found = [int(n) for n in os.listdir(root) if n.isdigit()
             and os.path.isfile(os.path.join(root, n, _PAYLOAD))]
    return sorted(found, reverse=True)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], "%s/%s" % (prefix, k))
    else:
        yield prefix, tree


def _tree_digests(tree):
    """{keypath: sha256 of the leaf's dtype, shape and bytes}; Python
    scalars digest their repr."""
    out = {}
    for path, leaf in _flatten(tree):
        h = hashlib.sha256()
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu").contiguous().reshape(-1)
            h.update(str(leaf.dtype).encode())
            h.update(str(tuple(leaf.shape)).encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
        out[path] = h.hexdigest()
    return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def latest_step(path):
    """Newest committed step: the max of the directory scan and the LATEST
    marker (the marker counts only when its step directory exists), so a
    stale or lost marker never hides or loses a checkpoint. None when there
    is none."""
    root = os.path.abspath(path)
    steps = _steps(root)
    marked = read_latest_marker(root)
    if marked is not None and not os.path.isfile(
            os.path.join(_step_dir(root, marked), _PAYLOAD)):
        marked = None
    candidates = [s for s in (steps[0] if steps else None, marked)
                  if s is not None]
    return max(candidates) if candidates else None


def _whole(tree):
    """`tree` with every registered block gathered to its whole leaf, and
    whether any was a block."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor) and block_layout(node) is not None:
            found.append(True)
            return gather_block(node)
        return node
    return walk(tree), bool(found)


def latest_committed_step(path):
    """The step the LATEST marker names when its payload exists, else
    None: under the coordinated protocol the step the ranks agreed on (a
    newer prepared payload is not counted, unlike `latest_step`)."""
    root = os.path.abspath(path)
    marked = read_latest_marker(root)
    if marked is not None and os.path.isfile(
            os.path.join(_step_dir(root, marked), _PAYLOAD)):
        return marked
    return None


def _multi():
    return dist.has_group() and dist.num_workers() > 1


def save_sharded(path, tree, step=0, wait=True, keep=None,
                 coordinated=False):
    """Write step `step` of `tree` (nested dicts of tensors and Python
    scalars; registered blocks are gathered to whole leaves, so every
    rank calls this): the payload and its sidecar, then the
    ``checkpoint.save`` fault site, then (``coordinated``) the election,
    then the LATEST marker naming the elected step. keep=N retains the
    newest N steps. The first rank writes. `wait` is accepted for the
    reference's signature: the write is synchronous."""
    del wait
    root = os.path.abspath(path)
    whole, _ = _whole(tree)
    writer = not _multi() or dist.rank() == 0
    if writer:
        _write_payload(root, whole, step)
    _faults.check("checkpoint.save", context="step=%d mid-commit" % step)
    marked = int(step)
    if coordinated:
        from ..resilience.commit import elect_step
        elected = elect_step(marked, kind="save")
        if elected is not None:
            marked = elected
    if writer:
        _commit(root, marked, keep)
    if _multi():
        # no rank reads the marker before the first rank moved it (after
        # an election every rank passed the fault site, so all arrive)
        from . import collectives as _coll
        _coll.barrier()


def save_train_state(path, params, opt_state, step, keep=None):
    """Write params and optimizer state as step `step` under `path`, then
    its sha256 sidecar, then the LATEST marker. keep=N retains only the
    newest N steps. A sharded state is written as whole leaves by the
    first rank (every rank calls this), with a flag that a ``zero=True``
    step's slots were ``data`` blocks."""
    zero = any(block_layout(x) is not None and block_layout(x)[2]
               for slot in opt_state.values() if isinstance(slot, dict)
               for _, x in _flatten(slot))
    tree = {"params": params, "opt_state": opt_state, "step": int(step)}
    if zero:
        tree["zero"] = True
    save_sharded(path, tree, step=step, keep=keep)


def _write_payload(root, tree, step):
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = "%s.tmp-%d" % (final, os.getpid())
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _PAYLOAD), "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    atomic_write(_sidecar(root, step),
                 json.dumps(_tree_digests(tree), sort_keys=True,
                            indent=0).encode("utf-8"))


def _commit(root, step, keep):
    write_latest_marker(root, step)
    if keep is not None:
        for old in _steps(root)[max(1, int(keep)):]:
            shutil.rmtree(_step_dir(root, old), ignore_errors=True)
            if os.path.exists(_sidecar(root, old)):
                os.remove(_sidecar(root, old))


def _verified(root, step, tree):
    sidecar = _sidecar(root, step)
    if not os.path.isfile(sidecar):
        return True
    try:
        with open(sidecar, "r", encoding="utf-8") as f:
            want = json.load(f)
    except (OSError, ValueError):
        return False           # a torn sidecar is as suspect as a payload
    return _tree_digests(tree) == want


def _load(root, step):
    """The verified tree of `step` (default: the newest), falling back to
    older steps: (step, tree)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError("no checkpoint under %s" % root)
    _faults.check("checkpoint.restore", context="step=%d" % int(step))
    candidates = [int(step)] + [s for s in _steps(root) if s < int(step)]
    tried = []
    for cand in candidates:
        try:
            tree = torch.load(os.path.join(_step_dir(root, cand), _PAYLOAD),
                              map_location="cpu", weights_only=True)
        except (OSError, EOFError, RuntimeError, ValueError,
                pickle.UnpicklingError):
            tree = None
        if tree is None or not _verified(root, cand, tree):
            _telem.inc("checkpoint.corrupt")
            from ..telemetry import flight as _flight
            _flight.note_event("checkpoint_corrupt", "step=%d" % cand)
            tried.append(cand)
            continue
        if tried:
            _telem.inc("checkpoint.corrupt_fallbacks")
        return cand, tree
    raise CheckpointCorruptError(
        "every checkpoint step under %s failed verification (steps tried: "
        "%s)" % (root, tried), steps_tried=tried)


def _lay_out(tree, mesh, rules, zero_names=(), prefix=""):
    """This rank's block of every tensor of `tree` under `rules` on `mesh`
    (by "/"-joined name below `prefix`), recorded as blocks; a name in
    `zero_names` further takes its ``data`` block along dimension 0."""
    if isinstance(tree, dict):
        return {k: _lay_out(v, mesh, rules, zero_names,
                            "%s/%s" % (prefix, k) if prefix else str(k))
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    spec = rules.spec_for(prefix, tuple(tree.shape), mesh)
    x = _place(tree, spec, mesh)
    zero = prefix in zero_names
    if zero:
        n, i = mesh.axis_size("data"), mesh.axis_index("data")
        per = x.shape[0] // n
        x = x.narrow(0, i * per, per)
    x = x.clone()
    register_block(x, mesh, spec, zero=zero)
    return x


def _like(tree, template):
    """`tree`'s tensors on the template's devices and dtypes, each cut to
    the template leaf's block where that leaf is a registered block."""
    if isinstance(tree, dict):
        return {k: _like(v, template[k] if isinstance(template, dict)
                         and k in template else None)
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) \
            or not isinstance(template, torch.Tensor):
        return tree
    x = tree.to(device=template.device, dtype=template.dtype)
    layout = block_layout(template)
    if layout is None:
        return x
    mesh, spec, zero = layout
    x = _place(x, spec, mesh)
    if zero:
        n, i = mesh.axis_size("data"), mesh.axis_index("data")
        per = x.shape[0] // n
        x = x.narrow(0, i * per, per)
    x = x.clone()
    register_block(x, mesh, spec, zero=zero)
    return x


def restore_sharded(path, step=None, mesh=None, rules=None, template=None,
                    coordinated=False, device=None):
    """The tree of step `step` (default: the newest; with ``coordinated``,
    the step the ranks elect from their committed markers), verified,
    with the fallback of the module docstring, on `device` (default
    cuda). With `mesh` (and `rules`, default replication) each rank keeps
    its block of every tensor by its "/"-joined name; with `template` (a
    tree of tensors) each tensor takes its template leaf's device, dtype
    and, for a registered block, its layout."""
    from .sharding import ShardingRules
    if template is None:
        device = resolve_device(device)
    root = os.path.abspath(path)
    if step is None and coordinated:
        local = latest_committed_step(root)
        if local is None:
            local = latest_step(root)
        from ..resilience.commit import elect_step
        step = elect_step(local, kind="restore")
    _, tree = _load(root, step)
    if template is not None:
        return _like(tree, template)
    tree = _to_device(tree, device)
    if mesh is not None:
        tree = _lay_out(tree, mesh, rules or ShardingRules([]))
    return tree


def restore_train_state(path, step=None, device=None, mesh=None,
                        rules=None):
    """(params, opt_state, step) of step `step` (default: the newest),
    verified against its sidecar and moved to `device` (default cuda);
    with `mesh` and `rules`, this rank's blocks of every parameter and
    per-parameter slot (the reference's arguments), and of a ``zero=True``
    step's slots their ``data`` blocks. A step that fails to load or to
    verify counts ``checkpoint.corrupt`` and the next-oldest step is
    tried; `CheckpointCorruptError` when none verifies, FileNotFoundError
    when there is no checkpoint."""
    device = resolve_device(device)
    _, tree = _load(os.path.abspath(path), step)
    tree = _to_device(tree, device)
    params, opt_state = tree["params"], tree["opt_state"]
    if mesh is not None and rules is not None:
        from .train_step import zero_leaf_names
        names = zero_leaf_names(params, rules, mesh) if tree.get("zero") \
            else set()
        slots = {k: _lay_out(v, mesh, rules, names)
                 for k, v in opt_state.items() if isinstance(v, dict)}
        params = _lay_out(params, mesh, rules)
        opt_state = {k: slots.get(k, v) for k, v in opt_state.items()}
    return params, opt_state, tree["step"]


def _zero_tree(payload):
    """A ZeRO state payload (`ZeroUpdater.state_payload`) as a tree the
    checkpoint writes: the layout as JSON text, the slots as tensors under
    stringified bucket indices."""
    return {"zero_format": int(payload["zero_format"]),
            "layout_json": json.dumps(payload.get("layout")),
            "state": {str(b): {str(n): torch.from_numpy(a.copy())
                               for n, a in slots.items()}
                      for b, slots in payload.get("state", {}).items()}}


def _zero_payload(tree):
    return {"zero_format": int(tree["zero_format"]),
            "layout": json.loads(tree["layout_json"]),
            "state": {int(b): {n: t.numpy() for n, t in slots.items()}
                      for b, slots in tree["state"].items()}}


def save_zero_state(path, updater, step=0, keep=None, coordinated=False):
    """Write a `ZeroUpdater`'s state: every rank's owned shards gathered
    into the world-size-independent full state (collective: every rank
    calls this) beside the frozen bucket layout; `restore_zero_state`
    re-partitions it for the restoring updater's world."""
    save_sharded(path, _zero_tree(updater.state_payload()), step=step,
                 keep=keep, coordinated=coordinated)


def restore_zero_state(path, updater, step=None, coordinated=False):
    """Load a `save_zero_state` step into `updater`, sliced for its world
    and rank (which may differ from the saver's). Returns the updater."""
    tree = restore_sharded(path, step=step, coordinated=coordinated,
                           device="cpu")
    updater.load_state_payload(_zero_payload(tree))
    return updater
