"""Training-state checkpoints for the port's functional trainer.

The port of `mxnet_tpu.parallel.checkpoint`'s `save_train_state`,
`restore_train_state` and `latest_step`, for one process. Each step is a
directory ``<path>/<step>/`` holding ``torch.save`` of ``{"params",
"opt_state", "step"}`` (the JAX package writes orbax); the directory is
written under a temporary name and renamed into place, so a crash never
leaves a half-written step under a step's name.

Integrity, as in the JAX package: beside each step a leaf-wise sha256
sidecar ``<path>/<step>.sha256.json`` digests every leaf's (dtype, shape,
bytes), and an atomic ``LATEST`` marker commits strictly after both.
`restore_train_state` re-digests what it loaded; a mismatch or a torn file
counts ``checkpoint.corrupt`` and falls back to the next-oldest step, and
`CheckpointCorruptError` is raised only when no step verifies. A step
without a sidecar restores unverified.

Sharded states. The blocks a `ShardedTrainStep` keeps on a mesh are
recorded (`sharding.register_block`); `save_train_state` gathers each of
them to its whole leaf (every rank calls it: the gathers are collective)
and the first rank writes, so a step directory always holds whole leaves
and never a block in a leaf's place. `restore_train_state(path,
mesh=..., rules=...)` lays the whole leaves out again: each rank keeps
its block of every parameter and of every per-parameter optimizer slot
(``m``, ``v``, ``mom``), as the reference's restore does. Not ported
yet (ROADMAP Queue A 6): re-laying a ``zero=True`` state, whose slots
hold ``data`` blocks, and the rest of the reference's checkpoint module
(`save_sharded`, `restore_sharded` and their per-shard files).
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
from ..resilience.errors import CheckpointCorruptError
from ..util import atomic_write, read_latest_marker, write_latest_marker
from . import dist
from .sharding import block_layout, gather_block, register_block, \
    shard_pytree

__all__ = ["save_train_state", "restore_train_state", "latest_step"]

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


def save_train_state(path, params, opt_state, step, keep=None):
    """Write params and optimizer state as step `step` under `path`, then
    its sha256 sidecar, then the LATEST marker. keep=N retains only the
    newest N steps. A sharded state is written as whole leaves by the
    first rank (every rank calls this)."""
    root = os.path.abspath(path)
    tree, sharded = _whole({"params": params, "opt_state": opt_state,
                            "step": int(step)})
    if sharded and dist.has_group() and dist.num_workers() > 1:
        from . import collectives as _coll
        if dist.rank() == 0:
            _write(root, tree, step, keep)
        _coll.barrier()
        return
    _write(root, tree, step, keep)


def _write(root, tree, step, keep):
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


def _relay(params, opt_state, mesh, rules):
    """This rank's blocks of whole `params` and of the per-parameter slots
    of `opt_state` under `rules` on `mesh`, each recorded as a block."""
    specs = rules.tree_specs(params, mesh)

    def place(tree):
        out = shard_pytree(tree, rules, mesh)

        def mark(node, spec):
            if isinstance(node, dict):
                for k in node:
                    mark(node[k], spec[k])
            else:
                register_block(node, mesh, spec)
        mark(out, specs)
        return out
    return place(params), {k: place(v) if isinstance(v, dict) else v
                           for k, v in opt_state.items()}


def restore_train_state(path, step=None, device=None, mesh=None,
                        rules=None):
    """(params, opt_state, step) of step `step` (default: the newest),
    verified against its sidecar and moved to `device` (default cuda);
    with `mesh` and `rules`, this rank's blocks of every parameter and
    per-parameter slot (the reference's arguments). A step that fails to
    load or to verify counts ``checkpoint.corrupt`` and the next-oldest
    step is tried; `CheckpointCorruptError` when none verifies,
    FileNotFoundError when there is no checkpoint."""
    device = resolve_device(device)
    root = os.path.abspath(path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError("no checkpoint under %s" % path)
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
            tried.append(cand)
            continue
        if tried:
            _telem.inc("checkpoint.corrupt_fallbacks")
        params = _to_device(tree["params"], device)
        opt_state = _to_device(tree["opt_state"], device)
        if mesh is not None and rules is not None:
            params, opt_state = _relay(params, opt_state, mesh, rules)
        return params, opt_state, tree["step"]
    raise CheckpointCorruptError(
        "every checkpoint step under %s failed verification (steps tried: "
        "%s)" % (path, tried), steps_tried=tried)
