"""Parameter sharding rules (the port of `mxnet_tpu.parallel.sharding`).

A `ShardingRules` table maps parameter names (regex, first match wins) to
a `PartitionSpec` `P(...)`: per dimension, the mesh axis (or tuple of
axes) that splits it, or None. `spec_for` trims a spec to the array's rank
and prunes the axes the mesh lacks, has at size 1, or that do not divide
the dimension, so one table serves every mesh shape (`LLAMA_RULES` on a
pure data-parallel mesh is plain replication).

`shard_pytree` gives each rank its block of every leaf: along each
dimension the spec keeps, the block of this rank's coordinate on that
axis (on a tuple of axes, the first axis major, as a JAX sharding lays it
out). `gather_pytree` joins the blocks back into full leaves on every
rank (checkpoints and tests). Trees are nested dicts of tensors, named by
their "/"-joined keys, as `models.llama`'s parameters are.

`ShardingRules.local` names the leaves whose ``model`` split the model's
own functions consume in place (Megatron's column and row products, the
vocab-parallel embedding and head): `LLAMA_RULES` names `models.llama`'s
projections and embeddings, `BERT_RULES` `models.bert`'s.
`parallel.ShardedTrainStep` gathers every other split on use.
"""
from __future__ import annotations

import re
import weakref

from . import dist

__all__ = ["P", "PartitionSpec", "ShardingRules", "LLAMA_RULES",
           "BERT_RULES", "spec_for", "shard_pytree", "replicate_pytree",
           "reshard_pytree", "gather_pytree", "logical_to_spec",
           "register_block", "block_layout", "gather_block"]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``P(("fsdp",), "model")``, ``P()``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(%s)" % ", ".join(repr(e) for e in self)


P = PartitionSpec


def _axis_sizes(mesh):
    return dict(mesh.shape) if mesh is not None else {}


def _prune_spec(spec, mesh, shape=None):
    """Drop the axes `mesh` lacks or has at size 1, and any that do not
    divide their dimension; trailing Nones go."""
    sizes = _axis_sizes(mesh)
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        kept = [n for n in names if sizes.get(n, 1) > 1]
        if shape is not None and kept:
            total = 1
            for n in kept:
                total *= sizes[n]
            if d < len(shape) and shape[d] % total != 0:
                kept = []
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def entry_axes(entry):
    """The axes of one spec entry, as a tuple (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class ShardingRules:
    """Ordered (regex -> PartitionSpec) table; unmatched names take
    `default` (replicated). `local`: regexes of the leaves whose ``model``
    split the model's functions consume in place (see the module
    docstring)."""

    def __init__(self, rules, default=P(), local=()):
        self.rules = [(re.compile(pat), P(*spec)) for pat, spec in rules]
        self.default = P(*default)
        self.local = [re.compile(pat) for pat in local]

    def is_local(self, name):
        """True when the model consumes `name`'s ``model`` split in
        place."""
        return any(pat.search(name) for pat in self.local)

    def without_local(self):
        """The same table with no leaf consumed in place: every split is
        gathered on use (the whole-model route, for comparison)."""
        out = ShardingRules([])
        out.rules, out.default = self.rules, self.default
        return out

    def spec_for(self, name, shape=None, mesh=None):
        spec = self.default
        for pat, s in self.rules:
            if pat.search(name):
                spec = s
                break
        if shape is not None:
            spec = P(*tuple(spec)[:len(shape)])
        if mesh is not None:
            spec = _prune_spec(spec, mesh, shape)
        return spec

    def tree_specs(self, params, mesh=None):
        """The specs of a nested dict of tensors, by "/"-joined name."""
        return _map_named(lambda name, leaf: self.spec_for(
            name, tuple(getattr(leaf, "shape", ())) or None, mesh), params)


def _map_named(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, "%s/%s" % (prefix, k) if prefix
                              else str(k)) for k, v in tree.items()}
    return fn(prefix, tree)


def spec_for(rules, name, shape=None, mesh=None):
    return rules.spec_for(name, shape, mesh)


# Megatron-style rules for a Llama decoder, in `models.llama`'s names:
# column-parallel q/k/v and gate/up, row-parallel o and down, the vocab
# over `model`, dim 0 over `fsdp` where it divides
LLAMA_RULES = ShardingRules([
    (r"embed|tok_embeddings|lm_head", P(("model",), ("fsdp",))),
    (r"attn/(wq|wk|wv)|q_proj|k_proj|v_proj", P(("fsdp",), ("model",))),
    (r"attn/wo|o_proj", P(("model",), ("fsdp",))),
    (r"mlp/(w1|w3)|gate_proj|up_proj", P(("fsdp",), ("model",))),
    (r"mlp/w2|down_proj", P(("model",), ("fsdp",))),
    (r"norm|scale|bias", P()),
], local=[r"^(tok_embeddings|lm_head)$",
          r"^layers/\d+/(attn/(wq|wk|wv|wo)|mlp/(w1|w2|w3))$"])

# the same for BERT in `models.bert`'s names
BERT_RULES = ShardingRules([
    (r"word_embed|position_embed|token_type_embed", P(("model",), ("fsdp",))),
    (r"attn/(wq|wk|wv)|query|key|value", P(("fsdp",), ("model",))),
    (r"attn/wo|attention/output", P(("model",), ("fsdp",))),
    (r"ffn/w1|intermediate", P(("fsdp",), ("model",))),
    (r"ffn/w2|output/dense", P(("model",), ("fsdp",))),
    (r"norm|beta|gamma|bias", P()),
], local=[r"^(word_embed|position_embed|token_type_embed)$",
          r"^layers/\d+/(attn/(wq|wk|wv|wo)|ffn/(w1|w2))$"])


def block_of(mesh, entry):
    """(this rank's block index, the number of blocks) along a dimension
    split by spec entry `entry`: the first axis major."""
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
        n *= mesh.axis_size(a)
    return idx, n


def _place(x, spec, mesh):
    """This rank's block of `x` under `spec` (a pruned spec: each kept
    dimension divides): all of it when replicated."""
    for d, entry in enumerate(spec):
        idx, n = block_of(mesh, entry)
        if n > 1:
            size = x.shape[d] // n
            x = x.narrow(d, idx * size, size)
    return x.contiguous()


def shard_pytree(params, rules, mesh):
    """Each leaf as this rank holds it under `rules` on `mesh`."""
    return _map_named(lambda name, x: _place(
        x, rules.spec_for(name, tuple(x.shape), mesh), mesh), params)


def gather_leaf(x, spec):
    """The full leaf from this rank's block `x` under `spec`: one
    all-gather per split axis over the current mesh (`mesh_scope`), the
    last axis of an entry first (it is the minor one)."""
    from . import collectives as _coll
    for d, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            x = _coll.all_gather(x, a, axis=d)
    return x


def gather_pytree(params, specs, mesh):
    """Every leaf whole, on every rank, from the blocks `shard_pytree`
    gave: its inverse (checkpoints, tests). `specs` is the tree of the
    pruned specs the blocks were cut by (`rules.tree_specs(full, mesh)`,
    `ShardedTrainStep.specs`)."""
    from .mesh import mesh_scope

    def one(name, x):
        return gather_leaf(x, _lookup(specs, name))

    with mesh_scope(mesh):
        return _map_named(one, params)


def _lookup(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def replicate_pytree(params, mesh=None):
    """Every leaf made equal across the ranks: broadcast from the first
    rank of the mesh (of the world without one), in place."""
    if dist.has_group() and dist.num_workers() > 1:
        import torch.distributed as tdist
        src = int(mesh.devices.flat[0]) if mesh is not None else 0

        def bcast(_, x):
            tdist.broadcast(x, src)
            return x
        return _map_named(bcast, params)
    return params


def reshard_pytree(params, rules, mesh, donate=False):
    """Lay full leaves (a restored snapshot, say) out on `mesh` by
    `rules`. `donate` is accepted for the reference's signature: the
    leaves here are plain tensors the caller owns."""
    del donate
    return shard_pytree(params, rules, mesh)


_DEFAULT_LOGICAL = {
    "batch": ("data", "fsdp"),
    "seq": "seq",
    "heads": "model",
    "kv_heads": "model",
    "embed": None,
    "mlp": "model",
    "vocab": "model",
    "head_dim": None,
}


def logical_to_spec(logical_axes, table=None):
    table = table or _DEFAULT_LOGICAL
    return P(*[table.get(a, None) for a in logical_axes])


# ------------------------------------------------ the blocks a step holds
# id(tensor) -> (weakref, mesh, spec, zero): the layout of a tensor that
# is one rank's block of a whole leaf, so that a checkpoint writes the
# whole leaf (`gather_block`) and never the block in its place
_BLOCKS = {}


def register_block(x, mesh, spec, zero=False):
    """Record that `x` is this rank's block of a leaf under `spec` on
    `mesh` (with `zero`, further its ``data`` block along dimension 0)."""
    key = id(x)
    _BLOCKS[key] = (weakref.ref(x, lambda _, k=key: _BLOCKS.pop(k, None)),
                    mesh, P(*spec), bool(zero))


def block_layout(x):
    """(mesh, spec, zero) of a registered block, else None."""
    entry = _BLOCKS.get(id(x))
    if entry is None or entry[0]() is not x:
        return None
    return entry[1:]


def gather_block(x):
    """The whole leaf of registered block `x` (collective over its mesh:
    every rank calls it), or `x` itself when it is not a block."""
    layout = block_layout(x)
    if layout is None:
        return x
    mesh, spec, zero = layout
    from . import collectives as _coll
    from .mesh import mesh_scope
    with mesh_scope(mesh):
        if zero:
            x = _coll.all_gather(x, "data", axis=0)
        return gather_leaf(x, spec)
