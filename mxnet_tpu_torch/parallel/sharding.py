"""Parameter sharding rules (the port of `mxnet_tpu.parallel.sharding`).

A `ShardingRules` table maps parameter names (regex, first match wins) to
a `PartitionSpec` `P(...)`: per dimension, the mesh axis (or tuple of
axes) that splits it, or None. `spec_for` trims a spec to the array's rank
and prunes the axes the mesh lacks, has at size 1, or that do not divide
the dimension, so one table serves every mesh shape (`LLAMA_RULES` on a
pure data-parallel mesh is plain replication).

This slice places leaves replicated or split over ``data`` only: a spec
that keeps an axis of size > 1 other than ``data`` (tensor parallelism
over ``model`` or ``fsdp``) raises NotImplementedError naming ROADMAP
Queue A 5b. Trees are nested dicts of tensors, named by their
"/"-joined keys, as `models.llama`'s parameters are.
"""
from __future__ import annotations

import re

import torch

from . import dist

__all__ = ["P", "PartitionSpec", "ShardingRules", "LLAMA_RULES",
           "BERT_RULES", "spec_for", "shard_pytree", "replicate_pytree",
           "reshard_pytree", "logical_to_spec", "TENSOR_PARALLEL"]

TENSOR_PARALLEL = ("tensor parallelism over a `model` or `fsdp` axis "
                   "larger than 1 comes with ROADMAP Queue A 5b")


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


def _check_placeable(spec, name=""):
    for entry in spec:
        names = entry if isinstance(entry, tuple) else (entry,)
        if any(n not in (None, "data") for n in names):
            raise NotImplementedError(
                "sharding %s as %s: %s" % (name or "a tensor", spec,
                                           TENSOR_PARALLEL))


class ShardingRules:
    """Ordered (regex -> PartitionSpec) table; unmatched names take
    `default` (replicated)."""

    def __init__(self, rules, default=P()):
        self.rules = [(re.compile(pat), P(*spec)) for pat, spec in rules]
        self.default = P(*default)

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

    def check_mesh(self, mesh):
        """Raise NotImplementedError when a rule could keep an axis of
        size > 1 other than ``data`` on `mesh`."""
        for pat, spec in self.rules + [(None, self.default)]:
            _check_placeable(_prune_spec(spec, mesh),
                             pat.pattern if pat is not None else "default")

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
])

BERT_RULES = ShardingRules([
    (r"word_embed|position_embed|token_type_embed", P(("model",), ("fsdp",))),
    (r"attn/(wq|wk|wv)|query|key|value", P(("fsdp",), ("model",))),
    (r"attn/wo|attention/output", P(("model",), ("fsdp",))),
    (r"ffn/w1|intermediate", P(("fsdp",), ("model",))),
    (r"ffn/w2|output/dense", P(("model",), ("fsdp",))),
    (r"norm|beta|gamma|bias", P()),
])


def _place(x, spec, mesh, name):
    """This rank's piece of `x` under `spec`: all of it when replicated,
    its ``data`` slice along the split dimension."""
    _check_placeable(spec, name)
    for d, entry in enumerate(spec):
        if entry is not None:
            n = mesh.axis_size("data")
            i = mesh.axis_index("data")
            return x.chunk(n, dim=d)[i].contiguous()
    return x


def shard_pytree(params, rules, mesh):
    """Each leaf as this rank holds it under `rules` on `mesh`."""
    return _map_named(lambda name, x: _place(
        x, rules.spec_for(name, tuple(x.shape), mesh), mesh, name), params)


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
