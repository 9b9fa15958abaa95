"""DLRM-style recommendation model: two towers and the dot interaction (the
port of `mxnet_tpu.models.dlrm`).

* a **dense tower** (bottom MLP) maps the continuous features into the
  space of the sparse embeddings;
* each **sparse field** looks up one row per example from its table: a
  gather from the parameter dict by default, or any other lookup through
  `embed_fn` (a vocab-sharded `embedding.ShardedEmbedding`, rows served by
  the kvstore) without touching the model;
* the **interaction** takes every pairwise dot product of the field
  embeddings and the dense tower's output (DLRM's "dot" interaction);
* the **top MLP** maps [dense tower output ‖ pairwise terms] to one
  logit; `dlrm_loss` is the mean sigmoid log-loss.

The layout is the JAX package's: ``{"bottom": [{"w", "b"}, ...], "top":
[...], "tables": [(vocab_f, embed_dim), ...]}`` with weights (in, out), so
`models.convert.params_from_jax` carries a JAX tree over.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..base import resolve_device

__all__ = ["DLRMConfig", "dlrm_init", "dlrm_forward", "dlrm_loss"]


@dataclass(frozen=True)
class DLRMConfig:
    vocab_sizes: tuple = (100, 100, 100, 100)  # rows per sparse field
    embed_dim: int = 16
    dense_dim: int = 13
    bottom_dims: tuple = (64, 32)    # hidden widths; output is embed_dim
    top_dims: tuple = (64, 32)       # hidden widths; output is 1 logit

    @property
    def n_fields(self):
        return len(self.vocab_sizes)


def _interaction_dim(cfg):
    # the dense tower's vector and the upper triangle of the pairwise dots
    # of (n_fields sparse + 1 dense) vectors
    n = cfg.n_fields + 1
    return cfg.embed_dim + n * (n - 1) // 2


def dlrm_init(cfg, generator=None, with_tables=True, device=None):
    """Random parameters from `generator` (a `torch.Generator`, drawn on
    its device, then moved to `device`, default cuda; a generator seeded
    0 on `device` when None). `with_tables=False` leaves the tables out,
    for a caller that owns them (sharded tables through `embed_fn`)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * scale).to(device)

    def mlp(dims):
        return [{"w": normal((dims[i], dims[i + 1]),
                             1.0 / math.sqrt(dims[i])),
                 "b": torch.zeros(dims[i + 1], device=device)}
                for i in range(len(dims) - 1)]

    params = {
        "bottom": mlp((cfg.dense_dim,) + tuple(cfg.bottom_dims)
                      + (cfg.embed_dim,)),
        "top": mlp((_interaction_dim(cfg),) + tuple(cfg.top_dims) + (1,)),
    }
    if with_tables:
        params["tables"] = [normal((v, cfg.embed_dim),
                                   1.0 / math.sqrt(cfg.embed_dim))
                            for v in cfg.vocab_sizes]
    return params


def _mlp_forward(layers, x, final_relu=True):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if final_relu or i + 1 < len(layers):
            x = torch.relu(x)
    return x


def dlrm_forward(params, dense, sparse_ids, cfg, embed_fn=None):
    """Logits (batch,) for `dense` (batch, dense_dim) floats and
    `sparse_ids` (batch, n_fields) ints. `embed_fn(field, ids)` replaces
    the gather from ``params["tables"]``."""
    if embed_fn is None:
        tables = params["tables"]

        def embed_fn(f, ids):
            return tables[f][ids.long()]

    bottom = _mlp_forward(params["bottom"], dense)          # (b, d)
    vecs = [bottom] + [embed_fn(f, sparse_ids[:, f])
                       for f in range(cfg.n_fields)]      # each (b, d)
    stack = torch.stack(vecs, dim=1)                        # (b, n, d)
    gram = torch.bmm(stack, stack.transpose(1, 2))          # (b, n, n)
    n = stack.shape[1]
    iu, ju = torch.triu_indices(n, n, 1, device=stack.device)
    pairs = gram[:, iu, ju]                                 # (b, n(n-1)/2)
    z = torch.cat([bottom, pairs], dim=1)
    return _mlp_forward(params["top"], z, final_relu=False)[:, 0]


def dlrm_loss(params, dense, sparse_ids, labels, cfg, embed_fn=None):
    """The mean sigmoid log-loss over {0, 1} labels."""
    logits = dlrm_forward(params, dense, sparse_ids, cfg, embed_fn=embed_fn)
    labels = labels.to(torch.float32)
    return torch.mean(F.softplus(logits) - labels * logits)
