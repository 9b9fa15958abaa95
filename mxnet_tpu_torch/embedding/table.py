"""Vocab-sharded embedding tables with row-sharded optimizer state (the
port of `mxnet_tpu.embedding.table`).

`ShardedEmbedding` is the per-rank object: rank r of `comm.world` owns the
contiguous rows ``[r * rows_per_shard, (r + 1) * rows_per_shard)`` of the
vocab (padded up to a multiple of the world, so the last rank may carry a
few zero rows). Its legs:

* **lookup**: each rank gathers the requested ids from its own shard, out
  of shard rows masked to zero, and one cross-rank sum (`comm.all_reduce`)
  completes the batch; exactly one rank contributes each real row.
* **apply_grads**: the sparse update. Each rank dedups its (ids, rows)
  with `parallel.collectives.merge_unique_rows`, exchanges the fixed-size
  unique-row slabs (`comm.all_gather`, rank order), merges again, and
  updates only the touched rows it owns, as the reference's lazy
  row_sparse update does: untouched rows and their state see no decay.
  Both dedups and the dense per-shard gradient go through
  `ops.sparse_ops.segment_sum` (kernel #11 on a card): two launches a
  push at world 1.
* **state_payload / load_state_payload**: world-size-independent
  checkpoints of the full table and state, re-sliced for the loading
  comm's world and rank.

The update builds a new weight tensor every step, as the reference's
immutable arrays do, so a snapshot (`gathered_weight`, the serving copy)
never changes under its reader. `EmbeddingComm` is the world-1 exchange;
tests inject a threaded in-process comm for world 2 and 4. The mesh comm
(`MeshEmbeddingComm`, `shard_spec`) comes with the port's multi-rank
communication slice, and the HBM-ledger accounting with its telemetry
package (`_nbytes` counts the bytes already).

Deviation: with no `weight=`, the table is drawn from a `torch.Generator`
seeded with `seed` on the table's device; the reference draws it with
`jax.random`, so the two initial tables differ. Tests pass `weight=` to
both.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import telemetry as _telem
from ..base import resolve_device, torch_dtype

__all__ = ["EmbeddingComm", "ShardedEmbedding"]

_OPTIMIZERS = ("sgd", "adam")


class EmbeddingComm:
    """The collective contract of a sharded table, and its world-1 form
    (identity exchanges; one rank owns every row).

    all_reduce(x): the cross-rank sum of a dense tensor (the lookup's
    completion). all_gather(x): the rank-order concatenation along axis 0
    of each rank's equal-shape contribution (the unique-row slabs)."""

    world = 1
    rank = 0

    def all_reduce(self, x):
        return x

    def all_gather(self, x):
        return x


def _numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class ShardedEmbedding:
    """One vocab-sharded table on one rank (see the module docstring).
    Optimizers: ``sgd`` with optional momentum, and ``adam`` with bias
    correction, both with weight decay on the touched rows and the lazy
    row_sparse semantics. `device` defaults to cuda."""

    def __init__(self, vocab, dim, comm=None, dtype=torch.float32,
                 optimizer="sgd", learning_rate=0.01, momentum=0.0,
                 beta1=0.9, beta2=0.999, eps=1e-8, wd=0.0,
                 weight=None, seed=0, name="embedding", device=None):
        if optimizer not in _OPTIMIZERS:
            raise ValueError("ShardedEmbedding supports %s; got %r"
                             % ("/".join(_OPTIMIZERS), optimizer))
        self.comm = comm or EmbeddingComm()
        self.device = resolve_device(device)
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.dtype = dtype if isinstance(dtype, torch.dtype) \
            else torch_dtype(dtype)
        self.name = str(name)
        self.optimizer = optimizer
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.eps = float(eps)
        self.wd = float(wd)
        world = self.comm.world
        self.padded_vocab = -(-self.vocab // world) * world
        self.rows_per_shard = self.padded_vocab // world
        self.lo = self.comm.rank * self.rows_per_shard
        if weight is None:
            # the full table from the seed, then this rank's slice: every
            # world size sees the same rows
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            full = (torch.randn((self.vocab, self.dim), generator=gen,
                                device=self.device, dtype=torch.float32)
                    * (1.0 / math.sqrt(self.dim))).to(self.dtype)
        else:
            full = weight if torch.is_tensor(weight) \
                else torch.from_numpy(np.array(weight))
            if tuple(full.shape) != (self.vocab, self.dim):
                raise ValueError("weight shape %s != (vocab, dim) %s"
                                 % (tuple(full.shape),
                                    (self.vocab, self.dim)))
        self.weight = self._slice_shard(full)
        self._state = {}
        if optimizer == "sgd" and self.momentum:
            self._state["mom"] = torch.zeros_like(self.weight)
        elif optimizer == "adam":
            self._state["mean"] = torch.zeros_like(self.weight)
            self._state["var"] = torch.zeros_like(self.weight)
        self._step = 0

    # -- geometry ----------------------------------------------------------
    def _slice_shard(self, full):
        """(vocab, dim) tensor -> a new (rows_per_shard, dim) tensor of this
        rank's rows on the table's device, the last rank's tail rows
        zero."""
        full = full.to(device=self.device, dtype=self.dtype)
        pad = self.padded_vocab - full.shape[0]
        if pad:
            full = torch.cat([full, full.new_zeros((pad, self.dim))])
        return full[self.lo:self.lo + self.rows_per_shard].clone()

    def _nbytes(self):
        n = self.weight.numel() * self.weight.element_size()
        for s in self._state.values():
            n += s.numel() * s.element_size()
        return int(n)

    def _ids(self, ids):
        if not torch.is_tensor(ids):
            ids = torch.from_numpy(np.array(ids))
        return ids.to(device=self.device, dtype=torch.int32)

    # -- lookup ------------------------------------------------------------
    def lookup(self, ids):
        """Rows for `ids` ((batch,) ints, any order, repeats fine): the
        local masked gather and one cross-rank sum. Negative ids (padding)
        give zero rows."""
        ids = self._ids(ids)
        _telem.inc("embedding.lookup")
        _telem.inc("embedding.lookup.rows", int(ids.shape[0]))
        with torch.no_grad():
            local = ids - self.lo
            in_shard = (local >= 0) & (local < self.rows_per_shard) \
                & (ids >= 0)
            rows = self.weight[local.clamp(0, self.rows_per_shard - 1)
                               .long()]
            rows = torch.where(in_shard[:, None], rows, 0)
        return self.comm.all_reduce(rows)

    # -- sparse update -----------------------------------------------------
    def apply_grads(self, ids, grads):
        """One sparse update: dedup the local rows, exchange the unique-row
        slabs, update the owned touched rows. `grads` is (batch, dim),
        aligned with `ids`; repeated ids add up."""
        from ..parallel.collectives import merge_unique_rows
        ids = self._ids(ids)
        if not torch.is_tensor(grads):
            grads = torch.from_numpy(np.array(grads))
        with torch.no_grad():
            grads = grads.detach().to(device=self.device, dtype=self.dtype)
            uids, uvals = merge_unique_rows(ids, grads)
            gids = self.comm.all_gather(uids)
            gvals = self.comm.all_gather(uvals)
            if self.comm.world > 1:
                uids, uvals = merge_unique_rows(gids, gvals)
            else:
                uids, uvals = gids, gvals
            _telem.inc("embedding.push")
            _telem.inc("embedding.push.rows", int(ids.shape[0]))
            _telem.inc("embedding.push.unique_rows", int((uids >= 0).sum()))
            self._apply_unique(uids, uvals)

    def _apply_unique(self, uids, uvals):
        """Update the owned rows from a deduped (ids, rows) slab (-1
        pads). Builds a new weight (and state) tensor."""
        from ..ops import sparse_ops as _sops
        local = uids - self.lo
        mine = (local >= 0) & (local < self.rows_per_shard) & (uids >= 0)
        idx = torch.where(mine, local, -1)
        # the dense per-shard gradient and the touched mask; rows of other
        # shards and pads go to a scratch row that is cut away
        scratch = self.rows_per_shard
        safe = torch.where(idx >= 0, idx, scratch)
        gshard = _sops.segment_sum(torch.where(mine[:, None], uvals, 0),
                                   safe, scratch + 1)[:-1]
        counts = torch.zeros((scratch + 1,), dtype=torch.float32,
                             device=self.device).index_add_(
            0, safe, mine.to(torch.float32))[:-1]
        touched = (counts > 0)[:, None]
        self._step += 1
        w = self.weight.float()
        g = gshard.float()
        if self.wd:
            g = g + self.wd * torch.where(touched, w, 0)
        lr = self.learning_rate
        if self.optimizer == "sgd":
            if self.momentum:
                mom = self._state["mom"].float()
                mom = torch.where(touched, self.momentum * mom - lr * g, mom)
                self._state["mom"] = mom.to(self.dtype)
                w = torch.where(touched, w + mom, w)
            else:
                w = torch.where(touched, w - lr * g, w)
        else:  # adam, lazy rows
            mean = self._state["mean"].float()
            var = self._state["var"].float()
            mean = torch.where(touched,
                               self.beta1 * mean + (1 - self.beta1) * g,
                               mean)
            var = torch.where(touched,
                              self.beta2 * var + (1 - self.beta2) * g * g,
                              var)
            self._state["mean"] = mean.to(self.dtype)
            self._state["var"] = var.to(self.dtype)
            t = self._step
            coef1 = 1.0 - self.beta1 ** t
            coef2 = 1.0 - self.beta2 ** t
            lr_t = lr * math.sqrt(coef2) / coef1
            upd = lr_t * mean / (torch.sqrt(var) + self.eps)
            w = torch.where(touched, w - upd, w)
        self.weight = w.to(self.dtype)

    # -- full-table views ----------------------------------------------------
    def gathered_weight(self):
        """The full (vocab, dim) table, gathered from the ranks and cut to
        the vocab: the serving snapshot and the checkpoint body."""
        return self.comm.all_gather(self.weight)[:self.vocab]

    # -- elastic checkpoints -------------------------------------------------
    def state_payload(self):
        """A world-size-independent state dict: a layout header and the
        full gathered table and optimizer state as numpy arrays (bf16 as
        float32, named in the layout)."""
        state = {name: _numpy(self.comm.all_gather(s)[:self.vocab])
                 for name, s in self._state.items()}
        return {
            "embed_format": 1,
            "layout": {"vocab": self.vocab, "dim": self.dim,
                       "dtype": str(self.dtype).replace("torch.", ""),
                       "optimizer": self.optimizer,
                       "world": self.comm.world},
            "table": _numpy(self.gathered_weight()),
            "state": state,
            "step": self._step,
        }

    def load_state_payload(self, payload):
        """The inverse of `state_payload`, sliced for this comm's world and
        rank: a payload of any world size loads onto any other."""
        if int(payload.get("embed_format", -1)) != 1:
            raise ValueError("not an embedding state payload: %r"
                             % (payload.get("embed_format"),))
        layout = payload["layout"]
        if (int(layout["vocab"]), int(layout["dim"])) != (self.vocab,
                                                          self.dim):
            raise ValueError(
                "payload table is %sx%s, this table is %dx%d"
                % (layout["vocab"], layout["dim"], self.vocab, self.dim))
        if layout.get("optimizer", self.optimizer) != self.optimizer:
            raise ValueError("payload optimizer %r != %r"
                             % (layout.get("optimizer"), self.optimizer))
        self.weight = self._slice_shard(
            torch.from_numpy(np.array(payload["table"])))
        self._state = {name: self._slice_shard(
            torch.from_numpy(np.array(full)))
            for name, full in payload["state"].items()}
        self._step = int(payload.get("step", 0))
