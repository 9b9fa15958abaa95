"""The compute half of a serving replica: chunk prefill, decode, CoW copy,
and the speculative-decoding draft and verify.

The port of `mxnet_tpu.serve.programs`. The JAX package compiles each of
these ahead of time for its fixed shape; PyTorch runs eagerly, so here
they are plain calls under the same fixed shapes, and `warmup()` runs
each shape once, so the allocator and the kernel build warm up before
traffic. The programs update the pool tensors in place (see
`models.llama`). Sampling runs right after the logits (`serve.sampling`),
so one integer per stream crosses back to the host, not a vocab row.

The programs per replica (all fixed-shape):

* ``chunk``        (P, C) multi-stream prefill window + sampled next token
* ``decode``       (B,) one token per active slot + sampling
* ``copy``         one-block copy (the prefix-sharing CoW)
* ``draft_chunk``  (P, C) draft-model mirror of a prefill window [spec]
* ``draft_k``      (B, k) greedy draft tokens                     [spec]
* ``verify``       (B, k+1) target greedy over drafted tokens     [spec]
* ``draft_copy``   CoW in the draft pool                          [spec]

Each call records a host span (``serve.prefill[PxC]``, ``serve.decode``,
``serve.draft_prefill``, ``serve.draft``, ``serve.verify``; cat
``serve``).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import telemetry as _telem
from ..models.llama import (llama_chunk_paged, llama_decode_paged,
                            llama_draft_loop)
from .sampling import sample_tokens

__all__ = ["ServePrograms", "default_chunk_size", "default_prefill_rows",
           "default_spec_k"]


def _env_int(name, default):
    try:
        return max(1, int(os.environ.get(name, str(default))))
    except (TypeError, ValueError):
        return default


def default_chunk_size():
    return _env_int("MXNET_TPU_SERVE_CHUNK", 16)


def default_prefill_rows():
    return _env_int("MXNET_TPU_SERVE_PREFILL_ROWS", 4)


def default_spec_k():
    return _env_int("MXNET_TPU_SERVE_SPEC_K", 4)


class _timed:
    """Record the enclosed call as one host span (cat ``serve``)."""

    __slots__ = ("name", "_ts", "_t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._ts = _telem.span_clock()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        _telem.record_span(self.name, "serve", self._ts,
                           time.perf_counter() - self._t0)
        return False


class ServePrograms:
    """Params + pool geometry in, token ids out. The scheduler owns WHAT
    runs when; this owns the shapes.

    With `draft_params` (and its `draft_cfg` and mirrored `draft_pool`),
    greedy streams decode speculatively: `draft_k` proposes `spec_k`
    tokens, `verify` computes the target's greedy token after each."""

    def __init__(self, params, cfg, pool, max_batch, max_context,
                 chunk_size=None, prefill_rows=None, draft_params=None,
                 draft_cfg=None, draft_pool=None, spec_k=None):
        self.params = params
        self.cfg = cfg
        self.pool = pool
        self.device = pool.device
        self.max_batch = int(max_batch)
        self.max_context = min(int(max_context), cfg.max_seq_len)
        self.blocks_per_stream = -(-self.max_context // pool.block_size)
        self.chunk_size = int(chunk_size or default_chunk_size())
        self.prefill_rows = int(prefill_rows or default_prefill_rows())
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.draft_pool = draft_pool
        self.spec = draft_params is not None
        self.spec_k = int(spec_k or default_spec_k()) if self.spec else 0
        if self.spec and (draft_cfg is None or draft_pool is None):
            raise ValueError("serve: a draft model needs draft_cfg and a "
                             "mirrored draft KV pool")
        self._warm = False

    @property
    def program_names(self):
        names = ["chunk", "decode", "copy"]
        if self.spec:
            names += ["draft_chunk", "draft_k", "verify", "draft_copy"]
        return names

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def warmup(self):
        """Run every program once at its serving shape with all-padding
        inputs: nothing is written (every position is -1 or its table
        entry unallocated) and nothing is emitted."""
        P, C = self.prefill_rows, self.chunk_size
        B, nb, N = self.max_batch, self.blocks_per_stream, \
            self.pool.num_blocks
        pads = (np.zeros((P, C)), np.full((P, C), -1), np.full((P, nb), N))
        self.chunk_prefill(*pads, np.zeros(P), np.zeros(P), np.zeros(P),
                           np.zeros(P), np.ones(P))
        self.decode(np.zeros(B), np.full(B, -1), np.full((B, nb), N),
                    np.zeros(B), np.zeros(B), np.zeros(B), np.ones(B))
        self.copy_block(0, 0)
        if self.spec:
            k = self.spec_k
            self.draft_prefill(*pads)
            self.draft_k(np.zeros(B), np.full(B, -1), np.full((B, nb), N))
            self.verify(np.zeros((B, k + 1)), np.full((B, k + 1), -1),
                        np.full((B, nb), N))
            self.draft_copy_block(0, 0)
        self._warm = True

    def chunk_prefill(self, tokens, positions, tables, seeds, sample_pos,
                      temps, top_k, top_p):
        """One multi-stream prefill window: (rows, chunk) prompt tokens at
        absolute positions (-1 = pad). Returns the sampled next token per
        row as numpy (meaningful only for rows that complete their
        stream's fill)."""
        with _timed("serve.prefill[%dx%d]" % (self.prefill_rows,
                                              self.chunk_size)):
            logits, _ = llama_chunk_paged(
                self.params, self.pool.pools, self._t(tokens),
                self._t(positions), self._t(tables), self.cfg,
                self.pool.block_size)
            tok = sample_tokens(logits, seeds, sample_pos, temps, top_k,
                                top_p)
            return tok.cpu().numpy()

    def decode(self, tokens, positions, tables, seeds, temps, top_k, top_p):
        """One decode step over the fixed-size batch (position -1 =
        inactive slot). Returns the next token per slot as numpy."""
        positions = np.asarray(positions, np.int64)
        with _timed("serve.decode"):
            logits, _ = llama_decode_paged(
                self.params, self.pool.pools, self._t(tokens),
                self._t(positions), self._t(tables), self.cfg,
                self.pool.block_size)
            tok = sample_tokens(logits, seeds, positions + 1, temps, top_k,
                                top_p)
            return tok.cpu().numpy()

    @staticmethod
    def _copy(pool, src, dst):
        for layer in pool.pools.values():
            for t in layer.values():
                t[dst].copy_(t[src])

    def copy_block(self, src, dst):
        """Copy pool block src onto dst in every layer (the prefix-sharing
        copy-on-write)."""
        self._copy(self.pool, src, dst)

    # ------------------------------------------------------- spec decoding
    def draft_prefill(self, tokens, positions, tables):
        """Mirror a prefill window through the draft model (the draft
        needs its own KV for the whole context)."""
        with _timed("serve.draft_prefill"):
            llama_chunk_paged(self.draft_params, self.draft_pool.pools,
                              self._t(tokens), self._t(positions),
                              self._t(tables), self.draft_cfg,
                              self.draft_pool.block_size)

    def draft_k(self, tokens, positions, tables):
        """spec_k greedy draft tokens per slot: (B, k) numpy."""
        with _timed("serve.draft"):
            drafted, _ = llama_draft_loop(
                self.draft_params, self.draft_pool.pools, self._t(tokens),
                self._t(positions), self._t(tables), self.draft_cfg,
                self.draft_pool.block_size, self.spec_k)
            return drafted.cpu().numpy()

    def verify(self, tokens, positions, tables):
        """The target model's greedy token after every fed position, in
        one chunk-shaped pass: (B, k+1) in, (B, k+1) numpy out."""
        with _timed("serve.verify"):
            logits, _ = llama_chunk_paged(
                self.params, self.pool.pools, self._t(tokens),
                self._t(positions), self._t(tables), self.cfg,
                self.pool.block_size, logits_at="all")
            return torch.argmax(logits, dim=-1).cpu().numpy()

    def draft_copy_block(self, src, dst):
        """The copy-on-write in the draft pool."""
        self._copy(self.draft_pool, src, dst)
