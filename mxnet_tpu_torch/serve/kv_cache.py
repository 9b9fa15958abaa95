"""Paged KV-cache allocator: refcounted fixed-size blocks + prefix sharing.

The port of `mxnet_tpu.serve.kv_cache`. KV lives in ONE physical pool per
layer on the device, carved into fixed-size blocks (sized by
``MXNET_TPU_SERVE_KV_BLOCKS`` x ``MXNET_TPU_SERVE_KV_BLOCK`` tokens): a
stream owns exactly the blocks its context fills, through a block table
the paged programs gather and scatter with, and finished streams return
their blocks to a free-list for immediate reuse.

Blocks are **refcounted**: KV at position p depends only on tokens
0..p, so a FULL block of a prompt whose tokens (and whole preceding
context) match another stream's is the same block. The pool hash-conses
full prompt-prefix blocks in a chain-keyed index (node key = (parent,
block tokens)), and `admit` finds the longest block-aligned common prefix:
matched blocks join the new stream's table with a refcount bump and
prefill skips their positions; when the match ends inside a block, that
block is copied on write (one fresh block plus a device copy of the
partially matched source). The index holds its own reference per cached
block and evicts least-recently-matched leaves when allocation would
otherwise fail.

Exhaustion is a verdict, not a crash: `alloc`/`admit` reserve every block
asked for or raise `Overloaded(reason="kv_exhausted")` having reserved
nothing. Freed blocks are not zeroed: positions past a stream's length are
masked out of every gather.

Telemetry: ``serve.kv.blocks_in_use`` gauge (``serve.kv.
draft_blocks_in_use`` for a draft model's pool), ``serve.kv.allocs`` /
``serve.kv.freed_blocks`` / ``serve.kv.exhausted`` /
``serve.kv.reconciled_blocks`` / ``serve.kv.storage_resets`` counters,
``serve.prefix.lookups`` / ``hits`` / ``blocks_shared`` / ``cow`` /
``inserted`` / ``evictions`` with the ``serve.prefix.blocks`` gauge, and
the byte story: ``serve.kv.bytes`` / ``serve.kv.draft_bytes`` (blocks in
use x bytes a block) and ``serve.prefix.bytes`` gauges. The pool's
storage is accounted to the memory ledger (scope ``kv_pool``, or
``kv_draft``; prefix bytes as the ``prefix_cache`` overlay), and an
`Overloaded(kv_exhausted)` carries the ledger's breakdown.
"""
from __future__ import annotations

import os
import threading

import numpy as np

from .. import telemetry as _telem
from ..base import resolve_device
from ..telemetry import ledger as _ledger
from .errors import Overloaded

__all__ = ["KVBlockPool", "default_num_blocks", "default_block_size",
           "prefix_sharing_enabled"]


def _env_int(name, default):
    try:
        return max(1, int(os.environ.get(name, str(default))))
    except (TypeError, ValueError):
        return default


def default_num_blocks():
    return _env_int("MXNET_TPU_SERVE_KV_BLOCKS", 256)


def default_block_size():
    return _env_int("MXNET_TPU_SERVE_KV_BLOCK", 16)


def prefix_sharing_enabled():
    return os.environ.get("MXNET_TPU_SERVE_PREFIX", "1").lower() not in (
        "0", "false", "off")


class _PrefixNode:
    """One hash-consed full block of cached prompt prefix."""

    __slots__ = ("key", "parent", "tokens", "block", "children", "lru")

    def __init__(self, key, parent, tokens, block, lru):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.block = block
        self.children = set()
        self.lru = lru


class KVBlockPool:
    """Physical paged KV pool + refcounted block accounting for one
    serving replica: the per-layer pool tensors (`models.llama.
    init_kv_pools` layout, on `device`, cuda by default), the stream ->
    block-table map, per-block refcounts and the prefix index. `scope`
    names the pool in the memory ledger: ``kv_pool`` for the target
    model, ``kv_draft`` for a draft model's mirror."""

    def __init__(self, cfg, num_blocks=None, block_size=None,
                 prefix_sharing=None, device=None, scope="kv_pool"):
        from ..models.llama import init_kv_pools
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_blocks = int(num_blocks or default_num_blocks())
        self.block_size = int(block_size or default_block_size())
        self.pools = init_kv_pools(cfg, self.num_blocks, self.block_size,
                                   device=self.device)
        self.scope = str(scope)
        draft = self.scope == "kv_draft"
        self._blocks_gauge = ("serve.kv.draft_blocks_in_use" if draft
                              else "serve.kv.blocks_in_use")
        self._bytes_gauge = ("serve.kv.draft_bytes" if draft
                             else "serve.kv.bytes")
        self.storage_bytes = _ledger.tree_nbytes(self.pools)
        self.bytes_per_block = self.storage_bytes // self.num_blocks
        _ledger.account(self.scope, self.storage_bytes)
        # LIFO free-list: a just-freed block is reused first
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._tables = {}           # stream_id -> [block ids]
        self._refs = {}             # block id -> owner count (tables+index)
        self.prefix_sharing = (prefix_sharing_enabled()
                               if prefix_sharing is None
                               else bool(prefix_sharing))
        self._nodes = {}            # node key -> _PrefixNode
        self._roots = set()         # node keys with parent None
        self._lru_clock = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------- geometry
    def blocks_for(self, n_tokens):
        """Blocks needed to hold an n_tokens context."""
        return -(-max(0, int(n_tokens)) // self.block_size)

    @property
    def free_blocks(self):
        with self._lock:
            return len(self._free)

    @property
    def blocks_in_use(self):
        with self._lock:
            return self.num_blocks - len(self._free)

    @property
    def prefix_blocks(self):
        """Blocks currently pinned by the prefix index."""
        with self._lock:
            return len(self._nodes)

    def _in_use_locked(self):
        return self.num_blocks - len(self._free)

    def _set_block_gauges(self, in_use):
        _telem.set_gauge(self._blocks_gauge, in_use)
        _telem.set_gauge(self._bytes_gauge, in_use * self.bytes_per_block)

    def _set_prefix_gauges(self, n_blocks):
        """The prefix gauges and the ledger's ``prefix_cache`` overlay
        (these bytes live inside the pool's storage)."""
        _telem.set_gauge("serve.prefix.blocks", n_blocks)
        _telem.set_gauge("serve.prefix.bytes",
                         n_blocks * self.bytes_per_block)
        _ledger.account("prefix_cache", n_blocks * self.bytes_per_block)

    # -------------------------------------------------------- prefix match
    def _children_of(self, parent_key):
        if parent_key is None:
            return self._roots
        node = self._nodes.get(parent_key)
        return node.children if node is not None else ()

    def _match_locked(self, context, limit):
        """Longest cached prefix of `context`, capped at `limit` tokens.
        Returns (shared block ids, fill_start, cow source block or None).
        Only reads and LRU touches; `admit` commits the refcounts."""
        bs = self.block_size
        matched = []
        parent = None
        i = 0
        while (i + 1) * bs <= len(context):
            key = (parent, tuple(context[i * bs:(i + 1) * bs]))
            node = self._nodes.get(key)
            if node is None:
                break
            matched.append(node)
            parent = key
            i += 1
        raw = len(matched) * bs
        # sub-block tail: the child sharing the longest prefix with the
        # remainder is the copy-on-write source
        partial_node, partial_len = None, 0
        rest = context[raw:raw + bs]
        if rest:
            for key in self._children_of(parent):
                node = self._nodes[key]
                n = 0
                for a, b in zip(node.tokens, rest):
                    if a != b:
                        break
                    n += 1
                if n > partial_len:
                    partial_node, partial_len = node, n
        fill_start = min(raw + partial_len, limit)
        shared = [n.block for n in matched[:fill_start // bs]]
        cow_src = None
        if fill_start % bs:
            idx = fill_start // bs
            src = matched[idx] if idx < len(matched) else partial_node
            cow_src = src.block
            src.lru = self._lru_clock = self._lru_clock + 1
        for node in matched[:fill_start // bs]:
            node.lru = self._lru_clock = self._lru_clock + 1
        return shared, fill_start, cow_src

    def _evict_locked(self, need, protect=()):
        """Reclaim up to `need` blocks by dropping least-recently-matched
        LEAF entries that no live stream shares. `protect`ed blocks (this
        admission's own match) are never evicted: the block would come
        straight back as a 'fresh' block of the same table."""
        protect = set(protect)
        freed = 0
        while freed < need:
            best = None
            for node in self._nodes.values():
                if (node.children or node.block in protect
                        or self._refs.get(node.block, 0) != 1):
                    continue
                if best is None or node.lru < best.lru:
                    best = node
            if best is None:
                break
            self._drop_node_locked(best)
            freed += 1
            _telem.inc("serve.prefix.evictions")
        return freed

    def _drop_node_locked(self, node):
        del self._nodes[node.key]
        (self._roots if node.parent is None
         else self._nodes[node.parent].children).discard(node.key)
        self._unref_locked(node.block)

    def _unref_locked(self, block):
        n = self._refs.get(block, 0) - 1
        if n > 0:
            self._refs[block] = n
            return 0
        self._refs.pop(block, None)
        self._free.append(block)
        return 1

    # ----------------------------------------------------------- allocation
    def alloc(self, stream_id, n_tokens):
        """Grow `stream_id`'s block table to cover `n_tokens` positions.
        All-or-nothing: raises `Overloaded(reason="kv_exhausted")` having
        reserved NOTHING when the free-list is short."""
        table, _, _ = self.admit(stream_id, n_tokens, context=None)
        return table

    def admit(self, stream_id, n_tokens, context=None):
        """Admission-time reservation of `n_tokens` positions, sharing the
        longest cached block-aligned prefix of `context` (a token list)
        when prefix sharing is on.

        Returns (table, fill_start, cow): prefill may skip positions below
        `fill_start`; when `cow` is a (src, dst) pair the caller copies
        block src onto the fresh block dst before relying on it. On
        `Overloaded` nothing is reserved and no refcount moved."""
        need_total = self.blocks_for(n_tokens)
        with self._lock:
            table = self._tables.get(stream_id, [])
            if table:
                # an existing stream grows without re-matching
                shared, fill_start, cow_src = [], 0, None
            elif context is not None and self.prefix_sharing:
                _telem.inc("serve.prefix.lookups")
                shared, fill_start, cow_src = self._match_locked(
                    [int(t) for t in context], max(0, len(context) - 1))
            else:
                shared, fill_start, cow_src = [], 0, None
            grow = need_total - len(table) - len(shared)
            if cow_src is not None and grow <= 0:
                cow_src = None      # nothing allocated to copy onto
            protect = set(shared)
            if cow_src is not None:
                protect.add(cow_src)
            if grow > len(self._free):
                self._evict_locked(grow - len(self._free), protect=protect)
            if max(grow, 0) > len(self._free):
                free = len(self._free)
                _telem.inc("serve.kv.exhausted")
                brk = _ledger.breakdown()
                raise Overloaded(
                    "KV pool exhausted: stream %r needs %d more block(s) "
                    "(%d tokens) but only %d of %d are free%s"
                    % (stream_id, grow, n_tokens, free, self.num_blocks,
                       ("; memory ledger: " + brk) if brk else ""),
                    reason="kv_exhausted", kv_free_blocks=free,
                    kv_needed_blocks=grow,
                    ledger_breakdown=_ledger.scopes() or None)
            if grow <= 0 and not shared:
                return list(table), 0, None
            for b in shared:
                self._refs[b] = self._refs.get(b, 0) + 1
            fresh = [self._free.pop() for _ in range(max(grow, 0))]
            for b in fresh:
                self._refs[b] = 1
            table = table + shared + fresh
            self._tables[stream_id] = table
            cow = ((cow_src, table[len(shared)]) if cow_src is not None
                   else None)
            shared_n = len(shared)
            in_use = self._in_use_locked()
        _telem.inc("serve.kv.allocs")
        if shared_n or cow is not None:
            _telem.inc("serve.prefix.hits")
        if shared_n:
            _telem.inc("serve.prefix.blocks_shared", shared_n)
        if cow is not None:
            _telem.inc("serve.prefix.cow")
        self._set_block_gauges(in_use)
        return list(table), fill_start, cow

    def free(self, stream_id):
        """Drop the stream's references; blocks with no other owner return
        to the free-list (idempotent). Returns the number freed."""
        with self._lock:
            table = self._tables.pop(stream_id, None)
            if not table:
                return 0
            freed = sum(self._unref_locked(b) for b in table)
            in_use = self._in_use_locked()
        if freed:
            _telem.inc("serve.kv.freed_blocks", freed)
        self._set_block_gauges(in_use)
        return freed

    # -------------------------------------------------------- prefix index
    def register_prefix(self, stream_id, tokens):
        """Hash-cons the stream's FULL blocks covering `tokens` (its
        prompt) into the prefix index once its prefill has written them.
        New entries pin the stream's block with an index reference, so the
        prefix outlives the stream."""
        if not self.prefix_sharing:
            return 0
        bs = self.block_size
        tokens = [int(t) for t in tokens]
        inserted = 0
        with self._lock:
            table = self._tables.get(stream_id, ())
            parent = None
            for i in range(min(len(tokens) // bs, len(table))):
                key = (parent, tuple(tokens[i * bs:(i + 1) * bs]))
                if key not in self._nodes:
                    self._nodes[key] = _PrefixNode(key, parent, key[1],
                                                   table[i], self._lru_clock)
                    (self._roots if parent is None
                     else self._nodes[parent].children).add(key)
                    self._refs[table[i]] = self._refs.get(table[i], 0) + 1
                    inserted += 1
                parent = key
            n_blocks = len(self._nodes)
        if inserted:
            _telem.inc("serve.prefix.inserted", inserted)
        self._set_prefix_gauges(n_blocks)
        return inserted

    def clear_prefix_cache(self):
        """Drop every cached prefix and its index references (recovery
        calls it when the storage was re-made: every cached block's
        content is gone). Returns the number of blocks that went back to
        the free-list."""
        with self._lock:
            freed = sum(self._unref_locked(n.block)
                        for n in self._nodes.values())
            self._nodes.clear()
            self._roots.clear()
            in_use = self._in_use_locked()
        if freed:
            _telem.inc("serve.kv.freed_blocks", freed)
        self._set_prefix_gauges(0)
        self._set_block_gauges(in_use)
        return freed

    def table(self, stream_id, width):
        """The stream's block table as a width-`width` int32 array padded
        with the `num_blocks` sentinel (dropped writes, masked reads)."""
        with self._lock:
            blocks = list(self._tables.get(stream_id, ()))[:width]
        out = np.full(width, self.num_blocks, np.int32)
        out[:len(blocks)] = blocks
        return out

    def owned_blocks(self, stream_id):
        with self._lock:
            return list(self._tables.get(stream_id, ()))

    def reconcile(self):
        """Rebuild refcounts and the free-list as the exact complement of
        every live owner (stream tables + prefix index). Recovery calls it
        because an asynchronous fault (the watchdog's StallError lands at
        any bytecode) can tear an alloc or a free: blocks in neither a
        table nor the list would leak, a torn refcount would free a shared
        block under a live sibling. Returns the net number of blocks
        recovered: 0 when the accounting was exact."""
        with self._lock:
            refs = {}
            for table in self._tables.values():
                for b in table:
                    refs[b] = refs.get(b, 0) + 1
            for node in self._nodes.values():
                refs[node.block] = refs.get(node.block, 0) + 1
            before = len(self._free)
            self._refs = refs
            self._free = [b for b in range(self.num_blocks - 1, -1, -1)
                          if b not in refs]
            recovered = len(self._free) - before
            in_use = self._in_use_locked()
        if recovered:
            _telem.inc("serve.kv.reconciled_blocks", recovered)
            self._set_block_gauges(in_use)
        return recovered

    def ensure_storage(self):
        """Re-make the pool tensors if they were dropped (a layer missing,
        or a tensor whose storage was released). The programs write the
        pool in place and nothing is donated, so a fault cannot do this by
        itself; recovery checks anyway, since every stream re-prefills and
        the pool only has to exist. Returns True when the storage was
        re-made: the caller then clears the prefix cache (the new tensors
        are zeros)."""
        from ..models.llama import init_kv_pools
        layers = self.pools or {}
        if len(layers) == self.cfg.n_layers and all(
                t.untyped_storage().nbytes() >= t.nbytes
                for layer in layers.values() for t in layer.values()):
            return False
        self.pools = init_kv_pools(self.cfg, self.num_blocks,
                                   self.block_size, device=self.device)
        _ledger.account(self.scope, _ledger.tree_nbytes(self.pools))
        _telem.inc("serve.kv.storage_resets")
        return True
