"""Continuous-batching scheduler: admission, chunked prefill, decode, spec,
and drain recovery.

The port of `mxnet_tpu.serve.scheduler`. One replica is one
`InferenceServer`, driving `ServePrograms` over the paged pool
(`KVBlockPool`):

* **continuous batching** — requests join and leave the running batch
  between decode steps; a finished stream frees its slot and blocks at
  once;
* **chunked, batched prefill** — prompt work is cut into fixed-shape
  (rows x chunk) windows interleaved with decode under a per-step token
  budget (``MXNET_TPU_SERVE_PREFILL_BUDGET``), so a burst of arrivals
  prefills together and a long prompt cannot starve running decodes;
* **prefix sharing** — admission looks the context up in the pool's
  prefix index: matched full blocks join the table by refcount and
  prefill skips them (copy-on-write at the divergence block);
* **speculative decoding** — with a draft model, greedy streams decode by
  draft-k / verify rounds (``serve.spec.*`` counters): the draft proposes
  ``spec_k`` tokens, the target verifies them in one chunk-shaped pass,
  and only tokens the target's own argmax agrees with are emitted, so the
  output equals plain greedy decoding;
* **sampling** — per-request temperature/top-k/top-p, draws keyed on
  (stream seed, position), so a recovered stream replays the same tokens;
  sampled streams take the plain decode path;
* **admission control** — a full queue answers `Overloaded(queue_full)`;
  a request whose worst-case context can never fit is shed at submit
  (`Overloaded(too_large)`); a transiently unfit one waits in the queue;
  the worst-case context is reserved at admission, so an admitted stream
  always finishes;
* **deadlines and retry budgets** — deadlines are checked in the queue and
  after every token (`DeadlineExceeded` carries the partial output and
  the request's trace); each request's replica-fault budget defaults to
  `RetryPolicy().max_attempts` (``MXNET_TPU_RETRIES``);
* **fault sites** — ``serve.admit`` (submission) and ``serve.step`` (top of
  every step) are `resilience.faults` sites; the step body runs under the
  hang watchdog (``MXNET_TPU_SERVE_STEP_DEADLINE_S``, else the global
  step deadline), so a hung step becomes a recoverable `StallError`;
* **drain and resume** — a fault drains the replica: every in-flight
  stream's blocks are freed (a shared prefix block under a live sibling
  survives) and the stream re-enters the queue at the front, budget
  decremented, to resume here or on another replica by re-prefilling its
  prompt + emitted tokens. Deterministic decoding makes the resumed
  output identical: no token lost, none duplicated.

Telemetry: ``serve.requests/admitted/completed/shed[.reason]/tokens/
prefills/prefill_chunks/prefill_chunk_tokens/decode_steps/recoveries/
requeued_streams/failed/replica_deaths`` and ``serve.spec.rounds/drafted/
accepted/rejected/discarded`` counters, ``serve.queue_depth`` /
``serve.batch_occupancy`` / ``serve.kv.*`` / ``serve.tokens_per_s``
gauges, ``serve.ttft_ms`` / ``serve.tpot_ms`` / ``serve.prefill_ms`` /
``serve.step_ms`` histograms, a ``serve.step`` span and a
``telemetry.step_event`` per step naming the active and completed
requests, flight-ring events for sheds and recoveries, and one
`RequestTrace` per request (its spans tile its wall clock, across
replicas).
"""
from __future__ import annotations

import os
import threading
import time
import uuid
import zlib
from collections import deque

import numpy as np

from .. import telemetry as _telem
from ..resilience import faults as _faults
from ..resilience import watchdog as _watchdog
from ..resilience.errors import RetriableError, RetryExhausted
from ..resilience.retry import RetryPolicy
from ..telemetry import flight as _flight
from ..telemetry import request_trace as _reqtrace
from .errors import DeadlineExceeded, Overloaded
from .kv_cache import KVBlockPool
from .programs import ServePrograms

__all__ = ["Request", "StreamHandle", "RequestQueue", "InferenceServer",
           "default_max_batch", "default_queue_cap"]


def _env_int(name, default):
    try:
        return max(1, int(os.environ.get(name, str(default))))
    except (TypeError, ValueError):
        return default


def default_max_batch():
    return _env_int("MXNET_TPU_SERVE_MAX_BATCH", 8)


def default_queue_cap():
    return _env_int("MXNET_TPU_SERVE_QUEUE", 64)


def default_prefill_budget(rows, chunk):
    try:
        raw = int(os.environ.get("MXNET_TPU_SERVE_PREFILL_BUDGET", "0"))
    except (TypeError, ValueError):
        raw = 0
    return raw if raw > 0 else rows * chunk


def _step_deadline_s():
    raw = os.environ.get("MXNET_TPU_SERVE_STEP_DEADLINE_S")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return _watchdog.default_deadline_s()


class Request:
    """One generation request: a token prompt plus its budgets and
    sampling policy.

    deadline_s is relative to submission and covers queue wait AND decode;
    eos_id stops the stream early; retries overrides the replica-fault
    budget (default: `RetryPolicy().max_attempts`). temperature <= 0 is
    greedy (the default); top_k/top_p filter the sampled distribution;
    seed pins the draws (default: derived from request_id, so retries of
    one request replay the same tokens).
    """

    def __init__(self, prompt, max_new_tokens=16, request_id=None,
                 deadline_s=None, eos_id=None, retries=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=None):
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("serve: empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("serve: max_new_tokens must be >= 1")
        self.request_id = (str(request_id) if request_id
                           else uuid.uuid4().hex[:12])
        self.deadline_s = deadline_s
        self.eos_id = eos_id
        self.retries = retries
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        if self.top_k < 0:
            raise ValueError("serve: top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("serve: top_p must be in (0, 1]")
        self.seed = (int(seed) if seed is not None
                     else zlib.crc32(self.request_id.encode())) & 0xffffffff

    @property
    def greedy(self):
        return self.temperature <= 0.0


class StreamHandle:
    """The caller's view of an in-flight stream: tokens appear as decoded,
    `result()` blocks for completion. Survives replica faults: a requeued
    stream keeps its handle (and its `trace`), so recovery shows to the
    client only as `requeues` ticking up."""

    def __init__(self, request):
        self.request = request
        self.id = request.request_id
        self.tokens = []
        self.error = None
        self.ttft_ms = None
        self.tpot_ms = []         # per-output-token latencies after the 1st
        self.requeues = 0
        self.trace = _reqtrace.NULL_TRACE
        self._done = threading.Event()

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block until the stream completes; returns the emitted tokens or
        raises the structured error that ended it."""
        if not self._done.wait(timeout):
            raise TimeoutError("serve: stream %s still running" % self.id)
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    def _complete(self):
        self._done.set()

    def _fail(self, exc):
        self.error = exc
        self._done.set()


class _Stream:
    """Scheduler-internal in-flight state; `handle.tokens` IS the emitted
    list, so requeue and resume carry it untouched."""

    __slots__ = ("handle", "request", "retries_left", "deadline",
                 "last_token_t", "t_submit", "owner", "table_row", "kv_id",
                 "fill_pos", "fill_len", "fill_chunks")

    def __init__(self, handle, retries_left):
        self.handle = handle
        self.request = handle.request
        self.retries_left = retries_left
        # `is not None`: deadline_s=0 means "already expired", not "none"
        self.deadline = (time.monotonic() + handle.request.deadline_s
                         if handle.request.deadline_s is not None else None)
        # the pool is keyed by this, never by the caller's request_id: two
        # in-flight requests reusing one id must not share a block table
        self.kv_id = uuid.uuid4().hex[:12]
        self.last_token_t = None
        self.t_submit = time.perf_counter()
        # who holds the stream: the RequestQueue while queued, the server
        # that popped it while in flight; written and read only under the
        # queue's lock, so recovery can ask atomically whether the stream
        # is still its own
        self.owner = None
        self.table_row = None     # padded block-table row, set at admission
        # chunked-prefill progress: positions [fill_pos, fill_len) still
        # need their KV written; the stream decodes once they are equal
        self.fill_pos = 0
        self.fill_len = 0
        self.fill_chunks = 0

    @property
    def context(self):
        return self.request.prompt + self.handle.tokens

    @property
    def filling(self):
        return self.fill_pos < self.fill_len

    def expired(self, now):
        return self.deadline is not None and now > self.deadline

    def finished(self):
        """Emitted all it ever will (budget spent, or EOS) but not yet
        retired: a requeued stream can arrive so when a fault landed
        between its last token and its finish check."""
        tokens = self.handle.tokens
        if len(tokens) >= self.request.max_new_tokens:
            return True
        return (self.request.eos_id is not None and bool(tokens)
                and tokens[-1] == self.request.eos_id)


class RequestQueue:
    """Bounded admission queue, shareable across replicas. `push` sheds at
    capacity; `requeue` (recovery and backpressure re-entry) is cap-exempt
    and goes to the FRONT: a stream is never shed by its replica's
    death."""

    def __init__(self, cap=None):
        self.cap = int(cap or default_queue_cap())
        self._items = deque()
        self._cond = threading.Condition(threading.Lock())

    def push(self, stream):
        with self._cond:
            if len(self._items) >= self.cap:
                raise Overloaded(
                    "serve queue full (%d waiting, cap %d)"
                    % (len(self._items), self.cap),
                    reason="queue_full", queue_depth=len(self._items),
                    retry_after_s=0.1)
            stream.owner = self
            self._items.append(stream)
            depth = len(self._items)
            self._cond.notify_all()
        _telem.set_gauge("serve.queue_depth", depth)

    def requeue(self, stream):
        with self._cond:
            stream.owner = self
            self._items.appendleft(stream)
            depth = len(self._items)
            self._cond.notify_all()
        _telem.set_gauge("serve.queue_depth", depth)

    def pop(self, owner=None):
        """Pop the head stream, handing its ownership to `owner` (the
        popping replica) under the queue lock."""
        with self._cond:
            if not self._items:
                return None
            stream = self._items.popleft()
            stream.owner = owner
            depth = len(self._items)
        _telem.set_gauge("serve.queue_depth", depth)
        return stream

    def owned_by(self, stream, who):
        """Atomic check: is `stream` still held by `who`, or did a requeue
        already hand it on (perhaps straight into a sibling's pop)?"""
        with self._cond:
            return stream.owner is who

    def wait_nonempty(self, timeout=None):
        with self._cond:
            if self._items:
                return True
            self._cond.wait(timeout)
            return bool(self._items)

    def __len__(self):
        with self._cond:
            return len(self._items)


class InferenceServer:
    """One fault-tolerant continuous-batching serving replica on `device`
    (cuda by default; the params must already live there).

    Usage::

        server = InferenceServer(params, cfg).warmup()
        h = server.submit(Request([1, 2, 3], max_new_tokens=8))
        server.run()                          # drive until idle
        print(h.result())

    Speculative decoding rides a draft model::

        server = InferenceServer(params, cfg, draft_params=dparams,
                                 draft_cfg=dcfg, spec_k=4)
    """

    def __init__(self, params, cfg, *, max_batch=None, kv_blocks=None,
                 block_size=None, max_context=None, chunk_size=None,
                 prefill_rows=None, prefill_budget=None,
                 prefix_sharing=None, draft_params=None, draft_cfg=None,
                 spec_k=None, queue=None, queue_cap=None,
                 step_deadline_s=None, max_restarts=3, name="replica0",
                 device=None):
        self.name = name
        self.cfg = cfg
        self.pool = KVBlockPool(cfg, num_blocks=kv_blocks,
                                block_size=block_size,
                                prefix_sharing=prefix_sharing, device=device)
        for p in (params, draft_params):
            where = None if p is None else p["tok_embeddings"].device
            if where is not None and where.type != self.pool.device.type:
                raise ValueError("serve: params live on %s, the server on "
                                 "%s" % (where, self.pool.device))
        if max_context is None:
            max_context = min(cfg.max_seq_len,
                              self.pool.num_blocks * self.pool.block_size)
        self.max_batch = int(max_batch or default_max_batch())
        # the draft pool mirrors the target pool's geometry and BLOCK IDS
        # (one table indexes both); accounting lives on the target pool
        self.draft_pool = None
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("serve: draft_params needs draft_cfg")
            self.draft_pool = KVBlockPool(
                draft_cfg, num_blocks=self.pool.num_blocks,
                block_size=self.pool.block_size, prefix_sharing=False,
                device=self.pool.device, scope="kv_draft")
        self.programs = ServePrograms(
            params, cfg, self.pool, self.max_batch, max_context,
            chunk_size=chunk_size, prefill_rows=prefill_rows,
            draft_params=draft_params, draft_cfg=draft_cfg,
            draft_pool=self.draft_pool, spec_k=spec_k)
        self.prefill_budget = (int(prefill_budget) if prefill_budget
                               else default_prefill_budget(
                                   self.programs.prefill_rows,
                                   self.programs.chunk_size))
        self.queue = queue if queue is not None else RequestQueue(queue_cap)
        self.step_deadline_s = (step_deadline_s if step_deadline_s
                                is not None else _step_deadline_s())
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self.dead = False
        self._slots = [None] * self.max_batch
        # the stream popped from the queue but not yet in a slot: a fault
        # inside _admit (the watchdog's async StallError can land between
        # any two bytecodes) must find it here, or recovery would lose it
        self._admitting = None
        # request ids retired during the current step, for its flight
        # record
        self._step_completed = []
        self._default_retries = RetryPolicy().max_attempts

    # ------------------------------------------------------------ admission
    def _worst_blocks(self, request):
        """Blocks reserved at admission: the FULL possible context (the
        final emitted token's KV is never written)."""
        return self.pool.blocks_for(len(request.prompt)
                                    + request.max_new_tokens - 1)

    def _note_shed(self, reason, detail=""):
        _telem.inc("serve.shed")
        _telem.inc("serve.shed.%s" % reason)
        _flight.note_event("serve_shed",
                           "%s %s" % (reason, detail) if detail else reason)

    def submit(self, request):
        """Queue a request; returns a `StreamHandle`. Raises `Overloaded`
        when the queue is full or the request can never fit."""
        _faults.check("serve.admit", context="request=%s"
                      % request.request_id)
        _telem.inc("serve.requests")
        # the trace starts at enqueue: a shed request leaves one too
        trace = _reqtrace.start(request.request_id)
        # the longest context a resumed stream can re-prefill
        max_prefill = len(request.prompt) + request.max_new_tokens - 1
        if (self._worst_blocks(request) > self.pool.num_blocks
                or max_prefill > self.programs.max_context):
            trace.finish("shed.too_large", tokens=0)
            self._note_shed("too_large")
            raise Overloaded(
                "request %s can never fit: prompt %d + budget %d tokens "
                "vs pool of %d blocks x %d (max context %d)"
                % (request.request_id, len(request.prompt),
                   request.max_new_tokens, self.pool.num_blocks,
                   self.pool.block_size, self.programs.max_context),
                reason="too_large",
                kv_needed_blocks=self._worst_blocks(request),
                kv_free_blocks=self.pool.free_blocks)
        handle = StreamHandle(request)
        handle.trace = trace
        retries = (request.retries if request.retries is not None
                   else self._default_retries)
        try:
            self.queue.push(_Stream(handle, retries_left=retries))
        except Overloaded:
            trace.finish("shed.queue_full", tokens=0)
            self._note_shed("queue_full")
            raise
        return handle

    def warmup(self):
        self.programs.warmup()
        return self

    def _free_slot(self):
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _finish_trace(self, handle, outcome):
        """Snapshot the request's trace into the ring (idempotent: an
        earlier, more specific finish wins)."""
        ttft = (round(handle.ttft_ms, 3) if handle.ttft_ms is not None
                else None)
        return handle.trace.finish(outcome, tokens=len(handle.tokens),
                                   ttft_ms=ttft, requeues=handle.requeues)

    def _retire(self, slot, stream, error=None):
        # the terminal event FIRST: if an async fault lands mid-retire, the
        # stream is done-marked while still in its slot, and
        # _drain_stream's done() branch finishes the cleanup
        if error is not None:
            self._finish_trace(stream.handle, "deadline" if isinstance(
                error, DeadlineExceeded) else "failed")
            stream.handle._fail(error)
        else:
            self._finish_trace(stream.handle, "completed")
            _telem.inc("serve.completed")
            stream.handle._complete()
        self._step_completed.append(stream.handle.id)
        self.pool.free(stream.kv_id)
        self._slots[slot] = None

    def _deadline_error(self, stream, where):
        self._note_shed("deadline", stream.handle.id)
        payload = self._finish_trace(stream.handle, "deadline")
        return DeadlineExceeded(
            "request %s missed its %.3gs deadline %s after %d token(s)"
            % (stream.handle.id, stream.request.deadline_s, where,
               len(stream.handle.tokens)), tokens=stream.handle.tokens,
            request_trace=payload)

    def _finish_check(self, slot, stream, token, now):
        request = stream.request
        if stream.expired(now):
            self._retire(slot, stream,
                         self._deadline_error(stream, "mid-stream"))
            return True
        if (len(stream.handle.tokens) >= request.max_new_tokens
                or (request.eos_id is not None
                    and token == request.eos_id)):
            self._retire(slot, stream)
            return True
        return False

    def _admit(self):
        """Fill free batch slots from the queue: pop -> reserve KV
        (sharing any cached prefix, copy-on-write at the divergence block)
        -> join the batch in the filling state. A transiently unfit head
        request goes back to the front and admission stops."""
        admitted = 0
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            # the pop marks the stream in flight in the same statement
            # (and hands its ownership to this server under the queue lock)
            self._admitting = stream = self.queue.pop(self)
            if stream is None:
                break
            # the wait just ended ("queue", or "recovery.queue" after a
            # drain); note which replica now holds the stream
            stream.handle.trace.mark("queue", replica=self.name) \
                .note_replica(self.name)
            if stream.finished():
                # a fault landed between its last token and its finish
                # check: retire it instead of re-prefilling a token too many
                self._finish_trace(stream.handle, "completed")
                self._step_completed.append(stream.handle.id)
                _telem.inc("serve.completed")
                stream.handle._complete()
                self._admitting = None
                continue
            if stream.expired(time.monotonic()):
                self._step_completed.append(stream.handle.id)
                stream.handle._fail(self._deadline_error(stream,
                                                         "in the queue"))
                self._admitting = None
                continue
            context = stream.context
            try:
                _, fill_start, cow = self.pool.admit(
                    stream.kv_id,
                    len(stream.request.prompt)
                    + stream.request.max_new_tokens - 1, context=context)
            except Overloaded:
                # transient: the pool drains as running streams finish
                self.queue.requeue(stream)
                self._admitting = None
                break
            stream.table_row = self.pool.table(
                stream.kv_id, self.programs.blocks_per_stream)
            stream.fill_pos = fill_start
            stream.fill_len = len(context)
            stream.fill_chunks = 0
            if cow is not None:
                self.programs.copy_block(*cow)
                if self.draft_pool is not None:
                    self.programs.draft_copy_block(*cow)
            self._slots[slot] = stream
            self._admitting = None
            _telem.inc("serve.admitted")
            admitted += 1
        return admitted

    # -------------------------------------------------------------- prefill
    def _plan_chunks(self):
        """This step's prefill windows: up to `prefill_rows` rows of up to
        `chunk_size` tokens, total capped by the token budget; round-robin
        over the filling streams."""
        filling = [s for s in self._slots if s is not None and s.filling]
        plan = []                   # (stream, start, n)
        progress = {s.kv_id: s.fill_pos for s in filling}
        budget = self.prefill_budget
        rows = self.programs.prefill_rows
        while filling and len(plan) < rows and budget > 0:
            advanced = False
            for s in filling:
                if len(plan) >= rows or budget <= 0:
                    break
                rem = s.fill_len - progress[s.kv_id]
                if rem <= 0:
                    continue
                n = min(rem, self.programs.chunk_size, budget)
                plan.append((s, progress[s.kv_id], n))
                progress[s.kv_id] += n
                budget -= n
                advanced = True
            if not advanced:
                break
        return plan

    def _prefill(self):
        """One chunked-prefill window (target model, and the draft mirror
        when spec is on); emits the first token of every stream whose
        fill completes."""
        plan = self._plan_chunks()
        if not plan:
            return 0
        P, C = self.programs.prefill_rows, self.programs.chunk_size
        nb = self.programs.blocks_per_stream
        tokens = np.zeros((P, C), np.int64)
        positions = np.full((P, C), -1, np.int64)
        tables = np.full((P, nb), self.pool.num_blocks, np.int64)
        seeds = np.zeros(P, np.int64)
        sample_pos = np.zeros(P, np.int64)
        temps = np.zeros(P, np.float32)
        top_k = np.zeros(P, np.int64)
        top_p = np.ones(P, np.float32)
        final_row = {}              # kv_id -> (row, stream)
        for r, (s, start, n) in enumerate(plan):
            tokens[r, :n] = s.context[start:start + n]
            positions[r, :n] = np.arange(start, start + n)
            tables[r] = s.table_row
            req = s.request
            seeds[r] = req.seed
            sample_pos[r] = s.fill_len
            temps[r] = req.temperature
            top_k[r] = req.top_k
            top_p[r] = req.top_p
            s.fill_chunks += 1
            if start + n >= s.fill_len:
                final_row[s.kv_id] = (r, s)
        t0 = time.perf_counter()
        out = self.programs.chunk_prefill(tokens, positions, tables, seeds,
                                          sample_pos, temps, top_k, top_p)
        if self.draft_pool is not None:
            self.programs.draft_prefill(tokens, positions, tables)
        _telem.inc("serve.prefill_chunks", len(plan))
        _telem.inc("serve.prefill_chunk_tokens",
                   int(sum(n for _, _, n in plan)))
        _telem.observe("serve.prefill_ms", (time.perf_counter() - t0) * 1e3)
        for s, start, n in plan:
            s.fill_pos = max(s.fill_pos, start + n)
        now = time.monotonic()
        for r, s in final_row.values():
            # the fill is complete: this row's token is the stream's first
            # output, and its prompt's full blocks become shareable
            token = int(out[r])
            _telem.inc("serve.prefills")
            self.pool.register_prefix(s.kv_id, s.request.prompt)
            s.handle.tokens.append(token)
            s.last_token_t = now
            s.handle.trace.mark("prefill", tokens=s.fill_len,
                                chunks=s.fill_chunks)
            _telem.inc("serve.tokens")
            if s.handle.ttft_ms is None:
                # time to first token counts the queue wait too
                s.handle.ttft_ms = (time.perf_counter() - s.t_submit) * 1e3
                _telem.observe("serve.ttft_ms", s.handle.ttft_ms)
            self._finish_check(self._slots.index(s), s, token, now)
        return len(plan)

    # --------------------------------------------------------------- decode
    def _emit(self, slot, stream, token, now, dt_share):
        """Append one decoded token and run the retirement checks. Returns
        True when the stream retired."""
        stream.handle.tokens.append(token)
        _telem.inc("serve.tokens")
        if stream.last_token_t is not None:
            stream.handle.tpot_ms.append(dt_share)
            _telem.observe("serve.tpot_ms", dt_share)
        stream.last_token_t = now
        # one decode span per emitted token: the inter-token interval, so
        # slot residency tiles the request's timeline
        stream.handle.trace.mark("decode", token=len(stream.handle.tokens))
        return self._finish_check(slot, stream, token, now)

    def _spec_eligible(self, stream):
        return self.programs.spec and stream.request.greedy

    def _decode_plain(self, active):
        """One decode step over `active` [(slot, stream)] (the other slots
        ride along masked)."""
        B = self.max_batch
        tokens = np.zeros(B, np.int64)
        positions = np.full(B, -1, np.int64)
        tables = np.full((B, self.programs.blocks_per_stream),
                         self.pool.num_blocks, np.int64)
        seeds = np.zeros(B, np.int64)
        temps = np.zeros(B, np.float32)
        top_k = np.zeros(B, np.int64)
        top_p = np.ones(B, np.float32)
        for i, s in active:
            req = s.request
            tokens[i] = s.handle.tokens[-1]
            positions[i] = len(s.context) - 1
            tables[i] = s.table_row
            seeds[i] = req.seed
            temps[i] = req.temperature
            top_k[i] = req.top_k
            top_p[i] = req.top_p
        out = self.programs.decode(tokens, positions, tables, seeds, temps,
                                   top_k, top_p)
        now = time.monotonic()
        for i, s in active:
            dt = ((now - s.last_token_t) * 1e3
                  if s.last_token_t is not None else 0.0)
            self._emit(i, s, int(out[i]), now, dt)
        return len(active)

    def _decode_spec(self, active):
        """One draft-k / verify round over `active` greedy streams: the
        draft proposes spec_k tokens per stream, one verify pass computes
        the target's greedy token at every drafted position, and the
        matching prefix plus the target's own next token is emitted —
        1..spec_k+1 tokens per stream, equal to plain greedy decoding."""
        B, k = self.max_batch, self.programs.spec_k
        nb = self.programs.blocks_per_stream
        tokens = np.zeros(B, np.int64)
        positions = np.full(B, -1, np.int64)
        tables = np.full((B, nb), self.pool.num_blocks, np.int64)
        for i, s in active:
            tokens[i] = s.handle.tokens[-1]
            positions[i] = len(s.context) - 1
            tables[i] = s.table_row
        drafted = self.programs.draft_k(tokens, positions, tables)
        # verify window: [last token, d1..dk] at positions p..p+k; the
        # target's answer at column j is the token FOLLOWING the fed one.
        # Columns past the stream's remaining budget ride position -1:
        # they would write past its reserved blocks (the draft loop may
        # still overrun its mirror pool, which costs accept rate only)
        vt = np.zeros((B, k + 1), np.int64)
        vp = np.full((B, k + 1), -1, np.int64)
        vt[:, 0] = tokens
        vt[:, 1:] = drafted
        remaining = {}
        for i, s in active:
            rem = s.request.max_new_tokens - len(s.handle.tokens)
            remaining[i] = rem
            cols = min(k + 1, max(rem, 1))
            vp[i, :cols] = np.arange(positions[i], positions[i] + cols)
        ver = self.programs.verify(vt, vp, tables)
        _telem.inc("serve.spec.rounds")
        now = time.monotonic()
        for i, s in active:
            cap = min(k, max(remaining[i] - 1, 0))
            accept = 0
            while accept < cap and drafted[i, accept] == ver[i, accept]:
                accept += 1
            emit = [int(t) for t in ver[i, :accept + 1]]
            # drafted counts the drafts that reached verification, so a
            # budget-capped final round does not dilute the accept rate
            _telem.inc("serve.spec.drafted", cap)
            _telem.inc("serve.spec.accepted", accept)
            _telem.inc("serve.spec.rejected", cap - accept)
            if k > cap:
                _telem.inc("serve.spec.discarded", k - cap)
            dt = ((now - s.last_token_t) * 1e3 / len(emit)
                  if s.last_token_t is not None else 0.0)
            for token in emit:
                if self._emit(i, s, token, now, dt):
                    break
        return len(active)

    def _decode(self):
        """One decode phase over every slot whose fill is complete: greedy
        streams ride the draft/verify round when a draft model is set, the
        rest the plain decode program."""
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None and not s.filling]
        if not active:
            return 0
        spec = [(i, s) for i, s in active if self._spec_eligible(s)]
        plain = [(i, s) for i, s in active if not self._spec_eligible(s)]
        decoded = 0
        if spec:
            decoded += self._decode_spec(spec)
        if plain:
            decoded += self._decode_plain(plain)
        _telem.inc("serve.decode_steps")
        return decoded

    def step(self):
        """One scheduler iteration: admit, prefill a chunk window, decode.
        Returns True while there is in-flight or queued work. Raises the
        injected or real `RetriableError`s that `run` absorbs."""
        if not self.programs._warm:
            self.warmup()
        t0 = time.perf_counter()
        ts = _telem.span_clock()
        self._step_completed = []
        with _watchdog.guard("serve.step", deadline_s=self.step_deadline_s):
            _faults.check("serve.step", context="replica=%s" % self.name)
            admitted = self._admit()
            prefilled = self._prefill()
            decoded = self._decode()
        occupancy = sum(1 for s in self._slots if s is not None)
        _telem.set_gauge("serve.batch_occupancy", occupancy)
        # admission-only steps land in the step plane too, or their
        # completed ids never reach a flight record
        if decoded or admitted or prefilled or self._step_completed:
            dur = time.perf_counter() - t0
            _telem.observe("serve.step_ms", dur * 1e3)
            _telem.record_span("serve.step", "step", ts, dur)
            info = {"active_requests":
                    [s.handle.id for s in self._slots if s is not None][:16]}
            if self._step_completed:
                info["completed_requests"] = self._step_completed[:16]
            _telem.step_event("serve.step", dur * 1e3, info=info)
        return occupancy > 0 or len(self.queue) > 0

    # ------------------------------------------------------------- recovery
    def _drain_stream(self, stream, exc):
        """Free one in-flight stream's blocks and send it back to the
        queue (front, budget decremented), or fail it when the budget is
        spent. Returns 1 when the stream was requeued."""
        stream.table_row = None
        stream.fill_pos = stream.fill_len = 0
        self.pool.free(stream.kv_id)
        if stream.handle.done():
            # its terminal event fired before the fault; only the pool and
            # slot cleanup remained
            return 0
        stream.retries_left -= 1
        if stream.retries_left < 0:
            _telem.inc("serve.failed")
            stream.handle.trace.mark("recovery.drain",
                                     error=type(exc).__name__)
            self._finish_trace(stream.handle, "failed")
            stream.handle._fail(RetryExhausted(
                "stream %s: replica-fault retry budget spent; last "
                "error: %s: %s" % (stream.handle.id, type(exc).__name__,
                                   exc),
                site="serve.step", last_error=exc))
            return 0
        stream.handle.requeues += 1
        # the recovery cost lands on the timeline: "recovery.drain" now,
        # "recovery.queue" at re-admission
        stream.handle.trace.note_drain(exc)
        self.queue.requeue(stream)
        _telem.inc("serve.requeued_streams")
        return 1

    def _recover(self, exc):
        """Drain after a replica fault: every in-flight stream — the batch
        slots and a stream caught mid-admission — frees its blocks and
        re-enters the shared queue at the front, to resume here or on a
        surviving replica by re-prefill. Streams whose budget is spent
        fail with `RetryExhausted`."""
        drained = 0
        requeued_ids, lost_ids = [], []

        def drain(stream):
            nonlocal drained
            n = self._drain_stream(stream, exc)
            drained += n
            (requeued_ids if n else lost_ids).append(stream.handle.id)

        admitting, self._admitting = self._admitting, None
        if admitting is not None and not admitting.handle.done() \
                and self.queue.owned_by(admitting, self):
            # drain the mid-admission stream only while the queue still
            # names this server its owner: if a requeue already handed it
            # on (perhaps into a sibling's pop), a second requeue would
            # admit one stream into two slots
            drain(admitting)
        for i, stream in enumerate(self._slots):
            if stream is None:
                continue
            self._slots[i] = None
            if stream is admitting:
                # caught between slot assignment and the _admitting clear:
                # drained once above
                continue
            drain(stream)
        # re-made storage is zeros: every cached prefix goes with it
        reset = self.pool.ensure_storage()
        if self.draft_pool is not None:
            reset = self.draft_pool.ensure_storage() or reset
        if reset:
            self.pool.clear_prefix_cache()
        # a fault inside an alloc or a free can tear the free-list or a
        # refcount: rebuild both from the surviving tables and index
        self.pool.reconcile()
        _telem.inc("serve.recoveries")
        msg = ("%s: %s (requeued %d: %s)"
               % (self.name, type(exc).__name__, drained,
                  ",".join(requeued_ids[:8]) if requeued_ids else "-"))
        if lost_ids:
            msg += " (not requeued: %s)" % ",".join(lost_ids[:8])
        _flight.note_event("serve_recover", msg)
        return drained

    def run(self, max_steps=None, stop=None):
        """Drive the scheduler: until idle (stop=None), or until `stop` (an
        Event) is set — the replica-thread mode, parking on the queue when
        idle. Retriable faults drain and continue up to `max_restarts`;
        past that, or on any other error, the replica drains its streams
        for the survivors, marks itself `dead` and re-raises. Returns the
        number of steps taken; sets the ``serve.tokens_per_s`` gauge."""
        steps = 0
        t0 = time.perf_counter()
        tokens0 = _telem.counter_value("serve.tokens")
        try:
            while stop is None or not stop.is_set():
                try:
                    busy = self.step()
                except RetriableError as exc:
                    self._recover(exc)
                    self.restarts += 1
                    if self.restarts > self.max_restarts:
                        self.dead = True
                        _telem.inc("serve.replica_deaths")
                        raise
                    continue
                except Exception as exc:
                    # a non-retriable escape (a device loss, a bug) still
                    # must not strand in-flight streams
                    self._recover(exc)
                    self.dead = True
                    _telem.inc("serve.replica_deaths")
                    raise
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    break
                if not busy:
                    if stop is None:
                        break
                    self.queue.wait_nonempty(timeout=0.05)
        finally:
            dt = time.perf_counter() - t0
            if dt > 0:
                _telem.set_gauge("serve.tokens_per_s",
                                 (_telem.counter_value("serve.tokens")
                                  - tokens0) / dt)
        return steps
