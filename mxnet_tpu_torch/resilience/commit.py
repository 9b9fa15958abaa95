"""Coordinated commit: the ranks agree on the latest committed step (the
port of `mxnet_tpu.resilience.commit`).

A run with one checkpoint stream per rank (a `SnapshotCheckpointer` on
each rank's disk) can disagree about which step is the latest when a rank
crashes mid-commit: its disk says N+1, the others' say N, and a restore
would replay different steps on different ranks. The fix is a two-phase
commit:

1. **prepare**: every rank makes its snapshot of step N durable; its
   LATEST marker does not move (the payload is invisible).
2. **elect and commit**: every rank reports its newest durable step and
   the ranks elect the **minimum**; each then moves its marker to the
   elected step, which every rank has. A restore runs the same election
   over the ranks' newest committed steps.

`CommitCoordinator.elect(step)` is a collective: every rank calls the
same sequence of elections. `agree(flag)` is the same exchange for a
flag (`ResilientRunner` makes a preemption notice that reached one rank
a proactive checkpoint on every rank at the same step boundary). The
exchange runs over the rendezvous key-value store (`parallel.dist.coordinator_client`, a c10d store; the
reference uses the jax.distributed coordinator): each rank sets its key
under a per-round, per-kind prefix, waits for every rank's key with
``timeout_s`` (the barrier), and reads them. A rank that never arrives,
or ranks that call different kinds of election, surface as a
`RetriableError` after the timeout instead of a hang. After each round a
rank deletes its own keys of the earlier rounds it wrote (a rank passes
round N only once every rank wrote round N, so every rank has finished
reading the earlier ones). One process elects its own step. ``gather=``
replaces the exchange (tests).

Rounds are counted per coordinator: ranks that start a new run in the
same processes (after a rank failed mid-election) make new coordinators
with a fresh ``namespace``, so their keys cannot meet the old rounds'.

Telemetry: ``resilience.commit.elections`` (and per kind),
``resilience.commit.rank_ahead`` (this rank had prepared past the elected
step), ``resilience.commit.cleanups`` and the
``resilience.commit.elected_step`` gauge.
"""
from __future__ import annotations

import datetime
import logging
import threading

from .errors import RetriableError

__all__ = ["CommitCoordinator", "elect_step"]

_LOG = logging.getLogger("mxnet_tpu_torch.resilience")


class CommitCoordinator:
    """Min-step election over the ranks.

    gather:     replaces the exchange: ``gather(step, round_id) ->
                list`` of every rank's step (tests, other fabrics).
    timeout_s:  how long a round waits for every rank's key; a missing
                rank raises `RetriableError`.
    namespace:  key prefix (two checkpoint streams of one job, or a new
                run in the same processes, take their own).
    """

    _PENDING_ROUNDS_CAP = 64

    def __init__(self, gather=None, timeout_s=60.0,
                 namespace="mxnet_tpu.commit"):
        self._gather = gather
        self.timeout_s = float(timeout_s)
        self.namespace = namespace
        self._lock = threading.Lock()
        self._round = 0
        # (kind, round) of every round this rank wrote a key for and has
        # not reclaimed, recorded before the wait so that a round that
        # times out is reclaimed by the next one
        self._pending_rounds = []

    def _next_round(self):
        with self._lock:
            self._round += 1
            return self._round

    def elect(self, step, kind="save"):
        """Collective: the minimum of every rank's `step` (None: nothing
        durable on this rank; None only when no rank has a step). `kind`
        tags the counters and the keys."""
        from .. import telemetry as _telem
        round_id = self._next_round()
        steps = self._exchange(step, kind, round_id)
        present = [s for s in steps if s is not None]
        elected = min(present) if present else None
        _telem.inc("resilience.commit.elections")
        _telem.inc("resilience.commit.elections.%s" % kind)
        if elected is not None:
            _telem.set_gauge("resilience.commit.elected_step", elected)
            if step is not None and step > elected:
                _telem.inc("resilience.commit.rank_ahead")
                _LOG.warning(
                    "commit: this rank prepared step %s but the ranks "
                    "elected %s; committing the elected step", step, elected)
        return elected

    def agree(self, flag, kind="preempt"):
        """Collective: True on every rank when `flag` is true on any (a
        preemption notice that reached one rank)."""
        round_id = self._next_round()
        return any(self._exchange(int(bool(flag)), kind, round_id))

    def _exchange(self, step, kind, round_id):
        if self._gather is not None:
            return list(self._gather(step, round_id))
        from ..parallel import dist
        if not dist.has_group() or dist.num_workers() <= 1:
            return [step]
        return self._exchange_store(dist.coordinator_client(), dist.rank(),
                                    dist.num_workers(), step, kind, round_id)

    def _key(self, kind, round_id, rank):
        return "%s/%s/round_%d/rank_%d" % (self.namespace, kind, round_id,
                                           rank)

    def _exchange_store(self, store, rank, num, step, kind, round_id):
        """Set this rank's key, wait for every rank's (the barrier), read
        them, then reclaim this rank's earlier rounds."""
        store.set(self._key(kind, round_id, rank),
                  "none" if step is None else str(int(step)))
        with self._lock:
            self._pending_rounds.append((kind, round_id))
            del self._pending_rounds[:-self._PENDING_ROUNDS_CAP]
        keys = [self._key(kind, round_id, r) for r in range(num)]
        try:
            store.wait(keys, datetime.timedelta(seconds=self.timeout_s))
        except RuntimeError as exc:
            raise RetriableError(
                "commit: %s election round %d timed out after %.1f s "
                "waiting for every rank (%s)" % (kind, round_id,
                                                 self.timeout_s, exc)) \
                from exc
        steps = []
        for key in keys:
            raw = store.get(key).decode()
            steps.append(None if raw == "none" else int(raw))
        self.cleanup_round(store, rank, kind, round_id)
        return steps

    def cleanup_round(self, store, rank, kind, round_id):
        """Delete this rank's keys of every earlier round it wrote; a
        failed delete stays on the ledger for the next round. Returns the
        number of rounds reclaimed."""
        from .. import telemetry as _telem
        with self._lock:
            stale = [rd for rd in self._pending_rounds
                     if rd != (kind, round_id)]
        reclaimed = []
        for old_kind, old_round in stale:
            try:
                store.delete_key(self._key(old_kind, old_round, rank))
            except RuntimeError as exc:
                _LOG.debug("commit: cleanup of round %d failed: %s",
                           old_round, exc)
                continue
            reclaimed.append((old_kind, old_round))
            _telem.inc("resilience.commit.cleanups")
        if reclaimed:
            with self._lock:
                self._pending_rounds = [rd for rd in self._pending_rounds
                                        if rd not in reclaimed]
        return len(reclaimed)


_DEFAULT = {}


def elect_step(step, kind="save", timeout_s=60.0):
    """One election through the process's default coordinator (the
    checkpoint functions' ``coordinated=True``): its rounds count on, so
    every rank's calls stay in lockstep."""
    coord = _DEFAULT.get(float(timeout_s))
    if coord is None:
        coord = _DEFAULT[float(timeout_s)] = CommitCoordinator(
            timeout_s=timeout_s, namespace="mxnet_tpu.commit.default")
    return coord.elect(step, kind=kind)
