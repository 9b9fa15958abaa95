"""Resumable training: checkpoints, fault recovery, a restart budget (the
port of `mxnet_tpu.resilience.run`).

`ResilientRunner` wraps a per-step callable (a `gluon.FusedTrainStep`, a
`parallel.ShardedTrainStep`, or any ``step_fn(step_idx) -> loss``) with the
recovery loop a preemptible fleet needs:

* **periodic snapshots**: every ``ckpt_every`` steps the runner captures
  the training state (parameters, optimizer state and bookkeeping, the
  random generators) through ``state_get`` and commits it atomically
  (write-then-rename, ``keep=N`` retention);
* **fault handling**: transport faults at the step boundary (the
  ``run.step`` site) are retried in place; anything else retriable
  (`PreemptionError`, `StallError`, `RetryExhausted`, a transport fault
  inside the step) triggers *restore-and-replay*: reload the latest
  snapshot, rewind the step counter, continue. Replay is deterministic,
  so an interrupted run reproduces the uninterrupted one;
* **restart budget**: ``max_restarts`` caps recoveries; past it the last
  fault is raised;
* **hang watchdog**: each step runs under ``watchdog.guard`` with
  ``step_deadline_s`` (default ``MXNET_TPU_STEP_DEADLINE_S``), so a hang
  at a Python boundary becomes a recoverable `StallError` (a CUDA call
  cannot be interrupted);
* **rollback-to-last-good**: a `DivergenceError` (the integrity
  sentinel) restores the last committed snapshot and skips the poisoned
  batch (``skip_policy``, ``rollback_budget``);
* **elastic re-layout**: an optional ``mesh_factory`` is polled after
  every restore and, for grow-back, at every checkpoint boundary; when
  the mesh's size changed the runner re-lays the state onto the new mesh
  and rebuilds the step (the ``for_sharded_step`` / ``for_fused_step``
  adapters do it; ``on_shrink`` / ``on_grow`` override). In the port a
  mesh is a set of process ranks: every rank runs the runner in
  lockstep, and a rank outside the current mesh stands by (its steps do
  nothing) until a grow-back takes it in. `mesh_factory` is called on
  every rank at the same points and must not make process groups there
  (make the meshes once, up front, and return one of them);
* **coordinated commit**: with ``commit=`` (a `commit.CommitCoordinator`
  or True) a checkpoint is prepared, the ranks elect the minimum step,
  and only then does the marker move; a restore elects too;
* **proactive preemption**: with ``preempt_listener=`` (a
  `preempt.PreemptionListener` or True), a SIGTERM or maintenance notice
  triggers a checkpoint at the next step boundary, so a resume replays no
  step.

Collectives run in lockstep: every rank enters every snapshot gather,
election and restore in the same order. A fault that fires on one rank
only (a save that dies mid-commit there) surfaces on the others as the
coordinator's timeout (`RetriableError`), not as a hang, and the run
ends; the ranks then start again with ``run(resume=True)`` (with a fresh
`CommitCoordinator` namespace when they stay in the same processes).

Telemetry: ``resilience.checkpoints`` / ``restores`` / ``mesh_shrinks`` /
``mesh_grows`` / ``proactive_checkpoints`` / ``rollbacks`` /
``skipped_batches`` counters, ``ckpt.save_ms``, and ``checkpoint`` /
``restore`` spans.
"""
from __future__ import annotations

import hashlib
import logging
import os
import pickle
import re
import shutil
import time

from . import faults, watchdog
from .errors import (DivergenceError, FatalTrainingError, ResilienceError,
                     RetriableError, TransportError)
from .errors import CheckpointCorruptError
from .retry import RetryPolicy, call_with_retry

__all__ = ["SnapshotCheckpointer", "ResilientRunner", "RunReport",
           "fused_step_state", "restore_fused_step_state"]

_LOG = logging.getLogger("mxnet_tpu_torch.resilience")


# ---------------------------------------------------------------------------
# checkpoint backend
# ---------------------------------------------------------------------------
class SnapshotCheckpointer:
    """Atomic pickled-tree checkpoints with ``keep=N`` retention.

    The backend for host-resident state (the runner's adapters snapshot
    to host tensors). Any object with the same ``prepare/commit/save/
    restore/latest_step`` methods can be passed as ``checkpointer=``.

    Commit protocol: write ``step_N.ckpt.tmp`` → fsync → ``os.replace`` to
    ``step_N.ckpt`` → rewrite the ``LATEST`` marker the same way. A crash at
    any point leaves either the previous committed state or the new one,
    never a torn file.

    The two phases are also exposed separately for coordinated runs:
    ``prepare(step, tree)`` makes the payload durable WITHOUT moving the
    marker, ``commit(step)`` flips the marker — the runner's
    `commit.CommitCoordinator` election sits between them, so the marker
    only ever names a step the whole fleet has. Both phases carry fault
    sites: ``checkpoint.save`` fires after the payload is durable and
    before the marker moves (the crashed-mid-commit shape), and
    ``checkpoint.restore`` fires on the way into a restore.

    Integrity: every payload is stamped with a sha256 sidecar
    (``step_N.ckpt.sha256``) at prepare time and verified on restore. A
    mismatched / truncated / unpicklable payload is counted
    (``checkpoint.corrupt``) and the restore FALLS BACK to the next-oldest
    durable snapshot instead of crashing; only a retention window with no
    good snapshot at all raises `CheckpointCorruptError`. The
    ``checkpoint.corrupt`` fault site (a `faults.transform` site) sits
    between pickling and the atomic write, so a ``corrupt`` plan entry
    flips bytes ON DISK while the sidecar keeps the true digest — the
    injectable torn-disk drill.
    """

    _STEP_RE = re.compile(r"^step_(\d+)\.ckpt$")

    def __init__(self, path, keep=2):
        self.path = os.path.abspath(path)
        self.keep = None if keep in (None, 0) else max(1, int(keep))
        os.makedirs(self.path, exist_ok=True)

    def _file(self, step):
        return os.path.join(self.path, "step_%d.ckpt" % int(step))

    def _digest_file(self, step):
        return self._file(step) + ".sha256"

    def prepare(self, step, tree):
        """Phase 1: make the step's payload durable. The LATEST marker does
        not move — an uncommitted payload is invisible to `latest_step`
        (marker precedence) and to any fleet that elects over committed
        steps. Ends at the ``checkpoint.save`` fault site: an injected
        crash here IS the mid-commit crash."""
        from ..util import atomic_write
        blob = pickle.dumps(tree, protocol=pickle.HIGHEST_PROTOCOL)
        # digest BEFORE the corrupt transform: the sidecar must hold the
        # truth so injected on-disk corruption is detectable, exactly like
        # a real torn write under a checksum stamped at save time
        digest = hashlib.sha256(blob).hexdigest()
        blob = faults.transform("checkpoint.corrupt", blob,
                                context="step=%d payload" % step)
        atomic_write(self._file(step), blob)
        atomic_write(self._digest_file(step), digest.encode())
        faults.check("checkpoint.save", context="step=%d mid-commit" % step)
        return self._file(step)

    def commit(self, step):
        """Phase 2: flip LATEST to `step` and apply retention. Refuses
        (False) when `step`'s payload is not durable here — an elected
        step that predates this rank's retention window must not produce
        a marker pointing at nothing."""
        from ..util import write_latest_marker
        if not os.path.exists(self._file(step)):
            _LOG.warning(
                "checkpoint: not committing step %s — payload missing "
                "under %s (marker unchanged)", step, self.path)
            return False
        write_latest_marker(self.path, step)
        self._retain()
        return True

    def save(self, step, tree):
        self.prepare(step, tree)
        self.commit(step)
        return self._file(step)

    def prepared_steps(self):
        """Every durable payload, committed or not (directory scan)."""
        return self.steps()

    def steps(self):
        out = []
        for name in os.listdir(self.path):
            m = self._STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        """Newest committed step — prefers the LATEST marker, falls back to
        a directory scan (marker lost/corrupt ≠ checkpoints lost)."""
        from ..util import read_latest_marker
        step = read_latest_marker(self.path)
        if step is not None and os.path.exists(self._file(step)):
            return step
        steps = self.steps()
        return steps[-1] if steps else None

    def _load_verified(self, step):
        """Read + verify + unpickle ONE step's payload. Raises ValueError
        on a checksum mismatch / truncation / unpickle failure — the
        caller's fallback walk treats all three identically (the disk
        lied; the sidecar is the truth)."""
        with open(self._file(step), "rb") as f:
            blob = f.read()
        digest_path = self._digest_file(step)
        if os.path.exists(digest_path):
            with open(digest_path, "rb") as f:
                want = f.read().decode().strip()
            got = hashlib.sha256(blob).hexdigest()
            if got != want:
                raise ValueError(
                    "checksum mismatch for step %d: sha256 %s != stamped %s"
                    % (step, got[:12], want[:12]))
        # pre-checksum checkpoints (no sidecar) still get the unpickle
        # sanity net below — never a crash on a truncated payload
        try:
            return pickle.loads(blob)
        except Exception as exc:
            raise ValueError(
                "unpicklable payload for step %d: %s: %s"
                % (step, type(exc).__name__, exc)) from exc

    def restore(self, step=None):
        """Restore `step` (default: newest committed). A corrupt payload —
        checksum mismatch, truncation, unpickle failure — is counted
        (``checkpoint.corrupt``) and the restore falls back to the
        next-oldest durable snapshot; `CheckpointCorruptError` only when
        every candidate is bad."""
        from .. import telemetry as _telem
        from ..telemetry import flight as _flight
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    "no checkpoint under %s" % self.path)
        faults.check("checkpoint.restore", context="step=%d" % step)
        candidates = [step] + [s for s in reversed(self.steps()) if s < step]
        tried = []
        for cand in candidates:
            if not os.path.exists(self._file(cand)):
                continue
            try:
                tree = self._load_verified(cand)
            except ValueError as exc:
                tried.append(cand)
                _telem.inc("checkpoint.corrupt")
                _flight.note_event("checkpoint_corrupt",
                                   "step=%d: %s" % (cand, exc))
                _LOG.warning(
                    "checkpoint: step %d payload is corrupt (%s) — falling "
                    "back to the next-oldest snapshot", cand, exc)
                continue
            if tried:
                _telem.inc("checkpoint.corrupt_fallbacks")
            return cand, tree
        raise CheckpointCorruptError(
            "every snapshot under %s failed verification (steps tried: %s)"
            % (self.path, tried or "none durable"), steps_tried=tried)

    def _retain(self):
        if self.keep is None:
            return
        steps = self.steps()
        for step in steps[:-self.keep]:
            try:
                os.remove(self._file(step))
                if os.path.exists(self._digest_file(step)):
                    os.remove(self._digest_file(step))
            except OSError:  # pragma: no cover — races with manual cleanup
                pass

    def clear(self):
        shutil.rmtree(self.path, ignore_errors=True)
        os.makedirs(self.path, exist_ok=True)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------
class RunReport:
    """What happened: per-step losses plus the recovery ledger."""

    def __init__(self):
        self.losses = []
        self.restarts = 0
        self.retries = 0
        self.steps_executed = 0     # includes replayed steps
        self.replayed_steps = 0     # re-executed after a restore rewind
        self.checkpoints = 0
        self.proactive_ckpts = 0    # checkpoints forced by a preempt notice
        self.mesh_shrinks = 0
        self.mesh_grows = 0
        self.rollbacks = 0          # divergence rollbacks-to-last-good
        self.skipped_batches = 0    # batches skipped past poisoned windows
        self.recovery_time_s = 0.0  # wall time spent inside restores

    def __repr__(self):
        return ("RunReport(steps=%d, executed=%d, replayed=%d, restarts=%d, "
                "retries=%d, checkpoints=%d, proactive=%d, mesh_shrinks=%d, "
                "mesh_grows=%d, rollbacks=%d, skipped_batches=%d, "
                "recovery_time_s=%.3f)"
                % (len(self.losses), self.steps_executed,
                   self.replayed_steps, self.restarts, self.retries,
                   self.checkpoints, self.proactive_ckpts, self.mesh_shrinks,
                   self.mesh_grows, self.rollbacks, self.skipped_batches,
                   self.recovery_time_s))


class ResilientRunner:
    """Drive ``step_fn`` for N steps, surviving retriable faults.

    step_fn(step_idx) -> loss   (must be deterministic given restored state
                                 — replay correctness depends on it)
    state_get() -> pytree       (host-resident snapshot of ALL mutable
                                 training state)
    state_set(tree)             (restore that snapshot in place)

    relayout(mesh) -> step_fn   (optional: re-lay the CURRENT training
                                 state onto `mesh` and return the rebuilt
                                 step — the elastic path; the
                                 `for_sharded_step` / `for_fused_step`
                                 adapters provide it automatically, so a
                                 mesh shrink/grow-back needs no user code.
                                 `on_shrink` / `on_grow` override it.)
    commit                      (True or a `commit.CommitCoordinator`:
                                 two-phase fleet-agreed checkpoints)
    preempt_listener            (True or a `preempt.PreemptionListener`:
                                 proactive checkpoint on SIGTERM /
                                 maintenance notices)
    skip_policy(step, exc)->int (rollback mode: how many batches to skip
                                 past a `DivergenceError` at `step`;
                                 default skip-one)
    rollback_budget             (max CONSECUTIVE rollbacks — no completed
                                 step between them — before escalating to
                                 `FatalTrainingError`; default env
                                 ``MXNET_TPU_ROLLBACK_BUDGET`` or 3)

    Rollback-to-last-good: a `DivergenceError` (the integrity
    sentinel — non-finite bucket/fused-step values, loss spike) is handled
    as its OWN recovery mode, distinct from restore-and-replay: the runner
    restores the last *committed* snapshot, then advances the data stream
    past the poisoned batch window, so the replayed trajectory never
    re-feeds the batch that diverged. Skip windows are bit-deterministic
    (pure step-index arithmetic, RNG/step state rides the snapshot) and
    travel inside dict checkpoints, so a process-level resume preserves
    them. ``step_fn`` receives the skip-adjusted DATA index.
    """

    def __init__(self, step_fn, state_get, state_set, ckpt_dir=None,
                 checkpointer=None, ckpt_every=1, keep=2, max_restarts=3,
                 step_deadline_s=None, retry_policy=None, mesh_factory=None,
                 on_shrink=None, on_grow=None, relayout=None, on_stall=None,
                 commit=None, preempt_listener=None, skip_policy=None,
                 rollback_budget=None):
        if checkpointer is None and ckpt_dir is not None:
            checkpointer = SnapshotCheckpointer(ckpt_dir, keep=keep)
        self.step_fn = step_fn
        self.state_get = state_get
        self.state_set = state_set
        self.ckpt = checkpointer
        self.ckpt_every = max(1, int(ckpt_every))
        self.max_restarts = int(max_restarts)
        self.step_deadline_s = (step_deadline_s
                                if step_deadline_s is not None
                                else watchdog.default_deadline_s())
        self.retry_policy = retry_policy or RetryPolicy()
        self.mesh_factory = mesh_factory
        self.on_shrink = on_shrink
        self.on_grow = on_grow
        self.relayout = relayout
        self.on_stall = on_stall
        if commit is True:
            from .commit import CommitCoordinator
            commit = CommitCoordinator()
        self.commit = commit or None
        self._own_listener = preempt_listener is True
        if preempt_listener is True:
            from .preempt import PreemptionListener
            preempt_listener = PreemptionListener()
        self.preempt_listener = preempt_listener or None
        self.skip_policy = skip_policy or (lambda step, exc: 1)
        if rollback_budget is None:
            try:
                rollback_budget = int(os.environ.get(
                    "MXNET_TPU_ROLLBACK_BUDGET", "3"))
            except (TypeError, ValueError):
                rollback_budget = 3
        self.rollback_budget = max(1, int(rollback_budget))
        # {from_step: batches_to_skip} — the poisoned-window ledger; the
        # effective data index for step s is s + sum(counts at steps <= s)
        self._skip_windows = {}
        self._consecutive_rollbacks = 0
        # last few save durations (rolling, this runner's own saves) —
        # the SIGTERM budgeter's evidence
        from collections import deque
        self._save_ms_window = deque(maxlen=8)
        self._mesh_size = None
        if mesh_factory is not None:
            mesh = mesh_factory()
            self._mesh_size = getattr(getattr(mesh, "devices", None),
                                      "size", None)

    # ------------------------------------------------------------------
    def _save(self, step, report, proactive=False):
        if self.ckpt is None:
            return
        from .. import telemetry as _telem
        from ..telemetry import flight as _flight
        t0 = time.monotonic()
        with _telem.span("checkpoint", "resilience"):
            tree = self.state_get()
            if isinstance(tree, dict) and "comm_schedule" not in tree:
                # the autotuned comm schedule rides the checkpoint, so a
                # relaunch skips the warm-up sweep
                from .. import engine as _engine
                sched = _engine.schedule_payload()
                if sched is not None:
                    tree = dict(tree)
                    tree["comm_schedule"] = sched
            if isinstance(tree, dict) and self._skip_windows \
                    and "integrity_skip" not in tree:
                # poisoned-batch skip windows ride the checkpoint so a
                # process-level resume keeps skipping the same batches
                tree = dict(tree)
                tree["integrity_skip"] = dict(self._skip_windows)
            if self.commit is not None:
                # two-phase: payload durable everywhere before any marker
                # moves; the marker then names the elected step
                self.ckpt.prepare(step, tree)
                elected = self.commit.elect(step, kind="save")
                self.ckpt.commit(step if elected is None else elected)
            else:
                self.ckpt.save(step, tree)
        # the save-cost ledger the SIGTERM budgeter reads: skipping a
        # proactive save is only safe when we KNOW how slow saves run
        save_ms = (time.monotonic() - t0) * 1e3
        _telem.observe("ckpt.save_ms", save_ms)
        self._save_ms_window.append(save_ms)
        _telem.inc("resilience.checkpoints")
        _flight.note_event("proactive_ckpt" if proactive else "checkpoint",
                           "step=%d" % step)
        report.checkpoints += 1
        if proactive:
            _telem.inc("resilience.proactive_checkpoints")
            report.proactive_ckpts += 1

    def _worst_save_ms(self):
        """Max save time over the last few saves THIS runner made, or —
        before its first save — the process-local ckpt.save_ms histogram's
        max as a coarse prior (a previous runner in this process, or a
        caller-seeded estimate; the registry does not survive a process
        relaunch). None with no history at all. A rolling window, not the
        lifetime max: one cold-compile outlier save must not disable
        proactive checkpoints for the rest of a long run once saves are
        fast again."""
        if self._save_ms_window:
            return max(self._save_ms_window)
        from .. import telemetry as _telem
        hist = _telem.registry.get("ckpt.save_ms")
        if hist is None:
            return None
        return hist.snapshot().get("max")

    def _restore(self, report, cause):
        if self.ckpt is None:
            raise cause
        from .. import telemetry as _telem
        t0 = time.monotonic()
        with _telem.span("restore", "resilience"):
            step = self.ckpt.latest_step()
            if self.commit is not None:
                # restore election: every rank rewinds to the step the
                # FLEET committed, not to its own (possibly ahead) marker
                step = self.commit.elect(step, kind="restore")
            if step is None:
                # nothing saved yet (e.g. start_step off the ckpt cadence):
                # the original fault is the story, not the empty dir
                raise cause from None
            try:
                step, tree = self.ckpt.restore(step)
            except FileNotFoundError:
                raise cause from None
            if isinstance(tree, dict) and tree.get("comm_schedule") \
                    is not None:
                from .. import engine as _engine
                _engine.restore_schedule(tree.pop("comm_schedule"))
            if isinstance(tree, dict) and "integrity_skip" in tree:
                # merge by max: in-process windows added AFTER this
                # snapshot was taken must survive the restore (else a
                # second rollback would replay the same poisoned batch)
                for f, c in (tree.pop("integrity_skip") or {}).items():
                    f = int(f)
                    self._skip_windows[f] = max(
                        self._skip_windows.get(f, 0), int(c))
            self.state_set(tree)
        _telem.inc("resilience.restores")
        from ..telemetry import flight as _flight
        _flight.note_event("restore", "step=%d cause=%s"
                           % (step, type(cause).__name__))
        report.restarts += 1
        report.recovery_time_s += time.monotonic() - t0
        _LOG.warning("resilience: restored step %d after %s: %s",
                     step, type(cause).__name__, cause)
        if self._maybe_relayout(report):
            # the snapshots on disk hold the old mesh's layout
            self._save(step, report)
        return step

    def _maybe_relayout(self, report, grow_only=False):
        """Poll the device set; on a change, re-lay the current training
        state onto the new mesh. A shrink means preempted hosts (rebuild
        smaller instead of dying on the next collective); a grow means
        capacity returned (rebuild bigger instead of running degraded
        forever). The `relayout` adapter does the re-laying; `on_shrink` /
        `on_grow` hooks override it. With grow_only=True (the periodic
        checkpoint-boundary poll over LIVE state) a shrink is left for the
        fault path — live arrays on vanished devices must go through
        restore, not relayout. Returns True when the state was re-laid."""
        if self.mesh_factory is None:
            return False
        mesh = self.mesh_factory()
        size = getattr(getattr(mesh, "devices", None), "size", None)
        if size is None or self._mesh_size is None or size == self._mesh_size:
            if not grow_only:
                self._mesh_size = size
            return False
        from .. import telemetry as _telem
        if size < self._mesh_size:
            if grow_only:
                return False
            _telem.inc("resilience.mesh_shrinks")
            report.mesh_shrinks += 1
            hook = self.on_shrink
            _LOG.warning(
                "resilience: device set shrank %d -> %d; degrading to the "
                "smaller mesh", self._mesh_size, size)
        else:
            _telem.inc("resilience.mesh_grows")
            report.mesh_grows += 1
            hook = self.on_grow
            _LOG.warning(
                "resilience: device set grew %d -> %d; re-laying state "
                "back onto the larger mesh", self._mesh_size, size)
        if hook is None:
            hook = self.relayout
        if hook is not None:
            new_step_fn = hook(mesh)
            if new_step_fn is not None:
                self.step_fn = new_step_fn
        self._mesh_size = size
        return True

    # margin over the rolling max save time when deciding whether a
    # proactive save still fits the announced grace window
    _SAVE_BUDGET_MARGIN = 1.5

    def _check_preempt(self, step, report):
        """Step-boundary preemption check: a pending notice triggers an
        immediate (coordinated, off-cadence) checkpoint, then surfaces as
        the `PreemptionError` the recovery path already understands —
        resume replays zero steps instead of a ckpt_every window.

        Deadline awareness: the notice carries the announced grace window
        (~30 s SIGTERM contract). When the remaining window cannot fit the
        rolling max save time (`ckpt.save_ms` × margin), the save is
        SKIPPED — a checkpoint the host dies in the middle of is worse
        than replaying from the last good one — and recovery falls back to
        restore-and-replay."""
        listener = self.preempt_listener
        if listener is None:
            return
        notice = listener.pending()
        if self.commit is not None:
            # the ranks agree: a notice on any rank checkpoints every rank
            # at this boundary (the save's collectives run in lockstep)
            if not self.commit.agree(notice is not None, kind="preempt"):
                return
            if notice is None:
                from .preempt import PreemptionNotice
                notice = PreemptionNotice("another rank's notice", "peer",
                                          grace_s=listener.grace_s)
        elif notice is None:
            return
        from .. import telemetry as _telem
        from ..telemetry import flight as _flight
        from .errors import PreemptionError
        _flight.note_event("preempt_notice",
                           "%s: %s" % (notice.source, notice.reason))
        saved = False
        if self.ckpt is not None:
            remaining_s = notice.remaining_s()
            worst_ms = self._worst_save_ms()
            # no budget at all (stale/late notice, or a long step ate the
            # window) means skip even with no save history — starting a
            # save with zero budget GUARANTEES the torn-write outcome
            over_budget = remaining_s <= 0 or (
                worst_ms is not None and
                worst_ms * self._SAVE_BUDGET_MARGIN / 1e3 > remaining_s)
            if over_budget:
                _telem.inc("resilience.preempt.save_skipped")
                _flight.note_event("preempt_save_skipped",
                                   "worst=%sms remaining=%.1fs"
                                   % ("%.0f" % worst_ms
                                      if worst_ms is not None else "?",
                                      remaining_s))
                _LOG.warning(
                    "preempt: SKIPPING the proactive save — worst save "
                    "%s ms (×%.1f margin) does not fit the %.1f s left "
                    "in the grace window; will restore-and-replay instead",
                    "%.0f" % worst_ms if worst_ms is not None else "?",
                    self._SAVE_BUDGET_MARGIN, remaining_s)
            else:
                self._save(step, report, proactive=True)
                saved = True
        listener.clear()
        raise PreemptionError(
            "preemption notice (%s): %s%s"
            % (notice.source, notice.reason,
               " — proactive checkpoint committed at step %d" % step
               if saved
               else (" (proactive save skipped — grace window too short)"
                     if self.ckpt is not None
                     else " (no checkpointer configured — nothing saved)")))

    def _boundary_check(self, step):
        """The pre-mutation fault boundary: injected/transient transport
        faults raised HERE are retried in place (nothing has changed yet).
        Counted faults deeper in the step go down the restore path."""
        faults.check("run.step", context="step=%d" % step)

    def data_index(self, step):
        """The data-stream index `step` consumes: the step index advanced
        past every skip window at or before it. Pure arithmetic over the
        window ledger — bit-deterministic across replay and resume."""
        if not self._skip_windows:
            return step
        return step + sum(c for f, c in self._skip_windows.items()
                          if f <= step)

    def _run_one(self, step, report):
        def on_retry(attempt, exc):
            report.retries += 1
        call_with_retry(self._boundary_check, step, site="run.step",
                        policy=self.retry_policy,
                        retry_on=lambda e: isinstance(e, TransportError),
                        on_retry=on_retry)
        from . import integrity as _integrity
        _integrity.set_step(step)
        with watchdog.guard("run.step", deadline_s=self.step_deadline_s,
                            on_stall=self.on_stall):
            loss = self.step_fn(self.data_index(step))
        report.steps_executed += 1
        if _integrity.enabled():
            # loss sentinel: non-finite always trips; a rolling-median
            # spike trips when MXNET_TPU_LOSS_SPIKE_FACTOR is set
            _integrity.observe_loss(self._to_float(loss), step)
        return loss

    def _rollback(self, step, exc, report):
        """Divergence recovery: restore the last COMMITTED snapshot, open
        a skip window over the poisoned batch(es), and continue — never an
        in-place retry (the same batch diverges again). A consecutive-
        rollback budget (reset by any completed step) escalates to fatal:
        if skipping batches does not stop the divergence, the problem is
        the run, not the data. Returns the restored step."""
        from .. import telemetry as _telem
        from ..telemetry import flight as _flight
        if self.ckpt is None:
            raise exc
        self._consecutive_rollbacks += 1
        if self._consecutive_rollbacks > self.rollback_budget:
            raise FatalTrainingError(
                "integrity: %d consecutive rollbacks exhausted the budget "
                "(%d) — divergence persists across skipped batches; last "
                "cause: %s" % (self._consecutive_rollbacks,
                               self.rollback_budget, exc)) from exc
        skip_n = max(1, int(self.skip_policy(step, exc)))
        restored = self._restore(report, exc)
        # a rollback is not a restart: it has its own ledger and budget
        report.restarts -= 1
        self._skip_windows[step] = self._skip_windows.get(step, 0) + skip_n
        report.rollbacks += 1
        report.skipped_batches += skip_n
        _telem.inc("resilience.rollbacks")
        _telem.inc("resilience.skipped_batches", skip_n)
        _flight.note_event(
            "rollback", "diverged_step=%d restored=%d skip=%d site=%s"
            % (step, restored, skip_n, getattr(exc, "site", "?")))
        _LOG.warning(
            "integrity: rolled back to step %d after divergence at step %d "
            "(%s); skipping %d batch(es)", restored, step, exc, skip_n)
        return restored

    def run(self, num_steps, start_step=0, resume=False):
        """Run steps ``[start_step, num_steps)``; returns a `RunReport`.

        resume=True restores the newest checkpoint first (auto-resume after
        a process-level kill: relaunch with the same ckpt_dir and resume).
        """
        report = RunReport()
        report.losses = [None] * num_steps
        step = start_step
        if self.preempt_listener is not None:
            self.preempt_listener.start()
        try:
            if resume and self.ckpt is not None \
                    and self.ckpt.latest_step() is not None:
                step = self._restore(report,
                                     RetriableError("process resume"))
                report.restarts -= 1  # a requested resume is not a failure
            frontier = step  # first never-executed step (replay detection)
            last_saved = None
            while step < num_steps:
                if (self.ckpt is not None and step % self.ckpt_every == 0
                        and last_saved != step):
                    self._save(step, report)
                    last_saved = step
                    # grow-back poll: capacity may have returned; re-lay
                    # the live state onto the larger mesh at a safe
                    # (just-checkpointed) boundary, and snapshot its new
                    # layout
                    if self._maybe_relayout(report, grow_only=True):
                        self._save(step, report)
                try:
                    self._check_preempt(step, report)
                    loss = self._run_one(step, report)
                except DivergenceError as exc:
                    # rollback-to-last-good, NOT restore-and-replay: the
                    # poisoned batch is skipped so the replayed trajectory
                    # never re-feeds it
                    step = self._rollback(step, exc, report)
                    last_saved = step  # that snapshot is already on disk
                    continue
                except RetriableError as exc:
                    if report.restarts >= self.max_restarts:
                        _LOG.error(
                            "resilience: restart budget (%d) exhausted",
                            self.max_restarts)
                        raise
                    step = self._restore(report, exc)
                    last_saved = step  # that snapshot is already on disk
                    continue
                self._consecutive_rollbacks = 0  # a completed step resets
                if step < frontier:
                    report.replayed_steps += 1
                else:
                    frontier = step + 1
                report.losses[step] = self._to_float(loss)
                step += 1
        except ResilienceError as exc:
            # the run is dying on a fault recovery could not absorb
            # (restart budget spent, fatal classification, mid-commit
            # wreckage): drop the flight recorder's step ledger to disk
            # BEFORE the exception unwinds the evidence
            from ..telemetry import flight as _flight
            path = _flight.dump_on_crash(
                "%s: %s" % (type(exc).__name__, exc),
                dir_hint=getattr(self.ckpt, "path", None))
            if path:
                _LOG.error("resilience: flight recorder dumped to %s", path)
            raise
        finally:
            if self._own_listener and self.preempt_listener is not None:
                self.preempt_listener.stop()
        return report

    @staticmethod
    def _to_float(loss):
        try:
            return float(loss.asnumpy()) if hasattr(loss, "asnumpy") \
                else float(loss)
        except (TypeError, ValueError):
            return loss

    # ------------------------------------------------------------------
    # adapters
    # ------------------------------------------------------------------
    @classmethod
    def for_fused_step(cls, fused, batch_fn, **kwargs):
        """Wrap a `gluon.FusedTrainStep`: the snapshot covers the net's
        parameters (trainable and auxiliary), the step's optimizer states
        and the optimizer's host bookkeeping (update counts, schedules),
        and the random generators, so kill-and-resume replays the
        uninterrupted run. ``batch_fn(step_idx) -> (data, label)`` must be
        deterministic per index.

        Elastic: with a ``mesh_factory``, a change of mesh rebuilds the
        step for the new mesh (`FusedTrainStep.rebuild_for_mesh`) and
        carries the state across; ``on_shrink``/``on_grow`` override."""

        def build(f):
            if not f._built:
                data, label = batch_fn(0)
                args = list(data) if isinstance(data, (list, tuple)) \
                    else [data]
                f._build(args[0].context, args)
            return f

        active = {"fused": build(fused)}

        def step_fn(i):
            # the ``train.batch`` transform site: a ``corrupt`` entry
            # poisons this batch with NaN (the divergence drill)
            d, l = faults.transform("train.batch", batch_fn(i),
                                    context="index=%d" % i)
            return active["fused"](d, l)

        def relayout(mesh):
            tree = fused_step_state(active["fused"])
            active["fused"] = build(active["fused"].rebuild_for_mesh(mesh))
            restore_fused_step_state(active["fused"], tree)
            return step_fn

        kwargs.setdefault("relayout", relayout)
        runner = cls(step_fn,
                     state_get=lambda: fused_step_state(active["fused"]),
                     state_set=lambda tree: restore_fused_step_state(
                         active["fused"], tree),
                     **kwargs)
        runner.active = active
        return runner

    @classmethod
    def for_sharded_step(cls, step, params, opt_state, batch_fn, **kwargs):
        """Wrap a `parallel.ShardedTrainStep`: the runner owns (params,
        opt_state), this rank's blocks; read the final values off
        ``runner.holder``. ``batch_fn(step_idx)`` returns the global batch
        (deterministic per index); each rank takes its slice
        (`shard_batch` of the active step). A snapshot holds this rank's
        blocks on the host and the mesh they were laid out for (no
        collective: each rank writes its own part); a restore adopts them
        (`ShardedTrainStep.adopt`).

        Elastic: with a ``mesh_factory``, a change of mesh gathers the
        restored (or, on a grow-back, the live) blocks to whole leaves
        over the old mesh, rebuilds the step for the new one
        (`ShardedTrainStep.rebuild_for_mesh`) and lays them out on it
        (`place`); a rank the new mesh leaves out stands by with no state,
        and a rank it takes in receives the state from the mesh's first
        rank. The runner then snapshots the new layout."""
        holder = {"params": params, "opt_state": opt_state}
        active = {"step": step}

        def step_fn(i):
            batch = faults.transform("train.batch", batch_fn(i),
                                     context="index=%d" % i)
            cur = active["step"]
            if not _member(cur.mesh):
                return None
            p, o, loss = cur(holder["params"], holder["opt_state"],
                             cur.shard_batch(batch), i)
            holder["params"], holder["opt_state"] = p, o
            return loss

        def state_get():
            cur = active["step"]
            if not _member(cur.mesh):
                return None
            return {"params": _host(holder["params"]),
                    "opt_state": _host(holder["opt_state"]),
                    "mesh": _mesh_key(cur.mesh)}

        def state_set(tree):
            cur = active["step"]
            if tree is None or not _member(cur.mesh):
                holder["params"] = holder["opt_state"] = None
                return
            if tree["mesh"] != _mesh_key(cur.mesh):
                raise FatalTrainingError(
                    "snapshot laid out for mesh %s, the step runs on %s"
                    % (tree["mesh"], _mesh_key(cur.mesh)))
            holder["params"], holder["opt_state"] = cur.adopt(
                tree["params"], tree["opt_state"])

        def relayout(mesh):
            old = active["step"]
            whole = _gathered(old, holder) if _member(old.mesh) else None
            new = old.rebuild_for_mesh(mesh)
            active["step"] = new
            if not _member(mesh):
                holder["params"] = holder["opt_state"] = None
                return step_fn
            whole = _share(whole, mesh)
            holder["params"], holder["opt_state"] = new.place(
                whole["params"], whole["opt_state"])
            return step_fn

        kwargs.setdefault("relayout", relayout)
        runner = cls(step_fn, state_get, state_set, **kwargs)
        runner.holder = holder
        runner.active = active
        return runner


# ---------------------------------------------------------------------------
# the sharded step's state
# ---------------------------------------------------------------------------
def _mesh_key(mesh):
    """A mesh's ranks and axes as plain data (None without a mesh)."""
    if mesh is None:
        return None
    return (tuple(int(r) for r in mesh.devices.flat),
            tuple(mesh.devices.shape), tuple(mesh.axis_names))


def _member(mesh):
    """True when this process is one of `mesh`'s ranks (always without a
    mesh or a process group)."""
    from ..parallel import dist
    if mesh is None or not dist.has_group():
        return True
    return dist.rank() in set(int(r) for r in mesh.devices.flat)


def _gathered(step, holder):
    """Whole leaves of the holder's blocks on the host, on every rank of
    the step's mesh (collective over it)."""
    from ..parallel.sharding import gather_block
    from ..parallel.mesh import mesh_scope

    def whole(tree):
        if isinstance(tree, dict):
            return {k: whole(v) for k, v in tree.items()}
        return gather_block(tree) if hasattr(tree, "shape") else tree

    with mesh_scope(step.mesh):
        return _host({"params": whole(holder["params"]),
                      "opt_state": whole(holder["opt_state"])})


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().to("cpu", copy=True)
    return tree


def _share(whole, mesh):
    """`whole` on every rank of `mesh`: broadcast from its first rank when
    another rank of it has none (a rank the mesh takes in)."""
    import torch
    from ..parallel import dist
    if not dist.has_group() or mesh.size == 1:
        return whole
    import torch.distributed as tdist
    group = mesh.group(tuple(mesh.axis_names))
    need = torch.tensor([0 if whole is not None else 1])
    tdist.all_reduce(need, group=group)
    if int(need.item()) == 0:
        return whole
    box = [whole]
    tdist.broadcast_object_list(box, src=int(mesh.devices.flat[0]),
                                group=group)
    return box[0]


# ---------------------------------------------------------------------------
# FusedTrainStep state capture
# ---------------------------------------------------------------------------
def _rng_capture():
    """The port's generators (one a context) and the CUDA generators."""
    import torch
    from .. import random as _random
    table = _random._table()
    snap = {"seed": _random._state.seed,
            "gens": [(ctx, g.get_state()) for ctx, g in table.items()],
            "torch": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        snap["cuda"] = torch.cuda.get_rng_state_all()
    return snap


def _rng_restore(snap):
    import torch
    from .. import random as _random
    table = _random._table()
    table.clear()
    _random._state.seed = snap["seed"]
    for ctx, state in snap["gens"]:
        g = torch.Generator(device=ctx.torch_device)
        g.set_state(state)
        table[ctx] = g
    torch.set_rng_state(snap["torch"])
    if "cuda" in snap:
        torch.cuda.set_rng_state_all(snap["cuda"])


def _host_raw(x):
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_host_raw(e) for e in x)
    return x.detach().to("cpu", copy=True)


def _aux_params(fused):
    train = set(id(p) for p in fused._train_params)
    return [p for p in fused._net.collect_params().values()
            if id(p) not in train]


def fused_step_state(fused):
    """A host snapshot of everything a `FusedTrainStep` changes."""
    from ..gluon.fused_step import _raw
    if not fused._built:
        raise RuntimeError(
            "fused_step_state: step not built yet; run one step or use "
            "ResilientRunner.for_fused_step (it builds the step)")
    return {
        "train": [_host_raw(p.data()._data) for p in fused._train_params],
        "other": [_host_raw(p.data()._data) for p in _aux_params(fused)],
        "states": [_host_raw(_raw(s)) for s in fused._states],
        "optimizer": _opt_capture(fused._trainer._optimizer),
        "rng": _rng_capture(),
        "wall_time": time.time(),
    }


# host-side schedule attributes some optimizers carry (Nadam's running
# m_schedule product, LBSGD's lbmult)
_OPT_SCALAR_ATTRS = ("m_schedule", "lbmult")


def _opt_capture(opt):
    """The optimizer's host bookkeeping (not a pickle of the optimizer:
    its param_dict holds live Parameters)."""
    return {
        "num_update": opt.num_update,
        "index_update_count": dict(opt._index_update_count),
        "attrs": {a: getattr(opt, a) for a in _OPT_SCALAR_ATTRS
                  if hasattr(opt, a)},
        "sched": (pickle.dumps(opt.lr_scheduler,
                               protocol=pickle.HIGHEST_PROTOCOL)
                  if opt.lr_scheduler is not None else None),
    }


def _opt_restore(opt, snap):
    opt.num_update = snap["num_update"]
    # in place: _all_index_update_counts[0] aliases this dict
    opt._index_update_count.clear()
    opt._index_update_count.update(snap["index_update_count"])
    for a, v in snap["attrs"].items():
        setattr(opt, a, v)
    if snap["sched"] is not None and opt.lr_scheduler is not None:
        clone = pickle.loads(snap["sched"])
        opt.lr_scheduler.__dict__.update(clone.__dict__)


def _copy_into(dst, src):
    if dst is None or src is None:
        return
    if isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
        return
    dst.copy_(src)


def restore_fused_step_state(fused, tree):
    """The inverse of `fused_step_state`: written back in place."""
    import torch
    from ..gluon.fused_step import _raw
    with torch.no_grad():
        for p, raw in zip(fused._train_params, tree["train"]):
            p.data()._data.copy_(raw)
        for p, raw in zip(_aux_params(fused), tree["other"]):
            p.data()._data.copy_(raw)
        for s, raws in zip(fused._states, tree["states"]):
            _copy_into(_raw(s), raws)
    _opt_restore(fused._trainer._optimizer, tree["optimizer"])
    _rng_restore(tree["rng"])
