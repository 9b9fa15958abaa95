"""The resilience plane of the port (`mxnet_tpu.resilience`).

``errors``    the retriable-vs-fatal taxonomy and `classify`;
``faults``    deterministic fault injection (``MXNET_TPU_FAULT_PLAN`` or
              ``faults.inject(...)``) at the serving, training, runner,
              checkpoint and preemption-poll sites;
``retry``     `RetryPolicy` (``MXNET_TPU_RETRIES``) and `call_with_retry`;
``watchdog``  turns a hung step into a structured `StallError`
              (``MXNET_TPU_STEP_DEADLINE_S``);
``run``       `ResilientRunner`: periodic atomic checkpoints, retry at the
              step boundary, restore-and-replay with a restart budget,
              rollback-to-last-good past a poisoned batch, and elastic
              re-layout when the mesh of ranks shrinks or grows back;
``commit``    `CommitCoordinator`: the two-phase coordinated commit (the
              ranks elect the minimum step over the rendezvous store
              before any LATEST marker moves);
``preempt``   `PreemptionListener`: SIGTERM and a maintenance-event
              poller (``MXNET_TPU_PREEMPT_POLL_S``) turned into proactive
              checkpoints;
``integrity`` the divergence sentinel (``MXNET_TPU_INTEGRITY=1``): finite
              checks at the kvstore, ZeRO and fused-step sites and a
              loss-spike detector (``MXNET_TPU_LOSS_SPIKE_FACTOR``), which
              raise `DivergenceError` for the runner's rollback (budget
              ``MXNET_TPU_ROLLBACK_BUDGET``).

Everything reports through `mxnet_tpu_torch.telemetry`:
``resilience.faults_injected`` / ``retries`` / ``stalls`` / ``restores`` /
``checkpoints`` / ``proactive_checkpoints`` / ``mesh_shrinks`` /
``mesh_grows`` / ``commit.elections`` / ``preempt.notices`` counters and
spans for backoffs, checkpoints, restores and stalls.
"""
from . import (commit, errors, faults, integrity, preempt, retry,  # noqa: F401
               run, watchdog)
from .commit import CommitCoordinator, elect_step
from .errors import (CheckpointCorruptError, DivergenceError,
                     FatalTrainingError, InjectedFault, PreemptionError,
                     ResilienceError, RetriableError, RetryExhausted,
                     StallError, TransportError, classify, is_retriable)
from .faults import FaultPlan, FaultSpec, inject
from .preempt import PreemptionListener, PreemptionNotice
from .retry import RetryPolicy, call_with_retry, retriable
from .run import ResilientRunner, RunReport, SnapshotCheckpointer
from .watchdog import Watchdog, guard, heartbeat

__all__ = ["errors", "faults", "retry", "watchdog", "run", "commit",
           "preempt", "integrity", "ResilienceError", "RetriableError",
           "TransportError", "InjectedFault", "PreemptionError",
           "StallError", "DivergenceError", "RetryExhausted",
           "FatalTrainingError", "CheckpointCorruptError", "classify",
           "is_retriable", "FaultPlan", "FaultSpec", "inject",
           "RetryPolicy", "call_with_retry", "retriable",
           "ResilientRunner", "RunReport", "SnapshotCheckpointer",
           "Watchdog", "guard", "heartbeat", "CommitCoordinator",
           "elect_step", "PreemptionListener", "PreemptionNotice"]
