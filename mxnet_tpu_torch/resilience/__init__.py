"""The resilience plane of the port (`mxnet_tpu.resilience`'s serving
half).

``errors``    the retriable-vs-fatal taxonomy and `classify`;
``faults``    deterministic fault injection (``MXNET_TPU_FAULT_PLAN`` or
              ``faults.inject(...)``) at the ``serve.admit`` and
              ``serve.step`` sites;
``retry``     `RetryPolicy` (``MXNET_TPU_RETRIES``) and `call_with_retry`;
``watchdog``  turns a hung step into a structured `StallError`
              (``MXNET_TPU_STEP_DEADLINE_S``).

Everything reports through `mxnet_tpu_torch.telemetry`:
``resilience.faults_injected`` / ``retries`` / ``stalls`` counters and
spans for backoffs, injected hangs and stalls. Not ported yet:
``commit``, ``integrity``, ``preempt`` and ``run`` (`ResilientRunner`).
"""
from . import errors, faults, retry, watchdog  # noqa: F401
from .errors import (CheckpointCorruptError, DivergenceError,
                     FatalTrainingError, InjectedFault, PreemptionError,
                     ResilienceError, RetriableError, RetryExhausted,
                     StallError, TransportError, classify, is_retriable)
from .faults import FaultPlan, FaultSpec, inject
from .retry import RetryPolicy, call_with_retry, retriable
from .watchdog import Watchdog, guard, heartbeat

__all__ = ["errors", "faults", "retry", "watchdog", "ResilienceError",
           "RetriableError", "TransportError", "InjectedFault",
           "PreemptionError", "StallError", "DivergenceError",
           "RetryExhausted", "FatalTrainingError", "CheckpointCorruptError",
           "classify", "is_retriable", "FaultPlan", "FaultSpec", "inject",
           "RetryPolicy", "call_with_retry", "retriable", "Watchdog",
           "guard", "heartbeat"]
