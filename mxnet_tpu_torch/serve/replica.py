"""Replica-group supervision: N serving replicas over one shared queue.

The port of `mxnet_tpu.serve.replica`. Each replica is an
`InferenceServer` on its own thread, with its own KV pool, all admitting
from ONE shared `RequestQueue`. A replica that takes a retriable fault
drains in place (its in-flight streams re-enter the shared queue and
resume by re-prefill); a replica that spends its restart budget dies, and
since the drain comes before the death, its streams are already queued
for the survivors: a killed replica costs requeues, never tokens. The
group is healthy while any replica lives.

On one card the replicas share the card, its default stream and the
interpreter lock: the group gives fault isolation, not two cards' worth
of throughput.

Telemetry: ``serve.replica_deaths`` (from the server), the
``serve.replicas_alive`` gauge and a ``serve_replica_death`` flight-ring
event per death.
"""
from __future__ import annotations

import logging
import threading
import time

from .. import telemetry as _telem
from ..telemetry import flight as _flight
from .errors import ServeError
from .scheduler import InferenceServer, RequestQueue

__all__ = ["ReplicaGroup"]

_LOG = logging.getLogger("mxnet_tpu_torch.serve")


class ReplicaGroup:
    """Usage::

        group = ReplicaGroup(params, cfg, replicas=2).warmup().start()
        handles = [group.submit(r) for r in requests]
        for h in handles:
            h.result(timeout=60)
        group.stop()
    """

    def __init__(self, params, cfg, replicas=2, queue_cap=None,
                 **server_kwargs):
        if replicas < 1:
            raise ValueError("serve: a replica group needs >= 1 replica")
        self.queue = RequestQueue(queue_cap)
        self.servers = [
            InferenceServer(params, cfg, queue=self.queue,
                            name="replica%d" % i, **server_kwargs)
            for i in range(int(replicas))]
        self._threads = []
        self._stop = threading.Event()

    def warmup(self):
        for server in self.servers:
            server.warmup()
        return self

    def _loop(self, server):
        try:
            server.run(stop=self._stop)
        except Exception as exc:  # noqa: BLE001 - a dead replica must not
            # take the group down; _recover already requeued its streams
            server.dead = True
            _LOG.warning("serve: %s died (%s: %s); %d replica(s) remain",
                         server.name, type(exc).__name__, exc,
                         self.alive_replicas)
            _flight.note_event(
                "serve_replica_death", "%s: %s (%d alive)"
                % (server.name, type(exc).__name__, self.alive_replicas))
        finally:
            _telem.set_gauge("serve.replicas_alive", self.alive_replicas)

    def start(self):
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._loop, args=(server,),
                             name="mxnet_tpu_%s" % server.name, daemon=True)
            for server in self.servers]
        for t in self._threads:
            t.start()
        _telem.set_gauge("serve.replicas_alive", self.alive_replicas)
        return self

    def stop(self, timeout=30.0):
        """Stop every replica thread; returns True when all joined."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        joined = not any(t.is_alive() for t in self._threads)
        self._threads = []
        return joined

    @property
    def alive_replicas(self):
        return sum(1 for s in self.servers if not s.dead)

    def submit(self, request):
        """Admit through any live replica (the queue cap and pool geometry
        are the same across the group)."""
        for server in self.servers:
            if not server.dead:
                return server.submit(request)
        raise ServeError("serve: every replica in the group is dead")

    def drain(self, timeout=60.0):
        """Block until the shared queue and every live replica's batch are
        empty; False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.queue) == 0 and all(
                    s.dead or (s._admitting is None
                               and all(slot is None for slot in s._slots))
                    for s in self.servers):
                return True
            time.sleep(0.01)
        return False
