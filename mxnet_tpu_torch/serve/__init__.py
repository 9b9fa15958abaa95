"""Continuous-batching inference on the CUDA card (the port of
`mxnet_tpu.serve`).

One replica is an `InferenceServer`: a continuous-batching scheduler over
a refcounted paged KV pool (`KVBlockPool`: fixed-size blocks, free-list,
hash-consed shared-prefix index with copy-on-write) and fixed-shape
programs (`ServePrograms`: a multi-stream chunk-prefill window, a decode
step, a block copy, and with a draft model the draft-k and verify
programs of speculative decoding). Structured `Overloaded` shedding,
deadlines (`DeadlineExceeded`), temperature/top-k/top-p sampling that
draws the JAX package's own tokens, the ``serve.admit`` / ``serve.step``
fault sites, the hang watchdog, drain-and-resume recovery, `ReplicaGroup`
(N replicas over one queue) and a `RequestTrace` per request.

Quickstart::

    import torch
    from mxnet_tpu_torch.models.llama import CONFIGS, llama_init
    from mxnet_tpu_torch.serve import InferenceServer, Request

    cfg = CONFIGS["llama_110m"]
    params = llama_init(torch.Generator("cuda").manual_seed(0), cfg)
    server = InferenceServer(params, cfg).warmup()
    h = server.submit(Request([1, 2, 3], max_new_tokens=32))
    server.run()              # or ReplicaGroup(...).start() for a group
    print(h.result())
"""
from __future__ import annotations

from .errors import DeadlineExceeded, Overloaded, ServeError
from .kv_cache import KVBlockPool
from .programs import (ServePrograms, default_chunk_size,
                       default_prefill_rows, default_spec_k)
from .replica import ReplicaGroup
from .sampling import sample_tokens
from .scheduler import InferenceServer, Request, RequestQueue, StreamHandle

__all__ = ["ServeError", "Overloaded", "DeadlineExceeded", "KVBlockPool",
           "ServePrograms", "default_chunk_size", "default_prefill_rows",
           "default_spec_k", "sample_tokens", "InferenceServer", "Request",
           "RequestQueue", "StreamHandle", "ReplicaGroup"]
