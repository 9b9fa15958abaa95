"""Multi-process rendezvous (the port of `mxnet_tpu.parallel.dist`).

The reference's launchers export the ps-lite rendezvous variables
(``DMLC_PS_ROOT_URI``, ``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER``,
``DMLC_WORKER_ID``); the JAX package hands them to
``jax.distributed.initialize``. Here they become the arguments of
``torch.distributed.init_process_group``: the root URI and port make a TCP
store (``tcp://uri:port``), or, when the URI is a ``file://`` path, a
`FileStore` on that file; the worker count is the world size and the
worker id the rank. Every process is a worker: there are no server or
scheduler roles.

The backend follows the device: NCCL for CUDA tensors (the default: the
port runs on the card), gloo for the CPU (``backend="gloo"`` or
``MXNET_TPU_DIST_BACKEND=gloo``, which the launcher's ``--backend`` sets).
Asking for NCCL
without a card raises; nothing swaps one backend for another. Ranks that
share a card (more ranks than cards: NCCL refuses two ranks on one
device) run gloo on the card: ``MXNET_TPU_DIST_DEVICE=cuda``, which the
launcher sets then, puts a gloo rank's tensors on card ``LOCAL_RANK``,
and `parallel.collectives` stages their collectives through host memory. With no
rendezvous variables and no arguments the process runs alone: no process
group exists and every collective of `parallel.collectives` is the
identity.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as tdist

__all__ = ["initialize", "is_initialized", "rank", "num_workers",
           "local_rank", "backend", "device", "env_spec_from_dmlc",
           "coordinator_client", "shutdown"]

_STATE = {"initialized": False, "rank": 0, "num": 1, "backend": None,
          "local_rank": 0, "owns_group": False}


def env_spec_from_dmlc(env=None):
    """The ``init_process_group`` arguments of the reference's DMLC_*
    variables, or None without ``DMLC_PS_ROOT_URI``. A ``file://`` root URI
    names a FileStore; any other makes ``tcp://uri:port``
    (``DMLC_PS_ROOT_PORT``, default 9091, the reference's)."""
    env = os.environ if env is None else env
    uri = env.get("DMLC_PS_ROOT_URI")
    if not uri:
        return None
    if uri.startswith("file://"):
        init_method = uri
    else:
        init_method = "tcp://%s:%s" % (uri, env.get("DMLC_PS_ROOT_PORT",
                                                    "9091"))
    return {"init_method": init_method,
            "world_size": int(env.get("DMLC_NUM_WORKER", "1")),
            "rank": int(env.get("DMLC_WORKER_ID", env.get("DMLC_RANK", "0")))}


def _pick_backend(backend):
    backend = backend or os.environ.get("MXNET_TPU_DIST_BACKEND") or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "the NCCL backend needs a CUDA card and none is visible; pass "
            "backend='gloo' to run the ranks on the CPU")
    return backend


def initialize(init_method=None, world_size=None, rank=None, backend=None):
    """Join the process group (a no-op once joined). With no arguments the
    DMLC_* variables decide; without them the process runs alone."""
    if _STATE["initialized"]:
        return
    if tdist.is_available() and tdist.is_initialized():
        # a group made by the caller: adopt it
        _STATE.update(initialized=True, rank=tdist.get_rank(),
                      num=tdist.get_world_size(),
                      backend=str(tdist.get_backend()),
                      local_rank=int(os.environ.get("LOCAL_RANK", "0")))
        return
    if init_method is None and world_size is None:
        spec = env_spec_from_dmlc()
        if spec is not None:
            init_method, world_size, rank = (spec["init_method"],
                                             spec["world_size"],
                                             spec["rank"])
    if init_method is None and world_size in (None, 1):
        _STATE.update(initialized=True, rank=0, num=1, backend=None,
                      local_rank=0)
        return
    backend = _pick_backend(backend)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    kwargs = {}
    if backend == "nccl" or _gloo_on_card(backend):
        torch.cuda.set_device(local)
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", local)
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=int(world_size), rank=int(rank or 0),
                             **kwargs)
    _STATE.update(initialized=True, rank=tdist.get_rank(),
                  num=tdist.get_world_size(), backend=backend,
                  local_rank=local, owns_group=True)


def _gloo_on_card(backend):
    return backend == "gloo" and \
        os.environ.get("MXNET_TPU_DIST_DEVICE") == "cuda"


def shutdown():
    """Leave the process group this module made (tests and launch
    scripts end with it, so that no rank exits while a peer still
    talks)."""
    if _STATE["owns_group"] and tdist.is_initialized():
        tdist.destroy_process_group()
    _STATE.update(initialized=False, rank=0, num=1, backend=None,
                  local_rank=0, owns_group=False)


def is_initialized():
    return _STATE["initialized"]


def has_group():
    """True when a torch process group exists (even of one rank)."""
    return tdist.is_available() and tdist.is_initialized()


def rank():
    """This worker's rank (reference: KVStore.rank)."""
    if not _STATE["initialized"] and has_group():
        return tdist.get_rank()
    return _STATE["rank"]


def num_workers():
    """World size (reference: KVStore.num_workers)."""
    if not _STATE["initialized"] and has_group():
        return tdist.get_world_size()
    return _STATE["num"]


def local_rank():
    """The card index of this rank on its host (``LOCAL_RANK``)."""
    return _STATE["local_rank"]


def backend():
    """"nccl", "gloo", or None when the process runs alone."""
    if has_group():
        return str(tdist.get_backend())
    return None


def device():
    """The device this rank computes on: its card under NCCL, the CPU
    under gloo (card ``LOCAL_RANK`` with ``MXNET_TPU_DIST_DEVICE=cuda``:
    ranks sharing a card); alone, the card when there is one (the port's
    default)."""
    be = backend()
    if be == "gloo":
        if _gloo_on_card(be):
            return torch.device("cuda", local_rank())
        return torch.device("cpu")
    if be is None and not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", local_rank())


def coordinator_client():
    """The rendezvous key-value store (a c10d `Store`: set/get/wait and
    counters), or None when the process runs alone."""
    if not has_group():
        return None
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()
