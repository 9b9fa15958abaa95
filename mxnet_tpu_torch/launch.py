"""Local multi-rank launcher (the port of the ``local`` launcher of the
repo's ``tools/launch.py``).

    python -m mxnet_tpu_torch.launch -n 4 --launcher local \\
        python train.py --kv-store dist_device_sync

starts N worker processes on this host, one per card, each with the
reference's rendezvous variables (``DMLC_ROLE=worker``,
``DMLC_PS_ROOT_URI``, ``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER``,
``DMLC_NUM_SERVER``, ``DMLC_WORKER_ID``) and ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE``; `parallel.dist.initialize` turns them into a NCCL
process group (gloo with ``--backend gloo``). ``CUDA_VISIBLE_DEVICES``
passes through unchanged, so every rank sees every card and NCCL finds
the NVLink peers; rank r computes on card ``LOCAL_RANK`` = r. With more
ranks than cards and no ``--backend`` (NCCL refuses two ranks on one
device), the ranks share the cards round robin (``LOCAL_RANK`` = r mod
cards: all on card 0 when there is one) over gloo, with
``MXNET_TPU_DIST_DEVICE=cuda`` so that each computes on its card. A root URI
of ``file:///path`` rendezvouses through a FileStore on that file instead
of a TCP port.

The first worker to exit with an error ends the others (a dead rank would
leave its peers blocked in a collective), and ``--timeout`` ends the whole
group. ``-s`` is accepted and ignored, as there are no server processes.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["build_env", "launch_local", "main"]


def build_env(rank, num_workers, root_uri="127.0.0.1", root_port=9091,
              num_servers=0, backend=None, base=None, cards=None):
    """The environment of worker `rank`; with `cards` (fewer than the
    workers) it computes on card rank mod cards, over gloo."""
    env = dict(os.environ if base is None else base)
    env.update({
        "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": str(root_uri),
        "DMLC_PS_ROOT_PORT": str(root_port),
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_NUM_SERVER": str(num_servers),
        "DMLC_WORKER_ID": str(rank),
        "LOCAL_RANK": str(rank if not cards else rank % cards),
        "LOCAL_WORLD_SIZE": str(num_workers),
    })
    if cards:
        backend = "gloo"
        env["MXNET_TPU_DIST_DEVICE"] = "cuda"
    if backend:
        env["MXNET_TPU_DIST_BACKEND"] = backend
    return env


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_local(command, num_workers, root_uri="127.0.0.1", root_port=9091,
                 num_servers=0, backend=None, timeout=None, env=None):
    """Run `command` as `num_workers` local processes; returns the first
    nonzero exit code (or 0, or 124 when `timeout` seconds pass). Without
    a backend, more workers than cards share the cards over gloo."""
    cards = None
    if backend is None:
        import torch
        n = torch.cuda.device_count()
        if 0 < n < num_workers:
            cards = n
    elif backend == "nccl":
        import torch
        n = torch.cuda.device_count()
        if n < num_workers:
            raise ValueError(
                "NCCL takes one rank a card: %d ranks, %d cards (leave "
                "--backend out to share the cards over gloo)"
                % (num_workers, n))
    procs = []
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for rank in range(num_workers):
            procs.append(subprocess.Popen(
                command, env=build_env(rank, num_workers, root_uri,
                                       root_port, num_servers, backend,
                                       base=env, cards=cards)))
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                return 124
            time.sleep(0.1)
    finally:
        _stop(procs)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-n", "--num-workers", type=int, required=True)
    parser.add_argument("-s", "--num-servers", type=int, default=0,
                        help="accepted for the reference's command line; "
                             "there are no server processes")
    parser.add_argument("--launcher", default="local", choices=["local"])
    parser.add_argument("--root-uri", default="127.0.0.1")
    parser.add_argument("--root-port", type=int, default=9091)
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    parser.add_argument("--timeout", type=float, default=None,
                        help="seconds before the whole group is ended")
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    if args.num_servers:
        print("note: -s ignored: the workers reduce among themselves",
              file=sys.stderr)
    return launch_local(args.command, args.num_workers, args.root_uri,
                        args.root_port, args.num_servers, args.backend,
                        args.timeout)


if __name__ == "__main__":
    sys.exit(main())
