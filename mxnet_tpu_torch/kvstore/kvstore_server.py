"""Parameter-server process entry (the port of
`mxnet_tpu.kvstore.kvstore_server`).

In the reference a process started with ``DMLC_ROLE=server`` becomes a
server and never runs the training script. Here the server's state and
optimizer live on the workers (`kvstore_dist.KVStoreDist`), so a server
role has nothing to serve: it keeps the contract (no user training code
runs) by exiting cleanly.
"""
from __future__ import annotations

import logging
import os
import sys

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """The server role's loop; `run()` returns at once."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.init_logging = False

    def _controller(self):
        def server_controller(cmd_id, cmd_body):
            if not self.init_logging:
                header = "%(asctime)-15s Server[" + str(
                    self.kvstore.rank) + "]"
                logging.basicConfig(level=logging.DEBUG,
                                    format=header + " %(message)s")
                self.init_logging = True
        return server_controller

    def run(self):
        logging.getLogger(__name__).info(
            "kvstore server role: the workers hold the store and run its "
            "optimizer; the server process has nothing to serve and exits")


def _init_kvstore_server_module():
    """Exit a process started as ``DMLC_ROLE=server``."""
    if os.environ.get("DMLC_ROLE", "worker") != "worker":
        KVStoreServer(None).run()
        sys.exit(0)
