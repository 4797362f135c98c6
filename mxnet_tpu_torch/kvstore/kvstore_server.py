"""KVStore server-role entry point: a documented pointer.

Counterpart of ``mxnet_tpu/kvstore/kvstore_server.py`` (reference:
python/mxnet/kvstore/kvstore_server.py, the ps-lite server loop started
with DMLC_ROLE=server by tools/launch.py). The port has no server
processes: every rank keeps the parameters and the optimizer state and
gradients reduce through the process group's collectives
(``kvstore/dist.py``). A process started as a server fails fast with that
explanation instead of hanging.
"""
from __future__ import annotations

import os

from ..base import MXNetError

__all__ = ["KVStoreServer", "init_server_module"]

_MSG = ("parameter-server roles do not exist in this port: every rank "
        "keeps the optimizer state and gradients reduce through "
        "torch.distributed collectives (kvstore/dist.py). Launch every "
        "process as a worker (tools/launch.py does this; drop "
        "-s/--num-servers).")


class KVStoreServer:
    """Reference: ``KVStoreServer(kvstore)``. Constructing one is
    accepted; ``run()`` raises the pointer."""

    def __init__(self, kvstore=None):
        self.kvstore = kvstore

    def run(self):
        raise MXNetError(_MSG)


def init_server_module():
    """Called at import: a process with DMLC_ROLE=server fails fast."""
    if os.environ.get("DMLC_ROLE") == "server":
        raise MXNetError(_MSG)
