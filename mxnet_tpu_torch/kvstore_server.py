"""Server-role entry point — compatibility facade.

Parity: the reference's ``python/mxnet/kvstore_server.py``. In the
reference, a process launched with ``DMLC_ROLE=server`` (or ``scheduler``)
imports this module, which starts a ps-lite ``KVServer`` loop
(``kvstore_server.py:57-68``): the server accumulates pushed gradients per
key, runs the (pickled) optimizer when all workers have pushed
(``src/kvstore/kvstore_dist_server.h:164-202``), and replies to pulls.

Counterpart of ``mxnet_tpu/kvstore_server.py``. There ARE no server
processes: every process launched by ``tools/launch.py`` is a peer
worker; ``dist_sync`` sums over gloo collectives and ``dist_async`` runs a
server thread in every worker (``kvstore_dist.py``). This module keeps the
reference's *contract* for scripts that still set a role env:

* importing it in a process whose role is ``server``/``scheduler`` joins
  the distributed runtime as a plain participant, waits at the global
  barrier until the workers shut down, and exits — so legacy launch
  scripts that spawn server roles don't deadlock the job;
* ``KVStoreServer`` mirrors the command surface (optimizer payload,
  sync-mode flag, stop) so code written against the reference API runs.
"""
from __future__ import annotations

import os
import pickle
import sys

from . import optimizer as opt

__all__ = ["KVStoreServer"]


def _role():
    """Node role, from MXNET_TPU_ROLE or the reference's DMLC_ROLE."""
    return os.environ.get("MXNET_TPU_ROLE",
                          os.environ.get("DMLC_ROLE", "worker"))


class KVStoreServer:
    """Command loop adapter (reference KVStoreServer kvstore_server.py:14-55).

    Commands (head, body) mirror the reference's controller protocol:
    head 0 → body is a pickled Optimizer (install as updater);
    head 1 → sync-mode flag (a no-op: dist_sync is always BSP);
    negative head → stop.
    """

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.init_logging = False
        self._running = True

    def _controller(self, cmd_id, cmd_body):
        if cmd_id < 0:
            self._running = False
        elif cmd_id == 0:
            optimizer = pickle.loads(cmd_body)
            self.kvstore.set_optimizer(optimizer)
        elif cmd_id == 1:
            pass  # kSyncMode: the collectives are always BSP
        else:
            raise ValueError("unknown server command %d" % cmd_id)

    def run(self):
        """Block until the job's workers finish (reference: ps-lite
        ``RunServer`` blocks in exec_.Start until a stop command)."""
        from . import distributed
        distributed.initialize()
        distributed.barrier("kvstore_server_exit")


def _init_server_module():
    """Reference kvstore_server.py:57-68: non-worker roles run the server
    loop on import and never return to user code."""
    role = _role()
    if role in ("server", "scheduler"):
        from . import kvstore
        server = KVStoreServer(kvstore.create("dist"))
        server.run()
        sys.exit(0)


_init_server_module()
