"""Multi-process runtime initialization.

Counterpart of ``mxnet_tpu/distributed.py`` (the reference's ps-lite
bootstrap: ``DMLC_ROLE``/``DMLC_PS_ROOT_*`` env vars wired by
``tools/launch.py``). Every process is a worker; the cross-process traffic
is ``torch.distributed`` with the **gloo** backend, which runs any number
of ranks on one host and on one card (NCCL refuses two ranks on one GPU).
The bootstrap reads the same env that the unchanged ``tools/launch.py``
sets:

* ``MXNET_TPU_COORDINATOR`` (``host:port``) becomes
  ``init_method="tcp://host:port"``;
* ``MXNET_TPU_NUM_WORKERS`` and ``MXNET_TPU_RANK`` are the world size and
  this process's rank;
* ``MXNET_TPU_LOCAL_DEVICES=N`` (``launch.py --local-devices N``) makes a
  CPU run with N CPU contexts (``local_devices()``) and the CPU the
  default context, as the JAX package gives N virtual CPU devices;
* ``MXNET_TPU_INIT_TIMEOUT`` (seconds, default 600) bounds the join.

With none of them set the process is rank 0 of 1 and nothing is joined.

At the join every process's local devices are gathered into one global,
process-ordered list, :func:`devices` (process 0's first), with the
process that owns each, :func:`device_processes`: the counterpart of the
global ``jax.devices()`` with each device's ``process_index``. A device
may repeat across processes (``cuda:0`` of process 0 and ``cuda:0`` of
process 1 are two ranks of a mesh built over the list).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .context import Context, cpu, gpu

__all__ = ["initialize", "is_initialized", "rank", "num_workers",
           "process_index", "process_count", "local_devices", "devices",
           "device_processes", "barrier", "shutdown"]

_initialized = False
_local = {"count": None}
# the global device list and each device's process, gathered at the join
_global = {"devices": None, "processes": None}


def initialize(coordinator=None, num_processes=None, process_id=None,
               local_device_count=None):
    """Join the process group (gloo) from the arguments, else from the
    ``MXNET_TPU_*`` env that ``tools/launch.py`` sets; with neither, a
    single-process run (nothing to join)."""
    global _initialized
    if _initialized:
        return
    coordinator = coordinator or os.environ.get("MXNET_TPU_COORDINATOR")
    if num_processes is None and "MXNET_TPU_NUM_WORKERS" in os.environ:
        num_processes = int(os.environ["MXNET_TPU_NUM_WORKERS"])
    if process_id is None and "MXNET_TPU_RANK" in os.environ:
        process_id = int(os.environ["MXNET_TPU_RANK"])
    if local_device_count is None and "MXNET_TPU_LOCAL_DEVICES" in os.environ:
        local_device_count = int(os.environ["MXNET_TPU_LOCAL_DEVICES"])
    if local_device_count is not None:
        _local["count"] = int(local_device_count)
        Context.default_ctx = cpu(0)
    init_timeout = int(os.environ.get("MXNET_TPU_INIT_TIMEOUT", 600))
    if num_processes is not None and num_processes > 1:
        if coordinator is None:
            raise ValueError("distributed.initialize: %d processes need a "
                             "coordinator (MXNET_TPU_COORDINATOR)"
                             % num_processes)
        if not dist.is_initialized():
            dist.init_process_group(
                "gloo", init_method="tcp://%s" % coordinator,
                world_size=int(num_processes), rank=int(process_id or 0),
                timeout=datetime.timedelta(seconds=init_timeout))
        mine = [str(c.torch_device) for c in local_devices()]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        _global["devices"] = [torch.device(d) for ds in every for d in ds]
        _global["processes"] = [p for p, ds in enumerate(every)
                                for _ in ds]
    _initialized = True


def is_initialized():
    return _initialized


def rank():
    """This process's rank (reference: kvstore rank / DMLC worker id)."""
    return dist.get_rank() if dist.is_initialized() else 0


def num_workers():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    """This process's index (``jax.process_index()``): its rank."""
    return rank()


def process_count():
    """The number of processes (``jax.process_count()``)."""
    return num_workers()


def local_devices():
    """This process's contexts: ``MXNET_TPU_LOCAL_DEVICES`` CPU contexts
    when set, else every visible card, else the CPU."""
    if _local["count"] is not None:
        return [cpu(i) for i in range(_local["count"])]
    if torch.cuda.is_available():
        return [gpu(i) for i in range(torch.cuda.device_count())]
    return [cpu(0)]


def devices():
    """Every process's devices as ``torch.device``s, process by process
    (the global ``jax.devices()``); this process's alone when no group
    was joined."""
    if _global["devices"] is not None and dist.is_initialized():
        return list(_global["devices"])
    return [c.torch_device for c in local_devices()]


def device_processes():
    """The process that owns each device of :func:`devices`."""
    if _global["processes"] is not None and dist.is_initialized():
        return list(_global["processes"])
    return [process_index()] * len(local_devices())


def barrier(name="mxnet_tpu_barrier"):
    """Global process barrier (reference Postoffice::Barrier): a gloo
    barrier; nothing to wait for in one process."""
    if num_workers() > 1:
        dist.barrier()


def shutdown():
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _global.update(devices=None, processes=None)
    _initialized = False
