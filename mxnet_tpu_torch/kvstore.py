"""KVStore: the data-parallel gradient aggregation API, in one process.

Counterpart of ``mxnet_tpu/kvstore.py`` (l.75-325, ``create`` l.432; the
reference's ``python/mxnet/kvstore.py`` over ``kvstore_local.h`` and
``kvstore_device.h``): ``init``, ``push`` and ``pull`` with int or list
keys; a push of several device copies of one key sums them, in the
order given, on the device of the store's copy (the first value the key
was initialized with); with an updater (``_set_updater``,
``set_optimizer``) the sum is applied to the stored value instead of
replacing it; ``pull`` copies the stored value into every output. The
types ``local``, ``device``, ``local_update_cpu`` and
``local_allreduce_cpu``/``_device`` are one store; the ``dist_*`` types
and the server commands belong to a later slice (with
``torch.distributed``).
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError, later_slice
from .ndarray import NDArray
from . import optimizer as opt

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu", "device",
          "local_allreduce_device")
_DIST = ("dist", "dist_sync", "dist_async")


def _ctype_key_value(key, vals):
    """Normalize (key, values) to (list[int], list[list[NDArray]])."""
    if isinstance(key, (int, np.integer)):
        key = [int(key)]
        vals = [vals]
    else:
        key = [int(k) for k in key]
    norm = []
    for v in vals:
        if isinstance(v, NDArray):
            norm.append([v])
        else:
            norm.append(list(v))
    return key, norm


class KVStore:
    """In-process key -> NDArray store with aggregation semantics."""

    def __init__(self, kv_type="local"):
        if kv_type in _DIST:
            raise later_slice("KVStore", "the distributed store (%s)"
                              % kv_type)
        self.type = kv_type
        self._store = {}
        self._updater = None

    def init(self, key, value):
        """Initialize key(s) once with a copy of the (first) value."""
        key, vals = _ctype_key_value(key, value)
        for k in key:
            if k in self._store:
                raise MXNetError("key %d already initialized" % k)
        for k, vlist in zip(key, vals):
            v = vlist[0]
            self._store[k] = v.copyto(v.context)

    def _merge(self, k, vlist):
        """The sum of the device copies, in order, on the store's device
        (reference kvstore_local.h MergePushValue)."""
        dev = self._store[k]._tensor.device
        merged = vlist[0]._tensor.to(dev, copy=True)
        for v in vlist[1:]:
            merged.add_(v._tensor.to(dev))
        return merged

    def push(self, key, value, priority=0):
        """Push value(s): the copies of one key are summed; with an
        updater, ``updater(key, merged, stored)`` applies the sum to the
        stored value, else the sum replaces it."""
        key, vals = _ctype_key_value(key, value)
        for k, vlist in zip(key, vals):
            if k not in self._store:
                raise MXNetError("key %d not initialized" % k)
            merged = self._merge(k, vlist)
            if self._updater is not None:
                self._updater(k, NDArray(merged, self._store[k].context),
                              self._store[k])
            else:
                self._store[k]._set(merged)

    def pull(self, key, out=None, priority=0):
        """Copy the stored value into every output array (reference
        kvstore_local.h Pull's CopyFromTo fan-out)."""
        assert out is not None
        key, outs = _ctype_key_value(key, out)
        for k, olist in zip(key, outs):
            if k not in self._store:
                raise MXNetError("key %d not initialized" % k)
            src = self._store[k]._tensor
            for o in olist:
                o._set(src)

    def _set_updater(self, updater):
        """Install ``updater(key, recv, local)`` (reference
        _set_updater)."""
        self._updater = updater

    set_updater = _set_updater

    def set_optimizer(self, optimizer):
        """Use an optimizer as the updater (the local store keeps the
        object itself, as the reference's local path does)."""
        self._set_updater(opt.get_updater(optimizer))

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        """A global barrier: nothing to wait for in one process."""

    def send_command_to_servers(self, head, body):
        raise later_slice("KVStore", "the parameter-server commands")

    def close(self):
        """Nothing to release: the local store owns no sockets."""


def create(name="local"):
    """Create a KVStore (reference kvstore.py create): ``local``,
    ``local_update_cpu``, ``local_allreduce_cpu``, ``device`` and
    ``local_allreduce_device`` in process; ``dist``, ``dist_sync`` and
    ``dist_async`` raise "later slice"."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _LOCAL + _DIST:
        raise MXNetError("unknown KVStore type %s" % name)
    return KVStore(name)
