"""KVStore: the data-parallel gradient aggregation API.

Counterpart of ``mxnet_tpu/kvstore.py`` (the reference's
``python/mxnet/kvstore.py`` over ``kvstore_local.h``, ``kvstore_device.h``
and ``kvstore_dist.h``): ``init``, ``push`` and ``pull`` with int or list
keys; a push of several device copies of one key sums them, in the order
given, on the device of the store's copy (the first value the key was
initialized with); with an updater (``_set_updater``, ``set_optimizer``)
the sum is applied to the stored value instead of replacing it; ``pull``
copies the stored value into every output. The types ``local``,
``device``, ``local_update_cpu`` and ``local_allreduce_cpu``/``_device``
are one store.

``dist``/``dist_sync`` keep the same BSP semantics across processes
(``distributed.py``, torch.distributed over gloo): ``init`` broadcasts
rank 0's values in one collective for the whole call; ``push`` merges
this process's copies, then all-reduces across processes in the input
dtype (an integer store stays integer). Arrays of at least
``MXNET_KVSTORE_BIGARRAY_BOUND`` elements (1e6, the reference's bound)
stay REDUCE-SCATTERED, a shard a process, until ``pull`` gathers them
(the reference's range partitioning across servers). The collectives
take the values where they live: gloo is handed the card's tensors and
stages them itself (``ROUTES`` records the device of the tensors each
collective was handed; ``init``'s broadcast moves pickled host copies).
``dist_async`` is the host-driven parameter server of ``kvstore_dist.py``
(update-per-push, no worker lockstep). In one process every ``dist``
type is the local store.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as tdist

from .base import MXNetError
from .ndarray import NDArray
from . import optimizer as opt
from . import telemetry as tele

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu", "device",
          "local_allreduce_device")
_DIST = ("dist", "dist_sync", "dist_async")

# the dist_sync collectives: bytes all-reduced (the merged value, once a
# push) and the wall time of each collective, staging included
_TM_SYNC_BYTES = tele.counter("kvstore.sync_bytes")
_TM_SYNC_MS = tele.histogram("kvstore.sync_ms")

# collective -> the device type of the tensors its last call handed gloo
# ("cuda", "cpu"; "host" for init's broadcast of pickled host copies)
ROUTES = {}


def _bigarray_bound():
    return int(float(os.environ.get("MXNET_KVSTORE_BIGARRAY_BOUND", 1e6)))


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


def _num_processes():
    from . import distributed
    return distributed.num_workers()


def _process_index():
    from . import distributed
    return distributed.rank()


class KVStore:
    """Key -> NDArray store with aggregation semantics."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._sharded = {}  # key -> _ShardedValue (big-array sync path)
        self._updater = None
        self._rng = None    # private rank-synced streams, _call_updater
        self._is_dist = kv_type.startswith("dist")
        self._is_async = kv_type == "dist_async"
        self._ps = None
        if self._is_dist:
            from . import distributed
            distributed.initialize()  # no-op if single-process/already up
        if self._is_async and _num_processes() > 1:
            from .kvstore_dist import PSBackend
            self._ps = PSBackend()

    def init(self, key, value):
        """Initialize key(s) once with a copy of the (first) value. dist:
        every process ends with rank 0's values (the reference's server
        holds one copy of each key, the first init wins), broadcast in
        ONE collective for the whole call."""
        key, vals = _ctype_key_value(key, value)
        for k in key:
            if k in self._store:
                raise MXNetError("key %d already initialized" % k)
        if self._ps is None and self._is_dist and _num_processes() > 1:
            host = [vlist[0]._tensor.detach().cpu() for vlist in vals]
            box = [host if _process_index() == 0 else None]
            tdist.broadcast_object_list(box, src=0)
            ROUTES["broadcast"] = "host"
            for k, vlist, val in zip(key, vals, box[0]):
                v = vlist[0]
                self._store[k] = NDArray(val.to(v._tensor.device),
                                         v.context)
            return
        for k, vlist in zip(key, vals):
            v = vlist[0]
            self._store[k] = v.copyto(v.context)
            if self._ps is not None:
                self._ps.init(k, v.asnumpy())

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
        stored value, else the sum replaces it. dist_sync sums across
        processes first (big arrays stay reduce-scattered while there is
        no updater); dist_async sends the sum to the key's server."""
        key, vals = _ctype_key_value(key, value)
        for k, vlist in zip(key, vals):
            if k not in self._store:
                raise MXNetError("key %d not initialized" % k)
            merged = self._merge(k, vlist)
            if self._ps is not None:
                self._ps.push(k, merged.cpu().numpy())
                continue
            if self._is_dist and _num_processes() > 1:
                red = _allreduce(merged, shard_big=self._updater is None)
                if isinstance(red, _ShardedValue):
                    self._sharded[k] = red
                    continue
                pending = self._sharded.pop(k, None)
                if pending is not None:
                    # an updater was installed after a big-array push:
                    # fold the still-sharded aggregate into the store
                    # first (overwrite semantics) so it is not dropped
                    self._store[k]._set(pending.gather())
                merged = red
            if self._updater is not None:
                self._call_updater(k, NDArray(merged,
                                              self._store[k].context),
                                   self._store[k])
            else:
                self._store[k]._set(merged)

    def _call_updater(self, k, recv, local):
        """Run the updater; under dist_sync with its draws from private
        rank-synced streams (``_sync_rng``): ``mx.random``'s generator of
        the value's device and torch's default generator there (SGLD's
        noise) are swapped for the store's own for the call, so the
        updater draws the same values on every process while user
        streams keep their per-process state."""
        if self._rng is None:
            self._updater(k, recv, local)
            return
        from . import random as mx_random
        dev = local._tensor.device
        seed, gens = self._rng
        if dev not in gens:
            mine = torch.Generator(device=dev).manual_seed(seed)
            dflt = torch.Generator(device=dev).manual_seed(seed + 1)
            gens[dev] = (mine, dflt)
        mine, dflt = gens[dev]
        default = torch.cuda.default_generators[dev.index or 0] \
            if dev.type == "cuda" else torch.default_generator
        user_state = default.get_state()
        user_gens = mx_random._GENERATORS
        mx_random._GENERATORS = dict(user_gens)
        mx_random._GENERATORS[dev] = mine
        default.set_state(dflt.get_state())
        try:
            self._updater(k, recv, local)
        finally:
            dflt.set_state(default.get_state())
            default.set_state(user_state)
            mx_random._GENERATORS = user_gens

    def pull(self, key, out=None, priority=0):
        """Copy the stored value into every output array (reference
        kvstore_local.h Pull's CopyFromTo fan-out). Reduce-scattered big
        arrays are gathered here; async keys are fetched from their
        servers."""
        assert out is not None
        key, outs = _ctype_key_value(key, out)
        for k, olist in zip(key, outs):
            if k not in self._store:
                raise MXNetError("key %d not initialized" % k)
            if self._ps is not None:
                val = torch.from_numpy(np.ascontiguousarray(
                    self._ps.pull(k)))
                for o in olist:
                    o._set(val)
                continue
            if k in self._sharded:
                self._store[k]._set(self._sharded.pop(k).gather())
            src = self._store[k]._tensor
            for o in olist:
                o._set(src)

    def _set_updater(self, updater):
        """Install ``updater(key, recv, local)`` (reference
        _set_updater). dist_async: it runs in the servers, so it must
        pickle; only rank 0 sends it, and the barrier has it installed
        before anyone returns. dist_sync: its draws are made rank-synced
        (``_sync_rng``)."""
        if self._ps is not None:
            if self.rank == 0:
                self._ps.set_optimizer(pickle.dumps(updater))
            self.barrier()
            return
        if self._is_dist and _num_processes() > 1:
            self._sync_rng()
        self._updater = updater

    set_updater = _set_updater

    def _sync_rng(self):
        """dist_sync applies the updater on every process's replica, so
        an updater that draws (SGLD's noise) must draw the same values
        everywhere or the replicas diverge. The private streams are
        seeded from a draw of rank 0's ``mx.random`` CPU stream, all-
        reduced (zeros elsewhere)."""
        from . import random as mx_random
        seed = torch.zeros(1, dtype=torch.int64)
        if self.rank == 0:
            seed[0] = int(torch.randint(
                0, 2 ** 31 - 1, (1,),
                generator=mx_random._generator(torch.device("cpu"))))
        tdist.all_reduce(seed)
        self._rng = (int(seed[0]), {})

    def set_optimizer(self, optimizer):
        """Use an optimizer as the updater. In dist mode the optimizer
        goes through pickle (the reference pickles it to the servers,
        kvstore.py -> kvstore_server.py:36-40), so the same
        serializability contract holds; the local store keeps the object
        itself, as the reference's local path does."""
        if self._is_dist:
            optimizer = pickle.loads(pickle.dumps(optimizer))
        if self._ps is not None:
            if self.rank == 0:  # reference: rank 0 sends, others wait
                self._ps.set_optimizer(pickle.dumps(optimizer))
            self.barrier()
            return
        self._set_updater(opt.get_updater(optimizer))

    @property
    def rank(self):
        return _process_index() if self._is_dist else 0

    @property
    def num_workers(self):
        return _num_processes() if self._is_dist else 1

    def barrier(self):
        """Global barrier (reference Postoffice::Barrier)."""
        if self._is_dist and _num_processes() > 1:
            from . import distributed
            distributed.barrier("kvstore_barrier")

    def send_command_to_servers(self, head, body):
        """A no-op: the servers run in the workers' processes (reference
        SendCommandToServers RPC)."""

    def close(self):
        """Release the async parameter-server sockets (if any), so a new
        dist_async store can bind the ports in the same process."""
        if self._ps is not None:
            self._ps.close()
            self._ps = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _allreduce(val, shard_big=True):
    """The cross-process sum of tensor ``val`` (a fresh merge: a
    contiguous one is summed in place), in its dtype, on its device. For ``shard_big`` values of at least the big-array bound the
    result stays reduce-scattered (a :class:`_ShardedValue`: this
    process's rows of the leading axis, padded to the process count)."""
    t0 = time.perf_counter()
    n = _num_processes()
    big = shard_big and val.numel() >= _bigarray_bound() and val.dim() > 0
    _TM_SYNC_BYTES.inc(val.numel() * val.element_size())
    if big:
        rows = val.shape[0]
        per = -(-rows // n)
        full = val.contiguous()
        if per * n != rows:
            pad = val.new_zeros((per * n - rows,) + tuple(val.shape[1:]))
            full = torch.cat([full, pad])
        shard = val.new_empty((per,) + tuple(val.shape[1:]))
        tdist.reduce_scatter_tensor(shard, full)
        ROUTES["reduce_scatter"] = shard.device.type
        out = _ShardedValue(shard, tuple(val.shape))
    else:
        out = val.contiguous()
        tdist.all_reduce(out)
        ROUTES["all_reduce"] = out.device.type
    _TM_SYNC_MS.observe((time.perf_counter() - t0) * 1e3)
    return out


class _ShardedValue:
    """A reduce-scattered stored value: this process's rows (the leading
    axis padded to the process count); gathered only on pull."""

    def __init__(self, shard, true_shape):
        self.shard = shard
        self.true_shape = tuple(true_shape)

    def gather(self):
        n = _num_processes()
        full = self.shard.new_empty((self.shard.shape[0] * n,)
                                    + tuple(self.shard.shape[1:]))
        tdist.all_gather_into_tensor(full, self.shard)
        ROUTES["all_gather"] = full.device.type
        return full[:self.true_shape[0]].reshape(self.true_shape)


def create(name="local"):
    """Create a KVStore (reference kvstore.py create / kvstore.cc:17-49):
    ``local``, ``local_update_cpu``, ``local_allreduce_cpu``, ``device``
    and ``local_allreduce_device`` in process; ``dist``, ``dist_sync`` and
    ``dist_async`` across the processes of ``distributed.py``."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _LOCAL + _DIST:
        raise MXNetError("unknown KVStore type %s" % name)
    return KVStore(name)
