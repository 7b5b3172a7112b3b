"""Device meshes for SPMD programs, in one process or across several.

Counterpart of ``mxnet_tpu/parallel/mesh.py`` (l.23-89). A :class:`Mesh`
names the axes of a grid of ``torch.device``s and records the process
that owns each rank (``processes``). A process drives every rank it
owns, as one JAX program drives the addressable devices of a
``jax.sharding.Mesh``; between the ranks of one process the port's
collectives are tensor operations on their shards, and between processes
they go over ``torch.distributed`` (gloo; ``parallel/collectives.py``
``Span``).

A grid may name the same device more than once: ``["cpu"] * 8`` is the
analogue of the JAX tests' 8 virtual CPU devices, and ``[cuda:0] * 4``
runs a 4-rank ring on one card. On distinct cards a hop between ranks is
a peer copy. A mesh built without ``devices=`` after
``distributed.initialize`` joined several processes spans them all, as
``jax.devices()`` does: its devices are every process's local devices,
process by process, and ``cuda:0`` of process 0 and ``cuda:0`` of process
1 are two ranks. A mesh given ``devices=`` alone belongs to this process.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from .. import distributed

__all__ = ["Mesh", "build_mesh", "data_parallel_mesh", "local_mesh",
           "model_parallel_mesh"]


class Mesh:
    """Named axes over an array of devices.

    ``devices``: an array (nested lists or numpy) of ``torch.device`` or
    device strings, one dimension per axis; ``axis_names``: a name per
    dimension. ``shape`` maps each name to its size, in order, as JAX's
    ``mesh.shape`` does. ``processes`` (the port's own, keyword-only): the
    process that owns each device, an array of the same shape; default
    this process for every rank. ``local_ranks`` are the ranks (row-major
    indices of the device array) this process owns."""

    def __init__(self, devices, axis_names, *, processes=None):
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).ravel()]
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.devices = grid.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise MXNetError("Mesh: %d axis names for a %d-d device array"
                             % (len(self.axis_names), self.devices.ndim))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        me = distributed.process_index()
        if processes is None:
            procs = np.full(len(flat), me, dtype=np.int64)
        else:
            procs = np.asarray(processes, dtype=np.int64).ravel()
            if procs.size != len(flat):
                raise MXNetError("Mesh: %d processes for %d devices"
                                 % (procs.size, len(flat)))
        self.processes = procs.reshape(self.devices.shape)
        self.local_ranks = [r for r, p in enumerate(procs) if p == me]
        if not self.local_ranks:
            raise MXNetError("Mesh: process %d owns no rank of it" % me)

    @property
    def size(self):
        return self.devices.size

    @property
    def is_multiprocess(self):
        """True when ranks of the mesh live in other processes."""
        return len(self.local_ranks) != self.devices.size

    def owner(self, r):
        """The process that owns rank ``r``."""
        return int(self.processes.ravel()[r])

    def local_devices(self):
        """The devices of this process's ranks, in rank order."""
        flat = self.devices.ravel()
        return [flat[r] for r in self.local_ranks]

    def axis_devices(self, name):
        """The devices along axis ``name``, in rank order (at index 0 of
        every other axis)."""
        if name not in self.axis_names:
            raise MXNetError("Mesh: no axis %r (axes: %r)"
                             % (name, self.axis_names))
        ax = self.axis_names.index(name)
        grid = np.moveaxis(self.devices, ax, 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self):
        procs = sorted({int(p) for p in self.processes.ravel()})
        return "Mesh(%s, %s%s)" % (self.shape, sorted(
            {str(d) for d in self.devices.ravel()}),
            ", processes %s" % procs if len(procs) > 1 else "")


def _visible_devices():
    """Every visible CUDA device; there is no silent CPU mesh."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise MXNetError("no CUDA device is visible: pass devices= (e.g. "
                         "['cpu'] * 8) to build a mesh on the host")
    return [torch.device("cuda", i) for i in range(n)]


def _default_devices():
    """(devices, processes): every process's devices once
    ``distributed`` joined several processes, else this process's visible
    CUDA devices."""
    if distributed.process_count() > 1:
        return distributed.devices(), distributed.device_processes()
    return _visible_devices(), None


def build_mesh(axes=None, devices=None, *, processes=None):
    """Build a Mesh from {axis_name: size} over ``devices`` (default:
    every process's devices after ``distributed.initialize`` joined
    several, else every visible CUDA device; a device may repeat). One
    axis may be -1, "use the remaining devices". ``processes`` (the
    port's own): the owner of each device, default this process."""
    if devices is None:
        devices, processes = _default_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if axes is None:
        axes = {"dp": n}
    names = tuple(axes.keys())
    sizes = [int(s) for s in axes.values()]
    n_wild = sum(1 for s in sizes if s == -1)
    if n_wild > 1:
        raise MXNetError("build_mesh: at most one axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_wild == 1:
        if n % fixed != 0:
            raise MXNetError("build_mesh: %d devices not divisible by %d"
                             % (n, fixed))
        sizes = [n // fixed if s == -1 else s for s in sizes]
    total = math.prod(sizes)
    if total > n:
        raise MXNetError("build_mesh: mesh needs %d devices, have %d"
                         % (total, n))
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    if processes is not None:
        processes = np.asarray(list(processes)[:total]).reshape(sizes)
    return Mesh(grid.reshape(sizes), names, processes=processes)


def data_parallel_mesh(n_devices=None, name="dp", devices=None):
    """Pure data-parallel mesh over all (or the first n) devices (every
    process's after ``distributed.initialize`` joined several)."""
    processes = None
    if devices is None:
        devices, processes = _default_devices()
    if n_devices is not None:
        devices = list(devices)[:n_devices]
    return build_mesh({name: len(devices)}, devices, processes=processes)


def local_mesh(devices=None):
    """The default 1-axis mesh over every visible device (every
    process's after ``distributed.initialize`` joined several)."""
    return data_parallel_mesh(devices=devices)


def model_parallel_mesh(tp=None, name="model", devices=None):
    """Single-axis tensor-parallel mesh over ``tp`` devices (all visible
    devices by default), the axis named ``"model"``."""
    if devices is None:
        devices = _visible_devices()
    if tp is None:
        tp = len(devices)
    tp = int(tp)
    if tp < 1:
        raise MXNetError("model_parallel_mesh: tp must be >= 1, got %d"
                         % tp)
    if tp > len(devices):
        raise MXNetError(
            "model_parallel_mesh: tp=%d exceeds the %d visible "
            "devices" % (tp, len(devices)))
    return build_mesh({name: tp}, list(devices)[:tp])
