"""Device meshes for single-controller SPMD programs.

Counterpart of ``mxnet_tpu/parallel/mesh.py`` (l.23-89). A :class:`Mesh`
names the axes of a grid of ``torch.device``s; one Python process drives
every rank of it, as one JAX program drives every device of a
``jax.sharding.Mesh`` (the port's collectives are tensor operations
between the ranks' shards, ``parallel/collectives.py``).

A grid may name the same device more than once: ``["cpu"] * 8`` is the
analogue of the JAX tests' 8 virtual CPU devices, and ``[cuda:0] * 4``
runs a 4-rank ring on one card. On distinct cards a hop between ranks is
a peer copy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Mesh", "build_mesh", "data_parallel_mesh", "local_mesh",
           "model_parallel_mesh"]


class Mesh:
    """Named axes over an array of devices.

    ``devices``: an array (nested lists or numpy) of ``torch.device`` or
    device strings, one dimension per axis; ``axis_names``: a name per
    dimension. ``shape`` maps each name to its size, in order, as JAX's
    ``mesh.shape`` does."""

    def __init__(self, devices, axis_names):
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

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, sorted(
            {str(d) for d in self.devices.ravel()}))


def _visible_devices():
    """Every visible CUDA device; there is no silent CPU mesh."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise MXNetError("no CUDA device is visible: pass devices= (e.g. "
                         "['cpu'] * 8) to build a mesh on the host")
    return [torch.device("cuda", i) for i in range(n)]


def build_mesh(axes=None, devices=None):
    """Build a Mesh from {axis_name: size} over ``devices`` (default:
    every visible CUDA device; a device may repeat). One axis may be -1,
    "use the remaining devices"."""
    if devices is None:
        devices = _visible_devices()
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
    return Mesh(grid.reshape(sizes), names)


def data_parallel_mesh(n_devices=None, name="dp", devices=None):
    """Pure data-parallel mesh over all (or the first n) devices."""
    if devices is None:
        devices = _visible_devices()
    if n_devices is not None:
        devices = list(devices)[:n_devices]
    return build_mesh({name: len(devices)}, devices)


def local_mesh(devices=None):
    """The default 1-axis mesh over every visible device."""
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
