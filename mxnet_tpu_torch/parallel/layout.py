"""Where each rank's shard of an array lies: the single controller's view
of a ``NamedSharding``.

JAX lays a sharded array out over the devices of a mesh itself; the
port's trainers hold one tensor per rank and move the pieces with the
collectives of ``parallel/collectives.py``. :class:`Layout` answers the
questions that takes, for a :class:`~.mesh.Mesh` and a
:class:`~.shard.PartitionSpec`: which slice of the whole array a rank
holds (:meth:`Layout.shard`), and how the ranks' shards put the whole (or
a part of it) back together (:meth:`Layout.assemble`, an ``all_gather``
along every sharded dimension). A dimension sharded over several axes is
split over their product in row-major order, as JAX splits it.

On a mesh across processes a process holds its ranks alone
(``Layout.local``) and its rows of the global batch:
:meth:`Layout.process_rows` says which (one block, as JAX's
``make_array_from_process_local_data`` wants it) and
:meth:`Layout.shard` takes a rank's slice from them (``row0``); to
assemble from other processes' shards, gather them first
(``collectives.Span.gather``) and hand ``assemble`` a ``pick`` over the
gathered list.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import later_slice

__all__ = ["Layout", "spec_groups"]


def spec_groups(spec, ndim):
    """``[(dim, (axis, ...)), ...]`` for every dimension ``spec`` shards."""
    out = []
    for dim, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        if group:
            out.append((dim, group))
    return out


class Layout:
    """The ranks of ``mesh`` in row-major order of its device array."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axes = tuple(mesh.axis_names)
        self.sizes = dict(mesh.shape)
        self.coords = list(np.ndindex(*mesh.devices.shape))
        self.devices = [mesh.devices[c] for c in self.coords]
        self._rank = {c: r for r, c in enumerate(self.coords)}
        self.local = list(mesh.local_ranks)

    def __len__(self):
        return len(self.coords)

    def index(self, r, axis):
        """Rank ``r``'s index along ``axis``."""
        return self.coords[r][self.axes.index(axis)]

    def moved(self, r, assign):
        """The rank at rank ``r``'s coordinates with the axes of
        ``assign`` (``{axis: index}``) set."""
        c = list(self.coords[r])
        for ax, i in assign.items():
            c[self.axes.index(ax)] = i
        return self._rank[tuple(c)]

    def _piece(self, r, group):
        """(index, count) of rank ``r``'s piece of a dimension split over
        the axes of ``group``."""
        idx, count = 0, 1
        for ax in group:
            idx = idx * self.sizes[ax] + self.index(r, ax)
            count *= self.sizes[ax]
        return idx, count

    def shard_shape(self, shape, spec):
        shape = list(shape)
        for dim, group in spec_groups(spec, len(shape)):
            shape[dim] //= math.prod(self.sizes[a] for a in group)
        return tuple(shape)

    def slices(self, r, shape, spec):
        """Rank ``r``'s slice of an array of ``shape`` as ``(start, stop)``
        per dimension."""
        out = [(0, d) for d in shape]
        for dim, group in spec_groups(spec, len(shape)):
            idx, count = self._piece(r, group)
            size = shape[dim] // count
            out[dim] = (idx * size, (idx + 1) * size)
        return out

    def shard(self, t, spec, r, shape=None, row0=0):
        """Rank ``r``'s shard of the whole tensor ``t`` (a view); or, with
        ``shape`` the global shape, of ``t`` holding the global rows
        ``[row0, row0 + len(t))`` of dimension 0 (this process's rows)."""
        sl = self.slices(r, t.shape if shape is None else shape, spec)
        for dim, (start, stop) in enumerate(sl):
            if dim == 0:
                start, stop = start - row0, stop - row0
            if stop - start != t.shape[dim]:
                t = t.narrow(dim, start, stop - start)
        return t

    def process_rows(self, shape, spec):
        """``(lo, hi)``: the rows of dimension 0 of an array of ``shape``
        that this process's ranks hold together, one block."""
        spans = sorted({tuple(self.slices(r, shape, spec)[0])
                        for r in self.local})
        lo, hi = spans[0][0], spans[-1][1]
        if sum(b - a for a, b in spans) != hi - lo:
            raise later_slice("Layout", "a process whose ranks' rows are "
                              "not one block")
        return lo, hi

    def assemble(self, pick, spec, r, ndim, keep=(), device=None):
        """The array that the shards of the ranks sharing rank ``r``'s
        coordinates make together, whole along every dimension that
        ``spec`` shards over axes outside ``keep`` (the dimensions sharded
        over ``keep`` stay rank ``r``'s piece). ``pick(rank)`` is that
        rank's shard; each piece moves to ``device`` (default rank
        ``r``'s) and the pieces are concatenated, so autograd
        differentiates through the gather. With nothing to gather it
        returns ``pick(r)`` itself."""
        device = self.devices[r] if device is None else torch.device(device)
        dims = [(d, g) for d, g in spec_groups(spec, ndim)
                if not set(g) & set(keep)]
        if not dims:
            return pick(r)

        def rec(k, assign):
            if k == len(dims):
                return pick(self.moved(r, assign)).to(device)
            dim, group = dims[k]
            parts = []
            for idx in np.ndindex(*[self.sizes[a] for a in group]):
                sub = dict(assign)
                sub.update(zip(group, idx))
                parts.append(rec(k + 1, sub))
            return torch.cat(parts, dim) if len(parts) > 1 else parts[0]

        return rec(0, {})

    def distinct(self, shape, spec):
        """One rank for each distinct slice of an array of ``shape``:
        ``[(rank, slices), ...]`` (a replicated array: rank 0 alone)."""
        seen, out = set(), []
        for r in range(len(self.coords)):
            sl = tuple(self.slices(r, shape, spec))
            if sl not in seen:
                seen.add(sl)
                out.append((r, list(sl)))
        return out
