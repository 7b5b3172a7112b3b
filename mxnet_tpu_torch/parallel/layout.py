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
"""
from __future__ import annotations

import math

import numpy as np
import torch

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

    def shard(self, t, spec, r):
        """Rank ``r``'s shard of the whole tensor ``t`` (a view)."""
        for dim, (start, stop) in enumerate(self.slices(r, t.shape, spec)):
            if stop - start != t.shape[dim]:
                t = t.narrow(dim, start, stop - start)
        return t

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
