"""Partition specs and sharding rules: which mesh axis shards each
dimension of an array.

Counterpart of ``mxnet_tpu/parallel/shard.py`` (l.1-115). ``P`` (JAX's
``PartitionSpec``) has one entry per dimension: the name of the mesh axis
that dimension is split over (or a tuple of names, split over their
product in row-major order), or ``None`` for a dimension every rank holds
whole; missing trailing entries are ``None``. :class:`NamedSharding`
pairs one with a mesh (``Decoder.init_cache(kv_sharding=NamedSharding(
mesh, P(None, None, "model")))``, the JAX signature).
:class:`ShardingRules` maps parameter names and shapes to specs by regex,
first match wins (the name-pattern dispatch the reference uses for
initializers); ``ParallelTrainer`` stores each parameter, and each input,
one shard per rank as they say. ``SequenceParallelTrainer`` reads specs in
its ``seq_param_rules``.
"""
from __future__ import annotations

import re

__all__ = ["NamedSharding", "P", "PartitionSpec", "ShardingRules"]


class PartitionSpec(tuple):
    """``P("sp", None)``: a tuple of mesh axis names (or ``None``) per
    dimension; ``P()`` replicates."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(%s)" % ", ".join(repr(p) for p in self)


P = PartitionSpec


class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`~.mesh.Mesh` (the record
    ``jax.sharding.NamedSharding`` is): ``mesh`` and ``spec``, nothing
    else. The single controller reads it to lay a tensor out as one shard
    per rank of the named axis."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


class ShardingRules:
    """Maps names and shapes to NamedShardings over a mesh.

    Parameters
    ----------
    mesh : parallel.Mesh
    param_rules : list of (name_regex, PartitionSpec)
        First match wins; an unmatched parameter is replicated. A spec
        entry that names an axis the mesh lacks, or whose axes' product
        does not divide the dimension, is dropped (that dimension is then
        replicated), so one rule set works across mesh sizes.
    data_axes : tuple of axis names
        Shard the leading (batch) dimension of every data/label input
        over them. Default: ``("dp",)`` when the mesh has ``dp``, else
        none.
    seq_axes : tuple of axis names
        Shard the second (sequence) dimension of rank >= 2 inputs over
        them. Default: none.
    """

    def __init__(self, mesh, param_rules=(), data_axes=None,
                 seq_axes=None):
        self.mesh = mesh
        self.param_rules = [(re.compile(pat), spec)
                            for pat, spec in param_rules]
        if data_axes is None:
            data_axes = tuple(a for a in ("dp",) if a in mesh.shape)
        self.data_axes = tuple(a for a in data_axes if a in mesh.shape)
        self.seq_axes = tuple(a for a in (seq_axes or ())
                              if a in mesh.shape)

    def _fit_spec(self, spec, shape):
        """Drop the entries that name no axis of the mesh or do not divide
        the shape; trailing Nones go."""
        out = []
        for i, names in enumerate(spec):
            if names is None or i >= len(shape):
                out.append(None)
                continue
            group = names if isinstance(names, tuple) else (names,)
            keep = [ax for ax in group if ax in self.mesh.shape]
            size = 1
            for ax in keep:
                size *= self.mesh.shape[ax]
            if keep and shape[i] % size == 0:
                out.append(tuple(keep) if len(keep) > 1 else keep[0])
            else:
                out.append(None)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def param_spec(self, name, shape):
        for pat, spec in self.param_rules:
            if pat.search(name):
                return self._fit_spec(spec, shape)
        return P()

    def data_spec(self, name, shape):
        def fit(axes, dim):
            size = 1
            for ax in axes:
                size *= self.mesh.shape[ax]
            if not axes or dim % size != 0:
                return None
            return axes if len(axes) > 1 else axes[0]

        if not shape:
            return P()
        batch = fit(self.data_axes, shape[0])
        seq = fit(self.seq_axes, shape[1]) if len(shape) > 1 else None
        if seq is None:
            return P(batch) if batch is not None else P()
        return P(batch, seq)

    def param_sharding(self, name, shape):
        return NamedSharding(self.mesh, self.param_spec(name, shape))

    def data_sharding(self, name, shape):
        return NamedSharding(self.mesh, self.data_spec(name, shape))

    def replicated(self):
        return NamedSharding(self.mesh, P())
