"""Partition specs: which mesh axis shards each dimension of an array.

Counterpart of ``mxnet_tpu/parallel/shard.py``'s ``P`` (JAX's
``PartitionSpec``): one entry per dimension, the name of the mesh axis
that dimension is split over, or ``None`` for a dimension every rank
holds whole; missing trailing entries are ``None``.
``SequenceParallelTrainer`` reads them in its ``seq_param_rules``;
:class:`NamedSharding` pairs one with a mesh (``Decoder.init_cache(
kv_sharding=NamedSharding(mesh, P(None, None, "model")))``, the JAX
signature). ``ShardingRules`` comes with the FSDP slice of the port.
"""
from __future__ import annotations

__all__ = ["NamedSharding", "P", "PartitionSpec"]


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
