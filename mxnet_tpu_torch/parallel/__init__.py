"""Decoding and training: the KV-cache ``Decoder`` derived from a Symbol
LM, the ``ParallelTrainer`` training step over ``make_graph_fn`` (on one
device, or over a mesh with data parallelism, ``ShardingRules``, ZeRO-1,
FSDP and rematerialization), sequence parallelism (ring attention and the
``SequenceParallelTrainer``) and pipeline parallelism
(``PipelineTrainer``): device meshes, partition specs and the collectives
between the ranks of a single-controller SPMD program.

Counterpart of ``mxnet_tpu/parallel/__init__.py``; the axes convention
is its own: dp data, tp tensor, pp pipeline, sp sequence, ep expert."""
from .mesh import (Mesh, build_mesh, data_parallel_mesh,  # noqa: F401
                   local_mesh, model_parallel_mesh)
from .shard import NamedSharding, ShardingRules, P  # noqa: F401
from .decode import Decoder  # noqa: F401
from .graph import (make_graph_fn, make_spmd_graph_fn,  # noqa: F401
                    integer_semantic_inputs)
from .trainer import ParallelTrainer  # noqa: F401
from .sp import SequenceParallelTrainer  # noqa: F401
from . import collectives  # noqa: F401
from .ring import (ring_attention, blockwise_attention,  # noqa: F401
                   ring_self_attention, striped_ring_attention)
from .pipeline import (pipeline_spmd, partition_stages,  # noqa: F401
                       PipelineTrainer)
