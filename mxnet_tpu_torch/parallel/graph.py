"""Symbol graph -> a function on torch tensors.

Counterpart of ``mxnet_tpu/parallel/graph.py`` (l.22-91). The reference
executes a bound graph node by node (``graph_executor.cc:776-819``);
here ``make_graph_fn`` returns a function that walks the graph once per
call, eagerly, and autograd records the walk for the backward. The walk
and the fused-kernel selection live in ``ops.fusion``. The ``Decoder``
keeps its own walk (it swaps the attention nodes for cached variants).

``make_spmd_graph_fn`` is the single-controller counterpart of running
the graph function under JAX's ``shard_map`` (``mxnet_tpu/parallel/sp.py``
l.148-219) or over a GSPMD-sharded batch (``mxnet_tpu/parallel/
trainer.py``): one walk drives every rank of a mesh in lockstep, node by
node, each rank on its own shard.
"""
from __future__ import annotations

import os

import numpy as np

from ..base import MXNetError
from ..ops.fusion import FusionPlan, eval_graph

__all__ = ["make_graph_fn", "make_spmd_graph_fn", "spmd_rings",
           "integer_semantic_inputs"]

# ops that forward their input VALUES unchanged (layout/flow only), so
# integer semantics propagate backwards through them — a label reshaped
# before reaching SoftmaxOutput is still a label
_VALUE_PRESERVING = {"Reshape", "Flatten", "SwapAxis", "BlockGrad"}


def integer_semantic_inputs(symbol):
    """Names of input variables whose values are INDICES (labels, token
    ids) in every use — mixed-precision trainers must not cast them:
    bfloat16 spaces integers 4 apart near 1000, so a cast label or token
    silently retargets every id above 256. A variable qualifies when
    every consumption path, traced through value-preserving ops, ends in
    an argument the op declares via ``OpSpec.integer_arguments``."""
    topo = symbol._topo()
    heads = {(id(h), i) for h, i in symbol._heads}
    uses = {}  # id(node) -> [(consumer, argname)]
    for n in topo:
        if n.is_var:
            continue
        argnames = n.spec.arguments(n.params)
        for (inp, _), aname in zip(n.inputs, argnames):
            uses.setdefault(id(inp), []).append((n, aname))

    int_out = {}  # id(node) -> every use of its output is an index use

    def node_is_int(n):
        if (id(n), 0) in heads:
            return False
        use_list = uses.get(id(n), [])
        if not use_list:
            return False
        for consumer, aname in use_list:
            if aname in consumer.spec.integer_arguments(consumer.params):
                continue
            if consumer.spec.name in _VALUE_PRESERVING \
                    and int_out.get(id(consumer), False):
                continue
            return False
        return True

    for n in reversed(topo):
        if not n.is_var:
            int_out[id(n)] = node_is_int(n)
    return {n.name for n in topo if n.is_var and node_is_int(n)}


def has_host_ops(symbol):
    """True when a node of ``symbol`` runs on the host (a custom Python
    op of ``operator.py``, a ``torch.TorchModuleOp``): it reads device
    values on the host, so a program over the graph cannot be captured as
    a CUDA graph and runs uncaptured (``program.Program(capture=False)``)."""
    return any(getattr(n.spec, "host", False) for n in symbol._topo()
               if not n.is_var)


def make_graph_fn(symbol, allow_fusion=True):
    """Build ``fn(arg_vals, aux_vals, is_train, generator,
    convbn_train=None) -> (outs, new_aux)``.

    ``arg_vals`` is a list in ``symbol.list_arguments()`` order (the
    topological order of variable nodes); ``aux_vals`` a list in
    ``symbol.list_auxiliary_states()`` order; ``generator`` the
    ``torch.Generator`` of the ops that draw at training time (dropout).
    The chains of ``ops.fusion.FusionPlan`` run as one kernel each:
    ``FullyConnected -> Activation`` as ``fused_linear``; ``Convolution ->
    BatchNorm [-> relu]`` as ``fused_conv_bn_act`` on eval and, for 1x1
    convs under ``MXNET_PALLAS_CONVBN_TRAIN=1``, as ``matmul_stats`` in
    training. ``allow_fusion=False`` runs no chain fused (every node its
    own op) unless ``MXNET_PALLAS_FUSION=1``, read here, turns the plan
    back on, as in the JAX package. ``convbn_train`` fixes whether the
    training conv chains run fused; ``None`` reads the gate at the call
    (a caller that builds a program reads it once, at the build)."""
    topo = symbol._topo()
    heads = symbol._heads
    if allow_fusion or os.environ.get("MXNET_PALLAS_FUSION") == "1":
        plan = FusionPlan(topo, heads)
    else:
        plan = None

    def fn(arg_vals, aux_vals, is_train, generator, convbn_train=None):
        outs, new_aux, _ = eval_graph(topo, heads, arg_vals, aux_vals,
                                      is_train, generator, plan=plan,
                                      convbn_train=convbn_train)
        return outs, new_aux

    return fn


def make_spmd_graph_fn(symbol, mesh, allow_fusion=True, span=None):
    """Build ``fn(rank_args, is_train, generators, rank_aux=None) ->
    (outs, new_aux)``, each a list per rank, for the ranks of ``mesh`` in
    row-major order of its device array: on a mesh across processes
    (``mesh.is_multiprocess``), this process's ranks (``mesh.local_ranks``)
    alone.

    ``rank_args[r]`` is rank r's argument list (``list_arguments()``
    order), each value on rank r's device, or a callable of no arguments
    that returns it: the walk calls it where it reaches the variable, so a
    parameter stored as shards is gathered at its use (the trainers pass
    an ``all_gather`` of the ranks' shards). ``rank_aux[r]`` is rank r's
    aux list (``list_auxiliary_states()`` order); ``generators[r]`` its
    ``torch.Generator``.

    The walk goes node by node over all ranks in lockstep: a plain op, or
    a fused chain of ``FusionPlan``, runs once per rank on that rank's
    values; an op whose ``is_collective`` holds (the ring attention
    impls) runs once per ring along its ``axis_name`` param, through
    ``forward_ranks``, with the inputs of the ring's ranks in axis order,
    since a ring hop needs every rank's K/V (a ring is built from the
    whole mesh, :func:`spmd_rings`: ``forward_ranks`` gets the ring
    positions of this process's ranks and a ``collectives.Span`` over the
    ring, through which its hops and deals cross between processes; a
    ring with no rank here is skipped); a training BatchNorm on more
    than one rank normalizes by the statistics of the batch all the ranks
    hold together (``BatchNorm.forward_global``: the ranks' sums are
    added in rank order), as GSPMD gives the JAX package's BatchNorm
    under a ``dp`` sharding, and every rank's moving statistics come out
    the same. ``span`` (a ``collectives.Span``): the walks live in
    several processes and ``mesh`` holds this process's; a training
    BatchNorm then sums over every process's walks, through gloo, also
    with one walk here. The whole walk is one autograd graph.

    ``allow_fusion=False`` runs no chain fused unless
    ``MXNET_PALLAS_FUSION=1`` turns the plan back on (as
    ``make_graph_fn``); the training conv -> BatchNorm chain never fuses
    here, since its statistics would be one rank's."""
    topo = symbol._topo()
    heads = symbol._heads
    if allow_fusion or os.environ.get("MXNET_PALLAS_FUSION") == "1":
        plan = FusionPlan(topo, heads)
    else:
        plan = None
    local = list(mesh.local_ranks)
    ring_cache = {}

    def rings(axis):
        if axis not in ring_cache:
            ring_cache[axis] = spmd_rings(mesh, axis)
        return ring_cache[axis]

    def fn(rank_args, is_train, generators, rank_aux=None):
        envs = [{} for _ in local]
        var_iters = [iter(a) for a in rank_args]
        if rank_aux is None:
            rank_aux = [[] for _ in local]
        new_aux = [list(a) for a in rank_aux]
        cur = 0  # aux cursor, the same on every rank
        for n in topo:
            if n.is_var:
                for env, it in zip(envs, var_iters):
                    v = next(it)
                    env[(id(n), 0)] = v() if callable(v) else v
                continue
            n_aux = len(n.spec.aux_states(n.params))
            if plan is not None and (
                    plan.is_covered(n, is_train, False)
                    or all([plan.execute(n, env, aux, is_train, na, False)
                            for env, aux, na in zip(envs, rank_aux,
                                                    new_aux)])):
                cur += n_aux
                continue
            if n.spec.is_collective(n.params):
                for at, pos, rspan in rings(n.params["axis_name"]):
                    ins = [[envs[r][(id(i), j)] for i, j in n.inputs]
                           for r in at]
                    outs = n.spec.forward_ranks(
                        n.params, ins, is_train,
                        [generators[r] for r in at], pos=pos, span=rspan)
                    for r, ro in zip(at, outs):
                        for j, o in enumerate(ro):
                            envs[r][(id(n), j)] = o
                continue
            ins = [[env[(id(i), j)] for i, j in n.inputs] for env in envs]
            aux_in = [a[cur:cur + n_aux] for a in rank_aux]
            if n_aux and is_train and (len(envs) > 1 or span is not None) \
                    and hasattr(n.spec, "forward_global"):
                outs, aux_out = n.spec.forward_global(n.params, ins, aux_in,
                                                      span)
            else:
                outs, aux_out = zip(*[
                    n.spec.forward(n.params, i, a, is_train, gen)
                    for i, a, gen in zip(ins, aux_in, generators)])
            for env, ro in zip(envs, outs):
                for j, o in enumerate(ro):
                    env[(id(n), j)] = o
            if n_aux:
                for na, ao in zip(new_aux, aux_out):
                    na[cur:cur + n_aux] = list(ao)
            cur += n_aux
        return ([[env[(id(h), i)] for h, i in heads] for env in envs],
                new_aux)

    return fn


def spmd_rings(mesh, axis):
    """The rings along ``axis`` of ``mesh`` that hold ranks of this
    process, in the mesh's order: ``[(at, pos, span), ...]``, ``at`` the
    indices of this process's ranks of the ring among ``mesh.local_ranks``,
    ``pos`` their positions on the ring, ``span`` a ``collectives.Span``
    over the ring's ranks (raising where they are spread unevenly over
    the processes): the ring's hops and deals go through its one-node
    exchanges whether or not they cross, so a ring adds its gradients
    alike in one process and across several."""
    from .collectives import Span
    if axis not in mesh.shape:
        raise MXNetError("the mesh %s has no axis %r for the ring"
                         % (mesh.shape, axis))
    ax = mesh.axis_names.index(axis)
    where = {r: k for k, r in enumerate(mesh.local_ranks)}
    groups = {}
    for r, c in enumerate(np.ndindex(*mesh.devices.shape)):
        groups.setdefault(c[:ax] + c[ax + 1:], []).append(r)
    out = []
    for ring in groups.values():
        pos = [i for i, r in enumerate(ring) if r in where]
        if not pos:
            continue
        out.append(([where[ring[i]] for i in pos], pos,
                    Span([mesh.owner(r) for r in ring])))
    return out
