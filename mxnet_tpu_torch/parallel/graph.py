"""Symbol graph -> a function on torch tensors.

Counterpart of ``mxnet_tpu/parallel/graph.py`` (l.22-91). The reference
executes a bound graph node by node (``graph_executor.cc:776-819``);
here ``make_graph_fn`` returns a function that walks the graph once per
call, eagerly, and autograd records the walk for the backward. The walk
and the fused-kernel selection live in ``ops.fusion``. The ``Decoder``
keeps its own walk (it swaps the attention nodes for cached variants).

``make_spmd_graph_fn`` is the single-controller counterpart of running
the graph function under JAX's ``shard_map`` (``mxnet_tpu/parallel/sp.py``
l.148-219): one walk drives every rank of a mesh in lockstep, node by
node, each rank on its own shard.
"""
from __future__ import annotations

import os

import numpy as np

from ..base import MXNetError
from ..ops.fusion import FusionPlan, eval_graph

__all__ = ["make_graph_fn", "make_spmd_graph_fn", "integer_semantic_inputs"]

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


def make_spmd_graph_fn(symbol, mesh):
    """Build ``fn(rank_args, is_train, generators) -> outs per rank`` for
    the ranks of ``mesh`` in row-major order of its device array.

    ``rank_args[r]`` is rank r's argument list (``list_arguments()``
    order), each value on rank r's device; ``generators[r]`` its
    ``torch.Generator``. The walk goes node by node over all ranks in
    lockstep: a plain op, or a fused chain of ``FusionPlan``, runs once per
    rank on that rank's values; an op whose ``is_collective`` holds (the
    ring attention impls) runs once per ring along its ``axis_name`` param,
    through ``forward_ranks``, with the inputs of the ring's ranks in
    axis order, since a ring hop needs every rank's K/V. The whole walk is
    one autograd graph. Aux states are not supported (no op of the
    sequence-parallel path has any)."""
    if symbol.list_auxiliary_states():
        raise MXNetError("the SPMD walk does not support aux states (%s)"
                         % ", ".join(symbol.list_auxiliary_states()))
    topo = symbol._topo()
    heads = symbol._heads
    plan = FusionPlan(topo, heads)
    coords = list(np.ndindex(*mesh.devices.shape))

    def rings(axis):
        if axis not in mesh.shape:
            raise MXNetError("the mesh %s has no axis %r for the ring"
                             % (mesh.shape, axis))
        ax = mesh.axis_names.index(axis)
        groups = {}
        for r, c in enumerate(coords):
            groups.setdefault(c[:ax] + c[ax + 1:], []).append(r)
        return list(groups.values())

    def fn(rank_args, is_train, generators):
        envs = [{} for _ in coords]
        var_iters = [iter(a) for a in rank_args]
        for n in topo:
            if n.is_var:
                for env, it in zip(envs, var_iters):
                    env[(id(n), 0)] = next(it)
                continue
            if plan.is_covered(n, is_train):
                continue
            if all([plan.execute(n, env, [], is_train) for env in envs]):
                continue
            if n.spec.is_collective(n.params):
                for ring in rings(n.params["axis_name"]):
                    ins = [[envs[r][(id(i), j)] for i, j in n.inputs]
                           for r in ring]
                    outs = n.spec.forward_ranks(
                        n.params, ins, is_train,
                        [generators[r] for r in ring])
                    for r, ro in zip(ring, outs):
                        for j, o in enumerate(ro):
                            envs[r][(id(n), j)] = o
                continue
            for env, gen in zip(envs, generators):
                ins = [env[(id(i), j)] for i, j in n.inputs]
                outs, _ = n.spec.forward(n.params, ins, [], is_train, gen)
                for j, o in enumerate(outs):
                    env[(id(n), j)] = o
        return [[env[(id(h), i)] for h, i in heads] for env in envs]

    return fn
