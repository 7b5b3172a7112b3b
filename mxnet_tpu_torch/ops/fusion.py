"""Graph-level fused-kernel selection and the shared graph walk.

Counterpart of ``mxnet_tpu/ops/fusion.py`` (l.71-287): ``FusionPlan``
matches fusible chains in a Symbol's topological order, and
:func:`eval_graph` runs the graph, executing each matched chain as one
kernel instead of separate ops. The port matches the ``fc_act`` chain
only — ``FullyConnected -> Activation`` (relu/sigmoid/tanh), where the
FullyConnected output has that Activation as its sole consumer and is not
a head — and runs it as :func:`~mxnet_tpu_torch.ops.kernels.fused_linear`
on the node's own ``[N, K]`` weight. The Convolution/BatchNorm chains wait
for the CNN slice, which ports those ops.

The plan is always on (the JAX package's default on a one-device mesh):
whether the kernel or its plain version runs is decided by the tensors'
device inside ``fused_linear``.
"""
from __future__ import annotations

from . import kernels

__all__ = ["FusionPlan", "eval_graph"]

_FC_ACTS = ("relu", "sigmoid", "tanh")


class FusionPlan:
    """Static chain matching over a Symbol's topo order."""

    def __init__(self, topo, heads):
        # chains are keyed by their LAST node: when the walk reaches it,
        # every input of the chain is in env; earlier members are covered
        self.chains = {}   # id(last node) -> (kind, [nodes])
        self.covered = {}  # id(earlier node) -> id(last node of its chain)
        consumers = {}
        for n in topo:
            if n.is_var:
                continue
            for inp, idx in n.inputs:
                consumers.setdefault((id(inp), idx), []).append(n)
        head_set = {(id(h), i) for h, i in heads}

        def sole_consumer(node, idx=0):
            if (id(node), idx) in head_set:
                return None
            cs = consumers.get((id(node), idx), [])
            return cs[0] if len(cs) == 1 else None

        for n in topo:
            if n.is_var or id(n) in self.covered:
                continue
            if n.spec.name == "FullyConnected":
                act = sole_consumer(n)
                if act is not None and act.spec.name == "Activation" \
                        and act.params.get("act_type") in _FC_ACTS \
                        and act.inputs[0][0] is n:
                    self.chains[id(act)] = ("fc_act", [n, act])
                    self.covered[id(n)] = id(act)

    def is_covered(self, n):
        return id(n) in self.covered

    def execute(self, n, env):
        """If ``n`` ends a chain, compute the fused result into its env
        slot and return True."""
        entry = self.chains.get(id(n))
        if entry is None:
            return False
        fc, act = entry[1]
        p = fc.params
        ins = [env[(id(inp), idx)] for inp, idx in fc.inputs]
        x = ins[0]
        lead = x.shape[:-1]
        x = x.reshape(x.shape[0], -1) if p["flatten"] \
            else x.reshape(-1, x.shape[-1])
        b = None if p["no_bias"] else ins[2]
        out = kernels.fused_linear(x, ins[1], b, act.params["act_type"])
        if not p["flatten"]:
            out = out.reshape(tuple(lead) + (p["num_hidden"],))
        env[(id(act), 0)] = out
        return True


def eval_graph(topo, heads, arg_vals, aux_vals, is_train, generator,
               plan=None):
    """The topological walk (the reference's per-node RunOps,
    ``graph_executor.cc:776-819``): every op's ``OpSpec.forward`` on the
    values of its inputs, with the chains of ``plan`` fused. Returns
    ``(head_outs, new_aux, env)``."""
    env = {}
    var_iter = iter(arg_vals)
    aux_cursor = 0
    new_aux = list(aux_vals)
    for n in topo:
        if n.is_var:
            env[(id(n), 0)] = next(var_iter)
            continue
        n_aux = len(n.spec.aux_states(n.params))
        if plan is not None and (plan.is_covered(n)
                                 or plan.execute(n, env)):
            aux_cursor += n_aux
            continue
        ins = [env[(id(inp), idx)] for inp, idx in n.inputs]
        aux_in = list(aux_vals[aux_cursor:aux_cursor + n_aux])
        outs, aux_out = n.spec.forward(n.params, ins, aux_in, is_train,
                                       generator)
        for j, o in enumerate(outs):
            env[(id(n), j)] = o
        if n_aux:
            new_aux[aux_cursor:aux_cursor + n_aux] = list(aux_out)
        aux_cursor += n_aux
    outs = [env[(id(h), i)] for h, i in heads]
    return outs, new_aux, env
