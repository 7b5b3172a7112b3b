"""Graph-level fused-kernel selection and the shared graph walk.

Counterpart of ``mxnet_tpu/ops/fusion.py`` (l.71-287): ``FusionPlan``
matches fusible chains in a Symbol's topological order, and
:func:`eval_graph` runs the graph, executing each active chain as one
kernel instead of separate ops. A chain is matched only where each
intermediate output has its next member as sole consumer and is not a
head:

* ``FullyConnected -> Activation`` (relu/sigmoid/tanh), train and eval:
  :func:`~mxnet_tpu_torch.ops.kernels.fused_linear` on the node's own
  ``[N, K]`` weight.
* ``Convolution (one group) -> BatchNorm [-> Activation(relu)]``. Eval:
  the moving statistics (and any conv bias) fold into a per-channel scale
  and bias in the epilogue of
  :func:`~mxnet_tpu_torch.ops.kernels.fused_conv_bn_act`. Train, for a
  1x1 / stride-1 / unpadded / undilated conv only, and only under
  ``MXNET_BN_STATS=auto`` with ``MXNET_PALLAS_CONVBN_TRAIN=1`` (read at
  each walk unless the caller fixes it, as a program does when it is
  built; opt-in as in the JAX package):
  :func:`~mxnet_tpu_torch.ops.kernels.matmul_stats` gives the conv and the
  batch statistics of its output in one kernel, the normalization and
  relu are one elementwise pass, and the moving statistics are written
  into ``new_aux``.

The plan is always on (the JAX package's default on a one-device mesh):
whether a kernel or its plain version runs is decided by the tensors'
device inside the kernel's wrapper.
"""
from __future__ import annotations

import os

import torch

from . import kernels
from .nn import _BN_STATS_MODE

__all__ = ["FusionPlan", "eval_graph"]

_FC_ACTS = ("relu", "sigmoid", "tanh")


def _convbn_train_enabled():
    """The training conv -> BatchNorm chain: only under the one-read
    "auto" statistics (the exact modes are defined by their own passes
    over the activation, which the epilogue replaces), and only with
    ``MXNET_PALLAS_CONVBN_TRAIN=1`` (off by default, as in the JAX
    package, whose TPU measurement found it slower end to end)."""
    if _BN_STATS_MODE() != "auto":
        return False
    return os.environ.get("MXNET_PALLAS_CONVBN_TRAIN") == "1"


class FusionPlan:
    """Static chain matching over a Symbol's topo order."""

    def __init__(self, topo, heads):
        # chains are keyed by their LAST node: when the walk reaches it,
        # every outside input of the chain (e.g. the BatchNorm gamma/beta
        # variables, which sort after the conv) is in env; earlier members
        # are covered (skipped while the chain is active)
        self.chains = {}   # id(last node) -> (kind, [nodes])
        self.covered = {}  # id(earlier node) -> id(last node of its chain)
        self.aux_off = {}  # id(node) -> aux cursor at that node
        cursor = 0
        consumers = {}
        for n in topo:
            if n.is_var:
                continue
            self.aux_off[id(n)] = cursor
            cursor += len(n.spec.aux_states(n.params))
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
            op = n.spec.name
            if op == "FullyConnected":
                act = sole_consumer(n)
                if act is not None and act.spec.name == "Activation" \
                        and act.params.get("act_type") in _FC_ACTS \
                        and act.inputs[0][0] is n:
                    self.chains[id(act)] = ("fc_act", [n, act])
                    self.covered[id(n)] = id(act)
            elif op == "Convolution" and n.params.get("num_group", 1) == 1:
                bn = sole_consumer(n)
                if bn is None or bn.spec.name != "BatchNorm" \
                        or bn.inputs[0][0] is not n:
                    continue
                act = sole_consumer(bn)
                if act is not None and act.spec.name == "Activation" \
                        and act.params.get("act_type") == "relu" \
                        and act.inputs[0][0] is bn:
                    self.chains[id(act)] = ("conv_bn_relu", [n, bn, act])
                    self.covered[id(n)] = id(act)
                    self.covered[id(bn)] = id(act)
                else:
                    self.chains[id(bn)] = ("conv_bn", [n, bn])
                    self.covered[id(n)] = id(bn)

    @staticmethod
    def _conv_is_pointwise(p):
        return (tuple(p["kernel"]) == (1, 1)
                and tuple(p["stride"]) == (1, 1)
                and tuple(p["pad"]) == (0, 0)
                and tuple(p["dilate"]) == (1, 1))

    @classmethod
    def _active(cls, kind, nodes, is_train, convbn_train=None):
        if kind == "fc_act" or not is_train:
            # eval conv+bn folds the moving statistics: always available
            return True
        if convbn_train is None:
            convbn_train = _convbn_train_enabled()
        return convbn_train and cls._conv_is_pointwise(nodes[0].params)

    def is_covered(self, n, is_train, convbn_train=None):
        last_id = self.covered.get(id(n))
        if last_id is None:
            return False
        kind, nodes = self.chains[last_id]
        return self._active(kind, nodes, is_train, convbn_train)

    def execute(self, n, env, aux_vals, is_train, new_aux=None,
                convbn_train=None):
        """If ``n`` ends an active chain, compute the fused result into
        its env slot and return True. ``new_aux`` receives the BatchNorm
        moving-statistics updates of the fused TRAIN chain;
        ``convbn_train`` fixes the train gate (None: read it now)."""
        entry = self.chains.get(id(n))
        if entry is None or not self._active(entry[0], entry[1], is_train,
                                             convbn_train):
            return False
        kind = entry[0]
        if kind == "fc_act":
            return self._execute_fc_act(entry, env)
        if is_train:
            return self._execute_conv_bn_train(entry, env, aux_vals,
                                               new_aux)
        return self._execute_conv_bn_eval(entry, env, aux_vals)

    @staticmethod
    def _execute_fc_act(entry, env):
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

    @staticmethod
    def _bn_inputs(bn, env):
        gamma, beta = (env[(id(inp), idx)] for inp, idx in bn.inputs[1:3])
        if bn.params["fix_gamma"]:
            gamma = torch.ones_like(gamma)
        return gamma, beta

    def _execute_conv_bn_train(self, entry, env, aux_vals, new_aux):
        """The 1x1 conv as ``matmul_stats`` over the NHWC rows of x: the
        batch statistics come from the kernel's epilogue. A conv bias
        cancels out of the normalized output (BatchNorm subtracts the
        batch mean; its gradient is exactly 0, as on the unfused path) and
        only shifts the recorded moving mean."""
        kind, nodes = entry
        conv, bn = nodes[0], nodes[1]
        p, bp = conv.params, bn.params
        ins = [env[(id(inp), idx)] for inp, idx in conv.inputs]
        x, w = ins[0], ins[1]
        gamma, beta = self._bn_inputs(bn, env)
        nb, c, h, wd = x.shape
        nf = p["num_filter"]
        xm = x.permute(0, 2, 3, 1).reshape(-1, c)
        y, s1, s2 = kernels.matmul_stats(xm, w.reshape(nf, c))
        m = xm.shape[0]
        acc = torch.promote_types(x.dtype, torch.float32)
        mean = s1.to(acc) / m
        var = torch.clamp(s2.to(acc) / m - mean.square(), min=0.0)
        inv = torch.rsqrt(var + float(bp["eps"]))
        ga = gamma.to(acc)
        scale = (ga * inv).to(y.dtype)
        shift = (beta.to(acc) - mean * ga * inv).to(y.dtype)
        out = y * scale[None, :] + shift[None, :]
        if kind == "conv_bn_relu":
            out = torch.relu(out)
        env[(id(nodes[-1]), 0)] = \
            out.reshape(nb, h, wd, nf).permute(0, 3, 1, 2)
        rec_mean = mean if p["no_bias"] else mean + ins[2].to(acc)
        off = self.aux_off[id(bn)]
        mmean, mvar = aux_vals[off], aux_vals[off + 1]
        mom = bp["momentum"]
        new_aux[off] = mom * mmean + (1 - mom) * rec_mean.to(mmean.dtype)
        new_aux[off + 1] = mom * mvar + (1 - mom) * var.to(mvar.dtype)
        return True

    def _execute_conv_bn_eval(self, entry, env, aux_vals):
        """Fold the moving statistics: ``scale = gamma / sqrt(var + eps)``,
        ``bias = beta - mean * scale`` (+ the conv bias times scale)."""
        kind, nodes = entry
        conv, bn = nodes[0], nodes[1]
        p = conv.params
        ins = [env[(id(inp), idx)] for inp, idx in conv.inputs]
        gamma, beta = self._bn_inputs(bn, env)
        off = self.aux_off[id(bn)]
        mmean, mvar = aux_vals[off], aux_vals[off + 1]
        inv = gamma * torch.rsqrt(mvar + bn.params["eps"])
        bias = beta - mmean * inv
        if not p["no_bias"]:
            bias = bias + ins[2] * inv
        env[(id(nodes[-1]), 0)] = kernels.fused_conv_bn_act(
            ins[0], ins[1], inv, bias, stride=p["stride"], pad=p["pad"],
            dilate=p["dilate"],
            act="relu" if kind == "conv_bn_relu" else "linear")
        return True


def eval_graph(topo, heads, arg_vals, aux_vals, is_train, generator,
               plan=None, convbn_train=None):
    """The topological walk (the reference's per-node RunOps,
    ``graph_executor.cc:776-819``): every op's ``OpSpec.forward`` on the
    values of its inputs, with the active chains of ``plan`` fused
    (``convbn_train``: see :meth:`FusionPlan.execute`).
    Returns ``(head_outs, new_aux, env)``."""
    env = {}
    var_iter = iter(arg_vals)
    aux_cursor = 0
    new_aux = list(aux_vals)
    for n in topo:
        if n.is_var:
            env[(id(n), 0)] = next(var_iter)
            continue
        n_aux = len(n.spec.aux_states(n.params))
        if plan is not None and (
                plan.is_covered(n, is_train, convbn_train)
                or plan.execute(n, env, aux_vals, is_train, new_aux,
                                convbn_train)):
            # a covered node's output comes from its chain's last node;
            # BatchNorm's aux pass through on eval, and the train chain
            # writes its updates into new_aux itself
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
