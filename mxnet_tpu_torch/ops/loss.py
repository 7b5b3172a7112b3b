"""Output (loss) operators.

Counterpart of ``mxnet_tpu/ops/loss.py``: ``SoftmaxOutput`` (l.43, after
the reference's ``softmax_output-inl.h``), the regression outputs
(l.100-135, ``regression_output-inl.h``), ``SoftmaxCELoss`` (l.140-200)
and ``IdentityAttachKLSparseReg`` (l.217,
``identity_attach_KL_sparse_reg-inl.h``). The reference's loss
contract is kept: a loss layer IGNORES the incoming head gradient (so a
backward with no head gradients, or with ones, "just works") and its
gradient is SUMMED over the batch — the optimizer's ``rescale_grad``
handles 1/batch. Each is a ``torch.autograd.Function``, so the rest of
the graph differentiates through plain autograd. The decoder strips the loss
head (``parallel.decode._logits_symbol``).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import OpSpec, Param, register, shape_assign


class _SoftmaxOutputFn(torch.autograd.Function):
    """softmax(data) over ``axis``; the data gradient is
    ``(p - onehot(label)) * grad_scale``, zeroed where ``label ==
    ignore`` (when ``ignore`` is not None), whatever the head gradient.
    Labels outside [0, classes) have no one-hot entry, as
    ``jax.nn.one_hot`` gives none. No gradient reaches the label."""

    @staticmethod
    def forward(ctx, data, label, axis, grad_scale, ignore):
        # over the last axis of the moved view: for the LM's [B, V, T]
        # (a SwapAxis view of contiguous [B, T, V] logits) that is the
        # contiguous layout, where the softmax kernel is fast
        out = torch.softmax(data.movedim(axis, -1), dim=-1).movedim(-1, axis)
        ctx.save_for_backward(out, label)
        ctx.cfg = (axis, grad_scale, ignore)
        return out

    @staticmethod
    def backward(ctx, g):
        del g  # reference loss layers ignore head gradients
        out, label = ctx.saved_tensors
        axis, grad_scale, ignore = ctx.cfg
        nclass = out.shape[axis]
        idx = label.detach().long()
        hit = ((idx >= 0) & (idx < nclass)).to(out.dtype)
        grad = out.clone()
        grad.scatter_add_(axis, idx.clamp(0, nclass - 1).unsqueeze(axis),
                          -hit.unsqueeze(axis))
        if grad_scale != 1.0:
            grad = grad * grad_scale
        if ignore is not None:
            grad = grad * (label != ignore).to(out.dtype).unsqueeze(axis)
        return grad, None, None, None, None


@register
class SoftmaxOutput(OpSpec):
    """Softmax + fused cross-entropy gradient (``softmax_output-inl.h``);
    ``multi_output`` is the per-position softmax over axis 1."""

    name = "SoftmaxOutput"
    aliases = ("Softmax",)
    params = {"grad_scale": Param("float", 1.0),
              "ignore_label": Param("float", -1.0),
              "multi_output": Param("bool", False),
              "use_ignore": Param("bool", False)}

    def arguments(self, p):
        return ["data", "label"]

    def integer_arguments(self, p):
        return ("label",)  # class ids — bf16 casts would corrupt >256

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return list(in_shapes), [None], []
        if p["multi_output"]:
            lshape = (d[0],) + tuple(d[2:])
        else:
            lshape = (d[0],)
        ins = [d, shape_assign(in_shapes[1], lshape, "SoftmaxOutput label")]
        return ins, [d], []

    def forward(self, p, ins, aux, is_train, generator):
        data, label = ins
        axis = 1 if p["multi_output"] else data.dim() - 1
        ignore = p["ignore_label"] if p["use_ignore"] else None
        return [_SoftmaxOutputFn.apply(data, label, axis, p["grad_scale"],
                                       ignore)], []


class _RegressionFn(torch.autograd.Function):
    """``out_fn(data)``; the data gradient is ``grad_fn(out, label) *
    grad_scale`` with the label reshaped to the output's shape (a ``(N,)``
    label for ``(N, 1)`` data), whatever the head gradient (the JAX
    package's ``_loss_vjp``, l.22-39). No gradient reaches the label."""

    @staticmethod
    def forward(ctx, data, label, out_fn, grad_fn, grad_scale):
        out = out_fn(data)
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_fn, grad_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        del g  # reference loss layers ignore head gradients
        out, label = ctx.saved_tensors
        grad_fn, grad_scale = ctx.cfg
        grad = grad_fn(out, label.reshape(out.shape)) * grad_scale
        return grad, None, None, None, None


def _regression(opname, out_fn, grad_fn):
    @register
    class _Reg(OpSpec):
        name = opname
        params = {"grad_scale": Param("float", 1.0)}

        def arguments(self, p):
            return ["data", "label"]

        def infer_shape(self, p, in_shapes):
            d = in_shapes[0]
            if d is None:
                return list(in_shapes), [None], []
            # label matches data, but a (N,) label is accepted for (N,1) data
            l = in_shapes[1]
            if l is not None and tuple(l) != tuple(d) \
                    and tuple(l) != tuple(d[:-1]):
                raise MXNetError("%s: label shape %s vs data %s"
                                 % (opname, l, d))
            return [d, l or d], [d], []

        def forward(self, p, ins, aux, is_train, generator):
            return [_RegressionFn.apply(ins[0], ins[1], out_fn, grad_fn,
                                        p["grad_scale"])], []
    _Reg.__name__ = "Op" + opname
    return _Reg


# regression_output-inl.h: Linear (identity, out - label), Logistic
# (sigmoid, out - label), MAE (identity, sign(out - label))
_regression("LinearRegressionOutput", lambda d: d.clone(),
            lambda o, l: o - l)
_regression("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l)
_regression("MAERegressionOutput", lambda d: d.clone(),
            lambda o, l: torch.sign(o - l))


class _SoftmaxCELossFn(torch.autograd.Function):
    """The per-row loss ``lse(z) - z[label]`` over the last axis, in f32,
    labels clipped to [0, classes), zero where ``label == ignore`` (when
    ``ignore`` is not None). The forward never forms the probabilities;
    the residual is the LOGITS, and the backward forms ``(softmax(z) -
    onehot(label)) * grad_scale`` once, in f32 (no one-hot entry for a
    label outside [0, classes), as ``jax.nn.one_hot`` gives none), zeroed
    at ignored rows, whatever the head gradient: ``SoftmaxOutput``'s
    gradient, so training through either head updates the parameters
    alike. No gradient reaches the label."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore):
        nclass = data.shape[-1]
        z = data.float()
        idx = label.detach().long().clamp(0, nclass - 1)
        loss = torch.logsumexp(z, dim=-1) \
            - z.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
        if ignore is not None:
            loss = torch.where(label == ignore, torch.zeros_like(loss),
                               loss)
        ctx.save_for_backward(data, label)
        ctx.cfg = (grad_scale, ignore)
        return loss

    @staticmethod
    def backward(ctx, g):
        del g  # reference loss layers ignore head gradients
        data, label = ctx.saved_tensors
        grad_scale, ignore = ctx.cfg
        nclass = data.shape[-1]
        grad = torch.softmax(data.float(), dim=-1)
        idx = label.detach().long()
        hit = ((idx >= 0) & (idx < nclass)).to(grad.dtype)
        grad.scatter_add_(-1, idx.clamp(0, nclass - 1).unsqueeze(-1),
                          -hit.unsqueeze(-1))
        if grad_scale != 1.0:
            grad.mul_(grad_scale)
        if ignore is not None:
            grad.mul_((label != ignore).to(grad.dtype).unsqueeze(-1))
        return grad.to(data.dtype), None, None, None


@register
class SoftmaxCELoss(OpSpec):
    """Fused softmax + cross-entropy loss head: the per-example loss out
    (f32, the class axis reduced away); the vocab-sized probability
    tensor is never an output."""

    name = "SoftmaxCELoss"
    params = {"grad_scale": Param("float", 1.0),
              "ignore_label": Param("float", -1.0),
              "use_ignore": Param("bool", False)}

    def arguments(self, p):
        return ["data", "label"]

    def integer_arguments(self, p):
        return ("label",)  # class ids — bf16 casts would corrupt >256

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return list(in_shapes), [None], []
        lshape = tuple(d[:-1])
        ins = [d, shape_assign(in_shapes[1], lshape, "SoftmaxCELoss label")]
        return ins, [lshape], []

    def forward(self, p, ins, aux, is_train, generator):
        data, label = ins
        ignore = p["ignore_label"] if p["use_ignore"] else None
        return [_SoftmaxCELossFn.apply(data, label, p["grad_scale"],
                                       ignore)], []


class _KLSparseRegFn(torch.autograd.Function):
    """Identity forward; the backward adds ``penalty * (-rho / rho_hat +
    (1 - rho) / (1 - rho_hat))`` a channel to the head gradient, with
    ``rho_hat`` the BATCH's mean activation a channel (over every axis but
    1), clipped to [1e-6, 1 - 1e-6] (the JAX package's ``f_bwd``,
    loss.py l.250-256), not the moving average."""

    @staticmethod
    def forward(ctx, x, rho_hat, rho, penalty):
        ctx.save_for_backward(rho_hat)
        ctx.cfg = (rho, penalty)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (rho_hat,) = ctx.saved_tensors
        rho, penalty = ctx.cfg
        rh = torch.clamp(rho_hat, 1e-6, 1 - 1e-6)
        kl_grad = penalty * (-rho / rh + (1 - rho) / (1 - rh))
        shape = (1, -1) + (1,) * (g.dim() - 2)
        return g + kl_grad.reshape(shape), None, None, None


@register
class IdentityAttachKLSparseReg(OpSpec):
    """Identity forward that attaches a KL sparsity penalty to the gradient
    (sparse autoencoders). The mean activation a channel is tracked in the
    aux ``moving_avg``, updated ``m * old + (1 - m) * rho_hat`` in
    training only."""

    name = "IdentityAttachKLSparseReg"
    params = {"sparseness_target": Param("float", 0.1),
              "penalty": Param("float", 0.001),
              "momentum": Param("float", 0.9)}

    def aux_states(self, p):
        return ["moving_avg"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return [None], [None], [None]
        return [d], [d], [(d[1],)]

    def forward(self, p, ins, aux, is_train, generator):
        x = ins[0]
        rho_hat = x.detach().mean(
            dim=tuple(i for i in range(x.dim()) if i != 1))
        mom = p["momentum"]
        new_avg = mom * aux[0] + (1 - mom) * rho_hat if is_train else aux[0]
        return [_KLSparseRegFn.apply(x, rho_hat, p["sparseness_target"],
                                     p["penalty"])], [new_avg]
