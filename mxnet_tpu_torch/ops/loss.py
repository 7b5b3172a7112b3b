"""Output (loss) operators.

Counterpart of ``SoftmaxOutput`` in ``mxnet_tpu/ops/loss.py`` (l.43),
after the reference's ``softmax_output-inl.h``. The reference's loss
contract is kept: a loss layer IGNORES the incoming head gradient (so a
backward with no head gradients, or with ones, "just works") and its
gradient is SUMMED over the batch — the optimizer's ``rescale_grad``
handles 1/batch. It is a ``torch.autograd.Function``, so the rest of the
graph differentiates through plain autograd. The decoder strips the loss
head (``parallel.decode._logits_symbol``).
"""
from __future__ import annotations

import torch

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
