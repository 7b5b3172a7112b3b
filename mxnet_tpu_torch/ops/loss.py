"""Output (loss) operators: registration and shape rules only.

Counterpart of ``SoftmaxOutput`` in ``mxnet_tpu/ops/loss.py`` (l.43), so
that a loss-ended LM graph loads; the decoder strips the loss head
(``parallel.decode._logits_symbol``). Its forward and the reference's
fused cross-entropy gradient belong to the training slice.
"""
from __future__ import annotations

from ..base import MXNetError
from .registry import OpSpec, Param, register, shape_assign


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
        raise MXNetError(
            "SoftmaxOutput: the forward belongs to the training slice of "
            "the PyTorch port; parallel.Decoder strips the loss head")
