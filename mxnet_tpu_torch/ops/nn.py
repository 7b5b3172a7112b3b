"""Neural-network operators: the subset the transformer LM uses.

Counterpart of ``mxnet_tpu/ops/nn.py``: ``FullyConnected`` (l.79),
``Activation`` (l.277), ``LeakyReLU`` (l.301), ``Dropout`` (l.595) and
``Embedding`` (l.643), after the reference's ``fully_connected-inl.h``,
``activation-inl.h``, ``leaky_relu-inl.h``, ``dropout-inl.h`` and
``embedding-inl.h``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import OpSpec, Param, register, same_shape_infer, shape_assign


@register
class FullyConnected(OpSpec):
    """out = data · weightᵀ + bias. Data with >2 dims is flattened to
    (N, -1) like the reference; ``flatten=False`` applies the product
    position-wise over the trailing axis."""

    name = "FullyConnected"
    params = {"num_hidden": Param("int"), "no_bias": Param("bool", False),
              "flatten": Param("bool", True)}

    def arguments(self, p):
        return ["data", "weight"] if p["no_bias"] else ["data", "weight", "bias"]

    def infer_shape(self, p, in_shapes):
        nh = p["num_hidden"]
        d = in_shapes[0]
        ins = list(in_shapes)
        if d is not None:
            k = d[-1] if not p["flatten"] else int(np.prod(d[1:]))
            ins[1] = shape_assign(ins[1], (nh, k), "FullyConnected weight")
        if not p["no_bias"]:
            ins[2] = shape_assign(ins[2], (nh,), "FullyConnected bias")
        if d is None:
            out = None
        elif p["flatten"]:
            out = (d[0], nh)
        else:
            out = tuple(d[:-1]) + (nh,)
        return ins, [out], []

    def forward(self, p, ins, aux, is_train, generator):
        x = ins[0]
        if p["flatten"]:
            x = x.reshape(x.shape[0], -1)
        # the bias rides in the product's epilogue
        return [F.linear(x, ins[1], None if p["no_bias"] else ins[2])], []


@register
class Activation(OpSpec):
    """relu/sigmoid/tanh/softrelu (``activation-inl.h``)."""

    name = "Activation"
    params = {"act_type": Param("str")}
    _FNS = {
        "relu": torch.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softrelu": F.softplus,
    }

    def infer_shape(self, p, in_shapes):
        return same_shape_infer(p, in_shapes)

    def forward(self, p, ins, aux, is_train, generator):
        try:
            fn = self._FNS[p["act_type"]]
        except KeyError:
            raise MXNetError("Activation: unknown act_type " + p["act_type"])
        return [fn(ins[0])], []


@register
class LeakyReLU(OpSpec):
    """leaky/prelu/rrelu/elu (``leaky_relu-inl.h``). rrelu samples its
    slope in [lower, upper) at training time and uses the midpoint for
    inference."""

    name = "LeakyReLU"
    params = {"act_type": Param("str", "leaky"),
              "slope": Param("float", 0.25),
              "lower_bound": Param("float", 0.125),
              "upper_bound": Param("float", 0.334)}

    def arguments(self, p):
        return ["data", "gamma"] if p["act_type"] == "prelu" else ["data"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        ins = list(in_shapes)
        if p["act_type"] == "prelu" and d is not None:
            ins[1] = shape_assign(ins[1], (d[1],), "LeakyReLU gamma")
        return ins, [d], []

    def forward(self, p, ins, aux, is_train, generator):
        x = ins[0]
        t = p["act_type"]
        if t == "leaky":
            return [torch.where(x > 0, x, p["slope"] * x)], []
        if t == "elu":
            return [torch.where(x > 0, x, p["slope"] * (torch.exp(x) - 1))], []
        if t == "prelu":
            g = ins[1].reshape((1, -1) + (1,) * (x.dim() - 2))
            return [torch.where(x > 0, x, g * x)], []
        if t == "rrelu":
            if is_train:
                lo, hi = p["lower_bound"], p["upper_bound"]
                slope = torch.rand(x.shape, generator=generator,
                                   device=x.device, dtype=x.dtype) \
                    * (hi - lo) + lo
            else:
                slope = (p["lower_bound"] + p["upper_bound"]) / 2.0
            return [torch.where(x > 0, x, slope * x)], []
        raise MXNetError("LeakyReLU: unknown act_type " + t)


@register
class Dropout(OpSpec):
    """Inverted dropout (``dropout-inl.h``): identity at inference."""

    name = "Dropout"
    params = {"p": Param("float", 0.5)}

    def infer_shape(self, p, in_shapes):
        return same_shape_infer(p, in_shapes)

    def forward(self, p, ins, aux, is_train, generator):
        x = ins[0]
        rate = p["p"]
        if not is_train or rate <= 0.0:
            return [x], []
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return [torch.where(mask, x / keep, torch.zeros_like(x))], []


@register
class Embedding(OpSpec):
    """Index lookup table (``embedding-inl.h``): data of indices ->
    data.shape + (output_dim,)."""

    name = "Embedding"
    params = {"input_dim": Param("int"), "output_dim": Param("int")}

    def arguments(self, p):
        return ["data", "weight"]

    def integer_arguments(self, p):
        return ("data",)  # token ids — bf16 casts would corrupt >256

    def infer_shape(self, p, in_shapes):
        ins = list(in_shapes)
        ins[1] = shape_assign(ins[1], (p["input_dim"], p["output_dim"]),
                              "Embedding weight")
        d = ins[0]
        if d is None:
            return ins, [None], []
        return ins, [tuple(d) + (p["output_dim"],)], []

    def forward(self, p, ins, aux, is_train, generator):
        # the indices are never differentiated (an integer tensor, or a
        # float one detached first); the table's gradient scatter-adds
        return [ins[1][ins[0].detach().long()]], []
