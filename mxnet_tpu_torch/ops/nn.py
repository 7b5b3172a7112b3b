"""Neural-network operators: those of the transformer LM and of ResNet.

Counterpart of ``mxnet_tpu/ops/nn.py``: ``FullyConnected`` (l.79),
``Convolution`` (l.126), ``Activation`` (l.277), ``LeakyReLU`` (l.301),
``BatchNorm`` (l.457) with its hand-derived training backward (l.343),
``Pooling`` (l.506), ``Dropout`` (l.595) and ``Embedding`` (l.643), after
the reference's ``fully_connected-inl.h``, ``convolution-inl.h``,
``activation-inl.h``, ``leaky_relu-inl.h``, ``batch_norm-inl.h``,
``pooling-inl.h``, ``dropout-inl.h`` and ``embedding-inl.h``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import OpSpec, Param, register, same_shape_infer, shape_assign


def _BN_STATS_MODE():
    """Training BatchNorm statistics algorithm, ``MXNET_BN_STATS`` (read at
    each call): "auto" (default) = one read, ``E[x^2] - mean^2`` clamped
    at 0 (the contract of flax's BatchNorm: exact enough for conv outputs,
    whose channel means sit within a few sigma of 0); "centered" = exact
    two-pass; "welford" = exact one-read (``torch.var_mean``);
    "onepass_unsafe" = the JAX package's other name for "auto": BatchNorm
    computes exactly as under "auto", but the training conv -> BatchNorm
    chain of ``ops.fusion`` stays off (its gate wants "auto" by name).
    Unknown values raise, so a typo cannot select the inexact default."""
    mode = os.environ.get("MXNET_BN_STATS", "auto")
    if mode not in ("auto", "centered", "welford", "onepass_unsafe"):
        raise MXNetError("MXNET_BN_STATS=%r: expected "
                         "auto|centered|welford|onepass_unsafe" % mode)
    return mode


def _conv_out(h, k, s, p, d):
    eff = d * (k - 1) + 1
    return (h + 2 * p - eff) // s + 1


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
class Convolution(OpSpec):
    """2-D convolution, NCHW (``convolution-inl.h``): stride, pad,
    dilation and ``num_group``; one ``F.conv2d`` (the JAX package's
    ``lax.conv_general_dilated``)."""

    name = "Convolution"
    params = {
        "kernel": Param("shape"),
        "num_filter": Param("int"),
        "stride": Param("shape", (1, 1)),
        "dilate": Param("shape", (1, 1)),
        "pad": Param("shape", (0, 0)),
        "num_group": Param("int", 1),
        "workspace": Param("int", 512),  # accepted for parity
        "no_bias": Param("bool", False),
    }

    def arguments(self, p):
        return ["data", "weight"] if p["no_bias"] else ["data", "weight", "bias"]

    def infer_shape(self, p, in_shapes):
        ins = list(in_shapes)
        d = ins[0]
        kh, kw = p["kernel"]
        nf = p["num_filter"]
        if nf % p["num_group"]:
            raise MXNetError("Convolution: num_filter %d not divisible by "
                             "num_group %d" % (nf, p["num_group"]))
        if d is not None:
            if len(d) != 4:
                raise MXNetError("Convolution: data must be 4D NCHW")
            if d[1] % p["num_group"]:
                raise MXNetError("Convolution: channels %d not divisible by "
                                 "num_group %d" % (d[1], p["num_group"]))
            ins[1] = shape_assign(ins[1], (nf, d[1] // p["num_group"], kh, kw),
                                  "Convolution weight")
        if not p["no_bias"]:
            ins[2] = shape_assign(ins[2], (nf,), "Convolution bias")
        if d is None:
            return ins, [None], []
        oh = _conv_out(d[2], kh, p["stride"][0], p["pad"][0], p["dilate"][0])
        ow = _conv_out(d[3], kw, p["stride"][1], p["pad"][1], p["dilate"][1])
        if oh <= 0 or ow <= 0:
            raise MXNetError("Convolution: kernel size exceeds input")
        return ins, [(d[0], nf, oh, ow)], []

    def forward(self, p, ins, aux, is_train, generator):
        return [F.conv2d(ins[0], ins[1], None if p["no_bias"] else ins[2],
                         stride=p["stride"], padding=p["pad"],
                         dilation=p["dilate"], groups=p["num_group"])], []


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


def _bn_axes(x):
    return (0,) + tuple(range(2, x.dim())), (1, -1) + (1,) * (x.dim() - 2)


class _BNTrain(torch.autograd.Function):
    """Training batch-norm with the JAX package's hand-derived backward
    (``_bn_train``, nn.py l.343-454): the forward computes the batch
    statistics in the mode ``_BN_STATS_MODE`` selects (accumulated in f32,
    or f64 for f64 data) and one folded scale/shift pass in x's dtype;
    it returns ``(out, mean, var)``, the statistics in x's dtype. The
    backward recomputes the centered x from the residuals and takes the
    JAX formula

        dx = gamma inv (gy - sum(gy)/n - xhat sum(gy xhat)/n)
             + g_mean/n + 2 xc g_var/n,     xc = x - mean, xhat = xc inv,

    as ``dx = a gy + b xc + c`` with per-channel a, b, c: PyTorch runs each
    op as its own pass over the activation, and this form makes the
    fewest (two reductions and two multiply-adds)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        axes, shape = _bn_axes(x)
        n = x.numel() // x.shape[1]
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        mode = _BN_STATS_MODE()
        if mode == "centered":
            mean = xf.mean(dim=axes)
            var = (xf - mean.reshape(shape)).square().mean(dim=axes)
        elif mode == "welford":
            var, mean = torch.var_mean(xf, dim=axes, correction=0)
        else:
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean.square(),
                              min=0.0)
        del xf
        inv = torch.rsqrt(var + eps)
        ga = gamma.to(acc)
        scale = (ga * inv).to(x.dtype)
        shift = (beta.to(acc) - mean * ga * inv).to(x.dtype)
        out = torch.addcmul(shift.reshape(shape), x, scale.reshape(shape))
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.n = n
        return out, mean.to(x.dtype), var.to(x.dtype)

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        x, gamma, mean, inv = ctx.saved_tensors
        n = ctx.n
        axes, shape = _bn_axes(x)
        acc = mean.dtype
        xc = torch.sub(x, mean.reshape(shape))         # in acc
        sum_gy = g_out.sum(dim=axes, dtype=acc)
        sum_gy_xhat = (g_out * xc).sum(dim=axes) * inv
        gi = gamma.to(acc) * inv
        b = 2.0 * g_var.to(acc) / n - gi * inv * sum_gy_xhat / n
        c = g_mean.to(acc) / n - gi * sum_gy / n
        dx = torch.addcmul(c.reshape(shape), xc, b.reshape(shape))
        dx.addcmul_(g_out, gi.reshape(shape))
        return (dx.to(x.dtype), sum_gy_xhat.to(gamma.dtype),
                sum_gy.to(gamma.dtype), None)


@register
class BatchNorm(OpSpec):
    """Batch normalization (``batch_norm-inl.h``).

    Train: normalize by the batch statistics and update the aux
    ``moving_mean``/``moving_var`` as ``m * old + (1 - m) * new``
    (momentum 0.9, eps 1e-3 by default). Eval: normalize by the moving
    statistics. ``fix_gamma`` (default True) freezes the scale at 1, so
    gamma gets no gradient."""

    name = "BatchNorm"
    params = {"eps": Param("float", 1e-3),
              "momentum": Param("float", 0.9),
              "fix_gamma": Param("bool", True)}

    def arguments(self, p):
        return ["data", "gamma", "beta"]

    def aux_states(self, p):
        return ["moving_mean", "moving_var"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        ins = list(in_shapes)
        if d is None:
            return ins, [None], [None, None]
        c = (d[1],)
        ins[1] = shape_assign(ins[1], c, "BatchNorm gamma")
        ins[2] = shape_assign(ins[2], c, "BatchNorm beta")
        return ins, [d], [c, c]

    def forward(self, p, ins, aux, is_train, generator):
        x, gamma, beta = ins
        mmean, mvar = aux
        if p["fix_gamma"]:
            gamma = torch.ones_like(gamma)
        if is_train:
            out, mean, var = _BNTrain.apply(x, gamma, beta, float(p["eps"]))
            m = p["momentum"]
            return [out], [m * mmean + (1 - m) * mean,
                           m * mvar + (1 - m) * var]
        _, shape = _bn_axes(x)
        inv = torch.rsqrt(mvar + p["eps"])
        out = (x - mmean.reshape(shape)) * inv.reshape(shape)
        out = out * gamma.reshape(shape) + beta.reshape(shape)
        return [out], [mmean, mvar]


@register
class Pooling(OpSpec):
    """max/avg/sum pooling (``pooling-inl.h``). The output size is ceil
    division capped so that the last window starts inside the padded
    input (l.177-183); the right and bottom padding grows to fit those
    windows; avg always divides by the whole kernel size, as mshadow's
    ``pool<Reducer>``. The padding is explicit (-inf for max, 0 for the
    sums) and the pool runs unpadded, since PyTorch's ``ceil_mode``
    divides an edge window by its clipped size."""

    name = "Pooling"
    params = {"kernel": Param("shape"),
              "pool_type": Param("str", "max"),
              "stride": Param("shape", (1, 1)),
              "pad": Param("shape", (0, 0)),
              # pool over the whole spatial extent, whatever the kernel
              "global_pool": Param("bool", False)}

    @staticmethod
    def _osize(h, k, s, p):
        o = (h + 2 * p - k + s - 1) // s + 1
        # the last window must start within input + padding
        if (o - 1) * s >= h + p:
            o -= 1
        return o

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return [None], [None], []
        if p["global_pool"]:
            return [d], [(d[0], d[1], 1, 1)], []
        kh, kw = p["kernel"]
        if kh > d[2] + 2 * p["pad"][0] or kw > d[3] + 2 * p["pad"][1]:
            raise MXNetError("Pooling: kernel size exceeds input")
        oh = self._osize(d[2], kh, p["stride"][0], p["pad"][0])
        ow = self._osize(d[3], kw, p["stride"][1], p["pad"][1])
        return [d], [(d[0], d[1], oh, ow)], []

    def forward(self, p, ins, aux, is_train, generator):
        x = ins[0]
        if p["global_pool"]:
            kh, kw = x.shape[2], x.shape[3]
            sh, sw, ph, pw = 1, 1, 0, 0
        else:
            kh, kw = p["kernel"]
            sh, sw = p["stride"]
            ph, pw = p["pad"]
        oh = self._osize(x.shape[2], kh, sh, ph)
        ow = self._osize(x.shape[3], kw, sw, pw)
        eh = max((oh - 1) * sh + kh - x.shape[2] - ph, ph)
        ew = max((ow - 1) * sw + kw - x.shape[3] - pw, pw)
        kind = p["pool_type"]
        if kind not in ("max", "avg", "sum"):
            raise MXNetError("Pooling: unknown pool_type " + kind)
        if ph or pw or eh or ew:
            x = F.pad(x, (pw, ew, ph, eh),
                      value=float("-inf") if kind == "max" else 0.0)
        if kind == "max":
            out = F.max_pool2d(x, (kh, kw), (sh, sw))
        else:
            out = F.avg_pool2d(x, (kh, kw), (sh, sw), divisor_override=(
                kh * kw if kind == "avg" else 1))
        return [out], []


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
