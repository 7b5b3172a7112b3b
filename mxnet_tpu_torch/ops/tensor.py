"""Structural and elementwise operators.

Counterpart of ``mxnet_tpu/ops/tensor.py``: the binary ops and their
scalar forms (l.24-72), the unary zoo (l.76-105), ``ElementWiseSum``
(l.109), ``Reshape`` (l.131), ``Flatten`` (l.184), ``Concat`` (l.200),
``SliceChannel`` (l.232), ``SpaceToDepth`` (l.269), ``SwapAxis``
(l.306), ``Cast`` (l.325), ``BlockGrad`` (l.342) and ``Crop`` (l.355).
Where PyTorch's derivative differs from JAX's, the op is written so that
autograd takes JAX's: ``abs`` sends the gradient through its ``x >= 0``
branch (``jax.grad(jnp.abs)(0.) == 1``), and a max or min against a
scalar splits a tie's gradient in halves, as ``jnp.maximum`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from .registry import OpSpec, Param, register, same_shape_infer


def _binary_op(opname, fn):
    @register
    class _Bin(OpSpec):
        name = opname

        def arguments(self, p):
            return ["lhs", "rhs"]

        def infer_shape(self, p, in_shapes):
            return same_shape_infer(p, in_shapes)

        def forward(self, p, ins, aux, is_train, generator):
            return [fn(ins[0], ins[1])], []
    _Bin.__name__ = "Op" + opname
    return _Bin


_binary_op("_Plus", torch.add)
_binary_op("_Minus", torch.sub)
_binary_op("_Mul", torch.mul)
_binary_op("_Div", torch.div)
_binary_op("_Power", torch.pow)
_binary_op("_Maximum", torch.maximum)
_binary_op("_Minimum", torch.minimum)


def _scalar_op(opname, fn):
    @register
    class _Scal(OpSpec):
        name = opname
        params = {"scalar": Param("float")}

        def infer_shape(self, p, in_shapes):
            return same_shape_infer(p, in_shapes)

        def forward(self, p, ins, aux, is_train, generator):
            return [fn(ins[0], p["scalar"]).to(ins[0].dtype)], []
    _Scal.__name__ = "Op" + opname
    return _Scal


_scalar_op("_PlusScalar", lambda x, s: x + s)
_scalar_op("_MinusScalar", lambda x, s: x - s)
_scalar_op("_RMinusScalar", lambda x, s: s - x)
_scalar_op("_MulScalar", lambda x, s: x * s)
_scalar_op("_DivScalar", lambda x, s: x / s)
_scalar_op("_RDivScalar", lambda x, s: s / x)
_scalar_op("_PowerScalar", lambda x, s: torch.pow(x, s))
_scalar_op("_RPowerScalar", lambda x, s: torch.pow(s, x))
# against a 0-dim tensor, not clamp: a tie's gradient splits in halves
_scalar_op("_MaximumScalar", lambda x, s: torch.maximum(
    x, torch.tensor(s, dtype=x.dtype, device=x.device)))
_scalar_op("_MinimumScalar", lambda x, s: torch.minimum(
    x, torch.tensor(s, dtype=x.dtype, device=x.device)))


def _unary_op(opname, fn):
    @register
    class _Un(OpSpec):
        name = opname

        def infer_shape(self, p, in_shapes):
            return same_shape_infer(p, in_shapes)

        def forward(self, p, ins, aux, is_train, generator):
            return [fn(ins[0]).to(ins[0].dtype)], []
    _Un.__name__ = "Op" + opname
    return _Un


# the unary zoo (both mx.nd.* and mx.sym.* in the reference)
_unary_op("abs", lambda x: torch.where(x >= 0, x, -x))
_unary_op("sign", torch.sign)
_unary_op("round", torch.round)     # half to even, as jnp.round
_unary_op("ceil", torch.ceil)
_unary_op("floor", torch.floor)
_unary_op("square", torch.square)
_unary_op("sqrt", torch.sqrt)
_unary_op("rsqrt", lambda x: 1.0 / torch.sqrt(x))
_unary_op("exp", torch.exp)
_unary_op("log", torch.log)
_unary_op("cos", torch.cos)
_unary_op("sin", torch.sin)


@register
class ElementWiseSum(OpSpec):
    """N-ary addition (``elementwise_sum-inl.h``)."""

    name = "ElementWiseSum"
    params = {"num_args": Param("int")}

    def arguments(self, p):
        return ["arg%d" % i for i in range(p["num_args"])]

    def infer_shape(self, p, in_shapes):
        return same_shape_infer(p, in_shapes)

    def forward(self, p, ins, aux, is_train, generator):
        out = ins[0]
        for x in ins[1:]:
            out = out + x
        return [out], []


@register
class Reshape(OpSpec):
    """View change (``reshape-inl.h``): ``target_shape`` excludes the
    batch dim (the 2015 interface); ``shape`` reshapes the whole tensor
    with one ``-1`` inferred and ``0`` copying the input dim."""

    name = "Reshape"
    params = {"target_shape": Param("shape", ()),
              "shape": Param("shape", ())}

    @staticmethod
    def _full_target(p, d):
        """Resolve the output shape given input shape ``d``."""
        if p["shape"]:
            tgt = tuple(int(t) for t in p["shape"])
            if tgt.count(-1) > 1:
                raise MXNetError("Reshape: more than one -1 in shape")
            tgt = tuple(d[i] if t == 0 and i < len(d) else t
                        for i, t in enumerate(tgt))
            if 0 in tgt:
                raise MXNetError("Reshape: 0 dim beyond input rank")
            total = int(np.prod(d))
            if -1 in tgt:
                known = int(np.prod([t for t in tgt if t != -1]))
                tgt = tuple(total // max(known, 1) if t == -1 else t
                            for t in tgt)
            return tgt
        tgt = (d[0],) + tuple(p["target_shape"])
        if 0 in tgt[1:]:
            known = int(np.prod([x for x in tgt[1:] if x != 0])) * tgt[0]
            total = int(np.prod(d))
            tgt = tuple(total // max(known, 1) if x == 0 else x
                        for x in tgt)
        return tgt

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return [None], [None], []
        tgt = self._full_target(p, d)
        if int(np.prod(tgt)) != int(np.prod(d)):
            raise MXNetError("Reshape: size mismatch %s -> %s" % (d, tgt))
        return [d], [tgt], []

    def forward(self, p, ins, aux, is_train, generator):
        x = ins[0]
        return [x.reshape(self._full_target(p, tuple(x.shape)))], []


@register
class Flatten(OpSpec):
    """Collapse all but the batch dim (``reshape-inl.h`` FlattenProp)."""

    name = "Flatten"

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return [None], [None], []
        return [d], [(d[0], int(np.prod(d[1:])))], []

    def forward(self, p, ins, aux, is_train, generator):
        x = ins[0]
        return [x.reshape(x.shape[0], -1)], []


@register
class Concat(OpSpec):
    """Concatenate along ``dim`` (``concat-inl.h``)."""

    name = "Concat"
    params = {"num_args": Param("int"), "dim": Param("int", 1)}

    def arguments(self, p):
        return ["arg%d" % i for i in range(p["num_args"])]

    def infer_shape(self, p, in_shapes):
        dim = p["dim"]
        if any(s is None for s in in_shapes):
            return list(in_shapes), [None], []
        ndim = len(in_shapes[0])
        out = list(in_shapes[0])
        total = 0
        for s in in_shapes:
            if len(s) != ndim:
                raise MXNetError("Concat: ndim mismatch")
            for ax in range(ndim):
                if ax != dim and s[ax] != out[ax]:
                    raise MXNetError("Concat: shape mismatch %s vs %s"
                                     % (s, tuple(out)))
            total += s[dim]
        out[dim] = total
        return list(in_shapes), [tuple(out)], []

    def forward(self, p, ins, aux, is_train, generator):
        # channels-last inputs give a channels-last result, which the next
        # fused conv reads as its NHWC operand without a copy
        return [torch.cat(ins, dim=p["dim"])], []


@register
class SliceChannel(OpSpec):
    """Split along an axis into ``num_outputs`` equal pieces
    (``slice_channel-inl.h``), the inverse of Concat; ``squeeze_axis``
    drops the split axis when each piece has size 1 there."""

    name = "SliceChannel"
    params = {"num_outputs": Param("int"), "axis": Param("int", 1),
              "squeeze_axis": Param("bool", False)}

    def outputs(self, p):
        return ["output%d" % i for i in range(p["num_outputs"])]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        n = p["num_outputs"]
        if d is None:
            return [None], [None] * n, []
        ax = p["axis"]
        if d[ax] % n != 0:
            raise MXNetError("SliceChannel: dim %d not divisible by %d"
                             % (d[ax], n))
        piece = list(d)
        piece[ax] //= n
        if p["squeeze_axis"]:
            if piece[ax] != 1:
                raise MXNetError("SliceChannel: squeeze needs size-1 axis")
            piece = piece[:ax] + piece[ax + 1:]
        return [d], [tuple(piece)] * n, []

    def forward(self, p, ins, aux, is_train, generator):
        x, n, ax = ins[0], p["num_outputs"], p["axis"]
        outs = torch.split(x, x.shape[ax] // n, dim=ax)
        if p["squeeze_axis"]:
            outs = [o.squeeze(ax) for o in outs]
        return list(outs), []


@register
class SpaceToDepth(OpSpec):
    """Rearrange spatial blocks into channels (NCHW):
    ``out[b, c*bs*bs + p*bs + q, i, j] = x[b, c, i*bs + p, j*bs + q]``
    (the stem of ``models.resnet.get_resnet(stem="s2d")``)."""

    name = "SpaceToDepth"
    params = {"block_size": Param("int")}

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return list(in_shapes), [None], []
        bs = p["block_size"]
        if len(d) != 4:
            raise MXNetError("SpaceToDepth: data must be 4D NCHW")
        if bs < 1 or d[2] % bs or d[3] % bs:
            raise MXNetError(
                "SpaceToDepth: block_size %d must divide H=%d and W=%d"
                % (bs, d[2], d[3]))
        out = (d[0], d[1] * bs * bs, d[2] // bs, d[3] // bs)
        return list(in_shapes), [out], []

    def forward(self, p, ins, aux, is_train, generator):
        x = ins[0]
        bs = p["block_size"]
        b, c, h, w = x.shape
        r = x.reshape(b, c, h // bs, bs, w // bs, bs)
        r = r.permute(0, 1, 3, 5, 2, 4)
        return [r.reshape(b, c * bs * bs, h // bs, w // bs)], []


@register
class SwapAxis(OpSpec):
    """Swap two axes (``swapaxis-inl.h``)."""

    name = "SwapAxis"
    params = {"dim1": Param("int", 0), "dim2": Param("int", 0)}

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return [None], [None], []
        s = list(d)
        s[p["dim1"]], s[p["dim2"]] = s[p["dim2"]], s[p["dim1"]]
        return [d], [tuple(s)], []

    def forward(self, p, ins, aux, is_train, generator):
        return [torch.swapaxes(ins[0], p["dim1"], p["dim2"])], []


@register
class Cast(OpSpec):
    """dtype conversion (``cast-inl.h``)."""

    name = "Cast"
    params = {"dtype": Param("str")}

    def infer_shape(self, p, in_shapes):
        return same_shape_infer(p, in_shapes)

    def infer_type(self, p, in_types):
        return [in_types[0]], [torch_dtype(p["dtype"])], []

    def forward(self, p, ins, aux, is_train, generator):
        return [ins[0].to(torch_dtype(p["dtype"]))], []


@register
class BlockGrad(OpSpec):
    """Identity forward, zero gradient (``block_grad-inl.h``)."""

    name = "BlockGrad"

    def infer_shape(self, p, in_shapes):
        return same_shape_infer(p, in_shapes)

    def forward(self, p, ins, aux, is_train, generator):
        return [ins[0].detach()], []


@register
class Crop(OpSpec):
    """Spatial crop to an explicit size or to a reference symbol's H/W
    (``crop-inl.h``). With ``num_args=2`` the second input supplies the
    target H/W and gets no gradient."""

    name = "Crop"
    params = {"num_args": Param("int", 1), "offset": Param("shape", (0, 0)),
              "h_w": Param("shape", (0, 0)),
              "center_crop": Param("bool", False)}

    def arguments(self, p):
        if p["num_args"] == 1:
            return ["data"]
        return ["data", "crop_like"]

    def _target_hw(self, p, shapes):
        if p["num_args"] == 2 and shapes[1] is not None:
            return shapes[1][2], shapes[1][3]
        if p["h_w"] != (0, 0):
            return p["h_w"]
        return None

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        hw = self._target_hw(p, in_shapes)
        if d is None or hw is None:
            return list(in_shapes), [None], []
        return list(in_shapes), [(d[0], d[1], hw[0], hw[1])], []

    def forward(self, p, ins, aux, is_train, generator):
        x = ins[0]
        if p["num_args"] == 2:
            th, tw = ins[1].shape[2], ins[1].shape[3]
        else:
            th, tw = p["h_w"]
        if p["center_crop"]:
            oy = (x.shape[2] - th) // 2
            ox = (x.shape[3] - tw) // 2
        else:
            oy, ox = p["offset"]
        # lax.dynamic_slice clamps the start so the window fits
        oy = min(max(oy, 0), x.shape[2] - th)
        ox = min(max(ox, 0), x.shape[3] - tw)
        return [x[:, :, oy:oy + th, ox:ox + tw]], []
