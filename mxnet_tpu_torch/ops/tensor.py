"""Structural and elementwise operators: the subset the transformer LM uses.

Counterpart of ``mxnet_tpu/ops/tensor.py``: the binary ops and their
scalar forms (l.40-73), ``ElementWiseSum`` (l.109), ``Reshape`` (l.131),
``Flatten`` (l.184), ``SpaceToDepth`` (l.269), ``SwapAxis`` (l.306),
``Cast`` (l.325), ``BlockGrad`` (l.342) and ``Crop`` (l.355).
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
