"""The f32 ``fused_conv_bn_act`` Winograd path's arithmetic against JAX.

On the card an f32 conv with a 3x3 kernel, stride 1, dilation 1 and
C % 4 == 0 (any padding) is Winograd F(2x2, 3x3) (``csrc/fused_linear.cu``
``wino_weights`` and ``conv_wino``): the weight ``[O, 9*C]`` as
``kernels._conv_operands`` packs it (columns in (ky, kx, c) order) becomes
U = G g G^T, [16, C, O]; each 2 x 2 output tile's 4 x 4 input patch, at
rows 2 ty - ph .. + 3 and columns 2 tx - pw .. + 3 of the channels-last x,
zero outside the image, becomes V = B^T d B; the 16 products M = sum_c U V
give Y = A^T M A, then the folded BatchNorm's scale and bias and the
activation, and the tiles past a ragged edge are dropped. Here, on the
CPU, that arithmetic is written out in plain torch from the port's own
operand packing and held against the Pallas kernel under the interpreter
(``mxnet_tpu/ops/pallas_kernels.py`` ``fused_conv_bn_act``) and against
``fused_conv_bn_act_plain``, at relative 1e-5 of the output's largest
value in f32 (the transforms and the 16 products sum in other orders than
a direct conv). The geometries are ResNet-50's stride-1 3x3 convs at
narrow channels (56, 28, 14 and 7 square, C = 8 and 16) plus odd sizes (5
x 9, 1 x 1), pads 0, 1 and 2, from NCHW and channels-last x.
``kernels.conv_algo``, the Python mirror of the C entry's routing rule, is
pinned: which geometries take Winograd, and that stride 2, dilation 2,
C = 3 and 1x1 do not; ResNet-50's eval forward sends 13 of its 53 chains
through it.
"""
import ctypes
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.models import get_resnet
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops.fusion import FusionPlan

F32 = torch.float32
# F(2x2, 3x3) (Lavin and Gray): B^T, G and A^T
BT = torch.tensor([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0],
                   [0, 1, 0, -1]], dtype=F32)
G = torch.tensor([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5],
                  [0, 0, 1]], dtype=F32)
AT = torch.tensor([[1, 1, 1, 0], [0, 1, -1, -1]], dtype=F32)
REL = 1e-5

# (name, H, W, C, pad): ResNet-50's stride-1 3x3 spatial sizes at narrow
# channels, then odd sizes (a ragged last tile row and column, a single
# pixel) and pads 0 and 2
GEOMETRIES = [
    ("56x56_c8", 56, 56, 8, 1),
    ("28x28_c16", 28, 28, 16, 1),
    ("14x14_c16", 14, 14, 16, 1),
    ("7x7_c8", 7, 7, 8, 1),
    ("5x9_c8_pad0", 5, 9, 8, 0),
    ("5x9_c4_pad2", 5, 9, 4, 2),
    ("1x1_c8_pad1", 1, 1, 8, 1),
    ("1x1_c4_pad2", 1, 1, 4, 2),
]
IDS = [g[0] for g in GEOMETRIES]
NF = 6


def _inputs(h, w, c, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, c, h, w).astype(np.float32)
    wt = (rng.randn(NF, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32)
    scale = (rng.rand(NF) + 0.5).astype(np.float32)
    bias = (rng.randn(NF) * 0.1).astype(np.float32)
    return x, wt, scale, bias


@functools.lru_cache(maxsize=None)
def _pallas(name, act):
    """The Pallas kernel under the interpreter, NCHW, once a geometry."""
    _, h, w, c, pad = GEOMETRIES[IDS.index(name)]
    x, wt, scale, bias = _inputs(h, w, c)
    return np.asarray(pk.fused_conv_bn_act(
        *map(jnp.asarray, (x, wt, scale, bias)), stride=(1, 1),
        pad=(pad, pad), dilate=(1, 1), act=act, interpret=True))


def winograd_conv(xc, wm, geom, scale, bias, act):
    """The kernel's F(2x2, 3x3) over ``kernels._conv_operands``' packing:
    ``[N*OH*OW, O]``, channels-last rows."""
    n, h, w, c, oh, ow, nf, kh, kw, sh, sw, ph, pw, dh, dw = geom
    assert (kh, kw, sh, sw, dh, dw) == (3, 3, 1, 1, 1, 1)
    th, tw = -(-oh // 2), -(-ow // 2)
    # the tiles' origins and their 4 x 4 patches, zero outside the image
    p = torch.arange(n * th * tw)
    img, r = p // (th * tw), p % (th * tw)
    ty, tx = r // tw, r % tw
    iy = (2 * ty - ph)[:, None, None] + torch.arange(4)[None, :, None]
    ix = (2 * tx - pw)[:, None, None] + torch.arange(4)[None, None, :]
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    pix = (img[:, None, None] * h + iy.clamp(0, h - 1)) * w \
        + ix.clamp(0, w - 1)
    d = xc.reshape(-1, c)[pix] * inside[..., None]       # [P, 4, 4, C]
    v = torch.einsum("ij,pjkc,lk->pilc", BT, d, BT)       # B^T d B
    g = wm.reshape(nf, 3, 3, c)                           # (ky, kx, c)
    u = torch.einsum("ij,ojkc,lk->ilco", G, g, G)         # G g G^T
    m = torch.einsum("pijc,ijco->pijo", v, u)
    y = torch.einsum("ai,pijo,bj->pabo", AT, m, AT)       # [P, 2, 2, O]
    y = K._ACTS[act](y * scale + bias)
    # the tiles into the image, the ragged edge dropped
    y = y.reshape(n, th, tw, 2, 2, nf).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * th, 2 * tw, nf)[:, :oh, :ow].reshape(-1, nf)


def _close(got, want):
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * top)


@pytest.mark.parametrize("act", ["relu", "linear"])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "cl"])
@pytest.mark.parametrize("name,h,w,c,pad", GEOMETRIES, ids=IDS)
def test_winograd_matches_pallas_and_plain(name, h, w, c, pad,
                                           channels_last, act):
    x, wt, scale, bias = _inputs(h, w, c)
    tx = torch.from_numpy(x)
    if channels_last:
        tx = tx.contiguous(memory_format=torch.channels_last)
    tw, ts, tb = map(torch.from_numpy, (wt, scale, bias))
    stride, padding = (1, 1), (pad, pad)
    assert K.conv_algo(F32, c, (3, 3), stride, padding, (1, 1)) == \
        "winograd"
    xc, wm, geom = K._conv_operands(tx, tw, stride, padding, (1, 1))
    got = winograd_conv(xc, wm, geom, ts, tb, act)
    oh, ow = geom[4:6]
    assert (oh, ow) == (h + 2 * pad - 2, w + 2 * pad - 2)
    got = got.reshape(2, oh, ow, NF).permute(0, 3, 1, 2).numpy()
    _close(got, _pallas(name, act))
    plain = K.fused_conv_bn_act_plain(tx, tw, ts, tb, stride, padding,
                                      (1, 1), act)
    _close(got, plain.numpy())


def test_winograd_workspace_rounds_c_and_o_up():
    """U is [16, Cp, Op]: C up to the kernel's 8-channel step, O up to
    its 64-channel block (the kernel zero-fills the padding)."""
    for c, nf, want in ((8, 6, 16 * 8 * 64), (4, 64, 16 * 8 * 64),
                        (64, 64, 16 * 64 * 64), (12, 65, 16 * 16 * 128),
                        (512, 512, 16 * 512 * 512)):
        ws = K._winograd_workspace(c, nf, "cpu")
        assert ws.dtype == F32 and ws.numel() == want


_CSRC = os.path.join(os.path.dirname(K.__file__), "csrc", "fused_linear.cu")


def test_workspace_constants_match_the_kernel():
    """The wrapper's channel step and block (``kernels._WINO_CK``,
    ``_WINO_BO``) are the kernel's ``wino::CK`` and ``wino::BO``."""
    with open(_CSRC) as f:
        src = f.read()
    consts = dict(re.findall(r"\b(CK|BO) = (\d+)", src[src.index(
        "namespace wino"):]))
    assert (int(consts["CK"]), int(consts["BO"])) == (K._WINO_CK,
                                                      K._WINO_BO)


def test_conv_entry_argument_types_match_its_signature():
    """``_ARGTYPES["fused_conv_bn_act"]`` is ``mx_fused_conv_bn_act``'s C
    signature, the workspace's float count (``long long``) after its
    pointer."""
    with open(_CSRC) as f:
        src = f.read()
    sig = src[src.index("mx_fused_conv_bn_act("):]
    params = [p.strip() for p in sig[sig.index("(") + 1:sig.index(")")]
              .split(",")]
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    want = [ctype[p.replace("const ", "").rsplit(" ", 1)[0]] for p in params]
    assert K._ARGTYPES["fused_conv_bn_act"] == want
    assert params[5:7] == ["void* ws", "long long ws_n"]


# (C, kernel, stride, pad, dilate, dtype) -> the path
ALGO_CASES = [
    ((8, (3, 3), (1, 1), (1, 1), (1, 1), F32), "winograd"),
    ((4, (3, 3), (1, 1), (0, 0), (1, 1), F32), "winograd"),
    ((512, (3, 3), (1, 1), (2, 2), (1, 1), F32), "winograd"),
    ((64, (3, 3), (1, 1), (1, 2), (1, 1), F32), "winograd"),
    ((64, (3, 3), (2, 2), (1, 1), (1, 1), F32), "implicit"),
    ((64, (3, 3), (1, 2), (1, 1), (1, 1), F32), "implicit"),
    ((64, (3, 3), (1, 1), (2, 2), (2, 2), F32), "implicit"),
    ((3, (3, 3), (1, 1), (1, 1), (1, 1), F32), "implicit"),
    ((6, (3, 3), (1, 1), (1, 1), (1, 1), F32), "implicit"),
    ((64, (1, 1), (1, 1), (0, 0), (1, 1), F32), "pointwise"),
    ((64, (1, 1), (2, 2), (0, 0), (1, 1), F32), "implicit"),
    ((64, (1, 1), (1, 1), (1, 1), (1, 1), F32), "implicit"),
    ((3, (7, 7), (2, 2), (3, 3), (1, 1), F32), "implicit"),
    ((8, (3, 2), (1, 1), (1, 1), (1, 1), F32), "implicit"),
    ((64, (3, 3), (1, 1), (1, 1), (1, 1), torch.bfloat16), "patches"),
    ((64, (1, 1), (1, 1), (0, 0), (1, 1), torch.bfloat16), "patches"),
]


@pytest.mark.parametrize("case,want", ALGO_CASES,
                         ids=["-".join(map(str, c[:4])) + "-" + str(c[5])
                              .split(".")[-1] + "-d" + str(c[4][0])
                              for c, _ in ALGO_CASES])
def test_conv_algo_rule(case, want):
    c, kernel, stride, pad, dilate, dt = case
    assert K.conv_algo(dt, c, kernel, stride, pad, dilate) == want


def test_resnet50_eval_sends_13_chains_through_winograd():
    """ResNet-50's stride-1 3x3 convs (stage 1: 3, stage 2: 3, stage 3: 5,
    stage 4: 2; the first unit of stages 2-4 strides its 3x3 conv) take
    Winograd in the f32 eval forward; the other 40 chains do not."""
    sym = get_resnet(1000, 50)
    plan = FusionPlan(sym._topo(), sym._heads)
    shapes, _, _ = sym.infer_shape(data=(2, 3, 224, 224),
                                   softmax_label=(2,))
    wshape = dict(zip(sym.list_arguments(), shapes))
    algos = {}
    for _, nodes in plan.chains.values():
        conv = nodes[0]
        p = conv.params
        w = wshape[conv.inputs[1][0].name]
        algos[conv.name] = K.conv_algo(F32, w[1], w[2:], p["stride"],
                                       p["pad"], p["dilate"])
    assert len(algos) == 53
    wino = sorted(n for n, a in algos.items() if a == "winograd")
    assert len(wino) == 13
    assert all(n.endswith("_b_conv") for n in wino)
    for stage, units in ((1, 3), (2, 3), (3, 5), (4, 2)):
        assert sum(n.startswith("stage%d_" % stage) for n in wino) == units
    assert sum(a == "pointwise" for a in algos.values()) == 33
