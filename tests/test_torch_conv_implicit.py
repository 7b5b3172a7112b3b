"""The f32 ``fused_conv_bn_act`` path's host side against the JAX package.

On the card the f32 conv is an implicit GEMM: the wrapper hands the C
entry a channels-last x, the weight permuted once to ``[O, kh*kw*C]`` and
the conv's geometry (``kernels._conv_operands``), and the kernel's tile
loader reads patch row ``m = (n, oy, ox)``, column ``k = (ky, kx, c)`` as
``x[n, oy*sh - ph + ky*dh, ox*sw - pw + kx*dw, c]``, zero outside the
image. Here, on the CPU, that address formula is written out in plain
torch over every (m, k) and held against JAX's
``conv_general_dilated_patches`` (the patches of ``pallas_kernels.py``
``fused_conv_bn_act``): the same values, exactly, once the columns are put
in JAX's (c, ky, kx) order, and the same GEMM with the permuted weight
(f32 sums in other orders: rtol/atol 1e-5). The geometries are
ResNet-50's at narrow channels (the stem's 7x7/2 over C = 3, 1x1/1, 1x1/2,
3x3/1, 3x3/2) plus a dilated and a non-square kernel, from an NCHW and a
channels-last x; the port's ``fused_conv_bn_act`` on the CPU is held
against the Pallas kernel under the interpreter at the same geometries
(rtol/atol 1e-4, as ``tests/test_torch_cnn.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.ops import kernels as K

# (name, C, kernel, stride, pad, dilate)
GEOMETRIES = [
    ("stem_7x7s2", 3, (7, 7), (2, 2), (3, 3), (1, 1)),
    ("1x1s1", 8, (1, 1), (1, 1), (0, 0), (1, 1)),
    ("1x1s2", 8, (1, 1), (2, 2), (0, 0), (1, 1)),
    ("3x3s1", 8, (3, 3), (1, 1), (1, 1), (1, 1)),
    ("3x3s2", 8, (3, 3), (2, 2), (1, 1), (1, 1)),
    ("3x3_dilated", 4, (3, 3), (1, 1), (2, 2), (2, 2)),
    ("3x2_nonsquare", 5, (3, 2), (2, 1), (1, 2), (2, 1)),
]
IDS = [g[0] for g in GEOMETRIES]
NF = 6


def _inputs(seed, c, kernel, channels_last):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, c, 13, 11).astype(np.float32)
    w = (rng.randn(NF, c, *kernel) * 0.3).astype(np.float32)
    scale = (rng.rand(NF) + 0.5).astype(np.float32)
    bias = rng.randn(NF).astype(np.float32)
    tx = torch.from_numpy(x)
    if channels_last:
        tx = tx.contiguous(memory_format=torch.channels_last)
    return x, w, scale, bias, tx


def _implicit_patches(xc, geom):
    """The kernel's loader over every (m, k): ``[N*OH*OW, kh*kw*C]`` with
    row m = (n, oy, ox) and column k = (ky, kx, c), read from the flat
    channels-last ``xc`` at ``((n*H + iy)*W + ix)*C + c``, 0 outside."""
    n, h, w, c, oh, ow, _, kh, kw, sh, sw, ph, pw, dh, dw = geom
    m = torch.arange(n * oh * ow)[:, None]
    k = torch.arange(kh * kw * c)[None, :]
    img, r = m // (oh * ow), m % (oh * ow)
    oy, ox = r // ow, r % ow
    t, ch = k // c, k % c
    ky, kx = t // kw, t % kw
    iy = oy * sh - ph + ky * dh
    ix = ox * sw - pw + kx * dw
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    off = ((img * h + iy.clamp(0, h - 1)) * w + ix.clamp(0, w - 1)) * c + ch
    return torch.where(inside, xc.reshape(-1)[off], torch.zeros(()))


def _jax_patches(x, kernel, stride, pad, dilate):
    """``pallas_kernels.fused_conv_bn_act``'s patches: ``[N*OH*OW,
    C*kh*kw]``, columns in (c, ky, kx) order, and (OH, OW)."""
    p = lax.conv_general_dilated_patches(
        jnp.asarray(x), kernel, stride, ((pad[0],) * 2, (pad[1],) * 2),
        rhs_dilation=dilate, dimension_numbers=("NCHW", "OIHW", "NCHW"))
    nb, ckk, oh, ow = p.shape
    return np.asarray(p.transpose(0, 2, 3, 1).reshape(nb * oh * ow, ckk)), \
        oh, ow


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "cl"])
@pytest.mark.parametrize("name,c,kernel,stride,pad,dilate", GEOMETRIES,
                         ids=IDS)
def test_implicit_gather_matches_jax_patches(name, c, kernel, stride, pad,
                                             dilate, channels_last):
    x, w, _, _, tx = _inputs(3, c, kernel, channels_last)
    xc, wm, geom = K._conv_operands(tx, torch.from_numpy(w), stride, pad,
                                    dilate)
    want, oh, ow = _jax_patches(x, kernel, stride, pad, dilate)
    assert geom == (2, 13, 11, c, oh, ow, NF) + kernel + stride + pad + dilate
    assert tuple(xc.shape) == (2, 13, 11, c) and xc.is_contiguous()
    assert tuple(wm.shape) == (NF, kernel[0] * kernel[1] * c)
    assert wm.is_contiguous()
    got = _implicit_patches(xc, geom)
    # the same values, exactly, once the columns are in JAX's order
    kh, kw = kernel
    reordered = got.reshape(-1, kh, kw, c).permute(0, 3, 1, 2).reshape(
        got.shape[0], -1)
    np.testing.assert_array_equal(reordered.numpy(), want)
    # the GEMM with the permuted weight equals JAX's with its weight
    np.testing.assert_allclose((got @ wm.t()).numpy(),
                               want @ w.reshape(NF, -1).T, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,c,kernel,stride,pad,dilate", GEOMETRIES,
                         ids=IDS)
def test_conv_operands_copy_only_an_nchw_x(name, c, kernel, stride, pad,
                                           dilate):
    """A channels-last x goes to the kernel as the view it is (no copy);
    an NCHW x is made channels-last by one copy. The weight of a 1x1 conv
    needs no copy either."""
    _, w, _, _, cl = _inputs(4, c, kernel, True)
    tw = torch.from_numpy(w)
    xc, wm, _ = K._conv_operands(cl, tw, stride, pad, dilate)
    assert xc.data_ptr() == cl.data_ptr()
    nchw = cl.contiguous()
    xn, _, _ = K._conv_operands(nchw, tw, stride, pad, dilate)
    assert xn.data_ptr() != nchw.data_ptr() and torch.equal(xn, xc)
    if kernel == (1, 1):
        assert wm.data_ptr() == tw.data_ptr()


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "cl"])
@pytest.mark.parametrize("act", ["relu", "linear"])
@pytest.mark.parametrize("name,c,kernel,stride,pad,dilate", GEOMETRIES,
                         ids=IDS)
def test_fused_conv_bn_act_geometries_match_pallas(name, c, kernel, stride,
                                                   pad, dilate, act,
                                                   channels_last):
    """The port's fused_conv_bn_act on the CPU and the card path's
    arithmetic (the implicit patches, the permuted weight, the epilogue of
    fused_linear's plain version) against the Pallas kernel."""
    x, w, scale, bias, tx = _inputs(5, c, kernel, channels_last)
    kw = dict(stride=stride, pad=pad, dilate=dilate, act=act)
    want = np.asarray(pk.fused_conv_bn_act(
        *map(jnp.asarray, (x, w, scale, bias)), interpret=True, **kw))
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    got = K.fused_conv_bn_act(tx, torch.from_numpy(w), ts, tb, **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    xc, wm, geom = K._conv_operands(tx, torch.from_numpy(w), stride, pad,
                                    dilate)
    via = K.fused_linear_plain(_implicit_patches(xc, geom), wm, tb, act, ts)
    via = via.reshape(2, geom[4], geom[5], NF).permute(0, 3, 1, 2)
    np.testing.assert_allclose(via.numpy(), want, rtol=1e-4, atol=1e-4)
