"""ResNets (He et al. 2015).

Counterpart of ``mxnet_tpu/models/resnet.py``:

* :func:`get_resnet_cifar`: the 6n+2 CIFAR net (reference
  ``symbol_resnet-28-small.py``: conv3x3-16 stem, three stages of n
  residual units at 16/32/64 filters, global-avg-pool, fc).
* :func:`get_resnet`: ImageNet ResNet-18/34/50/101/152, the JAX
  package's headline model (``bench.py``).

Every conv is followed by a BatchNorm as its sole consumer, so the
port's ``FusionPlan`` runs each conv -> BN [-> relu] chain as
``fused_conv_bn_act`` on eval, and the pointwise ones as ``matmul_stats``
in training when ``MXNET_PALLAS_CONVBN_TRAIN=1``.
"""
from .. import symbol as sym


def _conv_bn(data, num_filter, kernel, stride, pad, name, act=True,
             eps=2e-5, momentum=0.9):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name=name + "_conv")
    b = sym.BatchNorm(c, eps=eps, momentum=momentum, fix_gamma=False,
                      name=name + "_bn")
    if act:
        return sym.Activation(b, act_type="relu", name=name + "_relu")
    return b


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottleneck=True):
    """Post-activation residual unit (v1). ``dim_match=False`` projects the
    shortcut with a strided 1x1 conv+BN."""
    if bottleneck:
        mid = num_filter // 4
        body = _conv_bn(data, mid, (1, 1), (1, 1), (0, 0), name + "_a")
        body = _conv_bn(body, mid, (3, 3), stride, (1, 1), name + "_b")
        body = _conv_bn(body, num_filter, (1, 1), (1, 1), (0, 0),
                        name + "_c", act=False)
    else:
        body = _conv_bn(data, num_filter, (3, 3), stride, (1, 1),
                        name + "_a")
        body = _conv_bn(body, num_filter, (3, 3), (1, 1), (1, 1),
                        name + "_b", act=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn(data, num_filter, (1, 1), stride, (0, 0),
                            name + "_sc", act=False)
    return sym.Activation(body + shortcut, act_type="relu",
                          name=name + "_out")


_UNITS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


def get_resnet(num_classes=1000, num_layers=50, stem="standard"):
    """ImageNet ResNet. Input is NCHW 3x224x224.

    ``stem="s2d"`` replaces the 7x7/2 stem convolution with the
    MLPerf-style space-to-depth form: SpaceToDepth(2) then a 4x4/1
    convolution on 12 channels (cropped back to the same spatial size)
    — EXACTLY the same function (see ``convert_stem_weight_s2d``). The
    stem weight shape changes to [64, 12, 4, 4]; convert standard
    checkpoints with ``convert_stem_weight_s2d``.

    ``stem="s2d_input"``: the network consumes data ALREADY dealt to
    (12, 112, 112); the transform is done once in the input pipeline
    (``space_to_depth_batch``).
    """
    units, bottleneck = _UNITS[num_layers]
    filters = [256, 512, 1024, 2048] if bottleneck else [64, 128, 256, 512]
    data = sym.Variable("data")
    if stem in ("s2d", "s2d_input"):
        # "s2d": deal in-graph; "s2d_input": data arrives pre-dealt
        body = (sym.SpaceToDepth(data, block_size=2, name="stem_s2d")
                if stem == "s2d" else data)
        body = sym.Convolution(body, num_filter=64, kernel=(4, 4),
                               stride=(1, 1), pad=(2, 2), no_bias=True,
                               name="stem_conv")
        # pad 2 (symmetric) overshoots the exact left-2/right-1 halo by
        # one row/col; crop back so every output pixel matches the
        # standard stem bit-for-bit (Crop keeps offset (0,0))
        body = sym.Crop(body, offset=(0, 0), h_w=(112, 112), num_args=1,
                        name="stem_crop")
        body = sym.BatchNorm(body, eps=2e-5, momentum=0.9,
                             fix_gamma=False, name="stem_bn")
        body = sym.Activation(body, act_type="relu", name="stem_relu")
    elif stem == "standard":
        body = _conv_bn(data, 64, (7, 7), (2, 2), (3, 3), "stem")
    else:
        raise ValueError("get_resnet: stem must be 'standard', 's2d' "
                         "or 's2d_input'")
    body = sym.Pooling(body, pool_type="max", kernel=(3, 3), stride=(2, 2),
                       name="stem_pool")
    for si, (n, f) in enumerate(zip(units, filters), start=1):
        for ui in range(n):
            stride = (2, 2) if si > 1 and ui == 0 else (1, 1)
            body = residual_unit(body, f, stride, ui > 0,
                                 "stage%d_unit%d" % (si, ui + 1),
                                 bottleneck)
    pool = sym.Pooling(body, pool_type="avg", kernel=(1, 1), global_pool=True,
                       name="global_pool")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")


def get_resnet_cifar(num_classes=10, n=3, image_hw=28):
    """CIFAR 6n+2 ResNet (n=3 -> 20 layers); reference
    symbol_resnet-28-small.py trains on 28x28 crops."""
    data = sym.Variable("data")
    body = _conv_bn(data, 16, (3, 3), (1, 1), (1, 1), "stem")
    for si, f in enumerate([16, 32, 64], start=1):
        for ui in range(n):
            stride = (2, 2) if si > 1 and ui == 0 else (1, 1)
            body = residual_unit(body, f, stride, not (ui == 0 and si > 1),
                                 "stage%d_unit%d" % (si, ui + 1),
                                 bottleneck=False)
    final_hw = image_hw // 4
    pool = sym.Pooling(body, pool_type="avg", kernel=(final_hw, final_hw),
                       name="global_pool")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")


def convert_stem_weight_s2d(w):
    """EXACT reparameterization of a standard [O, C, 7, 7] stride-2 stem
    weight into the [O, C*4, 4, 4] stride-1 weight the ``stem="s2d"``
    graph uses: with input pixels dealt as z[c*4 + p*2 + q, i, j] =
    x[c, 2i+p, 2j+q], matching the original needs u = 2a + p - 1 (and
    likewise for columns), so kernel tap (u, v) lands at
    (a, b) = ((u+1)//2, (v+1)//2) with parities ((u+1)%2, (v+1)%2);
    the unreachable (a=0, parity=0) taps stay zero."""
    import numpy as np
    w = np.asarray(w)
    O, C, kh, kw = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError("convert_stem_weight_s2d expects a 7x7 kernel")
    out = np.zeros((O, C * 4, 4, 4), w.dtype)
    for u in range(7):
        a, p = (u + 1) // 2, (u + 1) % 2
        for v in range(7):
            b, q = (v + 1) // 2, (v + 1) % 2
            for c in range(C):
                out[:, c * 4 + p * 2 + q, a, b] = w[:, c, u, v]
    return out


def space_to_depth_batch(x, block_size=2):
    """Host-side input transform for ``get_resnet(stem="s2d_input")``:
    [B, C, H, W] -> [B, C*bs*bs, H/bs, W/bs] with the same channel
    order as the SpaceToDepth op (c*bs*bs + p*bs + q)."""
    import numpy as np
    x = np.asarray(x)
    b, c, h, w = x.shape
    bs = block_size
    r = x.reshape(b, c, h // bs, bs, w // bs, bs)
    return np.ascontiguousarray(
        r.transpose(0, 1, 3, 5, 2, 4)).reshape(b, c * bs * bs,
                                               h // bs, w // bs)
