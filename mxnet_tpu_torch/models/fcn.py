"""FCN-32s/16s/8s semantic segmentation (reference
``example/fcn-xs/symbol_fcnxs.py``; Long et al. 2015): a VGG-16 backbone
with convolutionalized fc6/fc7, per-stage score heads, Deconvolution
upsampling, Crop-to-reference skip fusion, and a multi_output
SoftmaxOutput over the class-score map. conv1_1 is padded by 100 pixels,
as the reference pads it, so the crop offsets are the reference's.

Counterpart of ``mxnet_tpu/models/fcn.py``: the same graphs, node names
and arguments.
"""
from .. import symbol as sym


def _vgg_stage(net, reps, filters, si, first_pad=(1, 1)):
    for ri in range(reps):
        pad = first_pad if (si == 1 and ri == 0) else (1, 1)
        net = sym.Convolution(net, kernel=(3, 3), pad=pad,
                              num_filter=filters,
                              name="conv%d_%d" % (si, ri + 1))
        net = sym.Activation(net, act_type="relu",
                             name="relu%d_%d" % (si, ri + 1))
    return sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2),
                       name="pool%d" % si)


def _score_head(net, num_classes, name):
    return sym.Convolution(net, kernel=(1, 1), num_filter=num_classes,
                           name=name)


def get_fcn_symbol(num_classes=21, variant="32s"):
    """Build FCN-``variant`` (one of "32s", "16s", "8s")."""
    if variant not in ("32s", "16s", "8s"):
        raise ValueError("variant must be 32s/16s/8s, got %r" % (variant,))
    data = sym.Variable("data")
    net = _vgg_stage(data, 2, 64, 1, first_pad=(100, 100))
    net = _vgg_stage(net, 2, 128, 2)
    pool3 = _vgg_stage(net, 3, 256, 3)
    pool4 = _vgg_stage(pool3, 3, 512, 4)
    net = _vgg_stage(pool4, 3, 512, 5)
    # convolutionalized classifier head
    net = sym.Convolution(net, kernel=(7, 7), num_filter=4096, name="fc6")
    net = sym.Activation(net, act_type="relu", name="relu6")
    net = sym.Dropout(net, p=0.5, name="drop6")
    net = sym.Convolution(net, kernel=(1, 1), num_filter=4096, name="fc7")
    net = sym.Activation(net, act_type="relu", name="relu7")
    net = sym.Dropout(net, p=0.5, name="drop7")
    score = _score_head(net, num_classes, "score")

    if variant == "32s":
        up = sym.Deconvolution(score, kernel=(64, 64), stride=(32, 32),
                               num_filter=num_classes, no_bias=True,
                               name="upscore32")
        out = sym.Crop(up, data, num_args=2, offset=(19, 19), name="crop32")
    else:
        score2 = sym.Deconvolution(score, kernel=(4, 4), stride=(2, 2),
                                   num_filter=num_classes, no_bias=True,
                                   name="score2")
        sp4 = _score_head(pool4, num_classes, "score_pool4")
        sp4c = sym.Crop(sp4, score2, num_args=2, offset=(5, 5),
                        name="score_pool4c")
        fuse4 = score2 + sp4c
        if variant == "16s":
            up = sym.Deconvolution(fuse4, kernel=(32, 32), stride=(16, 16),
                                   num_filter=num_classes, no_bias=True,
                                   name="upscore16")
            out = sym.Crop(up, data, num_args=2, offset=(27, 27),
                           name="crop16")
        else:
            score4 = sym.Deconvolution(fuse4, kernel=(4, 4), stride=(2, 2),
                                       num_filter=num_classes, no_bias=True,
                                       name="score4")
            sp3 = _score_head(pool3, num_classes, "score_pool3")
            sp3c = sym.Crop(sp3, score4, num_args=2, offset=(9, 9),
                            name="score_pool3c")
            fuse3 = score4 + sp3c
            up = sym.Deconvolution(fuse3, kernel=(16, 16), stride=(8, 8),
                                   num_filter=num_classes, no_bias=True,
                                   name="upscore8")
            out = sym.Crop(up, data, num_args=2, offset=(31, 31),
                           name="crop8")
    return sym.SoftmaxOutput(out, multi_output=True, use_ignore=True,
                             ignore_label=255, name="softmax")
