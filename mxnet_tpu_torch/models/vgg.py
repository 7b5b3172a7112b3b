"""VGG-11/13/16/19 (reference ``symbol_vgg.py`` is the 16-layer net;
Simonyan & Zisserman 2014). ``num_layers`` selects the config.

Counterpart of ``mxnet_tpu/models/vgg.py``: the same graphs, node names
and arguments. fc6 and fc7 (FullyConnected -> relu) run ``fused_linear``
under the port's ``FusionPlan``; the convs have no BatchNorm, so they
run ``F.conv2d``."""
from .. import symbol as sym

_CONFIGS = {
    11: ((1, 64), (1, 128), (2, 256), (2, 512), (2, 512)),
    13: ((2, 64), (2, 128), (2, 256), (2, 512), (2, 512)),
    16: ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)),
    19: ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512)),
}


def vgg_backbone(data, num_layers=16, with_pool5=True):
    """Conv body shared with FCN (fcn.py builds its skip heads off the
    stage outputs). Returns (net, stage_outputs)."""
    stages = []
    net = data
    for si, (reps, filters) in enumerate(_CONFIGS[num_layers], start=1):
        for ri in range(reps):
            net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=filters,
                                  name="conv%d_%d" % (si, ri + 1))
            net = sym.Activation(net, act_type="relu",
                                 name="relu%d_%d" % (si, ri + 1))
        if si < 5 or with_pool5:
            net = sym.Pooling(net, pool_type="max", kernel=(2, 2),
                              stride=(2, 2), name="pool%d" % si)
        stages.append(net)
    return net, stages


def get_vgg(num_classes=1000, num_layers=16):
    data = sym.Variable("data")
    net, _ = vgg_backbone(data, num_layers)
    fl = sym.Flatten(net)
    f6 = sym.FullyConnected(fl, num_hidden=4096, name="fc6")
    r6 = sym.Activation(f6, act_type="relu")
    d6 = sym.Dropout(r6, p=0.5)
    f7 = sym.FullyConnected(d6, num_hidden=4096, name="fc7")
    r7 = sym.Activation(f7, act_type="relu")
    d7 = sym.Dropout(r7, p=0.5)
    f8 = sym.FullyConnected(d7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(f8, name="softmax")
