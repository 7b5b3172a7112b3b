"""Inception family.

Counterpart of ``mxnet_tpu/models/inception.py``: the same graphs, node
names and arguments.

* :func:`get_inception_bn_small`: the CIFAR-10 net of the reference
  README (``symbol_inception-bn-28-small.py``).
* :func:`get_inception_bn`: BN-Inception for ImageNet
  (``symbol_inception-bn.py`` / ``-full.py``; Ioffe & Szegedy 2015), the
  default network of ``example/image-classification/train_imagenet.py``.
* :func:`get_googlenet`: the original GoogLeNet (``symbol_googlenet.py``).
* :func:`get_inception_v3`: factorized-conv Inception
  (``symbol_inception-v3.py``; Szegedy et al. 2015).

Widths follow the published papers. Every ``conv_factory`` with BatchNorm
is a Convolution -> BatchNorm -> relu chain: ``fused_conv_bn_act`` on
eval under the port's ``FusionPlan``, and ``matmul_stats`` in training
for the 1x1 ones when ``MXNET_PALLAS_CONVBN_TRAIN=1``.
"""
from .. import symbol as sym


def conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                 name=None, with_bn=True, act_type="relu"):
    """Conv → (BN) → ReLU block, the unit every Inception variant builds
    from (reference ConvFactory)."""
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=with_bn,
                        name=None if name is None else name + "_conv")
    if with_bn:
        c = sym.BatchNorm(c, fix_gamma=False,
                          name=None if name is None else name + "_bn")
    return sym.Activation(c, act_type=act_type,
                          name=None if name is None else name + "_relu")


# ---------------------------------------------------------------------------
# CIFAR-10 inception-bn-28-small
def _simple_module(data, ch_1x1, ch_3x3, name):
    b1 = conv_factory(data, ch_1x1, (1, 1), name=name + "_1x1")
    b3 = conv_factory(data, ch_3x3, (3, 3), pad=(1, 1), name=name + "_3x3")
    return sym.Concat(b1, b3, name=name + "_concat")


def _downsample_module(data, ch_3x3, name):
    b3 = conv_factory(data, ch_3x3, (3, 3), stride=(2, 2), pad=(1, 1),
                      name=name + "_3x3")
    pool = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                       name=name + "_pool")
    return sym.Concat(b3, pool, name=name + "_concat")


def get_inception_bn_small(num_classes=10):
    data = sym.Variable("data")
    net = conv_factory(data, 96, (3, 3), pad=(1, 1), name="conv1")
    net = _simple_module(net, 32, 32, "in3a")
    net = _simple_module(net, 32, 48, "in3b")
    net = _downsample_module(net, 80, "in3c")
    net = _simple_module(net, 112, 48, "in4a")
    net = _simple_module(net, 96, 64, "in4b")
    net = _simple_module(net, 80, 80, "in4c")
    net = _simple_module(net, 48, 96, "in4d")
    net = _downsample_module(net, 96, "in4e")
    net = _simple_module(net, 176, 160, "in5a")
    net = _simple_module(net, 176, 160, "in5b")
    net = sym.Pooling(net, pool_type="avg", kernel=(1, 1), global_pool=True,
                      name="global_pool")
    net = sym.Flatten(net, name="flatten1")
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")


# ---------------------------------------------------------------------------
# BN-Inception (ImageNet)
def _inception_bn_module(data, f1, f3r, f3, fd3r, fd3, proj, pool, name):
    branches = []
    if f1:
        branches.append(conv_factory(data, f1, (1, 1), name=name + "_1x1"))
    b3 = conv_factory(data, f3r, (1, 1), name=name + "_3x3r")
    branches.append(conv_factory(b3, f3, (3, 3), pad=(1, 1),
                                 name=name + "_3x3"))
    bd = conv_factory(data, fd3r, (1, 1), name=name + "_d3x3r")
    bd = conv_factory(bd, fd3, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    branches.append(conv_factory(bd, fd3, (3, 3), pad=(1, 1),
                                 name=name + "_d3x3b"))
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type=pool, name=name + "_pool")
    branches.append(conv_factory(p, proj, (1, 1), name=name + "_proj"))
    return sym.Concat(*branches, name=name + "_concat")


def _inception_bn_downsample(data, f3r, f3, fd3r, fd3, name):
    b3 = conv_factory(data, f3r, (1, 1), name=name + "_3x3r")
    b3 = conv_factory(b3, f3, (3, 3), stride=(2, 2), pad=(1, 1),
                      name=name + "_3x3")
    bd = conv_factory(data, fd3r, (1, 1), name=name + "_d3x3r")
    bd = conv_factory(bd, fd3, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    bd = conv_factory(bd, fd3, (3, 3), stride=(2, 2), pad=(1, 1),
                      name=name + "_d3x3b")
    p = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name=name + "_pool")
    return sym.Concat(b3, bd, p, name=name + "_concat")


def get_inception_bn(num_classes=1000):
    data = sym.Variable("data")
    net = conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3),
                       name="conv1")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = conv_factory(net, 64, (1, 1), name="conv2r")
    net = conv_factory(net, 192, (3, 3), pad=(1, 1), name="conv2")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="pool2")
    net = _inception_bn_module(net, 64, 64, 64, 64, 96, 32, "avg", "in3a")
    net = _inception_bn_module(net, 64, 64, 96, 64, 96, 64, "avg", "in3b")
    net = _inception_bn_downsample(net, 128, 160, 64, 96, "in3c")
    net = _inception_bn_module(net, 224, 64, 96, 96, 128, 128, "avg", "in4a")
    net = _inception_bn_module(net, 192, 96, 128, 96, 128, 128, "avg", "in4b")
    net = _inception_bn_module(net, 160, 128, 160, 128, 160, 96, "avg",
                               "in4c")
    net = _inception_bn_module(net, 96, 128, 192, 160, 192, 96, "avg", "in4d")
    net = _inception_bn_downsample(net, 128, 192, 192, 256, "in4e")
    net = _inception_bn_module(net, 352, 192, 320, 160, 224, 128, "avg",
                               "in5a")
    net = _inception_bn_module(net, 352, 192, 320, 192, 224, 128, "max",
                               "in5b")
    net = sym.Pooling(net, kernel=(1, 1), global_pool=True, pool_type="avg",
                      name="global_pool")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")


# ---------------------------------------------------------------------------
# GoogLeNet (Inception v1, no BN)
def _googlenet_module(data, f1, f3r, f3, f5r, f5, proj, name):
    b1 = conv_factory(data, f1, (1, 1), name=name + "_1x1", with_bn=False)
    b3 = conv_factory(data, f3r, (1, 1), name=name + "_3x3r", with_bn=False)
    b3 = conv_factory(b3, f3, (3, 3), pad=(1, 1), name=name + "_3x3",
                      with_bn=False)
    b5 = conv_factory(data, f5r, (1, 1), name=name + "_5x5r", with_bn=False)
    b5 = conv_factory(b5, f5, (5, 5), pad=(2, 2), name=name + "_5x5",
                      with_bn=False)
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="max", name=name + "_pool")
    p = conv_factory(p, proj, (1, 1), name=name + "_proj", with_bn=False)
    return sym.Concat(b1, b3, b5, p, name=name + "_concat")


def get_googlenet(num_classes=1000):
    data = sym.Variable("data")
    net = conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3),
                       name="conv1", with_bn=False)
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = conv_factory(net, 64, (1, 1), name="conv2r", with_bn=False)
    net = conv_factory(net, 192, (3, 3), pad=(1, 1), name="conv2",
                       with_bn=False)
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="pool2")
    net = _googlenet_module(net, 64, 96, 128, 16, 32, 32, "in3a")
    net = _googlenet_module(net, 128, 128, 192, 32, 96, 64, "in3b")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="pool3")
    net = _googlenet_module(net, 192, 96, 208, 16, 48, 64, "in4a")
    net = _googlenet_module(net, 160, 112, 224, 24, 64, 64, "in4b")
    net = _googlenet_module(net, 128, 128, 256, 24, 64, 64, "in4c")
    net = _googlenet_module(net, 112, 144, 288, 32, 64, 64, "in4d")
    net = _googlenet_module(net, 256, 160, 320, 32, 128, 128, "in4e")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="pool4")
    net = _googlenet_module(net, 256, 160, 320, 32, 128, 128, "in5a")
    net = _googlenet_module(net, 384, 192, 384, 48, 128, 128, "in5b")
    net = sym.Pooling(net, kernel=(1, 1), global_pool=True, pool_type="avg",
                      name="global_pool")
    net = sym.Flatten(net)
    net = sym.Dropout(net, p=0.4)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")


# ---------------------------------------------------------------------------
# Inception-v3
def _inception_a(data, pool_proj, name):
    b1 = conv_factory(data, 64, (1, 1), name=name + "_1x1")
    b5 = conv_factory(data, 48, (1, 1), name=name + "_5x5r")
    b5 = conv_factory(b5, 64, (5, 5), pad=(2, 2), name=name + "_5x5")
    b3 = conv_factory(data, 64, (1, 1), name=name + "_d3x3r")
    b3 = conv_factory(b3, 96, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    b3 = conv_factory(b3, 96, (3, 3), pad=(1, 1), name=name + "_d3x3b")
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="avg", name=name + "_pool")
    p = conv_factory(p, pool_proj, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b5, b3, p, name=name + "_concat")


def _reduction_a(data, name):
    b3 = conv_factory(data, 384, (3, 3), stride=(2, 2), name=name + "_3x3")
    bd = conv_factory(data, 64, (1, 1), name=name + "_d3x3r")
    bd = conv_factory(bd, 96, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    bd = conv_factory(bd, 96, (3, 3), stride=(2, 2), name=name + "_d3x3b")
    p = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name=name + "_pool")
    return sym.Concat(b3, bd, p, name=name + "_concat")


def _inception_b(data, c7, name):
    b1 = conv_factory(data, 192, (1, 1), name=name + "_1x1")
    b7 = conv_factory(data, c7, (1, 1), name=name + "_7x7r")
    b7 = conv_factory(b7, c7, (1, 7), pad=(0, 3), name=name + "_1x7a")
    b7 = conv_factory(b7, 192, (7, 1), pad=(3, 0), name=name + "_7x1a")
    bd = conv_factory(data, c7, (1, 1), name=name + "_d7r")
    bd = conv_factory(bd, c7, (7, 1), pad=(3, 0), name=name + "_7x1b")
    bd = conv_factory(bd, c7, (1, 7), pad=(0, 3), name=name + "_1x7b")
    bd = conv_factory(bd, c7, (7, 1), pad=(3, 0), name=name + "_7x1c")
    bd = conv_factory(bd, 192, (1, 7), pad=(0, 3), name=name + "_1x7c")
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="avg", name=name + "_pool")
    p = conv_factory(p, 192, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b7, bd, p, name=name + "_concat")


def _reduction_b(data, name):
    b3 = conv_factory(data, 192, (1, 1), name=name + "_3x3r")
    b3 = conv_factory(b3, 320, (3, 3), stride=(2, 2), name=name + "_3x3")
    b7 = conv_factory(data, 192, (1, 1), name=name + "_7x7r")
    b7 = conv_factory(b7, 192, (1, 7), pad=(0, 3), name=name + "_1x7")
    b7 = conv_factory(b7, 192, (7, 1), pad=(3, 0), name=name + "_7x1")
    b7 = conv_factory(b7, 192, (3, 3), stride=(2, 2), name=name + "_3x3b")
    p = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name=name + "_pool")
    return sym.Concat(b3, b7, p, name=name + "_concat")


def _inception_c(data, name):
    b1 = conv_factory(data, 320, (1, 1), name=name + "_1x1")
    b3 = conv_factory(data, 384, (1, 1), name=name + "_3x3r")
    b3a = conv_factory(b3, 384, (1, 3), pad=(0, 1), name=name + "_1x3")
    b3b = conv_factory(b3, 384, (3, 1), pad=(1, 0), name=name + "_3x1")
    bd = conv_factory(data, 448, (1, 1), name=name + "_d3r")
    bd = conv_factory(bd, 384, (3, 3), pad=(1, 1), name=name + "_d3")
    bda = conv_factory(bd, 384, (1, 3), pad=(0, 1), name=name + "_d1x3")
    bdb = conv_factory(bd, 384, (3, 1), pad=(1, 0), name=name + "_d3x1")
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="avg", name=name + "_pool")
    p = conv_factory(p, 192, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b3a, b3b, bda, bdb, p, name=name + "_concat")


def get_inception_v3(num_classes=1000):
    """Input NCHW 3x299x299."""
    data = sym.Variable("data")
    net = conv_factory(data, 32, (3, 3), stride=(2, 2), name="conv1")
    net = conv_factory(net, 32, (3, 3), name="conv2")
    net = conv_factory(net, 64, (3, 3), pad=(1, 1), name="conv3")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = conv_factory(net, 80, (1, 1), name="conv4")
    net = conv_factory(net, 192, (3, 3), name="conv5")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="pool2")
    net = _inception_a(net, 32, "in_a1")
    net = _inception_a(net, 64, "in_a2")
    net = _inception_a(net, 64, "in_a3")
    net = _reduction_a(net, "red_a")
    net = _inception_b(net, 128, "in_b1")
    net = _inception_b(net, 160, "in_b2")
    net = _inception_b(net, 160, "in_b3")
    net = _inception_b(net, 192, "in_b4")
    net = _reduction_b(net, "red_b")
    net = _inception_c(net, "in_c1")
    net = _inception_c(net, "in_c2")
    net = sym.Pooling(net, kernel=(1, 1), global_pool=True, pool_type="avg",
                      name="global_pool")
    net = sym.Flatten(net)
    net = sym.Dropout(net, p=0.5)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")
