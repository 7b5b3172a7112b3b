"""AlexNet (reference ``symbol_alexnet.py``; Krizhevsky et al. 2012,
single-tower variant): LRN, large ungrouped convs, dropout.

Counterpart of ``mxnet_tpu/models/alexnet.py``: the same graph, node
names and arguments. Its fc6 and fc7 (FullyConnected -> relu) run
``fused_linear`` under the port's ``FusionPlan``."""
from .. import symbol as sym


def get_alexnet(num_classes=1000):
    data = sym.Variable("data")
    # stage 1
    c1 = sym.Convolution(data, kernel=(11, 11), stride=(4, 4), num_filter=96)
    r1 = sym.Activation(c1, act_type="relu")
    p1 = sym.Pooling(r1, pool_type="max", kernel=(3, 3), stride=(2, 2))
    n1 = sym.LRN(p1, nsize=5, alpha=1e-4, beta=0.75)
    # stage 2
    c2 = sym.Convolution(n1, kernel=(5, 5), pad=(2, 2), num_filter=256)
    r2 = sym.Activation(c2, act_type="relu")
    p2 = sym.Pooling(r2, pool_type="max", kernel=(3, 3), stride=(2, 2))
    n2 = sym.LRN(p2, nsize=5, alpha=1e-4, beta=0.75)
    # stage 3: three 3x3 convs
    c3 = sym.Convolution(n2, kernel=(3, 3), pad=(1, 1), num_filter=384)
    r3 = sym.Activation(c3, act_type="relu")
    c4 = sym.Convolution(r3, kernel=(3, 3), pad=(1, 1), num_filter=384)
    r4 = sym.Activation(c4, act_type="relu")
    c5 = sym.Convolution(r4, kernel=(3, 3), pad=(1, 1), num_filter=256)
    r5 = sym.Activation(c5, act_type="relu")
    p3 = sym.Pooling(r5, pool_type="max", kernel=(3, 3), stride=(2, 2))
    # classifier
    fl = sym.Flatten(p3)
    f1 = sym.FullyConnected(fl, num_hidden=4096)
    r6 = sym.Activation(f1, act_type="relu")
    d1 = sym.Dropout(r6, p=0.5)
    f2 = sym.FullyConnected(d1, num_hidden=4096)
    r7 = sym.Activation(f2, act_type="relu")
    d2 = sym.Dropout(r7, p=0.5)
    f3 = sym.FullyConnected(d2, num_hidden=num_classes)
    return sym.SoftmaxOutput(f3, name="softmax")
