"""Small MNIST-class models (reference ``example/image-classification/
train_mnist.py:15-54``: get_mlp / get_lenet).

Counterpart of ``mxnet_tpu/models/classifiers.py``: the same graphs, node
names and arguments."""
from .. import symbol as sym


def get_mlp(num_classes=10, hidden=(128, 64)):
    """3-layer perceptron (train_mnist.py:15-26)."""
    net = sym.Variable("data")
    for i, h in enumerate(hidden):
        net = sym.FullyConnected(net, name="fc%d" % (i + 1), num_hidden=h)
        net = sym.Activation(net, name="relu%d" % (i + 1), act_type="relu")
    net = sym.FullyConnected(net, name="fc%d" % (len(hidden) + 1),
                             num_hidden=num_classes)
    return sym.SoftmaxOutput(net, name="softmax")


def get_lenet(num_classes=10):
    """LeNet-style conv net (train_mnist.py:28-54): two conv/tanh/pool
    stages then two fully-connected layers."""
    data = sym.Variable("data")
    c1 = sym.Convolution(data, name="conv1", kernel=(5, 5), num_filter=20)
    a1 = sym.Activation(c1, act_type="tanh")
    p1 = sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(p1, name="conv2", kernel=(5, 5), num_filter=50)
    a2 = sym.Activation(c2, act_type="tanh")
    p2 = sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    fl = sym.Flatten(p2)
    f1 = sym.FullyConnected(fl, name="fc1", num_hidden=500)
    a3 = sym.Activation(f1, act_type="tanh")
    f2 = sym.FullyConnected(a3, name="fc2", num_hidden=num_classes)
    return sym.SoftmaxOutput(f2, name="softmax")
