"""Model zoo of the PyTorch port: symbol constructors for the reference's
example model families.

Counterpart of ``mxnet_tpu/models/__init__.py`` (the reference's
``example/``): :mod:`.classifiers` (``train_mnist.py``'s MLP and LeNet),
:mod:`.alexnet`, :mod:`.vgg`, :mod:`.resnet`, :mod:`.inception`
(Inception-BN, its CIFAR-10 small net, GoogLeNet, Inception-v3),
:mod:`.lstm` (the unrolled LSTM LM), :mod:`.fcn` (FCN-32s/16s/8s) and
:mod:`.transformer`. Every classifier ends in a ``SoftmaxOutput`` and
drops straight into ``FeedForward``; ``get_symbol(name, **kw)`` mirrors
the reference's ``train_model.py --network`` dispatch.
"""
from . import (classifiers, alexnet, vgg, resnet,  # noqa: F401
               inception, lstm, fcn)
from .classifiers import get_mlp, get_lenet
from .alexnet import get_alexnet
from .vgg import get_vgg
from .resnet import (get_resnet, get_resnet_cifar,  # noqa: F401
                     residual_unit, convert_stem_weight_s2d,
                     space_to_depth_batch)
from .inception import (get_inception_bn_small, get_inception_bn,
                        get_inception_v3, get_googlenet)
from .lstm import lstm_unroll, LSTMState, LSTMParam  # noqa: F401
from .fcn import get_fcn_symbol
from . import transformer  # noqa: F401
from .transformer import (get_transformer_lm, transformer_block,  # noqa: F401
                          moe_transformer_block)

_REGISTRY = {
    "mlp": get_mlp,
    "lenet": get_lenet,
    "alexnet": get_alexnet,
    "vgg": get_vgg,
    "resnet": get_resnet,
    "resnet-28-small": get_resnet_cifar,
    "inception-bn-28-small": get_inception_bn_small,
    "inception-bn": get_inception_bn,
    "inception-v3": get_inception_v3,
    "googlenet": get_googlenet,
    "fcn-xs": get_fcn_symbol,
}


def get_symbol(name, **kwargs):
    """Construct a model symbol by name (``train_model.py --network``)."""
    if name not in _REGISTRY:
        raise ValueError("unknown network %r (have: %s)"
                         % (name, ", ".join(sorted(_REGISTRY))))
    return _REGISTRY[name](**kwargs)
