"""Model zoo of the PyTorch port: the transformer LM and the ResNets."""
from .transformer import get_transformer_lm, transformer_block  # noqa: F401
from .resnet import (get_resnet, get_resnet_cifar,  # noqa: F401
                     residual_unit, convert_stem_weight_s2d,
                     space_to_depth_batch)
