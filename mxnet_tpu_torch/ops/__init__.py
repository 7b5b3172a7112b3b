"""Operator registry and the ops of the transformer LM and the ResNets;
``kernels`` holds the hand-written CUDA kernels with their plain PyTorch
versions."""
from . import registry  # noqa: F401
from . import tensor, nn, attention, loss  # noqa: F401  (registration)
