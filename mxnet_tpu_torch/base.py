"""Base types and dtype codes of the PyTorch port.

Counterpart of ``mxnet_tpu/base.py``: the ``MXNetError`` exception and the
mshadow dtype codes the ``.params`` format stores on disk
(``include/mxnet/base.h``: kFloat32=0, kFloat64=1, kFloat16=2, kUint8=3,
kInt32=4, plus the bfloat16 extension code 16). The port keeps its own
copy so that it never imports the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "DTYPE_TORCH_TO_MX", "DTYPE_MX_TO_TORCH",
           "torch_dtype", "later_slice", "refuse_unported"]


class MXNetError(Exception):
    """Error raised by the framework (parity: ``MXGetLastError`` errors)."""


def later_slice(owner, what):
    """The error for a feature of the JAX package the port has not yet."""
    return MXNetError("%s: %s belongs to a later slice of the PyTorch port"
                      % (owner, what))


def refuse_unported(owner, **params):
    """Raise :func:`later_slice` for the first of ``params`` (``name=(value,
    default)``, a parameter the port accepts where the JAX package has it
    but does not implement) that is set to anything but its default."""
    for name, (value, default) in params.items():
        if value is not None if default is None else value != default:
            raise later_slice(owner, "%s=%r" % (name, value))


# the .params type flags by torch dtype (numpy arrays travel as tensors:
# numpy has no bfloat16 of its own)
DTYPE_TORCH_TO_MX = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.uint8: 3,
    torch.int32: 4,
    torch.bfloat16: 16,
}
DTYPE_MX_TO_TORCH = {v: k for k, v in DTYPE_TORCH_TO_MX.items()}

_BY_NAME = {"float32": torch.float32, "float64": torch.float64,
            "float16": torch.float16, "bfloat16": torch.bfloat16,
            "uint8": torch.uint8, "int8": torch.int8,
            "int32": torch.int32, "int64": torch.int64}


def torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a name such as
    ``"bfloat16"``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _BY_NAME:
        raise MXNetError("unsupported dtype %s" % (dtype,))
    return _BY_NAME[name]
