"""Device context.

Counterpart of ``mxnet_tpu/context.py`` (Context stack, ``cpu()`` and
``gpu(i)``; dev type codes of ``include/mxnet/base.h:90-175``). Here
``gpu(i)`` names CUDA device ``i`` and ``Context.torch_device`` is the
``torch.device`` tensors are placed on.

The default context is ``gpu(0)``, where the JAX package and the
reference have ``cpu(0)``: every ``ctx=None`` (the NDArray factories,
``FeedForward``, ``current_context()``) means the card, and placing an
array there without CUDA raises as :func:`resolve_device` does. Code that
wants the host says so: ``ctx=cpu()`` or ``with cpu():``.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["Context", "current_context", "cpu", "gpu", "resolve_device"]


class Context:
    """A device context (device type + device id); kCPU=1, kGPU=2,
    kCPUPinned=3 as in the reference."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    default_ctx = None  # set below

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        elif isinstance(device_type, str):
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %s" % device_type)
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = device_id
        else:
            self.device_typeid = int(device_type)
            self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self):
        """The ``torch.device`` this context names: ``cuda:i`` for
        ``gpu(i)``, the host for ``cpu()``/``cpu_pinned()``."""
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = Context.default_ctx
        Context.default_ctx = self
        return self

    def __exit__(self, ptype, value, trace):
        Context.default_ctx = self._old_ctx


Context.default_ctx = Context("gpu", 0)


def cpu(device_id=0):
    """Return a CPU context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """Return the context of CUDA device ``device_id``."""
    return Context("gpu", device_id)


def current_context():
    """Return the current context (``gpu(0)`` unless a ``with ctx:``
    block says otherwise)."""
    return Context.default_ctx


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on. ``None`` means
    ``cuda:0``; with no CUDA device that raises instead of drifting onto
    the host — the caller asks for the CPU explicitly (``"cpu"``,
    ``cpu()``)."""
    if isinstance(device, Context):
        device = device.torch_device
    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the host")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("device %s requested but CUDA is not available"
                         % device)
    return device
