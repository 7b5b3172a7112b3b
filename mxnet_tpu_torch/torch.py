"""Torch interop: torch tensors and modules on NDArrays.

Counterpart of ``mxnet_tpu/torch.py`` (the reference's ``plugin/torch``
and ``python/mxnet/torch.py``). This module is ``mxnet_tpu_torch.torch``:
every module of the package imports ``torch`` absolutely, so it never
shadows the library — but it must never be run as a script from inside
the package directory.

* :func:`to_torch` returns a COPY of the array's tensor (a write to it
  does not reach the NDArray, as the JAX package's numpy round trip
  does not), on the array's device — where the JAX package always hands
  back a host tensor.
* :func:`from_torch` copies a tensor into a new NDArray, on ``ctx`` or
  else on the tensor's device.
* :class:`TorchModuleOp` embeds an ``nn.Module`` as a symbolic operator:
  the module runs on the op's device under autograd (gradients flow to
  its inputs; its own parameters are torch-owned and frozen for the
  graph, as the reference's TorchModule with frozen params). It counts
  as a host op (``PythonOp``'s rule: the module may do anything), so a
  graph that holds one runs uncaptured.
"""
from __future__ import annotations

import numpy as np
import torch

from .ndarray import NDArray
from .operator import PythonOp, _PythonOpSpec

__all__ = ["to_torch", "from_torch", "TorchModuleOp", "th_function"]


def to_torch(nd_arr):
    """NDArray -> torch.Tensor: a copy, on the array's device."""
    return nd_arr._tensor.detach().clone()


def from_torch(tensor, ctx=None):
    """torch.Tensor -> NDArray (a copy), on ``ctx`` or the tensor's
    device."""
    t = tensor.detach()
    if ctx is not None:
        t = t.to(ctx.torch_device)
    return NDArray._from_tensor(t.clone(), ctx)


def th_function(fn, *nds):
    """Apply a torch function to NDArrays (reference mxnet.th.*
    dispatch); the results come back as NDArrays."""
    outs = fn(*[to_torch(x) for x in nds])
    if isinstance(outs, (list, tuple)):
        return [from_torch(o) for o in outs]
    return from_torch(outs)


def _module_device(module):
    for p in module.parameters():
        return p.device
    for b in module.buffers():
        return b.device
    return torch.device("cpu")


class TorchModuleOp(PythonOp):
    """Wrap a ``torch.nn.Module`` as a symbolic operator.

    The module's parameters are torch-owned (updated by torch optimizers
    if desired); the op exposes only data inputs, like the reference's
    TorchModule with frozen params. Gradients w.r.t. inputs flow back into
    the surrounding graph through torch autograd.
    """

    def __init__(self, module, num_inputs=1, need_top_grad=True):
        super().__init__(need_top_grad=need_top_grad)
        self.module = module
        self.num_inputs = num_inputs
        self._saved = None

    def list_arguments(self):
        return ["data"] if self.num_inputs == 1 \
            else ["data%d" % i for i in range(self.num_inputs)]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        dev = _module_device(self.module)
        with torch.no_grad():
            dummies = [torch.zeros(*s, device=dev) for s in in_shape]
            out = self.module(*dummies)
        return in_shape, [list(out.shape)]

    # the numpy protocol of PythonOp, for callers that drive the op by
    # hand (the graph runs the module on tensors: _TorchModuleSpec)
    def forward(self, in_data, out_data):
        dev = _module_device(self.module)
        xs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              .requires_grad_(True) for a in in_data]
        out = self.module(*xs)
        self._saved = (xs, out)
        out_data[0][:] = out.detach().cpu().numpy()

    def backward(self, out_grad, in_data, out_data, in_grad):
        xs, out = self._saved if self._saved else (None, None)
        if xs is None:
            # recompute (backward without forward in this process)
            self.forward(in_data, [np.empty_like(out_data[0])])
            xs, out = self._saved
        g = torch.from_numpy(np.ascontiguousarray(out_grad[0])).to(
            out.device) if out_grad else torch.ones_like(out)
        grads = torch.autograd.grad(out, xs, grad_outputs=g,
                                    allow_unused=True)
        for dst, gt in zip(in_grad, grads):
            dst[:] = 0 if gt is None else gt.detach().cpu().numpy()
        self._saved = None

    def _make_spec(self):
        return _TorchModuleSpec(self)


class _TorchModuleSpec(_PythonOpSpec):
    """The module on the inputs' device, under autograd, with its
    parameters frozen (detached) for the graph."""

    def forward(self, p, ins, aux, is_train, generator):
        mod = self.pyop.module
        dev = ins[0].device
        if _module_device(mod) != dev:
            mod.to(dev)
        params = {k: v.detach() for k, v in mod.named_parameters()}
        params.update(dict(mod.named_buffers()))
        out = torch.func.functional_call(mod, params, tuple(ins))
        return [out], []
