"""Custom operators defined in Python.

Counterpart of ``mxnet_tpu/operator.py`` (the reference's
``python/mxnet/operator.py``: ``PythonOp``/``NumpyOp``, synchronous
host-side ops over ``native_op-inl.h``'s C callback bridge, and
``NDArrayOp``, ``ndarray_op-inl.h``). The JAX package bridges to the host
with ``jax.pure_callback`` and ``custom_vjp`` inside the jitted program;
here the bridge is a ``torch.autograd.Function`` that copies its inputs to
numpy, calls the user's ``forward`` (and, on the backward pass, the
user's ``backward``) and copies the results back to the inputs' device.

Such an op reads device values on the host, so a graph that holds one
cannot be captured as a CUDA graph: its spec says ``host = True``, and
the programs built over such a graph (``ParallelTrainer``'s and
``PipelineTrainer``'s step, the fused ``fit``) run uncaptured, counted by
the ``program.uncaptured_runs`` telemetry counter. The serving engine
never holds one: its ``Decoder`` takes only the position-wise and
temporal ops of an LM and refuses any other op by name at its build, as
the JAX package's does.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ops.registry import OpSpec
from .symbol import Symbol, _Node, Variable
from .name import NameManager

__all__ = ["PythonOp", "NumpyOp", "NDArrayOp"]


class PythonOp:
    """Base class for Python-defined operators.

    Subclasses override ``forward(in_data, out_data)`` (write outputs into
    out_data in place), ``backward(out_grad, in_data, out_data, in_grad)``,
    ``infer_shape(in_shape) -> (in_shapes, out_shapes)``,
    ``list_arguments``/``list_outputs``. ``need_top_grad=False`` declares a
    loss op whose backward ignores head gradients (reference operator.py:
    NumpyOp(need_top_grad)).
    """

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    # --- user-overridable interface (defaults: the identity op, the
    # reference operator.py base-class behavior)
    def forward(self, in_data, out_data):
        out_data[0][:] = in_data[0]

    def backward(self, out_grad, in_data, out_data, in_grad):
        if self.need_top_grad_:
            in_grad[0][:] = out_grad[0]
        else:
            in_grad[0][:] = 1.0

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_

    # --- symbol creation ----------------------------------------------
    def __call__(self, *args, **kwargs):
        spec = self._make_spec()
        name = kwargs.pop("name", None)
        name = NameManager.current().get(name, type(self).__name__.lower())
        arg_names = self.list_arguments()
        inputs = [None] * len(arg_names)
        for i, s in enumerate(args):
            inputs[i] = s._single_head()
        for k, s in kwargs.items():
            if k not in arg_names:
                raise MXNetError("unknown input %s" % k)
            inputs[arg_names.index(k)] = s._single_head()
        for i, inp in enumerate(inputs):
            if inp is None:
                inputs[i] = Variable(name + "_" + arg_names[i])._single_head()
        node = _Node("_Python_" + type(self).__name__, spec, {}, name, inputs)
        return Symbol([(node, i) for i in range(len(self.list_outputs()))])

    def get_symbol(self, *args, **kwargs):
        return self(*args, **kwargs)

    def _make_spec(self):
        return _PythonOpSpec(self)


# NumpyOp and NDArrayOp share PythonOp's protocol; the reference's
# distinction (blocking TBlob callback vs async NDArray callback)
# collapses here — both run synchronously on the host.
class NumpyOp(PythonOp):
    pass


class NDArrayOp(PythonOp):
    pass


def _host(t):
    return t.detach().cpu().numpy()


class _HostBridge(torch.autograd.Function):
    """``pyop.forward`` and ``pyop.backward`` on host copies of the
    tensors, the results copied back to the inputs' device."""

    @staticmethod
    def forward(ctx, pyop, out_shapes, *xs):
        in_np = [_host(x) for x in xs]
        out_np = [np.zeros(s, dtype=in_np[0].dtype) for s in out_shapes]
        pyop.forward(in_data=in_np, out_data=out_np)
        dev = xs[0].device
        outs = tuple(torch.from_numpy(o).to(dev) for o in out_np)
        ctx.pyop = pyop
        ctx.n_in = len(xs)
        ctx.save_for_backward(*xs, *outs)
        return outs

    @staticmethod
    def backward(ctx, *gs):
        pyop = ctx.pyop
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        in_data = [_host(x) for x in xs]
        out_data = [_host(o) for o in outs]
        in_grad = [np.zeros_like(a) for a in in_data]
        # a loss op: the head gradients are not materialized (reference)
        out_grad = [_host(g) for g in gs] if pyop.need_top_grad() else []
        pyop.backward(out_grad=out_grad, in_data=in_data,
                      out_data=out_data, in_grad=in_grad)
        dev = xs[0].device
        return (None, None) + tuple(torch.from_numpy(g).to(dev)
                                    for g in in_grad)


class _PythonOpSpec(OpSpec):
    """Adapter presenting a PythonOp instance as an OpSpec."""

    # a host op: reads device values on the host, so a graph holding it
    # runs uncaptured (``parallel.graph.has_host_ops``)
    host = True

    def __init__(self, pyop):
        self.pyop = pyop
        self.name = "_Python_" + type(pyop).__name__

    def arguments(self, p):
        return self.pyop.list_arguments()

    def outputs(self, p):
        return self.pyop.list_outputs()

    def infer_shape(self, p, in_shapes):
        if in_shapes and in_shapes[0] is None:
            return list(in_shapes), [None] * len(self.pyop.list_outputs()), []
        # an input not known yet comes as an empty shape (the reference's
        # empty TShape): the op's infer_shape may fill it in
        ins, outs = self.pyop.infer_shape(
            [list(s) if s is not None else [] for s in in_shapes])
        return ([tuple(s) for s in ins], [tuple(o) for o in outs], [])

    def forward(self, p, ins, aux, is_train, generator):
        _, out_shapes = self.pyop.infer_shape([list(x.shape) for x in ins])
        outs = _HostBridge.apply(self.pyop, [tuple(s) for s in out_shapes],
                                 *ins)
        return list(outs), []
