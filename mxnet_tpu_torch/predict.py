"""Deployment predictor: the C predict API's Python side.

Counterpart of ``mxnet_tpu/predict.py`` (the reference's
``include/mxnet/c_predict_api.h`` + ``src/c_api/c_predict_api.cc``):
create a predictor from (symbol JSON, parameter bytes), forward only, no
autodiff. The forward is the port's ``make_graph_fn`` with fusion on, so a
conv net's ``Convolution -> BatchNorm [-> relu]`` chains run as
``fused_conv_bn_act`` and its ``FullyConnected -> Activation`` chains as
``fused_linear`` on the card.

``dev_type``/``dev_id`` choose the device: ``"gpu"`` or 2 is
``cuda:dev_id`` (the default), ``"cpu"`` or 1 the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from . import ndarray as nd
from . import symbol as sym_mod
from .parallel.graph import make_graph_fn, integer_semantic_inputs

__all__ = ["Predictor"]


def _predict_device(dev_type, dev_id):
    if dev_type in ("gpu", 2):
        return resolve_device(torch.device("cuda", int(dev_id)))
    if dev_type in ("cpu", 1):
        return torch.device("cpu")
    raise MXNetError("Predictor: unknown dev_type %r (gpu/2 or cpu/1)"
                     % (dev_type,))


class Predictor:
    """Forward-only executor over a frozen graph.

    Parameters
    ----------
    symbol_json : str — symbol JSON text or a path to it
    param_data : bytes | str | dict — .params file bytes, path, or an
        already-loaded {'arg:name'/'aux:name' -> NDArray} dict
    input_shapes : dict name -> shape
    dev_type/dev_id : ``"gpu"``/2 (``cuda:dev_id``) or ``"cpu"``/1
    output_names : optional list of internal output names — re-heads
        the graph there (reference MXPredCreatePartialOut; feature
        extraction from intermediate layers)
    """

    def __init__(self, symbol_json, param_data, input_shapes,
                 dev_type="gpu", dev_id=0, output_names=None):
        self.device = _predict_device(dev_type, dev_id)
        if "{" not in symbol_json:  # path, not JSON text
            with open(symbol_json) as f:
                symbol_json = f.read()
        self._symbol = sym_mod.load_json(symbol_json)
        if output_names:
            # partial-out: re-head the graph at the named internal
            # outputs; bare node names take the "_output" suffix
            internals = self._symbol.get_internals()
            avail = internals.list_outputs()
            heads = []
            for key in output_names:
                name = key if key in avail else key + "_output"
                if name not in avail:
                    raise MXNetError(
                        "Predictor: unknown output %r (internals: "
                        "%s...)" % (key, ", ".join(avail[:8])))
                heads.append(internals[name])
            self._symbol = sym_mod.Group(heads)

        if isinstance(param_data, dict):
            save_dict = param_data
        elif isinstance(param_data, (bytes, bytearray)):
            save_dict = nd.load_buffer(bytes(param_data))
        else:
            save_dict = nd.load(param_data)
        arg_params, aux_params = {}, {}
        for k, v in save_dict.items():
            if k.startswith("arg:"):
                arg_params[k[4:]] = v
            elif k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:  # raw name (the predict API accepts both layouts)
                arg_params[k] = v

        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        arg_names = self._symbol.list_arguments()
        aux_names = self._symbol.list_auxiliary_states()
        arg_shapes, out_shapes, aux_shapes = \
            self._symbol.infer_shape(**self._input_shapes)
        if arg_shapes is None:
            raise MXNetError("Predictor: cannot infer shapes")
        self._out_shapes = out_shapes
        self._arg_names = arg_names
        dev = self.device
        self._params = {}
        for name, shape in zip(arg_names, arg_shapes):
            if name in self._input_shapes:
                continue
            if name in arg_params:
                self._params[name] = nd._tensor_of(arg_params[name]).to(dev)
            elif name.endswith("label"):
                # loss-layer labels are dead inputs at inference
                self._params[name] = torch.zeros(shape, device=dev)
            else:
                raise MXNetError("Predictor: missing parameter %s" % name)
        self._aux = []
        for name in aux_names:
            if name not in aux_params:
                raise MXNetError("Predictor: missing aux state %s" % name)
            self._aux.append(nd._tensor_of(aux_params[name]).to(dev))
        self._graph_fn = make_graph_fn(self._symbol)
        # inputs whose values are INDICES in every use (Embedding data,
        # loss labels) keep their integer dtype; everything else is f32
        self._integer_inputs = set(integer_semantic_inputs(self._symbol))
        self._outputs = None

    def forward(self, **inputs):
        """Set inputs and run (reference MXPredForward + MXPredSetInput)."""
        vals = dict(self._params)
        for k, shape in self._input_shapes.items():
            if k not in inputs:
                raise MXNetError("Predictor.forward: missing input %s" % k)
            v = inputs[k]
            if isinstance(v, nd.NDArray):
                v = v._tensor
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
            if tuple(v.shape) != shape:
                raise MXNetError("input %s: shape %s != bound %s"
                                 % (k, tuple(v.shape), shape))
            # index-semantic inputs keep their integer dtype (a blanket
            # f32 cast corrupts ids above 2^24); integer inputs feeding
            # float graphs (uint8 images into a conv net) become f32
            if not (k in self._integer_inputs
                    and not v.dtype.is_floating_point):
                v = v.to(torch.float32)
            vals[k] = v.to(self.device)
        with torch.no_grad():
            outs, _ = self._graph_fn([vals[n] for n in self._arg_names],
                                     list(self._aux), False, None)
        self._outputs = outs
        return self

    def get_output(self, index):
        """Fetch output as numpy (reference MXPredGetOutput)."""
        if self._outputs is None:
            raise MXNetError("call forward first")
        return self._outputs[index].detach().cpu().numpy()

    @property
    def num_outputs(self):
        return len(self._out_shapes)
