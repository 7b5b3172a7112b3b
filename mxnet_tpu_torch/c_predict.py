"""Plain-typed shims backing the native C predict ABI.

Counterpart of ``mxnet_tpu/c_predict.py``. The port's copy of the C
library, ``capi/c_predict_api.cc`` (``libmxnet_tpu_torch_predict.so``,
built by ``capi.build``), embeds CPython and calls these functions with
only str/bytes/tuple arguments, keeping the C side free of numpy/torch
C-API coupling. This is the inversion of the reference's stack — there,
Python wraps a C predictor (``src/c_api/c_predict_api.cc``); here the
compute path is Python over torch and the port's kernels, so C embeds it.
The C side passes ``dev_type`` ``"gpu"`` for its device type 2 (the card,
``cuda:dev_id``) and ``"cpu"`` otherwise. The ABI surface matches
``include/mxnet/c_predict_api.h``: create → set_input* → forward →
get_output_shape/get_output.

Set ``MXNET_TPU_PREDICT_NUMPY=1`` to serve predictions from the
numpy-only amalgamation interpreter (``amalgamation/mxnet_tpu_predict.py``,
loaded by path; it belongs to neither package) instead of torch.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["create", "create_partial_out", "set_input", "forward",
           "get_output_shape", "get_output", "num_outputs"]


def _predictor_cls():
    if os.environ.get("MXNET_TPU_PREDICT_NUMPY", "0") == "1":
        import importlib.util
        path = os.path.join(os.path.dirname(__file__), os.pardir,
                            "amalgamation", "mxnet_tpu_predict.py")
        spec = importlib.util.spec_from_file_location("mxnet_tpu_predict",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.Predictor
    from .predict import Predictor
    return Predictor


class _CPredictor:
    def __init__(self, symbol_json, param_bytes, names, shapes,
                 dev_type, dev_id, output_names=None):
        input_shapes = {n: tuple(s) for n, s in zip(names, shapes)}
        self.input_shapes = input_shapes
        cls = _predictor_cls()
        if output_names:
            self.pred = cls(symbol_json, param_bytes, input_shapes,
                            dev_type, dev_id, output_names=output_names)
        else:
            self.pred = cls(symbol_json, param_bytes, input_shapes,
                            dev_type, dev_id)
        self.inputs = {}
        self.outputs = []


def create(symbol_json: str, param_bytes: bytes, names, shapes,
           dev_type: str = "gpu", dev_id: int = 0):
    """→ opaque predictor object (MXPredCreate)."""
    return _CPredictor(symbol_json, param_bytes, list(names),
                       [tuple(int(x) for x in s) for s in shapes],
                       dev_type, dev_id)


def create_partial_out(symbol_json: str, param_bytes: bytes, names,
                       shapes, dev_type: str, dev_id: int, output_names):
    """→ predictor re-headed at internal outputs
    (MXPredCreatePartialOut)."""
    return _CPredictor(symbol_json, param_bytes, list(names),
                       [tuple(int(x) for x in s) for s in shapes],
                       dev_type, dev_id,
                       output_names=[str(n) for n in output_names])


def set_input(h, key: str, data: bytes):
    """Stage a float32 input by raw little-endian bytes (MXPredSetInput)."""
    if key not in h.input_shapes:
        raise KeyError("unknown input %s" % key)
    shape = h.input_shapes[key]
    arr = np.frombuffer(data, dtype="<f4")
    if arr.size != int(np.prod(shape)):
        raise ValueError("input %s: got %d floats, want %s"
                         % (key, arr.size, shape))
    h.inputs[key] = arr.reshape(shape)


def forward(h):
    """Run the graph on staged inputs (MXPredForward)."""
    missing = set(h.input_shapes) - set(h.inputs)
    if missing:
        raise ValueError("inputs not set: %s" % sorted(missing))
    h.pred.forward(**h.inputs)
    h.outputs = [np.asarray(h.pred.get_output(i), dtype=np.float32)
                 for i in range(h.pred.num_outputs)]


def num_outputs(h) -> int:
    return h.pred.num_outputs


def get_output_shape(h, index: int):
    """→ tuple of ints (MXPredGetOutputShape)."""
    if not h.outputs:
        forward(h)
    return tuple(int(d) for d in h.outputs[index].shape)


def get_output(h, index: int) -> bytes:
    """→ float32 little-endian bytes (MXPredGetOutput)."""
    return np.ascontiguousarray(h.outputs[index],
                                dtype="<f4").tobytes()
