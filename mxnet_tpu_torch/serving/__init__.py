"""Serving: the continuous-batching engine, its host-side prefix cache,
n-gram drafter and flight recorder, traffic capture, the KV handoff of
disaggregated prefill/decode, the fleet router, and weight quantization.

``InferenceEngine``, ``Request``, the engine's errors and the fleet load
on first use (the engine imports ``parallel.decode``, which imports this
package).
"""
from .capture import CaptureStream, load_capture
from .flight import FlightRecorder
from .handoff import KVHandoff, pack_rows, unpack_rows
from .prefix import PrefixCache
from .quant import (QuantizedTensor, quantize_tensor, quantize_params,
                    quantized_weight_names, dequantize)
from .spec import NgramDrafter

__all__ = ["InferenceEngine", "Request", "PrefixCache", "FlightRecorder",
           "NgramDrafter", "CaptureStream", "load_capture",
           "QuantizedTensor", "quantize_tensor", "quantize_params",
           "quantized_weight_names", "dequantize",
           "EngineOverloaded", "EngineClosed", "EngineStuck", "FleetRouter",
           "FleetRequest", "FleetFlightRecorder", "KVHandoff", "pack_rows",
           "unpack_rows"]

_ENGINE = ("InferenceEngine", "Request", "EngineOverloaded", "EngineClosed",
           "EngineStuck")
_FLEET = ("FleetRouter", "FleetRequest", "FleetFlightRecorder")


def __getattr__(name):
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    if name in _FLEET:
        from . import fleet
        return getattr(fleet, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
