"""Serving: the continuous-batching engine, its host-side prefix cache,
n-gram drafter and flight recorder, and weight quantization.

``InferenceEngine``, ``Request`` and the engine's errors load on first
use: the engine imports ``parallel.decode``, which imports
``serving.quant``.
"""
from .flight import FlightRecorder
from .prefix import PrefixCache
from .spec import NgramDrafter

__all__ = ["InferenceEngine", "Request", "PrefixCache", "NgramDrafter",
           "FlightRecorder", "EngineOverloaded", "EngineClosed",
           "EngineStuck"]

_ENGINE = ("InferenceEngine", "Request", "EngineOverloaded", "EngineClosed",
           "EngineStuck")


def __getattr__(name):
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
