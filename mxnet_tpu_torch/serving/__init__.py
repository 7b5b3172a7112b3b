"""Serving: the continuous-batching engine, its host-side prefix cache and
n-gram drafter, and weight quantization.

``InferenceEngine`` and ``Request`` load on first use: the engine imports
``parallel.decode``, which imports ``serving.quant``.
"""
from .prefix import PrefixCache
from .spec import NgramDrafter

__all__ = ["InferenceEngine", "Request", "PrefixCache", "NgramDrafter"]

_ENGINE = ("InferenceEngine", "Request")


def __getattr__(name):
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
