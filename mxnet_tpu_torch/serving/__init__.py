"""Serving: the continuous-batching engine and weight quantization.

``InferenceEngine`` and ``Request`` load on first use: the engine imports
``parallel.decode``, which imports ``serving.quant``.
"""

__all__ = ["InferenceEngine", "Request"]


def __getattr__(name):
    if name in __all__:
        from . import engine
        return getattr(engine, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
