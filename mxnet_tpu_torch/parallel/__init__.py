"""Decoding and training: the KV-cache ``Decoder`` derived from a Symbol
LM, and the ``ParallelTrainer`` training step over ``make_graph_fn``."""
from .decode import Decoder  # noqa: F401
from .graph import make_graph_fn, integer_semantic_inputs  # noqa: F401
from .trainer import ParallelTrainer  # noqa: F401
