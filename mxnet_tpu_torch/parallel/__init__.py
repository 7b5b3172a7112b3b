"""Decoding: the KV-cache ``Decoder`` derived from a Symbol LM."""
from .decode import Decoder  # noqa: F401
