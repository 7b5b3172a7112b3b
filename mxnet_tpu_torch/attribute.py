"""Attribute scoping for symbols.

Copy of ``mxnet_tpu/attribute.py`` (the reference's
``python/mxnet/attribute.py``): ``AttrScope`` is a context manager whose
attributes are attached to every symbol created inside it (explicit
per-symbol attrs win).
"""
from __future__ import annotations

__all__ = ["AttrScope"]


class AttrScope:
    _current = None

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings")
        self._attr = kwargs
        self._old = None

    def get(self, attr):
        """Merge scope attrs under explicit ``attr`` (explicit wins)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old = AttrScope._current
        merged = dict(self._old._attr) if self._old else {}
        merged.update(self._attr)
        self._attr = merged
        AttrScope._current = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current = self._old

    @staticmethod
    def current():
        if AttrScope._current is None:
            AttrScope._current = AttrScope()
        return AttrScope._current
