"""Automatic symbol naming.

Copy of ``mxnet_tpu/name.py`` (the reference's ``python/mxnet/name.py``):
NameManager assigns ``<hint><counter>`` names to anonymous symbols; Prefix
prepends a prefix.
"""
from __future__ import annotations

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Assign unique names to anonymous symbols."""

    _current = None

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name is not None:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old = NameManager._current
        NameManager._current = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current = self._old

    @staticmethod
    def current():
        if NameManager._current is None:
            NameManager._current = NameManager()
        return NameManager._current


class Prefix(NameManager):
    """NameManager that always prepends a prefix (reference name.py:40)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
