"""Locate and load the port's native libraries (parity:
``python/mxnet/libinfo.py`` + ``base.py`` _LIB loading).

Counterpart of ``mxnet_tpu/libinfo.py``. The port's native libraries are
the two C ABIs of ``capi/``: the graph ABI (``libmxnet_tpu_torch_capi.so``)
and the predict ABI (``libmxnet_tpu_torch_predict.so``), built with
``g++`` into ``build/capi/`` (``capi.build``). ``MXNET_TPU_LIBRARY`` names
another library to load first.
"""
from __future__ import annotations

import ctypes
import os

_LIB = None
_TRIED = False


def find_lib_path():
    """The built libraries that exist, ``MXNET_TPU_LIBRARY`` first, then
    the graph ABI, then the predict ABI."""
    from . import capi
    candidates = [os.environ.get("MXNET_TPU_LIBRARY", "")]
    for name in ("graph", "predict"):
        out_name, files = capi.LIBRARIES[name]
        candidates.append(os.path.join(capi.BUILD, capi._key(files),
                                       out_name))
    return [p for p in candidates if p and os.path.exists(p)]


def get_lib():
    """The loaded graph-ABI CDLL, built with ``g++`` on first use; None
    where it cannot be built or loaded."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    paths = find_lib_path()
    if not paths:
        from . import capi
        try:
            paths = [capi.build("graph")]
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(paths[0])
        lib.MXTApiGetLastError.restype = ctypes.c_char_p
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def check_call(ret):
    if ret != 0:
        lib = get_lib()
        msg = lib.MXTApiGetLastError().decode() if lib else \
            "native call failed"
        from .base import MXNetError
        raise MXNetError(msg)
