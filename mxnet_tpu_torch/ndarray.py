"""The ``.params`` codec: save/load lists and dicts of arrays.

Counterpart of the serialization half of ``mxnet_tpu/ndarray.py``
(l.570-664), byte-compatible with it and with the reference checkpoint
format (``ndarray.cc:518-640``): a uint64 magic 0x112 and a reserved
uint64, the array count, then per array a TShape (uint32 ndim,
uint32[ndim]), a Context (int32 dev_type, int32 dev_id), an int32 type
flag and the raw little-endian data; then the name count and each name as
a uint64 length and its UTF-8 bytes.

Arrays go in as numpy arrays or torch tensors (bfloat16 needs a tensor:
numpy has no such type) and come back as CPU torch tensors. The
imperative ``NDArray`` belongs to a later slice of the port.
"""
from __future__ import annotations

import io
import struct

import numpy as np
import torch

from .base import DTYPE_MX_TO_TORCH, DTYPE_TORCH_TO_MX, MXNetError

__all__ = ["save", "load", "load_buffer"]

_LIST_MAGIC = 0x112


def _as_tensor(arr):
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().contiguous()
    raise MXNetError("save only accepts numpy arrays or torch tensors, "
                     "got %s" % type(arr).__name__)


def _save_one(fo, arr):
    t = _as_tensor(arr)
    if t.dtype not in DTYPE_TORCH_TO_MX:
        raise MXNetError("save: dtype %s has no .params type code"
                         % t.dtype)
    shape = tuple(t.shape) or (1,)  # no 0-dim arrays on disk
    fo.write(struct.pack("<I", len(shape)))
    fo.write(struct.pack("<%dI" % len(shape), *shape))
    fo.write(struct.pack("<ii", 1, 0))  # saved as CPU context like the ref
    fo.write(struct.pack("<i", DTYPE_TORCH_TO_MX[t.dtype]))
    # reinterpret the storage as bytes (host order is little-endian on
    # every platform torch supports)
    fo.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


def _load_one(fi):
    (ndim,) = struct.unpack("<I", fi.read(4))
    if ndim == 0:
        return torch.empty((1,))
    shape = struct.unpack("<%dI" % ndim, fi.read(4 * ndim))
    struct.unpack("<ii", fi.read(8))  # context, ignored: the caller places
    (type_flag,) = struct.unpack("<i", fi.read(4))
    if type_flag not in DTYPE_MX_TO_TORCH:
        raise MXNetError("load: unknown type flag %d" % type_flag)
    dtype = DTYPE_MX_TO_TORCH[type_flag]
    count = int(np.prod(shape))
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    raw = bytearray(fi.read(nbytes))
    if len(raw) != nbytes:
        raise MXNetError("load: truncated .params data")
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def save(fname, data):
    """Save one array, a list of arrays or a str-keyed dict of arrays
    (reference ``ndarray.py:565``)."""
    if isinstance(data, (np.ndarray, torch.Tensor)):
        data = [data]
    names = []
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        arrays = list(data)
    with open(fname, "wb") as fo:
        fo.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        fo.write(struct.pack("<Q", len(arrays)))
        for arr in arrays:
            _save_one(fo, arr)
        fo.write(struct.pack("<Q", len(names)))
        for name in names:
            enc = name.encode("utf-8")
            fo.write(struct.pack("<Q", len(enc)))
            fo.write(enc)


def _load_stream(fi):
    magic, _ = struct.unpack("<QQ", fi.read(16))
    if magic != _LIST_MAGIC:
        raise MXNetError("Invalid NDArray file format")
    (count,) = struct.unpack("<Q", fi.read(8))
    arrays = [_load_one(fi) for _ in range(count)]
    (nkeys,) = struct.unpack("<Q", fi.read(8))
    if nkeys == 0:
        return arrays
    names = []
    for _ in range(nkeys):
        (ln,) = struct.unpack("<Q", fi.read(8))
        names.append(fi.read(ln).decode("utf-8"))
    return dict(zip(names, arrays))


def load(fname):
    """Load a list or dict saved by :func:`save`, by the JAX package or
    by the reference; arrays come back as CPU tensors."""
    with open(fname, "rb") as fi:
        return _load_stream(fi)


def load_buffer(data):
    """Load from in-memory ``.params`` bytes."""
    return _load_stream(io.BytesIO(data))
