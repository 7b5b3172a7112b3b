"""NDArray: the imperative array API, and the ``.params`` codec.

Counterpart of ``mxnet_tpu/ndarray.py`` (the reference's
``python/mxnet/ndarray.py`` over ``src/ndarray/ndarray.cc``). The JAX
package keeps a storage-chunk indirection (``_Chunk`` and an offset)
because XLA buffers are immutable; torch storage already gives the
reference's view triple (``ndarray.h:227-250``):

* an ``NDArray`` wraps one torch tensor on its ``Context``'s device;
* ``slice``, ``reshape`` and ``__getitem__`` on axis 0 return NDArrays
  over views of the same storage;
* every write (``_set``, ``__setitem__``, ``copyto``, the in-place
  operators) is a ``copy_`` into that storage, so every view sees it.

Operations run eagerly on the array's device; ``wait_to_read`` and
``waitall`` synchronize the card. The dtype of an array is a numpy dtype,
except bfloat16, which numpy lacks: it is ``torch.bfloat16``, and
``asnumpy()`` widens such an array to float32 (exact).

The ``.params`` codec is byte-compatible with the JAX package and the
reference checkpoint format (``ndarray.cc:518-640``): a uint64 magic
0x112 and a reserved uint64, the array count, then per array a TShape
(uint32 ndim, uint32[ndim]), a Context (int32 dev_type, int32 dev_id), an
int32 type flag and the raw little-endian data; then the name count and
each name as a uint64 length and its UTF-8 bytes. ``save`` takes
NDArrays, numpy arrays or torch tensors; ``load`` returns NDArrays on
``cpu()`` (the file records a CPU context). ``_load_tensors`` and
``_load_buffer_tensors`` return CPU tensors for the callers that want
them.
"""
from __future__ import annotations

import io
import struct
import warnings

import numpy as np
import torch

from .base import (DTYPE_MX_TO_TORCH, DTYPE_TORCH_TO_MX, MXNetError,
                   torch_dtype)
from .context import Context, cpu, current_context, resolve_device

__all__ = ["NDArray", "zeros", "ones", "full", "empty", "array", "save",
           "load", "load_buffer", "concatenate", "waitall",
           "onehot_encode", "clip", "dot", "norm", "sqrt", "rsqrt",
           "square", "abs", "sign", "round", "ceil", "floor", "exp", "log",
           "cos", "sin", "maximum", "minimum", "negative",
           "choose_element_0index", "fill_element_0index", "sum", "max",
           "min", "argmax_channel", "transpose", "imdecode"]

_LIST_MAGIC = 0x112
# numpy dtypes that keep their type in array() (the .params types)
_PARAMS_DTYPES = ("float32", "float64", "float16", "uint8", "int32",
                  "bfloat16")


def _np_dtype(tdtype):
    """The dtype an NDArray reports: numpy's, or ``torch.bfloat16``."""
    if tdtype == torch.bfloat16:
        return torch.bfloat16
    return np.dtype(torch.empty((), dtype=tdtype).numpy().dtype)


def _device(ctx):
    """The torch device of ``ctx`` (None: the current context); a card
    context without CUDA raises."""
    return resolve_device(ctx if ctx is not None else current_context())


def _ctx(ctx):
    return Context(ctx) if ctx is not None else current_context()


def _result_dtype(a, b):
    """mshadow's rule as the JAX package writes it: numpy's promotion of
    the two dtypes, computed on numpy dtypes where both have one."""
    if a == torch.bfloat16 or b == torch.bfloat16:
        return torch.promote_types(a, b)
    return torch_dtype(np.promote_types(_np_dtype(a), _np_dtype(b)))


class NDArray:
    """An array (possibly a view) with the reference's mutation semantics
    over a torch tensor."""

    __slots__ = ("_tensor", "_context", "writable")

    # numpy defers to our reflected operators (np_array * ndarray)
    __array_priority__ = 100.0

    def __init__(self, tensor, ctx=None, writable=True):
        self._tensor = tensor
        self._context = Context(ctx) if ctx is not None else (
            Context("gpu", tensor.device.index or 0)
            if tensor.device.type == "cuda" else cpu())
        self.writable = writable

    @staticmethod
    def _from_tensor(val, ctx):
        """A new array owning ``val`` (0-dim values become shape (1,): the
        reference has no 0-dim arrays)."""
        val = val.detach()
        if val.dim() == 0:
            val = val.reshape(1)
        return NDArray(val.contiguous(), ctx)

    def _set(self, value):
        """Write ``value`` (a tensor, numpy array or scalar) into this
        view, broadcast to its shape and cast to its dtype."""
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        if isinstance(value, NDArray):
            value = value._tensor
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        with torch.no_grad():
            self._tensor.copy_(value.detach().broadcast_to(self.shape))
        return self

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._tensor.shape)

    @property
    def size(self):
        return self._tensor.numel()

    @property
    def ndim(self):
        return self._tensor.dim()

    @property
    def dtype(self):
        return _np_dtype(self._tensor.dtype)

    @property
    def context(self):
        return self._context

    ctx = context

    def __repr__(self):
        return "<%s %s @%s>" % (type(self).__name__,
                                "x".join(str(s) for s in self.shape),
                                self.context)

    # -- synchronization ---------------------------------------------------
    def wait_to_read(self):
        """Block until the writes queued on the array's device are done
        (``NDArray::WaitToRead``)."""
        if self._tensor.is_cuda:
            torch.cuda.synchronize(self._tensor.device)

    wait_to_write = wait_to_read

    # -- host interop ------------------------------------------------------
    def asnumpy(self):
        """A numpy copy, blocking (``MXNDArraySyncCopyToCPU``); bfloat16
        comes back widened to float32."""
        t = self._tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        res = empty(self.shape, ctx=self.context, dtype=dtype)
        res._set(self._tensor)
        return res

    # -- views -------------------------------------------------------------
    def reshape(self, new_shape):
        new_shape = tuple(int(s) for s in new_shape) or (1,)
        if int(np.prod(new_shape)) != self.size:
            raise MXNetError("NDArray.reshape: size must not change")
        return NDArray(self._tensor.view(new_shape), self._context,
                       self.writable)

    def slice(self, start, stop):
        start, stop = int(start), int(stop)
        if not 0 <= start <= stop <= self.shape[0]:
            raise MXNetError("slice out of range")
        return NDArray(self._tensor[start:stop], self._context,
                       self.writable)

    def __getitem__(self, in_slice):
        if isinstance(in_slice, int):
            return self.slice(in_slice, in_slice + 1).reshape(
                self.shape[1:] or (1,))
        if isinstance(in_slice, slice):
            if in_slice.step is not None and in_slice.step != 1:
                raise MXNetError("NDArray only supports contiguous slicing "
                                 "on axis 0")
            start = 0 if in_slice.start is None else in_slice.start
            stop = self.shape[0] if in_slice.stop is None else in_slice.stop
            return self.slice(start, stop)
        raise MXNetError("NDArray only supports int/slice indexing on "
                         "axis 0")

    def __setitem__(self, in_slice, value):
        if isinstance(in_slice, slice) and in_slice.step in (None, 1):
            target = self if (in_slice.start is None
                              and in_slice.stop is None) \
                else self.__getitem__(in_slice)
        elif isinstance(in_slice, int):
            target = self.__getitem__(in_slice)
        else:
            raise MXNetError("NDArray only supports contiguous slice "
                             "assignment")
        target._set(value)

    # -- copies ------------------------------------------------------------
    def copy(self):
        return self.copyto(self.context)

    def copyto(self, other):
        """Copy into another NDArray (writing it) or to a new array on a
        context."""
        if isinstance(other, NDArray):
            if other is self or (
                    other._tensor.data_ptr() == self._tensor.data_ptr()
                    and other._tensor.device == self._tensor.device):
                warnings.warn("copy an array to itself, is it intended?")
                return other
            if other.shape != self.shape:
                raise MXNetError("copyto shape mismatch %s vs %s"
                                 % (self.shape, other.shape))
            return other._set(self._tensor)
        if isinstance(other, Context):
            return NDArray(self._tensor.detach().to(_device(other),
                                                    copy=True), other)
        raise MXNetError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if self.context == context:
            return self
        return self.copyto(context)

    # -- arithmetic (the result's dtype follows mshadow, not numpy) ----------
    def _binary(self, other, fn, reverse=False):
        a = self._tensor
        if isinstance(other, NDArray):
            b = other._tensor
            rdtype = _result_dtype(a.dtype, b.dtype)
        elif isinstance(other, (int, float, bool, np.number)):
            b = other.item() if isinstance(other, np.number) else other
            rdtype = a.dtype
        else:
            b = torch.as_tensor(np.asarray(other), device=a.device)
            rdtype = _result_dtype(a.dtype, b.dtype)
        out = fn(b, a) if reverse else fn(a, b)
        return NDArray._from_tensor(out.to(rdtype), self.context)

    def __add__(self, o):
        return self._binary(o, torch.add)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, torch.sub)

    def __rsub__(self, o):
        return self._binary(o, torch.sub, reverse=True)

    def __mul__(self, o):
        return self._binary(o, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, torch.true_divide)

    def __rtruediv__(self, o):
        return self._binary(o, torch.true_divide, reverse=True)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, o):
        return self._binary(o, torch.pow)

    def __neg__(self):
        return NDArray._from_tensor(-self._tensor, self.context)

    def _inplace(self, other, fn):
        b = other._tensor if isinstance(other, NDArray) else other
        return self._set(fn(self._tensor, b))

    def __iadd__(self, o):
        return self._inplace(o, torch.add)

    def __isub__(self, o):
        return self._inplace(o, torch.sub)

    def __imul__(self, o):
        return self._inplace(o, torch.mul)

    def __itruediv__(self, o):
        return self._inplace(o, torch.true_divide)

    __idiv__ = __itruediv__

    def __reduce__(self):
        dtype = "bfloat16" if self._tensor.dtype == torch.bfloat16 else None
        return (_ndarray_from_numpy, (self.asnumpy(), self.writable, dtype))

    @property
    def T(self):
        return transpose(self)


def _ndarray_from_numpy(data, writable=True, dtype=None):
    arr = array(data, dtype=dtype)
    arr.writable = writable
    return arr


def _tensor_of(value):
    """The tensor behind an NDArray, a tensor, or a numpy array."""
    if isinstance(value, NDArray):
        return value._tensor
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


# -- creation ------------------------------------------------------------------

def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def empty(shape, ctx=None, dtype=np.float32):
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=np.float32):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)), _ctx(ctx))


def ones(shape, ctx=None, dtype=np.float32):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)), _ctx(ctx))


def full(shape, val, ctx=None, dtype=np.float32):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)), _ctx(ctx))


def array(source_array, ctx=None, dtype=None):
    """An NDArray from any array-like (reference ``ndarray.py:370``): an
    NDArray, a torch tensor, a numpy array or a nested list. Without
    ``dtype`` a numpy dtype of the ``.params`` format is kept, anything
    else becomes float32."""
    if isinstance(source_array, (NDArray, torch.Tensor)):
        src = _tensor_of(source_array).detach()
        if dtype is None and src.dtype not in DTYPE_TORCH_TO_MX:
            dtype = np.float32
    else:
        host = np.asarray(source_array)
        if dtype is None:
            dtype = host.dtype.name if host.dtype.name in _PARAMS_DTYPES \
                else np.float32
        tdt = torch_dtype(dtype)
        src = torch.from_numpy(np.ascontiguousarray(
            host, dtype=np.float32 if tdt == torch.bfloat16
            else _np_dtype(tdt)))
    if dtype is not None:
        src = src.to(torch_dtype(dtype))
    if src.dim() == 0:
        src = src.reshape(1)
    return NDArray(src.to(_device(ctx), copy=True).contiguous(), _ctx(ctx))


def concatenate(arrays, axis=0, always_copy=True):
    if not arrays:
        raise MXNetError("need at least one array")
    if len(arrays) == 1 and not always_copy and axis == 0:
        return arrays[0]
    dev = arrays[0]._tensor.device
    val = torch.cat([a._tensor.to(dev) for a in arrays], dim=axis)
    return NDArray._from_tensor(val, arrays[0].context)


def waitall():
    """Block until all queued work is done (``MXNDArrayWaitAll``)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- registered functions (``out=`` as the C registry's mutate_vars) -----------

def _maybe_out(val, out, ctx):
    if out is not None:
        return out._set(val)
    return NDArray._from_tensor(val, ctx)


def _unary_factory(fn, name):
    def func(arr, out=None):
        return _maybe_out(fn(arr._tensor).to(arr._tensor.dtype), out,
                          arr.context)
    func.__name__ = name
    func.__doc__ = ("Elementwise %s (reference: unary_function-inl.h:"
                    "146-189)" % name)
    return func


sqrt = _unary_factory(torch.sqrt, "sqrt")
rsqrt = _unary_factory(lambda x: 1.0 / torch.sqrt(x), "rsqrt")
square = _unary_factory(torch.square, "square")
exp = _unary_factory(torch.exp, "exp")
log = _unary_factory(torch.log, "log")
sign = _unary_factory(torch.sign, "sign")
cos = _unary_factory(torch.cos, "cos")
sin = _unary_factory(torch.sin, "sin")
ceil = _unary_factory(torch.ceil, "ceil")
floor = _unary_factory(torch.floor, "floor")
round = _unary_factory(torch.round, "round")
abs = _unary_factory(torch.abs, "abs")


def negative(arr, out=None):
    return _maybe_out(-arr._tensor, out, arr.context)


def _pair(lhs, rhs, fn, out):
    ctx = lhs.context if isinstance(lhs, NDArray) else rhs.context
    dev = (lhs if isinstance(lhs, NDArray) else rhs)._tensor.device
    a = lhs._tensor if isinstance(lhs, NDArray) \
        else torch.as_tensor(lhs, device=dev)
    b = rhs._tensor if isinstance(rhs, NDArray) \
        else torch.as_tensor(rhs, device=dev)
    return _maybe_out(fn(a, b), out, ctx)


def maximum(lhs, rhs, out=None):
    return _pair(lhs, rhs, torch.maximum, out)


def minimum(lhs, rhs, out=None):
    return _pair(lhs, rhs, torch.minimum, out)


def clip(arr, a_min, a_max, out=None):
    """Clip values (reference: ndarray.cc:793 ``clip``)."""
    return _maybe_out(torch.clamp(arr._tensor, a_min, a_max), out,
                      arr.context)


def dot(lhs, rhs, out=None):
    """Matrix/vector product (reference: ndarray.cc:741 ``dot``)."""
    a, b = lhs._tensor, rhs._tensor
    if a.dim() == 1 and b.dim() == 1:
        val = torch.dot(a, b)
    else:
        val = torch.matmul(a, b)
    return _maybe_out(val, out, lhs.context)


def norm(arr, out=None):
    """L2 norm, as a 1-element float32 NDArray (reference mx.nd.norm)."""
    val = torch.linalg.vector_norm(arr._tensor.float().reshape(-1))
    return _maybe_out(val.reshape(1), out, arr.context)


def sum(arr, out=None):
    return _maybe_out(torch.sum(arr._tensor).reshape(1), out, arr.context)


def max(arr, out=None):
    return _maybe_out(torch.max(arr._tensor).reshape(1), out, arr.context)


def min(arr, out=None):
    return _maybe_out(torch.min(arr._tensor).reshape(1), out, arr.context)


def transpose(arr, axes=None, out=None):
    t = arr._tensor
    axes = tuple(reversed(range(t.dim()))) if axes is None else tuple(axes)
    return _maybe_out(t.permute(axes), out, arr.context)


def argmax_channel(arr, out=None):
    val = torch.argmax(arr._tensor, dim=1).to(arr._tensor.dtype)
    return _maybe_out(val, out, arr.context)


def onehot_encode(indices, out):
    """Fill ``out`` with one-hot rows (reference: ndarray.cc:764)."""
    depth = out.shape[1]
    idx = indices._tensor.to(torch.int64).reshape(-1)
    return out._set(torch.nn.functional.one_hot(idx, depth))


def choose_element_0index(lhs, rhs, out=None):
    """out[i] = lhs[i, rhs[i]] (reference: ndarray.cc:771)."""
    idx = rhs._tensor.to(torch.int64).reshape(-1)
    val = torch.gather(lhs._tensor, 1, idx[:, None])[:, 0]
    return _maybe_out(val, out, lhs.context)


def fill_element_0index(lhs, mhs, rhs, out=None):
    """out = lhs; out[i, rhs[i]] = mhs[i] (reference: ndarray.cc:778)."""
    idx = rhs._tensor.to(torch.int64).reshape(-1)
    val = lhs._tensor.clone()
    val[torch.arange(idx.shape[0], device=idx.device), idx] = \
        mhs._tensor.reshape(-1).to(val.dtype)
    return _maybe_out(val, out, lhs.context)


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0,
             channels=3, mean=None):
    """Decode a JPEG/PNG bytestring (reference: ndarray.cc:799
    ``_imdecode``) into a ``[1, 3, H, W]`` float32 array: Pillow, else
    OpenCV, as the JAX package does (``MXNetError`` without either).
    ``clip_rect=(x0, y0, x1, y1)`` crops first; ``mean`` (an NDArray) is
    subtracted."""
    import io as _io
    try:
        from PIL import Image
        img = np.asarray(Image.open(_io.BytesIO(str_img)).convert("RGB"))
    except ImportError:
        try:
            import cv2
        except ImportError as exc:
            raise MXNetError("imdecode needs PIL or cv2") from exc
        img = cv2.imdecode(np.frombuffer(str_img, np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise MXNetError("imdecode: decode failed")
        img = img[:, :, ::-1]
    x0, y0, x1, y1 = clip_rect
    if x1 > 0 or y1 > 0:
        img = img[y0:y1, x0:x1]
    img = np.transpose(img, (2, 0, 1)).astype(np.float32)
    if mean is not None:
        img = img - mean.asnumpy()
    img = img[None]
    if out is not None:
        out._set(torch.from_numpy(np.ascontiguousarray(img)))
        return out
    return array(img)


# -- the .params codec ----------------------------------------------------------

def _host_tensor(arr):
    if isinstance(arr, NDArray):
        return arr._tensor.detach().cpu().contiguous()
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().contiguous()
    raise MXNetError("save only accepts NDArrays, numpy arrays or torch "
                     "tensors, got %s" % type(arr).__name__)


def _save_one(fo, arr):
    t = _host_tensor(arr)
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
    (reference ``ndarray.py:565``): NDArrays, numpy arrays or torch
    tensors. ``fname`` may be a URI (``stream.open_stream``)."""
    if isinstance(data, (NDArray, np.ndarray, torch.Tensor)):
        data = [data]
    names = []
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        arrays = list(data)
    from .stream import open_stream  # URI dispatch (dmlc::Stream)
    with open_stream(fname, "wb") as fo:
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


def _as_ndarrays(loaded):
    if isinstance(loaded, dict):
        return {k: NDArray(v, cpu()) for k, v in loaded.items()}
    return [NDArray(v, cpu()) for v in loaded]


def _load_tensors(fname):
    """:func:`load` as CPU torch tensors."""
    from .stream import open_stream
    with open_stream(fname, "rb") as fi:
        return _load_stream(fi)


def _load_buffer_tensors(data):
    """:func:`load_buffer` as CPU torch tensors."""
    return _load_stream(io.BytesIO(data))


def load(fname):
    """Load a list or dict saved by :func:`save`, by the JAX package or by
    the reference, as NDArrays on ``cpu()``. ``fname`` may be a URI
    (``s3://``, ``hdfs://``, ``file://``; ``stream.open_stream``)."""
    return _as_ndarrays(_load_tensors(fname))


def load_buffer(data):
    """Load from in-memory ``.params`` bytes, as NDArrays on ``cpu()``."""
    return _as_ndarrays(_load_buffer_tensors(data))

