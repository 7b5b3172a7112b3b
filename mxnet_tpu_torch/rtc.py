"""Runtime user kernels: CUDA source compiled at run time (MXRtc).

Counterpart of ``mxnet_tpu/rtc.py`` in the NVRTC-era form its docstring
names (the reference's ``python/mxnet/rtc.py`` + ``src/common/mxrtc.cc``):
``Rtc(name, inputs, outputs, kernel)`` takes the BODY of a CUDA kernel;
the kernel's ``extern "C" __global__`` signature is generated over the
named float arrays (inputs ``const float*``, outputs ``float*``), with
``<name>_ndim`` and ``<name>_dims[]`` constants for each, exactly as
``mxrtc.cc``'s ``decorate`` writes it::

    x, y = mx.nd.ones((1024,), ctx=mx.gpu(0)), mx.nd.zeros((1024,), ...)
    k = mx.rtc.Rtc("axpy", [("x", x)], [("y", y)],
                   "int i = blockIdx.x * blockDim.x + threadIdx.x;"
                   "if (i < x_dims[0]) y[i] += 2.0f * x[i];")
    k.push([x], [y], (4, 1, 1), (256, 1, 1))

The source is compiled for the card's architecture through NVRTC and
launched with the driver API (``cuLaunchKernel``) on torch's current
stream, both through ctypes against the toolkit's ``libnvrtc`` and the
driver's ``libcuda``. CPU NDArrays raise: there is no plain version of a
user's kernel. The JAX package's ``PallasOp`` (a user's Pallas function)
has no counterpart.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import sys

import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Rtc"]

# launches of each Rtc kernel, by name (counted where cuLaunchKernel
# returned success)
LAUNCHES = {}

_LIBS = {}


def _find(name, env_dirs):
    """A loadable ``lib<name>.so``: the CUDA toolkit's, the system's, or a
    CUDA wheel's beside torch."""
    cands = []
    for d in env_dirs:
        cands += sorted(glob.glob(os.path.join(d, "lib%s.so*" % name)))
    found = ctypes.util.find_library(name)
    if found:
        cands.append(found)
    for p in sys.path:
        cands += sorted(glob.glob(os.path.join(
            p, "nvidia", "*", "lib", "lib%s.so*" % name)))
    for c in cands:
        try:
            return ctypes.CDLL(c)
        except OSError:
            continue
    raise MXNetError("Rtc: lib%s.so not found (CUDA_HOME/lib64, the "
                     "system, or a CUDA wheel)" % name)


def _nvrtc():
    if "nvrtc" not in _LIBS:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        lib = _find("nvrtc", [os.path.join(home, "lib64"),
                              os.path.join(home, "lib")])
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        _LIBS["nvrtc"] = lib
    return _LIBS["nvrtc"]


def _cuda():
    if "cuda" not in _LIBS:
        try:
            _LIBS["cuda"] = ctypes.CDLL("libcuda.so.1")
        except OSError:
            _LIBS["cuda"] = _find("cuda", [])
    return _LIBS["cuda"]


def _nvrtc_check(rc, what, prog=None):
    if rc != 0:
        lib = _nvrtc()
        msg = lib.nvrtcGetErrorString(rc).decode()
        log = ""
        if prog is not None:
            n = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(n))
            buf = ctypes.create_string_buffer(n.value)
            lib.nvrtcGetProgramLog(prog, buf)
            log = "\n" + buf.value.decode(errors="replace")
        raise MXNetError("Rtc: %s failed: %s%s" % (what, msg, log))


def _cu_check(rc, what):
    if rc != 0:
        s = ctypes.c_char_p()
        _cuda().cuGetErrorString(rc, ctypes.byref(s))
        raise MXNetError("Rtc: %s failed: CUDA error %d (%s)"
                         % (what, rc, (s.value or b"?").decode()))


def decorate(name, inputs, outputs, kernel):
    """The full kernel source ``mxrtc.cc``'s ``decorate`` makes of a body:
    the signature over the named arrays, then each array's ``_ndim`` and
    ``_dims[]`` constants, then the body."""
    src = '\nextern "C" __global__ void ' + name + "("
    src += ",".join(["const float* " + n for n, _ in inputs]
                    + ["float* " + n for n, _ in outputs])
    src += ") {\n"
    for n, arr in list(inputs) + list(outputs):
        src += "const int %s_ndim = %d;\n" % (n, len(arr.shape))
        src += "const int %s_dims[] = {%s};\n" % (
            n, ",".join(str(int(d)) for d in arr.shape))
    return src + kernel + "\n}\n"


class Rtc:
    """A CUDA kernel compiled at run time (reference MXRtc).

    Parameters
    ----------
    name : str — the kernel's name
    inputs : list of (str, NDArray) — the input arrays by name
    outputs : list of (str, NDArray) — the output arrays by name
    kernel : str — the kernel's body (after ``{``, before ``}``)

    The arrays given here fix the ``_ndim``/``_dims`` constants; ``push``
    takes arrays of the same shapes.
    """

    def __init__(self, name, inputs, outputs, kernel):
        self.name = name
        self.source = decorate(name, inputs, outputs, kernel)
        self._shapes = [tuple(a.shape) for _, a in list(inputs)
                        + list(outputs)]
        self._n_in = len(inputs)
        self._modules = {}      # device index -> (CUmodule, CUfunction)

    def _compile(self, dev):
        """The kernel's CUfunction on card ``dev``, compiled at first
        use for its architecture."""
        idx = dev.index if dev.index is not None else 0
        hit = self._modules.get(idx)
        if hit is not None:
            return hit[1]
        nv = _nvrtc()
        prog = ctypes.c_void_p()
        _nvrtc_check(nv.nvrtcCreateProgram(
            ctypes.byref(prog), self.source.encode(),
            (self.name + ".cu").encode(), 0, None, None),
            "nvrtcCreateProgram")
        try:
            major, minor = torch.cuda.get_device_capability(dev)
            arch = "sm_%d%d%s" % (major, minor, "a" if major >= 9 else "")
            opts = [b"--gpu-architecture=" + arch.encode(), b"-std=c++17"]
            copts = (ctypes.c_char_p * len(opts))(*opts)
            _nvrtc_check(nv.nvrtcCompileProgram(prog, len(opts), copts),
                         "nvrtcCompileProgram", prog)
            n = ctypes.c_size_t()
            _nvrtc_check(nv.nvrtcGetCUBINSize(prog, ctypes.byref(n)),
                         "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(n.value)
            _nvrtc_check(nv.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        finally:
            nv.nvrtcDestroyProgram(ctypes.byref(prog))
        cu = _cuda()
        # the module loads into the current context: torch's primary
        # context of the card, made current on this thread
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        ctx = ctypes.c_void_p()
        _cu_check(cu.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
        if not ctx.value:
            _cu_check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), idx),
                      "cuDevicePrimaryCtxRetain")
            _cu_check(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
        mod, fn = ctypes.c_void_p(), ctypes.c_void_p()
        _cu_check(cu.cuModuleLoadData(ctypes.byref(mod), cubin),
                  "cuModuleLoadData")
        _cu_check(cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                         self.name.encode()),
                  "cuModuleGetFunction")
        self._modules[idx] = (mod, fn)
        return fn

    def push(self, inputs, outputs, grid_dims, block_dims):
        """Launch on NDArrays of the card (reference ``Rtc.push``):
        ``grid_dims`` and ``block_dims`` are (x, y, z) triples; the launch
        runs on torch's current stream."""
        arrs = list(inputs) + list(outputs)
        if len(inputs) != self._n_in or len(arrs) != len(self._shapes):
            raise MXNetError("Rtc.push: %s takes %d inputs and %d outputs"
                             % (self.name, self._n_in,
                                len(self._shapes) - self._n_in))
        for a, shape in zip(arrs, self._shapes):
            if not isinstance(a, NDArray):
                raise MXNetError("Rtc.push expects NDArrays")
            t = a._tensor
            if t.device.type != "cuda":
                raise MXNetError("Rtc.push: %s is on %s; a runtime CUDA "
                                 "kernel runs on the card" % (self.name,
                                                              t.device))
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise MXNetError("Rtc.push: arrays must be contiguous "
                                 "float32")
            if tuple(t.shape) != shape:
                raise MXNetError("Rtc.push: shape %s, the kernel was made "
                                 "for %s" % (tuple(t.shape), shape))
        dev = arrs[0]._tensor.device
        fn = self._compile(dev)
        ptrs = [ctypes.c_void_p(a._tensor.data_ptr()) for a in arrs]
        params = (ctypes.c_void_p * len(ptrs))(
            *[ctypes.addressof(p) for p in ptrs])
        gx, gy, gz = (tuple(grid_dims) + (1, 1))[:3]
        bx, by, bz = (tuple(block_dims) + (1, 1))[:3]
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        _cu_check(_cuda().cuLaunchKernel(
            fn, ctypes.c_uint(gx), ctypes.c_uint(gy), ctypes.c_uint(gz),
            ctypes.c_uint(bx), ctypes.c_uint(by), ctypes.c_uint(bz),
            ctypes.c_uint(0), stream, params, None), "cuLaunchKernel")
        LAUNCHES[self.name] = LAUNCHES.get(self.name, 0) + 1
        return outputs
