"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``:

* :func:`paged_attention` (Pallas ``paged_attention`` l.1115): slot-paged
  attention over each slot's live KV rows ``[0, pos+C)``, causal in the
  chunk, GQA-native, online softmax in f32, optional int8 KV. Three C
  entries, chosen by dtype and shape (:func:`paged_entry`): every chunk
  with C < 16 (decode reads, verify chunks) a split-KV read whose splits
  are merged by a second kernel of the same entry, a bf16 q's prefill
  chunk over a bf16 or an int8 cache the tensor-core attention forward of
  ``csrc/attention.cuh`` with the paged mask, and what is left a scalar
  kernel.
* :func:`quant_matmul` (l.1259): ``x @ dequant(q)^T`` for int8
  (per-output-channel scales) and nibble-packed int4 (per-group scales)
  weights, f32 accumulation.
* :func:`fused_decode_attention` (l.1389): one decode step's QKV
  projection -> rope -> attention over the live cache plus the new token
  -> output projection in one launch.
* :func:`flash_attention` (l.373): streaming-softmax attention with
  causal, window and padded-key masks, differentiable: the forward kernel
  emits the per-row logsumexp, and the backward is a dQ kernel over query
  tiles and a dK/dV kernel over key tiles that recompute the
  probabilities from it.
* :func:`fused_linear` (l.813): ``act(x @ w^T + b)`` with the epilogue on
  the f32 accumulator, differentiable (the backward is plain products, as
  the JAX package keeps it outside Pallas).
* :func:`fused_conv_bn_act` (l.838): ``act(scale_c * conv(x, w) + bias_c)``,
  the eval-time conv -> BatchNorm -> act chain with the folded BatchNorm
  in the epilogue, its path a rule on the geometry (:func:`conv_algo`): in
  f32 Winograd F(2x2, 3x3) for stride-1 3x3 convs, else an implicit GEMM
  that gathers the patches from a channels-last x in its tile loader; in
  bf16 ``fused_linear``'s GEMM over patches made by one strided copy.
* :func:`matmul_stats` (l.969): ``(x @ w^T, sum_rows y, sum_rows y^2)``
  with the statistics taken from the f32 accumulator, differentiable (the
  backward folds the statistics' cotangents into the output's and makes
  two plain products).
* :func:`striped_pair_attention` (l.664): one hop of the striped causal
  ring, ``(o, lse)`` under the mask ``a*n + q_off >= b*n + k_off``,
  differentiable in both outputs: the flash kernels of
  ``csrc/attention.cuh`` with the striped mask, the lse cotangent folded
  into the backward's row term.

The kernels live in ``csrc/*.cu`` (CUDA C++ for ``sm_90a``). Each source
is compiled by ``nvcc`` into its own shared library with a plain C
interface under ``build/kernels/`` at first use — all sources in
parallel, keyed by a hash of the source — and loaded with ``ctypes``. A
source may export several C entries (``flash_attention`` exports the
forward, dQ and dK/dV); each entry has its own argument types and its own
launch counter.

Dispatch: a tensor on the CPU goes to the plain version in this module
(the tests run those); a CUDA tensor launches the kernel or raises —
there is no fallback. Each launch adds one to its entry in
:func:`launch_counts` (the analogue of the JAX package's
``dispatch_count``); the plain versions are not counted.

Each public wrapper takes the JAX wrapper's parameters, in its order and
of its kind, and one rule holds for the two kinds that are the TPU's:

* **tile knobs** (``block_q``, ``block_k``, ``block_m``, ``block_n``,
  ``block_f``): accepted and validated as the JAX wrapper validates them
  (a positive size; ``paged_attention``'s ``block_k`` must divide the
  cache length, ``quant_matmul``'s ``block_f`` the output channels); they
  have no effect on CUDA, where each kernel's tiles are fixed, and the
  result does not depend on the tiling;
* **interpret**: ``None`` or ``False`` runs the kernel on CUDA tensors
  (the plain version on CPU ones); ``True`` runs the plain version on any
  device, the port's counterpart of the Pallas interpreter. It runs only
  when the caller asks for it, never as a fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import numbers
import os
import re
import shutil
import subprocess
import time

import torch

from ..base import MXNetError

__all__ = ["paged_attention", "default_paged_block_k", "quant_matmul",
           "fused_decode_attention", "flash_attention", "fused_linear",
           "fused_conv_bn_act", "fused_conv_bn_act_plain", "matmul_stats",
           "matmul_stats_fwd", "matmul_stats_plain",
           "paged_attention_plain", "quant_matmul_plain",
           "fused_decode_attention_plain", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_fwd_plain",
           "flash_attention_bwd_plain", "striped_pair_attention",
           "striped_pair_attention_fwd", "striped_pair_attention_bwd",
           "striped_pair_attention_plain",
           "striped_pair_attention_bwd_plain", "fused_linear_fwd",
           "fused_linear_plain", "build", "build_log", "parse_ptxas",
           "ptxas_report", "launch_counts", "reset_launch_counts",
           "paged_entry", "paged_decode_splits", "fused_decode_splits",
           "quant_matmul_splits",
           "conv_algo", "KERNELS",
           "ENTRIES", "SOURCE"]

# the sources build() compiles
KERNELS = ("paged_attention", "quant_matmul", "fused_decode_attention",
           "flash_attention", "striped_pair_attention", "fused_linear",
           "matmul_stats")

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kernels")
_HEADERS = ("common.cuh", "gemm.cuh", "attention.cuh", "decode.cuh",
            "qgemm.cuh")

_LIBS = {}

# dtype codes of the C interfaces (csrc/common.cuh)
_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the head dims the attention kernels of csrc/attention.cuh take, by dtype
_FLASH_D = {torch.bfloat16: (16, 32, 64, 128),
            torch.float32: (8, 16, 32, 64, 128)}


def launch_counts():
    """Kernel launches per C entry since :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


# -- build --------------------------------------------------------------

def _nvcc():
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                         "kernels build on a machine with the CUDA toolkit")
    return path


def _lib_path(name):
    h = hashlib.sha256()
    for fn in (name + ".cu",) + _HEADERS:
        with open(os.path.join(_CSRC, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, "%s-%s.so" % (name, h.hexdigest()[:16]))


def build(names=KERNELS):
    """Compile the kernels' sources that are not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: seconds}`` (0 for
    a library already built) and leaves each compiler log (``-Xptxas
    -v``: registers, shared memory, spills) beside its library as
    ``.log``."""
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or _nvcc()
        tmp = "%s.%d.tmp" % (out, os.getpid())
        log = open(build_log(name), "w")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp,
               os.path.join(_CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out)
    secs = dict.fromkeys(names, 0.0)
    failed = []
    for name, (proc, log, tmp, out) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        msgs = []
        for name in failed:
            with open(build_log(name)) as f:
                msgs.append("%s:\n%s" % (name, f.read()[-4000:]))
        raise MXNetError("nvcc failed for %s\n%s"
                         % (", ".join(failed), "\n".join(msgs)))
    return secs


_PTXAS_FN = re.compile(r"(?:Compiling entry function '([^']+)'|"
                       r"Function properties for (\S+))")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text):
    """The functions of a ``-Xptxas -v`` log, in order: ``[{"function":
    mangled name, "registers": n or None, "spill_stores": bytes,
    "spill_loads": bytes}]``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            name = m.group(1) or m.group(2)
            cur = out.setdefault(name, {"function": name, "registers": None,
                                        "spill_stores": 0, "spill_loads": 0})
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return list(out.values())


def build_log(name):
    """The compiler log :func:`build` leaves beside source ``name``'s
    library."""
    return _lib_path(name)[:-3] + ".log"


def ptxas_report(log):
    """:func:`parse_ptxas` of the compiler log at path ``log`` (e.g.
    :func:`build_log`), each function also under ``"name"``, demangled
    where the toolkit's ``cu++filt`` (or ``c++filt``) is found, else as
    mangled."""
    with open(log) as f:
        rows = parse_ptxas(f.read())
    mangled = [r["function"] for r in rows]
    names = mangled
    tools = [os.path.join(os.path.dirname(_nvcc()), "cu++filt"),
             shutil.which("c++filt")]
    for tool in tools:
        if tool and os.path.exists(tool) and mangled:
            res = subprocess.run([tool], input="\n".join(mangled),
                                 capture_output=True, text=True)
            got = res.stdout.splitlines()
            if res.returncode == 0 and len(got) == len(mangled):
                names = got
                break
    for r, n in zip(rows, names):
        r["name"] = n
    return rows


def _lib(entry):
    """The C function ``mx_<entry>``, its source built and loaded at the
    first call."""
    src = SOURCE[entry]
    lib = _LIBS.get(src)
    if lib is None:
        build((src,))
        lib = ctypes.CDLL(_lib_path(src))
        for e in ENTRIES[src]:
            fn = getattr(lib, "mx_" + e)
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES[e]
        _LIBS[src] = lib
    return getattr(lib, "mx_" + entry)


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# the C entries of each source; every entry ends in the stream
ENTRIES = {
    "paged_attention": ("paged_attention", "paged_attention_chunk",
                        "paged_attention_decode"),
    "quant_matmul": ("quant_matmul",),
    "fused_decode_attention": ("fused_decode_attention",),
    "flash_attention": ("flash_attention_fwd", "flash_attention_dq",
                        "flash_attention_dkv"),
    "striped_pair_attention": ("striped_pair_fwd", "striped_pair_dq",
                               "striped_pair_dkv"),
    "fused_linear": ("fused_linear", "fused_conv_bn_act"),
    "matmul_stats": ("matmul_stats",),
}
SOURCE = {e: src for src, es in ENTRIES.items() for e in es}
_ARGTYPES = {
    # q, k, v, k_scale, v_scale, pos, out, S, C, H, KV, L, D, scale,
    # q_dtype, kv_dtype, stream
    "paged_attention": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    # q, k, v, k_scale, v_scale, pos, out, S, C, H, KV, L, D, scale,
    # kv_dtype, stream
    "paged_attention_chunk": [_P] * 7 + [_I] * 6 + [_F, _I, _P],
    # q, k, v, k_scale, v_scale, pos, out, workspace, S, C, H, KV, L, D,
    # splits, scale, q_dtype, kv_dtype, stream
    "paged_attention_decode": [_P] * 8 + [_I] * 7 + [_F, _I, _I, _P],
    # x, q, scale, out, part, count, M, E, F, bits, group, ksplit, x_dtype,
    # out_dtype, stream
    "quant_matmul": [_P] * 6 + [_I] * 8 + [_P],
    # x, pos, k_cache, v_cache, wqkv, sqkv, bqkv, wo, so, bo, cos, sin,
    # out, k_new, v_new, then the workspaces qkv, o, part, att, count, then
    # S, E, H, KV, D, L, bits, group, key splits, QKV and output splits,
    # scale, x_dtype, cache_dtype, the dtype of k_new and v_new, stream
    "fused_decode_attention": [_P] * 20 + [_I] * 11 + [_F, _I, _I, _I, _P],
    # q, k, v, o, lse, B, H, Tq, Tk, D, the batch and time strides of q,
    # k and v, scale, causal, window, dtype, stream
    "flash_attention_fwd": [_P] * 5 + [_I] * 5 + [_L] * 6
    + [_F, _I, _I, _I, _P],
    # q, k, v, o, do, lse, dcap, dq, B, H, Tq, Tk, D, strides, scale,
    # causal, window, dtype, stream
    "flash_attention_dq": [_P] * 8 + [_I] * 5 + [_L] * 6
    + [_F, _I, _I, _I, _P],
    # q, k, v, do, lse, dcap, dk, dv, B, H, Tq, Tk, D, strides, scale,
    # causal, window, dtype, stream
    "flash_attention_dkv": [_P] * 8 + [_I] * 5 + [_L] * 6
    + [_F, _I, _I, _I, _P],
    # q, k, v, o, lse, BH, Cq, Ck, D, scale, n, q_off, k_off, dtype, stream
    "striped_pair_fwd": [_P] * 5 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    # q, k, v, o, do, lse, g_lse, dcap, dq, BH, Cq, Ck, D, scale, n, q_off,
    # k_off, dtype, stream
    "striped_pair_dq": [_P] * 9 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    # q, k, v, do, lse, dcap, dk, dv, BH, Cq, Ck, D, scale, n, q_off, k_off,
    # dtype, stream
    "striped_pair_dkv": [_P] * 8 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    # x, w, scale, bias, out, M, N, K, act, dtype, stream
    "fused_linear": [_P] * 5 + [_I] * 5 + [_P],
    # x (channels-last), w [O, kh*kw*C], scale, bias, out, the Winograd
    # workspace and its floats, then the geometry N, H, W, C, OH, OW, O, kh,
    # kw, sh, sw, ph, pw, dh, dw, then act, dtype, stream
    "fused_conv_bn_act": [_P] * 6 + [_L] + [_I] * 17 + [_P],
    # x, w, y, s1 partials, s2 partials, M, N, K, dtype, stream
    "matmul_stats": [_P] * 5 + [_I] * 4 + [_P],
}
_LAUNCHES = dict.fromkeys(SOURCE, 0)

# the count of a program being counted (profiler.py ``_count``): a dict the
# wrappers add their launches' operations and operand bytes to; None
# outside a count
_COST = None


def _cost(flops, *tensors):
    """Add one launch's operations and its operands' bytes (each read or
    written once) to the active count; one None check outside a count."""
    if _COST is not None:
        _COST["flops"] += float(flops)
        _COST["bytes_accessed"] += float(sum(
            t.numel() * t.element_size() for t in tensors if t is not None))


def _launch(entry, *args):
    """Call C entry ``mx_<entry>`` on the current stream and count the
    launch; a launch the runtime refused raises here (it never ran)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = _lib(entry)(*args, stream)
    if err != 0:
        raise MXNetError("%s: CUDA launch failed with error %d"
                         % (entry, err))
    _LAUNCHES[entry] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_cuda(*tensors):
    """True for CUDA tensors (the kernel runs), False for CPU ones (the
    plain version runs); anything else, or a mix, raises."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise MXNetError("kernel inputs must lie on one device, got %s"
                         % sorted(map(str, devs)))
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise MXNetError("no kernel for device %s" % dev)
    return True


def _plain(interpret, *tensors):
    """True where the plain version runs: ``interpret=True`` asks for it
    on any device; otherwise CPU tensors take it and CUDA ones the kernel
    (:func:`_on_cuda`)."""
    if interpret:
        return True
    return not _on_cuda(*tensors)


def _check_tiles(name, **knobs):
    """The JAX wrapper's tile knobs: None or a positive int each, and
    no effect here (the module's rule)."""
    for knob, val in knobs.items():
        if val is not None and (isinstance(val, bool) or not isinstance(
                val, numbers.Integral) or val < 1):
            raise ValueError("%s: %s must be a positive int or None, got %r"
                             % (name, knob, val))


def _check(cond, what, *args):
    """Raise ``MXNetError(what % args)`` unless ``cond``; the message is
    formatted only on failure (the checks run on every launch)."""
    if not cond:
        raise MXNetError(what % args if args else what)


def _contig(*pairs):
    for name, t in pairs:
        if t is not None and not t.is_contiguous():
            raise MXNetError("%s must be contiguous" % name)


def _aligned(nbytes, *pairs):
    """The kernels' vector loads need buffers on ``nbytes`` boundaries."""
    for name, t in pairs:
        if t.data_ptr() % nbytes:
            raise MXNetError("%s must start on a %d-byte boundary"
                             % (name, nbytes))


# -- shared dequantization ------------------------------------------------

def unpack4(u):
    """[rows, E/2] uint8 nibble-packed -> f32 [rows, E]: the low nibble
    is the even element, the high nibble the odd one, sign-extended two's
    complement (``_unpack4_block``, pallas_kernels.py l.1226)."""
    lo = (u & 0xF).to(torch.int32)
    hi = ((u >> 4) & 0xF).to(torch.int32)
    both = torch.stack([lo, hi], dim=-1).reshape(
        u.shape[:-1] + (2 * u.shape[-1],))
    return (both - 16 * (both >= 8).to(torch.int32)).to(torch.float32)


def _dequant_w(q, s, bits, group):
    """The f32 weight a kernel contracts with: int4 unpacked and scaled
    per group (before the dot); int8 cast raw — its per-row scale
    multiplies the product instead (``_dequant_w``, l.1239)."""
    if bits == 4:
        return unpack4(q) * torch.repeat_interleave(s, group, dim=-1)
    return q.to(torch.float32)


def _check_quant(name, q, scale, bits, group, e):
    if bits == 8:
        _check(q.dtype == torch.int8 and q.dim() == 2 and q.shape[1] == e,
               "%s: bits=8 wants int8 weights [F, %d], got %s %s",
               name, e, q.dtype, tuple(q.shape))
        _check(scale.shape == (q.shape[0],),
               "%s: int8 scales must be [F]", name)
    elif bits == 4:
        _check(group is not None and group > 0 and group % 2 == 0
               and e % group == 0,
               "%s: bits=4 needs the per-group scale width (an even "
               "divisor of E=%d), got group=%r", name, e, group)
        _check(q.dtype == torch.uint8 and q.dim() == 2
               and 2 * q.shape[1] == e,
               "%s: bits=4 wants uint8 packed weights [F, %d], got %s %s",
               name, e // 2, q.dtype, tuple(q.shape))
        _check(scale.shape == (q.shape[0], e // group),
               "%s: int4 scales must be [F, E/group]", name)
    else:
        raise MXNetError("%s: bits must be 8 or 4, got %r" % (name, bits))
    _check(scale.dtype == torch.float32, "%s: scales must be f32", name)


# -- paged_attention ------------------------------------------------------

def default_paged_block_k(max_len):
    """The JAX kernel's KV rows per grid block: the largest of (128, 64,
    32, 16, 8) dividing ``max_len``, else ``max_len`` itself
    (``default_paged_block_k``, l.1012). The CUDA kernels do not take
    it: they walk live keys in tiles of their own (32 rows for the scalar
    entry, 64 for the chunk entry, ranges of :func:`paged_decode_splits`
    for the decode entry) and stop at each query tile's last live key."""
    for b in (128, 64, 32, 16, 8):
        if max_len % b == 0:
            return b
    return max_len


def paged_attention_plain(q, k, v, pos, k_scale=None, v_scale=None,
                          scale=None):
    """Plain PyTorch version of :func:`paged_attention`: the same
    function with one masked softmax, reading the cache only up to the
    last row any slot's chunk reaches."""
    s_, c, h, d = q.shape
    l_, kv = k.shape[1], k.shape[2]
    g = h // kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    live = min(l_, int(pos.max()) + c)
    kf = k[:, :live].to(torch.float32)
    vf = v[:, :live].to(torch.float32)
    if k_scale is not None:
        kf = kf * k_scale[:, :live, :, None]
        vf = vf * v_scale[:, :live, :, None]
    qg = q.to(torch.float32).reshape(s_, c, kv, g, d)
    sc = torch.einsum("sckgd,slkd->skgcl", qg, kf) * scale
    kpos = torch.arange(live, device=q.device)
    qpos = pos.to(torch.int64)[:, None] \
        + torch.arange(c, device=q.device)                  # [S, C]
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None, None]
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros_like(sc))
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("skgcl,slkd->sckgd", p / den, vf)
    return o.reshape(s_, c, h, d).to(q.dtype)


# the chunk entry's query rows at least: shorter chunks (a decode read, a
# speculative verify) would fill under a quarter of its 64-row tiles, and
# take the decode entry
_CHUNK_MIN_C = 16


def paged_entry(q_dtype, kv_dtype, c, d):
    """The C entry :func:`paged_attention` launches for a CUDA call, by
    dtype and shape:

    * ``c < 16`` query rows (C = 1 decode reads, speculative verify
      chunks), any q and cache dtype: ``paged_attention_decode``, the
      split-KV read (:func:`paged_decode_splits`);
    * a bf16 q over a bf16 or an int8 cache with ``c >= 16`` and a
      tensor-core head_dim (16, 32, 64, 128): ``paged_attention_chunk``,
      the attention forward of ``csrc/attention.cuh`` with the paged mask
      (an int8 tile turned into bf16 integers in shared memory, its row
      scales applied to the score and probability columns);
    * what is left (``c >= 16`` with an f32 q or cache, an int8 cache
      under an f32 q, or another head_dim): ``paged_attention``, the
      scalar kernel.

    No entry gives way to another."""
    if c < _CHUNK_MIN_C:
        return "paged_attention_decode"
    if (q_dtype == torch.bfloat16
            and kv_dtype in (torch.bfloat16, torch.int8)
            and d in _FLASH_D[torch.bfloat16]):
        return "paged_attention_chunk"
    return "paged_attention"


# keys x head_dim a decode split takes at least (128 keys at D = 64: 16 KB
# of bf16 K and V), SMs a slot's (kv head, split) blocks may reach, and
# splits at most (the merge holds each split's (m, l) in registers)
_DEC_SPLIT_ELEMS = 8192
_DEC_SMS_PER_SPLIT = 4
_DEC_MAX_SPLITS = 32


@functools.lru_cache(maxsize=None)
def paged_decode_splits(l_, d, sms):
    """How many key ranges the decode entry cuts a slot's ``l_`` cache
    rows into: ranges of at least ``8192 // d`` keys, at most one for
    every 4 of the card's ``sms`` SMs (so that a slot's reads of one kv
    head spread over at most a quarter of the card), and at most 32.
    Split ``i`` takes keys ``[i * ceil(l_ / n), (i + 1) * ceil(l_ / n))``.
    A function of the cache's shape and the card alone, never of ``pos``:
    the host reads no device value, and a captured launch stays valid for
    every ``pos``."""
    per = max(1, _DEC_SPLIT_ELEMS // d)
    return max(1, min(-(-l_ // per), sms // _DEC_SMS_PER_SPLIT,
                      _DEC_MAX_SPLITS))


def _paged_decode(q, k, v, pos, k_scale, v_scale, scale):
    """Launch ``paged_attention_decode``; it takes only what
    :func:`paged_entry` routes to it, and raises on anything else."""
    s_, c, h, d = q.shape
    l_, kv = k.shape[1], k.shape[2]
    _check(c < _CHUNK_MIN_C, "paged_attention_decode: takes C < %d query "
           "rows, got %d", _CHUNK_MIN_C, c)
    _check(d <= 128, "paged_attention_decode: head_dim must be <= 128, "
           "got %d", d)
    _check(s_ <= 65535 and kv <= 65535, "paged_attention_decode: at most "
           "65535 slots and kv heads")
    _contig(("q", q), ("k", k), ("v", v), ("pos", pos),
            ("k_scale", k_scale), ("v_scale", v_scale))
    ns = paged_decode_splits(l_, d, _sm_count(q.device))
    out = torch.empty_like(q)
    # each split's (m, l, acc[D]) per query row, written by the splits and
    # read by their merge, both inside the entry
    ws = torch.empty((s_, kv, ns, (h // kv) * c, d + 2),
                     dtype=torch.float32, device=q.device)
    _cost(4 * s_ * c * h * l_ * d, q, k, v, k_scale, v_scale, pos, out)
    _launch("paged_attention_decode", _ptr(q), _ptr(k), _ptr(v),
            _ptr(k_scale), _ptr(v_scale), _ptr(pos), _ptr(out), _ptr(ws),
            s_, c, h, kv, l_, d, ns, float(scale), _CODE[q.dtype],
            _CODE[k.dtype])
    return out


def _paged_chunk(q, k, v, pos, scale, k_scale=None, v_scale=None):
    """Launch ``paged_attention_chunk``; it takes only what
    :func:`paged_entry` routes to it, and raises on anything else."""
    s_, c, h, d = q.shape
    l_, kv = k.shape[1], k.shape[2]
    _check(q.dtype == torch.bfloat16
           and k.dtype in (torch.bfloat16, torch.int8)
           and v.dtype == k.dtype,
           "paged_attention_chunk: q must be bf16 and the cache bf16 or "
           "int8")
    _check((k.dtype == torch.int8) == (k_scale is not None
                                       and v_scale is not None),
           "paged_attention_chunk: an int8 cache comes with its row scales, "
           "a bf16 one without")
    _check(d in _FLASH_D[torch.bfloat16],
           "paged_attention_chunk: head_dim must be in %s, got %d",
           _FLASH_D[torch.bfloat16], d)
    _check(s_ * h <= 65535, "paged_attention_chunk: at most 65535 (slot, "
           "head) pairs")
    _contig(("q", q), ("k", k), ("v", v), ("pos", pos),
            ("k_scale", k_scale), ("v_scale", v_scale))
    _aligned(16, ("q", q), ("k", k), ("v", v))
    out = torch.empty_like(q)
    _cost(4 * s_ * c * h * l_ * d, q, k, v, k_scale, v_scale, pos, out)
    _launch("paged_attention_chunk", _ptr(q), _ptr(k), _ptr(v),
            _ptr(k_scale), _ptr(v_scale), _ptr(pos), _ptr(out), s_, c, h,
            kv, l_, d, float(scale), _CODE[k.dtype])
    return out


def paged_attention(q, k, v, pos, *, k_scale=None, v_scale=None,
                    scale=None, block_k=None, interpret=None):
    """Slot-paged attention reading only the live KV rows.

    q: [S, C, H, D] — each slot's C-token query chunk. k, v:
    [S, L, Hkv, D] cache buffers, float, or int8 with ``k_scale``/
    ``v_scale`` [S, L, Hkv] f32 row scales (dequantized as the rows are
    loaded). pos: [S] int32, the chunk's start per slot; rows
    ``[pos, pos+C)`` must already be written, and chunk row ``c`` attends
    keys ``[0, pos+c]``. Returns [S, C, H, D] in q's dtype, accumulated
    in f32. Rows past a slot's last live key are never read. On the card,
    :func:`paged_entry` picks the C entry that runs.

    ``block_k`` (the JAX kernel's KV rows a grid step) and ``interpret``
    follow the module's rule: ``block_k`` must divide L (as in the JAX
    wrapper) and changes nothing here; ``interpret=True`` runs the plain
    version on any device."""
    s_, c, h, d = q.shape
    _check(k.dim() == 4 and k.shape == v.shape and k.shape[0] == s_
           and k.shape[3] == d, "paged_attention: k/v must be [S, L, Hkv, "
           "D] matching q [S, C, H, D]")
    l_, kv = k.shape[1], k.shape[2]
    _check(kv >= 1 and h % kv == 0,
           "paged_attention: %d kv heads must divide %d heads", kv, h)
    _check(pos.shape == (s_,) and pos.dtype == torch.int32,
           "paged_attention: pos must be int32 [S]")
    _check_tiles("paged_attention", block_k=block_k)
    if block_k is not None and l_ % block_k:
        raise ValueError(
            "paged_attention: block_k=%d must divide the cache length %d "
            "(whole blocks keep the grid static)" % (block_k, l_))
    quant = k_scale is not None or v_scale is not None
    if quant:
        _check(k_scale is not None and v_scale is not None,
               "paged_attention: k_scale and v_scale must be passed "
               "together")
        _check(k.dtype == torch.int8 and v.dtype == torch.int8,
               "paged_attention: scales come with an int8 cache")
        _check(k_scale.shape == (s_, l_, kv) and v_scale.shape
               == (s_, l_, kv) and k_scale.dtype == torch.float32
               and v_scale.dtype == torch.float32,
               "paged_attention: scales must be f32 [S, L, Hkv]")
    else:
        _check(k.dtype in (torch.float32, torch.bfloat16)
               and v.dtype == k.dtype,
               "paged_attention: a float cache must be f32 or bf16, "
               "got %s/%s", k.dtype, v.dtype)
    _check(q.dtype in (torch.float32, torch.bfloat16),
           "paged_attention: q must be f32 or bf16, got %s", q.dtype)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _plain(interpret, q, k, v, pos, k_scale, v_scale):
        return paged_attention_plain(q, k, v, pos, k_scale, v_scale,
                                     scale)
    entry = paged_entry(q.dtype, k.dtype, c, d)
    if entry == "paged_attention_decode":
        return _paged_decode(q, k, v, pos, k_scale, v_scale, scale)
    if entry == "paged_attention_chunk":
        return _paged_chunk(q, k, v, pos, scale, k_scale, v_scale)
    _check(d <= 128, "paged_attention: the kernel takes head_dim <= 128, "
           "got %d", d)
    _contig(("q", q), ("k", k), ("v", v), ("pos", pos),
            ("k_scale", k_scale), ("v_scale", v_scale))
    out = torch.empty_like(q)
    _cost(4 * s_ * c * h * l_ * d, q, k, v, k_scale, v_scale, pos, out)
    _launch("paged_attention", _ptr(q), _ptr(k), _ptr(v), _ptr(k_scale),
            _ptr(v_scale), _ptr(pos), _ptr(out), s_, c, h, kv, l_, d,
            float(scale), _CODE[q.dtype], _CODE[k.dtype])
    return out


# -- quant_matmul -----------------------------------------------------------

def quant_matmul_plain(x, q, scale, bits=8, group=None, out_dtype=None):
    """Plain PyTorch version of :func:`quant_matmul`: dequantize, one f32
    product, int8 scales after it."""
    acc = x.to(torch.float32) @ _dequant_w(q, scale, bits, group).t()
    if bits == 8:
        acc = acc * scale
    return acc.to(out_dtype or x.dtype)


def quant_matmul(x, q, scale, *, bits=8, group=None, block_f=None,
                 out_dtype=None, interpret=None):
    """``x [M, E] @ dequant(q) [F, E]^T -> [M, F]``.

    ``q``: int8 ``[F, E]`` (``bits=8``, ``scale`` f32 ``[F]``, applied to
    the product) or nibble-packed uint8 ``[F, E//2]`` (``bits=4``,
    ``scale`` f32 ``[F, E//group]``, applied to the weight before the
    dot). x in f32 or bf16; the result is accumulated in f32 and returned
    in ``out_dtype`` (default x's).

    ``block_f`` (the JAX kernel's output channels a grid step) and
    ``interpret`` follow the module's rule: ``min(block_f, F)`` must divide
    F (as in the JAX wrapper) and changes nothing here; ``interpret=True``
    runs the plain version on any device."""
    _check(x.dim() == 2, "quant_matmul: x must be [M, E], got %s",
           tuple(x.shape))
    _check(x.dtype in (torch.float32, torch.bfloat16),
           "quant_matmul: x must be f32 or bf16, got %s", x.dtype)
    m, e = x.shape
    _check_quant("quant_matmul", q, scale, bits, group, e)
    _check_tiles("quant_matmul", block_f=block_f)
    if block_f is not None and q.shape[0] \
            and q.shape[0] % min(block_f, q.shape[0]):
        raise ValueError(
            "quant_matmul: block_f=%d must divide the output-channel count "
            "%d (the grid partitions whole blocks)" % (block_f, q.shape[0]))
    out_dtype = out_dtype or x.dtype
    _check(out_dtype in (torch.float32, torch.bfloat16),
           "quant_matmul: out_dtype must be f32 or bf16")
    if _plain(interpret, x, q, scale):
        return quant_matmul_plain(x, q, scale, bits, group, out_dtype)
    _contig(("x", x), ("q", q), ("scale", scale))
    _aligned(16, ("q", q))
    f = q.shape[0]
    out = torch.empty((m, f), dtype=out_dtype, device=x.device)
    if m:
        ksplit = quant_matmul_splits(f, e, _sm_count(x.device))
        part, count = _split_workspace(m, f, ksplit, x.device)
        _cost(2 * m * f * e, x, q, scale, out)
        _launch("quant_matmul", _ptr(x), _ptr(q), _ptr(scale), _ptr(out),
                _ptr(part), _ptr(count), m, e, f, bits, group or 0, ksplit,
                _CODE[x.dtype], _CODE[out_dtype])
    return out


# csrc/qgemm.cuh BM, BF, KS: rows and channels of a tile, contraction
# values of a stage (the unit the splits cut)
_QMM_BM, _QMM_BF, _QMM_KS = 32, 64, 128


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def quant_matmul_splits(f, e, sms):
    """How many ranges ``csrc/qgemm.cuh`` cuts the contraction of an
    ``[F, E]`` weight into, on a card of ``sms`` SMs: enough for a block
    per SM over the weight's 64-channel tiles, in whole 128-value stages,
    each range as many stages as the next (the last may be short). A
    function of F, E and the card, never of M: a row's sums do not depend
    on the batch it rides in."""
    n_f = -(-f // _QMM_BF)
    n_k = -(-e // _QMM_KS)
    want = min(n_k, max(1, -(-sms // n_f)))
    steps = -(-n_k // want)
    return -(-n_k // steps)


_COUNTS = {}


def _current_stream(device):
    """The handle of the stream :func:`_launch` launches on (0 for a
    CPU ``device``: only the tests launch from there, recording)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.current_stream().cuda_stream


def _zeroed_counts(n, device):
    """``n`` int32 arrival counts on ``device``, all 0, for a launch on
    the current stream. The kernels that count arrivals
    (``csrc/qgemm.cuh`` ``finish_tile``: ``quant_matmul`` and the fused
    decode step's two GEMMs) set each count back to 0 when its last
    arrival has read it, so one buffer serves every launch on one stream,
    with no memset. Launches on a stream run one after another; two
    streams may run at once, so each stream has a buffer of its own."""
    key = (device, _current_stream(device))
    buf = _COUNTS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTS[key] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                         device=device)
    return buf


def _split_workspace(m, f, ksplit, device):
    """The f32 partials and arrival counts of an ``[m, f]`` product cut
    into ``ksplit`` contraction ranges (None for one range)."""
    if ksplit == 1:
        return None, None
    tiles = -(-m // _QMM_BM) * -(-f // _QMM_BF)
    part = torch.empty(tiles * ksplit * _QMM_BM * _QMM_BF,
                       dtype=torch.float32, device=device)
    return part, _zeroed_counts(tiles, device)


# -- fused_decode_attention -------------------------------------------------

_SMEM_MAX = 232448       # bytes of shared memory a block may use (H100)
# keys x head_dim a split of the fused step's read takes at least (512
# keys at D = 64): four times the decode entry's, since each of its splits
# also costs a merge read, and a decode step's slots are many
_FD_SPLIT_ELEMS = 32768


def _rope_tables(pos, half, rope, rope_base):
    """Per-slot cos/sin [S, half] f32 at angle ``pos * base**(-i/half)``;
    the identity rotation (cos=1, sin=0) when rope is off."""
    if not rope:
        return _identity_rotation(pos.shape[0], half, pos.device)
    from .attention import rope_freqs
    ang = pos.to(torch.float32)[:, None] \
        * rope_freqs(half, rope_base, pos.device)[None, :]
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=None)
def fused_decode_splits(l_, d, sms):
    """How many key ranges the fused step's read cuts a slot's ``l_`` cache
    rows into: :func:`paged_decode_splits`' rule with ranges of at least
    ``32768 // d`` keys. A function of the cache's shape and the card
    alone, never of ``pos`` or the slot count."""
    per = max(1, _FD_SPLIT_ELEMS // d)
    return max(1, min(-(-l_ // per), sms // _DEC_SMS_PER_SPLIT,
                      _DEC_MAX_SPLITS))


@functools.lru_cache(maxsize=64)
def _identity_rotation(s_, half, device):
    ones = torch.ones((s_, half), dtype=torch.float32, device=device)
    return ones, torch.zeros_like(ones)


def fused_decode_attention_plain(x, pos, k_cache, v_cache, wqkv, sqkv,
                                 bqkv, wo, so, bo, cos, sin, heads, bits,
                                 group, scale, cache_dtype=None):
    """Plain PyTorch version of :func:`fused_decode_attention` (with the
    rope tables already built); ``k_new`` and ``v_new`` in
    ``cache_dtype``, default the cache's."""
    s_, e = x.shape
    l_, kv, d = k_cache.shape[1:]
    g, half = heads // kv, d // 2
    qkv = x.to(torch.float32) @ _dequant_w(wqkv, sqkv, bits, group).t()
    if bits == 8:
        qkv = qkv * sqkv
    qkv = qkv + bqkv.to(torch.float32)
    qh = qkv[:, :e].reshape(s_, heads, d)
    kh = qkv[:, e:e + kv * d].reshape(s_, kv, d)
    vh = qkv[:, e + kv * d:e + 2 * kv * d].reshape(s_, kv, d)
    cs, sn = cos[:, None, :], sin[:, None, :]

    def rot(t):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cs - t2 * sn, t2 * cs + t1 * sn], dim=-1)

    qh, kh = rot(qh), rot(kh)
    qg = qh.reshape(s_, kv, g, d)
    ck = k_cache.to(torch.float32)
    cv = v_cache.to(torch.float32)
    s_cache = torch.einsum("skgd,slkd->skgl", qg, ck) * scale
    live = torch.arange(l_, device=x.device)[None, None, None, :] \
        < pos.to(torch.int64)[:, None, None, None]
    s_cache = torch.where(live, s_cache, torch.full_like(s_cache, -1e30))
    s_new = torch.einsum("skgd,skd->skg", qg, kh)[..., None] * scale
    full = torch.cat([s_cache, s_new], dim=-1)          # [S, KV, G, L+1]
    w = torch.exp(full - full.amax(dim=-1, keepdim=True))
    den = w.sum(dim=-1, keepdim=True)
    o = torch.einsum("skgl,slkd->skgd", w[..., :l_], cv) \
        + w[..., l_:] * vh[:, :, None, :]
    o = (o / den).reshape(s_, heads * d)
    out = o @ _dequant_w(wo, so, bits, group).t()
    if bits == 8:
        out = out * so
    out = out + bo.to(torch.float32)
    cdt = cache_dtype or k_cache.dtype
    return out.to(x.dtype), kh.to(cdt), vh.to(cdt)


def fused_decode_attention(x, pos, k_cache, v_cache, wqkv, sqkv, bqkv,
                           wo, so, bo, *, heads, kv_heads, bits=8,
                           group=None, rope=True, rope_base=10000.0,
                           scale=None, cache_dtype=None, interpret=None):
    """One decode step's QKV projection -> rope -> attention -> output
    projection in one C entry call (``matmul_impl="fused"``, paged, C ==
    1): a GEMM over all slots, a split-KV read and merge, and a GEMM over
    all slots (``csrc/fused_decode_attention.cu``).

    Per slot: dequantize and apply the QKV weights to the token, rotate
    q/k at the slot's position (half-split rope), attend over the live
    cache rows ``[0, pos)`` plus the new token's own k/v with one plain
    softmax, and apply the dequantized output projection. The cache is
    not written: the returned ``(k_new, v_new)`` rows (k already roped)
    are written by the caller after the call.

    x: [S, E] f32 or bf16; pos: [S] int32; k_cache/v_cache:
    [S, L, KV, D] f32 or bf16; wqkv/wo with sqkv/so as in
    :func:`quant_matmul` (one ``bits`` for both); bqkv [3E-ish], bo [E].
    Returns ``(out [S, E] in x's dtype, k_new [S, KV, D], v_new
    [S, KV, D])``, the two rows in ``cache_dtype`` (f32 or bf16; a torch
    dtype or its name) when it is given, else in the cache's dtype, each
    rounded once from its f32 value (``cache_dtype``, l.1443).
    ``interpret`` follows the module's rule: ``True`` runs the plain
    version on any device."""
    _check(x.dim() == 2 and x.dtype in (torch.float32, torch.bfloat16),
           "fused_decode_attention: x must be f32/bf16 [S, E]")
    s_, e = x.shape
    _check(k_cache.dim() == 4 and k_cache.shape == v_cache.shape
           and k_cache.shape[0] == s_ and k_cache.shape[2] == kv_heads,
           "fused_decode_attention: caches must be [S, L, KV, D]")
    _check(k_cache.dtype in (torch.float32, torch.bfloat16)
           and v_cache.dtype == k_cache.dtype,
           "fused_decode_attention: caches must be f32 or bf16")
    l_, kv, d = k_cache.shape[1:]
    _check(heads % kv == 0 and heads * d == e and d % 2 == 0,
           "fused_decode_attention: heads*head_dim must equal E=%d with "
           "kv_heads dividing heads and an even head_dim", e)
    fq = e + 2 * kv * d
    _check_quant("fused_decode_attention", wqkv, sqkv, bits, group, e)
    _check_quant("fused_decode_attention", wo, so, bits, group, e)
    _check(wqkv.shape[0] == fq and wo.shape[0] == e
           and bqkv.shape == (fq,) and bo.shape == (e,),
           "fused_decode_attention: wqkv/bqkv must have %d rows and "
           "wo/bo %d", fq, e)
    _check(pos.shape == (s_,) and pos.dtype == torch.int32,
           "fused_decode_attention: pos must be int32 [S]")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    cdt = k_cache.dtype if cache_dtype is None else (
        getattr(torch, cache_dtype, None) if isinstance(cache_dtype, str)
        else cache_dtype)
    _check(cdt in (torch.float32, torch.bfloat16),
           "fused_decode_attention: cache_dtype must be float32 or "
           "bfloat16, got %r", cache_dtype)
    cos, sin = _rope_tables(pos, d // 2, rope, rope_base)
    bq = bqkv.to(torch.float32).contiguous()
    bo_ = bo.to(torch.float32).contiguous()
    if _plain(interpret, x, pos, k_cache, v_cache, wqkv, sqkv, wo, so):
        return fused_decode_attention_plain(
            x, pos, k_cache, v_cache, wqkv, sqkv, bq, wo, so, bo_, cos,
            sin, heads, bits, group, scale, cdt)
    g = heads // kv
    # the merge of a kv head's splits holds its G roped q rows, k_new and
    # 35 floats a row (csrc/fused_decode_attention.cu merge_smem)
    smem = 4 * ((g + 1) * d + 35 * g)
    _check(smem <= _SMEM_MAX,
           "fused_decode_attention: %d query heads a kv head of head_dim "
           "%d need %d bytes of shared memory, more than a block has",
           g, d, smem)
    _check(d in (8, 16, 32, 64, 128),
           "fused_decode_attention: the kernel reads a cache row in whole "
           "16-byte chunks: head_dim must be a power of two in [8, 128], "
           "got %d", d)
    _contig(("x", x), ("pos", pos), ("k_cache", k_cache),
            ("v_cache", v_cache), ("wqkv", wqkv), ("sqkv", sqkv),
            ("wo", wo), ("so", so))
    _aligned(16, ("k_cache", k_cache), ("v_cache", v_cache),
             ("wqkv", wqkv), ("wo", wo))
    dev = x.device
    out = torch.empty_like(x)
    kn = torch.empty((s_, kv, d), dtype=cdt, device=dev)
    vn = torch.empty_like(kn)
    sms = _sm_count(dev)
    ns = fused_decode_splits(l_, d, sms)
    ks1, ks3 = quant_matmul_splits(fq, e, sms), quant_matmul_splits(e, e, sms)
    # the workspaces: the projection [S, FQ] (f32), the attention output
    # [S, E] (x's dtype), the GEMMs' split partials, each key split's (m,
    # l, acc[D]) per query row, and the arrival counts of the phase 1 and
    # phase 3 tiles
    nmt = -(-s_ // _QMM_BM)
    tiles1, tiles3 = nmt * -(-fq // _QMM_BF), nmt * -(-e // _QMM_BF)
    qkv = torch.empty((s_, fq), dtype=torch.float32, device=dev)
    o = torch.empty_like(x)
    nparts = max(tiles1 * ks1 if ks1 > 1 else 0,
                 tiles3 * ks3 if ks3 > 1 else 0)
    part = torch.empty(nparts * _QMM_BM * _QMM_BF, dtype=torch.float32,
                       device=dev) if nparts else None
    att = torch.empty((s_, kv, ns, g, d + 2), dtype=torch.float32,
                      device=dev)
    count = _zeroed_counts(tiles1 + tiles3, dev)
    _cost(2 * s_ * fq * e + 4 * s_ * heads * l_ * d + 2 * s_ * e * e, x,
          pos, k_cache, v_cache, wqkv, sqkv, wo, so, out, kn, vn)
    _launch("fused_decode_attention", _ptr(x), _ptr(pos), _ptr(k_cache),
            _ptr(v_cache), _ptr(wqkv), _ptr(sqkv), _ptr(bq), _ptr(wo),
            _ptr(so), _ptr(bo_), _ptr(cos), _ptr(sin), _ptr(out),
            _ptr(kn), _ptr(vn), _ptr(qkv), _ptr(o), _ptr(part), _ptr(att),
            _ptr(count), s_, e, heads, kv, d, l_, bits, group or 0, ns, ks1,
            ks3, float(scale), _CODE[x.dtype],
            _CODE[k_cache.dtype], _CODE[cdt])
    return out, kn, vn


# -- flash_attention --------------------------------------------------------

def _flash_mask(tq, tk, causal, window, device):
    """[tq, tk] bool: key visible from query (the kernels' ``visible``)."""
    qp = torch.arange(tq, device=device)[:, None]
    kp = torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qp >= kp)
    if window:
        mask = mask & (qp - kp < window)
    return mask


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None, window=0):
    """Plain PyTorch version of :func:`flash_attention_fwd`: one masked
    softmax in f32 (``_reference_attention``, pallas_kernels.py l.333,
    with the window mask), with the kernels' -1e30 masking and 1e-30
    clamp, so a row that sees no key gives zeros."""
    b, tq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = _flash_mask(tq, k.shape[1], causal, window, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p / den, v.float())
    lse = (m + torch.log(den)).reshape(b * h, tq)
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False,
                              scale=None, window=0):
    """Plain PyTorch version of :func:`flash_attention_bwd`: the kernels'
    recompute formulas on whole matrices, in f32 — ``p = exp(s - lse)``,
    ``dcap = rowsum(dO * O)``, ``dV = p^T dO``, ``dS = p (dO V^T - dcap)
    scale``, ``dQ = dS K``, ``dK = dS^T Q`` (``_flash_bwd``, l.291)."""
    b, tq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = _flash_mask(tq, k.shape[1], causal, window, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(b, h, tq, 1)),
                    torch.zeros_like(s))
    dof = do.float()
    dcap = torch.einsum("bqhd,bqhd->bhq", dof, o.float())[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - dcap) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_flash(q, k, v, window, causal):
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
           and q.shape[0] == k.shape[0] and q.shape[2:] == k.shape[2:],
           "flash_attention: q [B, Tq, H, D] and k, v [B, Tk, H, D] "
           "needed, got %s %s %s", tuple(q.shape), tuple(k.shape),
           tuple(v.shape))
    _check(q.dtype in _FLASH_D and k.dtype == q.dtype and v.dtype == q.dtype,
           "flash_attention: q, k, v must share one dtype, f32 or bf16")
    if window < 0:
        # a negative window would mask every key and return zeros
        raise ValueError("flash_attention: window must be >= 0, got %d"
                         % window)
    if window and not causal:
        raise ValueError("flash_attention: window>0 requires causal")


def _flash_kernel_args(name, q, k, v, *tensors):
    """The shape and the q/k/v strides the C entries take. q, k and v may
    be views (e.g. into one packed qkv tensor) whose heads are D apart with
    each head's D values contiguous; the other tensors are contiguous. The
    bf16 kernels load rows in 16-byte pieces."""
    b, tq, h, d = q.shape
    _check(d in _FLASH_D[q.dtype],
           "%s: the kernel takes head_dim in %s for %s, got %d", name,
           _FLASH_D[q.dtype], q.dtype, d)
    _check(b * h <= 65535, "%s: at most 65535 (batch, head) pairs", name)
    strides = []
    for nm, t in (("q", q), ("k", k), ("v", v)):
        _check(t.stride(3) == 1 and t.stride(2) == d,
               "%s: %s's heads must be %d apart with contiguous values, "
               "got strides %s", name, nm, d, t.stride())
        strides += [t.stride(0), t.stride(1)]
    _contig(*tensors)
    if q.dtype == torch.bfloat16:
        _check(all(st % 8 == 0 for st in strides),
               "%s: bf16 q/k/v rows must start on 16-byte boundaries", name)
        _aligned(16, ("q", q), ("k", k), ("v", v), *tensors)
    return (b, h, tq, k.shape[1], d) + tuple(strides)


def flash_attention_fwd(q, k, v, *, causal=False, scale=None, window=0,
                        interpret=None):
    """Forward: ``(o [B, Tq, H, D] in q's dtype, lse [B*H, Tq] f32)``, the
    per-row logsumexp the backward recomputes the probabilities from.
    ``interpret=True`` runs the plain version on any device."""
    _check_flash(q, k, v, window, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _plain(interpret, q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal, scale, window)
    cfg = _flash_kernel_args("flash_attention_fwd", q, k, v)
    b, h, tq = cfg[:3]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    _cost(4 * b * h * tq * k.shape[1] * q.shape[3], q, k, v, o, lse)
    _launch("flash_attention_fwd", _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(lse), *cfg, float(scale), int(causal), int(window),
            _CODE[q.dtype])
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False, scale=None,
                        window=0, interpret=None):
    """Backward of :func:`flash_attention_fwd`: ``(dq, dk, dv)``, in q's,
    k's and v's dtypes. On the card, the dQ kernel (which also writes
    ``dcap = rowsum(dO * O)``) and then the dK/dV kernel;
    ``interpret=True`` runs the plain version on any device."""
    _check_flash(q, k, v, window, causal)
    _check(o.shape == q.shape and do.shape == q.shape
           and lse.shape == (q.shape[0] * q.shape[2], q.shape[1]),
           "flash_attention_bwd: o and do must be shaped like q, lse "
           "[B*H, Tq]")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _plain(interpret, q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         scale, window)
    do = do.to(q.dtype).contiguous()
    cfg = _flash_kernel_args("flash_attention_bwd", q, k, v, ("o", o),
                             ("do", do), ("lse", lse)) \
        + (float(scale), int(causal), int(window), _CODE[q.dtype])
    dcap = torch.empty_like(lse)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    _cost(14 * q.shape[0] * q.shape[2] * q.shape[1] * k.shape[1]
          * q.shape[3], q, k, v, o, do, lse, dq, dk, dv)
    _launch("flash_attention_dq", _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(do), _ptr(lse), _ptr(dcap), _ptr(dq), *cfg)
    _launch("flash_attention_dkv", _ptr(q), _ptr(k), _ptr(v), _ptr(do),
            _ptr(lse), _ptr(dcap), _ptr(dk), _ptr(dv), *cfg)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward the dQ and dK/dV kernels (the JAX
    package's ``_flash_core`` custom VJP, l.348)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, interpret):
        cfg = dict(causal=causal, scale=scale, window=window,
                   interpret=interpret)
        o, lse = flash_attention_fwd(q, k, v, **cfg)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = cfg
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=False, scale=None, block_q=None,
                    block_k=None, interpret=None, window=0):
    """Fused attention, differentiable. q: [B, Tq, H, D], k, v: [B, Tk,
    H, D] (f32 or bf16); returns [B, Tq, H, D] in q's dtype.

    Key ``j`` is visible from query ``i`` when ``j < Tk`` and, if
    ``causal``, ``i >= j`` and, if ``window`` > 0 (causal only),
    ``i - j < window``; the kernels skip whole tiles no row can see, so
    windowed attention costs T·window, not T². f32 math inside (the bf16
    kernels round the probabilities to bf16 for the products with V and
    K). q, k and v may be views whose heads are D apart with contiguous
    values (slices of a packed qkv projection): the kernels read them in
    place; gradients come back contiguous.

    ``block_q``, ``block_k`` and ``interpret`` follow the module's rule:
    the tile knobs are validated and change nothing here (the kernels'
    tiles are fixed); ``interpret=True`` runs the plain forward and
    backward on any device."""
    _check_tiles("flash_attention", block_q=block_q, block_k=block_k)
    return _FlashAttention.apply(q, k, v, bool(causal), scale, int(window),
                                 bool(interpret))


# -- striped_pair_attention ---------------------------------------------------

def _striped_mask(cq, ck, q_off, k_off, n, device):
    """[cq, ck] bool: local key b visible from local query a on a striped
    hop, ``a*n + q_off >= b*n + k_off`` (the kernels' ``visible``)."""
    a = torch.arange(cq, device=device)[:, None]
    b = torch.arange(ck, device=device)[None, :]
    return a * n + q_off >= b * n + k_off


def striped_pair_attention_plain(q, k, v, q_off, k_off, n_stride,
                                 scale=None):
    """Plain PyTorch version of :func:`striped_pair_attention_fwd`: dense
    f32 scores under the striped mask, ``o`` normalized over the visible
    keys and ``lse`` [BH, Cq, 1]; a row with no visible key gets o = 0 and
    lse = -1e30 (``_spair_fwd_kernel``, l.482-485)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = _striped_mask(q.shape[1], k.shape[1], q_off, k_off, n_stride,
                         q.device)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p / den.clamp_min(1e-30), v.float())
    lse = torch.where(den > 0, m + torch.log(den.clamp_min(1e-30)),
                      torch.full_like(den, -1e30))
    return o.to(q.dtype), lse


def striped_pair_attention_bwd_plain(q, k, v, o, lse, g_o, g_lse, q_off,
                                     k_off, n_stride, scale=None):
    """Plain PyTorch version of :func:`striped_pair_attention_bwd`: the
    kernels' recompute on whole matrices in f32, with the lse cotangent in
    the row term, ``dcap = rowsum(g_o * o) - g_lse`` (``_spair_bwd_impl``,
    l.598-606)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = _striped_mask(q.shape[1], k.shape[1], q_off, k_off, n_stride,
                         q.device)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    dof = g_o.float()
    dcap = (dof * o.float()).sum(dim=-1, keepdim=True) - g_lse.float()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - dcap) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_spair(q, k, v, q_off, k_off, n_stride):
    _check(q.dim() == 3 and k.dim() == 3 and k.shape == v.shape
           and q.shape[0] == k.shape[0] and q.shape[2] == k.shape[2],
           "striped_pair_attention: q [BH, Cq, D] and k, v [BH, Ck, D] "
           "needed, got %s %s %s", tuple(q.shape), tuple(k.shape),
           tuple(v.shape))
    _check(q.dtype in _FLASH_D and k.dtype == q.dtype and v.dtype == q.dtype,
           "striped_pair_attention: q, k, v must share one dtype, f32 or "
           "bf16")
    _check(n_stride >= 1 and 0 <= q_off < n_stride and 0 <= k_off < n_stride,
           "striped_pair_attention: ring positions q_off=%r, k_off=%r must "
           "lie in [0, n_stride=%r)", q_off, k_off, n_stride)


def _spair_kernel_args(name, q, k, *tensors):
    """The shape the C entries take; every tensor contiguous, the bf16
    ones on 16-byte boundaries (the kernels load rows in 16-byte
    pieces)."""
    bh, cq, d = q.shape
    _check(d in _FLASH_D[q.dtype],
           "%s: the kernel takes head_dim in %s for %s, got %d", name,
           _FLASH_D[q.dtype], q.dtype, d)
    _check(bh <= 65535, "%s: at most 65535 (batch, head) pairs", name)
    _contig(*tensors)
    if q.dtype == torch.bfloat16:
        _aligned(16, *tensors)
    return bh, cq, k.shape[1], d


def striped_pair_attention_fwd(q, k, v, q_off, k_off, *, n_stride,
                               scale=None, interpret=None):
    """Forward of one striped hop: ``(o [BH, Cq, D] in q's dtype, lse
    [BH, Cq, 1] f32)``; ``interpret=True`` runs the plain version on any
    device."""
    _check_spair(q, k, v, q_off, k_off, n_stride)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _plain(interpret, q, k, v):
        return striped_pair_attention_plain(q, k, v, q_off, k_off, n_stride,
                                            scale)
    cfg = _spair_kernel_args("striped_pair_fwd", q, k, ("q", q), ("k", k),
                             ("v", v))
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[1], 1), dtype=torch.float32,
                      device=q.device)
    _cost(4 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2], q, k, v,
          o, lse)
    _launch("striped_pair_fwd", _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(lse), *cfg, float(scale), int(n_stride), int(q_off),
            int(k_off), _CODE[q.dtype])
    return o, lse


def striped_pair_attention_bwd(q, k, v, o, lse, g_o, g_lse, q_off, k_off, *,
                               n_stride, scale=None, interpret=None):
    """Backward of :func:`striped_pair_attention_fwd` from the cotangents of
    both outputs: ``(dq, dk, dv)`` in q's, k's and v's dtypes. On the card,
    the dQ kernel (which also writes ``dcap = rowsum(g_o * o) - g_lse``)
    and then the dK/dV kernel; ``interpret=True`` runs the plain version on
    any device."""
    _check_spair(q, k, v, q_off, k_off, n_stride)
    _check(o.shape == q.shape and g_o.shape == q.shape
           and lse.shape == q.shape[:2] + (1,) and g_lse.shape == lse.shape,
           "striped_pair_attention_bwd: o and g_o must be shaped like q, "
           "lse and g_lse [BH, Cq, 1]")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _plain(interpret, q, k, v, o, lse, g_o, g_lse):
        return striped_pair_attention_bwd_plain(q, k, v, o, lse, g_o, g_lse,
                                                q_off, k_off, n_stride, scale)
    g_o = g_o.to(q.dtype).contiguous()
    g_lse = g_lse.to(torch.float32).contiguous()
    cfg = _spair_kernel_args(
        "striped_pair_bwd", q, k, ("q", q), ("k", k), ("v", v), ("o", o),
        ("g_o", g_o), ("lse", lse), ("g_lse", g_lse)) \
        + (float(scale), int(n_stride), int(q_off), int(k_off),
           _CODE[q.dtype])
    dcap = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _cost(14 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2], q, k, v,
          o, g_o, lse, dq, dk, dv)
    _launch("striped_pair_dq", _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(g_o), _ptr(lse), _ptr(g_lse), _ptr(dcap), _ptr(dq), *cfg)
    _launch("striped_pair_dkv", _ptr(q), _ptr(k), _ptr(v), _ptr(g_o),
            _ptr(lse), _ptr(dcap), _ptr(dk), _ptr(dv), *cfg)
    return dq, dk, dv


class _StripedPair(torch.autograd.Function):
    """Forward kernel; backward the dQ and dK/dV kernels from the
    cotangents of o and lse (the JAX package's ``_spair_core`` custom VJP,
    l.628-657)."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, n_stride, scale, interpret):
        o, lse = striped_pair_attention_fwd(q, k, v, q_off, k_off,
                                            n_stride=n_stride, scale=scale,
                                            interpret=interpret)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (q_off, k_off, n_stride, scale, interpret)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        q_off, k_off, n_stride, scale, interpret = ctx.cfg
        dq, dk, dv = striped_pair_attention_bwd(
            q, k, v, o, lse, g_o, g_lse, q_off, k_off, n_stride=n_stride,
            scale=scale, interpret=interpret)
        return dq, dk, dv, None, None, None, None, None


def striped_pair_attention(q, k, v, q_off, k_off, *, n_stride, scale=None,
                           block_q=128, block_k=128, interpret=None):
    """One striped ring hop, differentiable in both outputs.

    q: [BH, Cq, D], k, v: [BH, Ck, D] (f32 or bf16), local row ``a`` of q
    at global position ``a*n_stride + q_off`` and row ``b`` of k, v at
    ``b*n_stride + k_off``; ``q_off``/``k_off`` are host ints in
    ``[0, n_stride)`` (the ranks' positions on the ring). Key ``b`` is
    visible from query ``a`` when ``a*n + q_off >= b*n + k_off``. Returns
    ``(o [BH, Cq, D] in q's dtype, lse [BH, Cq, 1] f32)``: o normalized
    over the visible keys, lse the per-row logsumexp (-1e30 where no key
    is visible), to be merged with other hops by ``logaddexp``.

    ``block_q``, ``block_k`` and ``interpret`` follow the module's rule:
    the tile knobs are validated and change nothing here (the kernels'
    tiles are fixed); ``interpret=True`` runs the plain forward and
    backward on any device."""
    _check_tiles("striped_pair_attention", block_q=block_q, block_k=block_k)
    return _StripedPair.apply(q, k, v, int(q_off), int(k_off),
                              int(n_stride), scale, bool(interpret))


# -- fused_linear -------------------------------------------------------------

_ACT_CODE = {"linear": 0, "relu": 1, "sigmoid": 2, "tanh": 3}
_ACTS = {"linear": lambda y: y, "relu": torch.relu,
         "sigmoid": torch.sigmoid, "tanh": torch.tanh}
# the activation's derivative from its OUTPUT (pallas_kernels.py l.717), so
# the backward keeps no pre-activation; in f32 for the smooth ones
_ACT_GRADS = {
    "linear": lambda g, out: g,
    # g where out > 0, else 0: exact in any dtype
    "relu": lambda g, out: torch.ops.aten.threshold_backward(g, out, 0),
    "sigmoid": lambda g, out: g.float() * out.float() * (1 - out.float()),
    "tanh": lambda g, out: g.float() * (1 - out.float() * out.float())}


def fused_linear_plain(x, w, b=None, act="linear", scale=None):
    """Plain PyTorch version of :func:`fused_linear_fwd`: the f32 product,
    then the epilogue, then the cast to x's dtype."""
    acc = x.float() @ w.float().t()
    if scale is not None:
        acc = acc * scale.float()
    if b is not None:
        acc = acc + b.float()
    return _ACTS[act](acc).to(x.dtype)


def fused_linear_fwd(x, w, b=None, act="linear", scale=None, *,
                     interpret=None):
    """``act(scale * (x @ w^T) + b)`` in one kernel: x [M, K], w [N, K]
    (a FullyConnected weight as stored), b and scale [N] or None; f32
    accumulation, the result in x's dtype. ``scale`` is the folded
    BatchNorm scale of the conv path; the LM passes none.
    ``interpret=True`` runs the plain version on any device."""
    _check(act in _ACT_CODE, "fused_linear: unknown activation %r", act)
    _check(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[1],
           "fused_linear: x [M, K] and w [N, K] needed, got %s %s",
           tuple(x.shape), tuple(w.shape))
    _check(x.dtype in (torch.float32, torch.bfloat16) and w.dtype == x.dtype,
           "fused_linear: x and w must share one dtype, f32 or bf16")
    m, kdim = x.shape
    n = w.shape[0]
    for name, t in (("b", b), ("scale", scale)):
        _check(t is None or t.shape == (n,), "fused_linear: %s must be [%d]",
               name, n)
    if _plain(interpret, x, w, b, scale):
        return fused_linear_plain(x, w, b, act, scale)
    _contig(("x", x), ("w", w))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        bf = None if b is None else b.to(torch.float32).contiguous()
        sf = None if scale is None else scale.to(torch.float32).contiguous()
        _cost(2 * m * n * kdim, x, w, scale, b, out)
        _launch("fused_linear", _ptr(x), _ptr(w), _ptr(sf), _ptr(bf),
                _ptr(out), m, n, kdim, _ACT_CODE[act], _CODE[x.dtype])
    return out


class _FusedLinear(torch.autograd.Function):
    """Forward kernel; backward plain products (``_fused_linear_bwd``,
    l.799): the activation's derivative from the output, then dx, dW and
    db."""

    @staticmethod
    def forward(ctx, x, w, b, act, interpret):
        out = fused_linear_fwd(x, w, b, act, interpret=interpret)
        ctx.save_for_backward(x, w, out)
        ctx.act = act
        ctx.has_bias = b is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        dpre = _ACT_GRADS[ctx.act](g, out).to(x.dtype)
        dx = dpre @ w
        dw = dpre.t() @ x
        db = dpre.sum(dim=0) if ctx.has_bias else None
        return dx, dw, db, None, None


def fused_linear(x, w, b=None, act="linear", *, block_m=256, block_n=256,
                 block_k=512, interpret=None):
    """``act(x @ w^T + b)`` in one kernel, differentiable. x: [M, K], w:
    [N, K], b: [N] or None. ``gelu`` runs the linear kernel and then
    PyTorch's tanh-approximated gelu (its derivative needs the
    pre-activation), as the JAX package composes it (l.828).

    ``block_m``, ``block_n``, ``block_k`` and ``interpret`` follow the
    module's rule: the tile knobs are validated and change nothing here
    (the kernel's tiles are fixed); ``interpret=True`` runs the plain
    version on any device."""
    _check_tiles("fused_linear", block_m=block_m, block_n=block_n,
                 block_k=block_k)
    interpret = bool(interpret)
    if act == "gelu":
        return torch.nn.functional.gelu(
            _FusedLinear.apply(x, w, b, "linear", interpret),
            approximate="tanh")
    _check(act in _ACT_CODE, "fused_linear: unknown activation %r", act)
    return _FusedLinear.apply(x, w, b, act, interpret)


# -- fused_conv_bn_act --------------------------------------------------------

def _conv_out_hw(h, wd, kh, kw, stride, pad, dilate):
    """The conv's output height and width (the C entry checks the same)."""
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (wd + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    _check(oh > 0 and ow > 0, "fused_conv_bn_act: kernel exceeds the input")
    return oh, ow


def _conv_operands(x, w, stride, pad, dilate):
    """What the f32 implicit GEMM is handed: ``(xc, wm, geometry)``. ``xc``
    is x as a contiguous NHWC tensor ``[N, H, W, C]`` (a free view of a
    channels-last x, as the previous fused conv leaves it; one copy of an
    NCHW one), ``wm`` the weight permuted once to ``[O, kh*kw*C]``, its
    columns in the kernel's (ky, kx, c) order, and ``geometry`` the C
    entry's ``(N, H, W, C, OH, OW, O, kh, kw, sh, sw, ph, pw, dh, dw)``.
    The kernel reads patch row ``m = (n, oy, ox)``, column ``k = (ky, kx,
    c)`` as ``xc[n, oy*sh - ph + ky*dh, ox*sw - pw + kx*dw, c]``, zero
    outside the image."""
    nb, c, h, wd = x.shape
    nf, _, kh, kw = w.shape
    oh, ow = _conv_out_hw(h, wd, kh, kw, stride, pad, dilate)
    xc = x.permute(0, 2, 3, 1).contiguous()
    wm = w.permute(0, 2, 3, 1).reshape(nf, -1).contiguous()
    return xc, wm, (nb, h, wd, c, oh, ow, nf, kh, kw) + tuple(stride) \
        + tuple(pad) + tuple(dilate)


def _im2col(x, w, stride, pad, dilate):
    """The bf16 conv as the operands of one GEMM: ``(patches, wm, OH, OW)``,
    the patches a contiguous ``[N*OH*OW, C*kh*kw]`` matrix and ``wm`` the
    weight ``[O, C*kh*kw]`` with its columns in the same order
    (``conv_general_dilated_patches``, l.855-861). The patches are a
    strided view ``[N, OH, OW, ., ., .]`` of the (padded) input, gathered
    by one copy. Their column order follows x's memory format, so that
    the gather reads and writes runs of contiguous values: (kh, kw, c)
    for a channels-last x (as the previous fused conv leaves it; the
    weight is permuted to match, a small copy), else (c, kh, kw), the
    order of ``w.reshape(O, -1)``. A 1x1 stride-1 unpadded conv needs
    only the NHWC view of x (free when x is channels-last). The f32 path
    makes no patches (:func:`_conv_operands`)."""
    nb, c, h, wd = x.shape
    nf, _, kh, kw = w.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    oh, ow = _conv_out_hw(h, wd, kh, kw, stride, pad, dilate)
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        return x.permute(0, 2, 3, 1).reshape(-1, c), w.reshape(nf, c), oh, ow
    if ph or pw:
        x = torch.nn.functional.pad(x, (pw, pw, ph, ph))
    sn, sc, sy, sx = x.stride()
    rows = (nb, oh, ow), (sn, sy * sh, sx * sw)
    if x.is_contiguous(memory_format=torch.channels_last) \
            and not x.is_contiguous():
        cols = x.as_strided(rows[0] + (kh, kw, c),
                            rows[1] + (sy * dh, sx * dw, sc),
                            x.storage_offset())
        wm = w.permute(0, 2, 3, 1).reshape(nf, -1)
    else:
        cols = x.as_strided(rows[0] + (c, kh, kw),
                            rows[1] + (sc, sy * dh, sx * dw),
                            x.storage_offset())
        wm = w.reshape(nf, -1)
    return cols.contiguous().view(-1, c * kh * kw), wm, oh, ow


# channels and output channels the Winograd kernel takes a step and a block
# (csrc/fused_linear.cu wino::CK, wino::BO)
_WINO_CK, _WINO_BO = 8, 64


def conv_algo(dtype, c, kernel, stride, pad, dilate):
    """The path ``fused_conv_bn_act``'s C entry takes for a conv, by dtype
    and geometry alone (the entry applies the same rule):

    * f32, a 3x3 kernel, stride 1, dilation 1, ``c % 4 == 0``, any
      padding: ``"winograd"``, F(2x2, 3x3) with the weight transform
      written into a workspace the wrapper allocates
      (:func:`_winograd_workspace`);
    * f32, a 1x1 stride-1 unpadded conv: ``"pointwise"``, the GEMM over x
      as the ``[N*H*W, C]`` matrix it is;
    * every other f32 conv: ``"implicit"``, the implicit GEMM that
      gathers the patches in its tile loader;
    * bf16: ``"patches"``, the GEMM over patches made by one strided copy
      (:func:`_im2col`).

    No path gives way to another."""
    if dtype == torch.bfloat16:
        return "patches"
    if (tuple(kernel), tuple(stride), tuple(pad)) == ((1, 1), (1, 1), (0, 0)):
        return "pointwise"
    if (tuple(kernel), tuple(stride), tuple(dilate)) == ((3, 3), (1, 1),
                                                         (1, 1)) \
            and c % 4 == 0:
        return "winograd"
    return "implicit"


def _winograd_workspace(c, nf, device):
    """The Winograd path's workspace: the transformed weight U [16, Cp,
    Op], C rounded up to the kernel's channel step and O to its block
    (zero-padded by the kernel), f32."""
    cp = -(-c // _WINO_CK) * _WINO_CK
    op = -(-nf // _WINO_BO) * _WINO_BO
    return torch.empty(16 * cp * op, dtype=torch.float32, device=device)


def fused_conv_bn_act_plain(x, w, scale, bias, stride=(1, 1), pad=(0, 0),
                            dilate=(1, 1), act="relu"):
    """Plain PyTorch version of :func:`fused_conv_bn_act`: ``F.conv2d`` in
    f32, then the epilogue, then the cast to x's dtype."""
    acc = torch.nn.functional.conv2d(x.float(), w.float(), stride=stride,
                                     padding=pad, dilation=dilate)
    acc = acc * scale.float()[:, None, None] + bias.float()[:, None, None]
    return _ACTS[act](acc).to(x.dtype)


def fused_conv_bn_act(x, w, scale, bias, stride=(1, 1), pad=(0, 0),
                      dilate=(1, 1), act="relu", *, block_m=256,
                      block_n=256, block_k=512, interpret=None):
    """``act(scale_c * conv(x, w) + bias_c)`` in one GEMM kernel: the
    eval-time conv -> BatchNorm -> act chain with the moving statistics
    (and any conv bias) folded into ``scale``/``bias`` [O].

    x [N, C, H, W], w [O, C, kh, kw] (one group), f32 or bf16; returns
    [N, O, OH, OW] in x's dtype, as the NCHW view of the kernel's
    ``[N*OH*OW, O]`` output (channels-last in memory). In f32 (the eval
    forward's path) the kernel reads a channels-last x itself
    (:func:`_conv_operands`): a stride-1 3x3 conv with C % 4 == 0 is
    Winograd F(2x2, 3x3), its transformed weight written into a workspace
    allocated here (:func:`_winograd_workspace`), any other conv an
    implicit GEMM; in bf16 the patches are made outside it
    (:func:`_im2col`), as the JAX package makes them in XLA.
    :func:`conv_algo` names the path. Forward only: the JAX kernel has no
    gradient either.

    ``block_m``, ``block_n``, ``block_k`` and ``interpret`` follow the
    module's rule: the tile knobs are validated and change nothing here
    (the kernels' tiles are fixed); ``interpret=True`` runs the plain
    version on any device."""
    _check(act in _ACT_CODE, "fused_conv_bn_act: unknown activation %r", act)
    _check_tiles("fused_conv_bn_act", block_m=block_m, block_n=block_n,
                 block_k=block_k)
    _check(x.dim() == 4 and w.dim() == 4 and x.shape[1] == w.shape[1],
           "fused_conv_bn_act: x [N, C, H, W] and w [O, C, kh, kw] needed, "
           "got %s %s", tuple(x.shape), tuple(w.shape))
    _check(x.dtype in (torch.float32, torch.bfloat16) and w.dtype == x.dtype,
           "fused_conv_bn_act: x and w must share one dtype, f32 or bf16")
    nf = w.shape[0]
    _check(scale.shape == (nf,) and bias.shape == (nf,),
           "fused_conv_bn_act: scale and bias must be [%d]", nf)
    _check(not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, scale, bias))),
        "fused_conv_bn_act is an inference kernel: it has no gradient")
    stride, pad, dilate = (tuple(int(v) for v in a)
                           for a in (stride, pad, dilate))
    if _plain(interpret, x, w, scale, bias):
        return fused_conv_bn_act_plain(x, w, scale, bias, stride, pad,
                                       dilate, act)
    ws = None
    if x.dtype == torch.float32:
        xc, wm, geom = _conv_operands(x, w, stride, pad, dilate)
        oh, ow = geom[4:6]
        if conv_algo(x.dtype, x.shape[1], w.shape[2:], stride, pad,
                     dilate) == "winograd":
            ws = _winograd_workspace(x.shape[1], nf, x.device)
    else:
        xc, wm, oh, ow = _im2col(x, w, stride, pad, dilate)
        # the patches as the x of a 1x1 stride-1 conv over [1, 1, M, K]
        m, kdim = xc.shape
        geom = (1, 1, m, kdim, 1, m, nf, 1, 1, 1, 1, 0, 0, 1, 1)
        _contig(("patches", xc), ("w", wm))
    nb = x.shape[0]
    out = torch.empty((nb * oh * ow, nf), dtype=x.dtype, device=x.device)
    if out.numel():
        _cost(2 * out.numel() * wm.shape[1], xc, wm, scale, bias, out)
        _launch("fused_conv_bn_act", _ptr(xc), _ptr(wm),
                _ptr(scale.to(torch.float32).contiguous()),
                _ptr(bias.to(torch.float32).contiguous()), _ptr(out),
                _ptr(ws), 0 if ws is None else ws.numel(), *geom,
                _ACT_CODE[act], _CODE[x.dtype])
    return out.reshape(nb, oh, ow, nf).permute(0, 3, 1, 2)


# -- matmul_stats -------------------------------------------------------------

# rows of the kernel's M-tiles in both dtypes (csrc/gemm.cuh BM, FBM): one
# row of partial sums per tile
_MS_TILE = 128


def matmul_stats_plain(x, w):
    """Plain PyTorch version of :func:`matmul_stats_fwd`: the f32 product,
    its column sums and sums of squares, then the product cast to x's
    dtype."""
    acc = x.float() @ w.float().t()
    return acc.to(x.dtype), acc.sum(dim=0), acc.square().sum(dim=0)


def matmul_stats_fwd(x, w, *, interpret=None):
    """``(y, s1, s2)``: ``y = x @ w^T`` [M, N] in x's dtype, and the f32
    column sums ``s1 = sum_m y`` and ``s2 = sum_m y^2`` [N] of the f32
    product before it is rounded. x [M, K], w [N, K] (a 1x1 conv weight
    [O, C]), f32 or bf16. The kernel writes one row of partial sums per
    M-tile; they are summed here, as the JAX package sums them outside
    Pallas (l.937-938). ``interpret=True`` runs the plain version on any
    device."""
    _check(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[1],
           "matmul_stats: x [M, K] and w [N, K] needed, got %s %s",
           tuple(x.shape), tuple(w.shape))
    _check(x.dtype in (torch.float32, torch.bfloat16) and w.dtype == x.dtype,
           "matmul_stats: x and w must share one dtype, f32 or bf16")
    if _plain(interpret, x, w):
        return matmul_stats_plain(x, w)
    _contig(("x", x), ("w", w))
    m, kdim = x.shape
    n = w.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty((2, -(-m // _MS_TILE), n),
                       dtype=torch.float32, device=x.device)
    if m:
        _cost(2 * m * n * kdim, x, w, y, part)
        _launch("matmul_stats", _ptr(x), _ptr(w), _ptr(y), _ptr(part[0]),
                _ptr(part[1]), m, n, kdim, _CODE[x.dtype])
    s1, s2 = part.sum(dim=1)
    return y, s1, s2


class _MatmulStats(torch.autograd.Function):
    """Forward kernel; backward plain products (``_matmul_stats_bwd``,
    l.951-963): the statistics' cotangents fold into the output's as
    ``g = gy + gs1 + 2 y gs2`` (f32, then x's dtype), then ``dx = g w``
    and ``dw = g^T x``."""

    @staticmethod
    def forward(ctx, x, w, interpret):
        y, s1, s2 = matmul_stats_fwd(x, w, interpret=interpret)
        ctx.save_for_backward(x, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, w, y = ctx.saved_tensors
        g = (gy.float() + gs1.float()[None, :]
             + 2.0 * y.float() * gs2.float()[None, :]).to(x.dtype)
        return g @ w, g.t() @ x, None


def matmul_stats(x, w, *, block_m=256, block_n=256, block_k=512,
                 interpret=None):
    """``(x @ w^T, per-column sum, per-column sum of squares)`` in one
    kernel, differentiable. x [M, K], w [N, K]; the statistics are f32
    sums of the f32 product, for the training conv -> BatchNorm chain
    (``ops.fusion``), which then needs no second read of the
    activation.

    ``block_m``, ``block_n``, ``block_k`` and ``interpret`` follow the
    module's rule: the tile knobs are validated and change nothing here
    (the kernel's tiles are fixed); ``interpret=True`` runs the plain
    version on any device."""
    _check_tiles("matmul_stats", block_m=block_m, block_n=block_n,
                 block_k=block_k)
    return _MatmulStats.apply(x, w, bool(interpret))
