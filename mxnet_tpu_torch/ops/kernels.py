"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version.

Counterpart of the serving half of ``mxnet_tpu/ops/pallas_kernels.py``:

* :func:`paged_attention` (Pallas ``paged_attention`` l.1115): slot-paged
  attention over each slot's live KV rows ``[0, pos+C)``, causal in the
  chunk, GQA-native, online softmax in f32, optional int8 KV.
* :func:`quant_matmul` (l.1259): ``x @ dequant(q)^T`` for int8
  (per-output-channel scales) and nibble-packed int4 (per-group scales)
  weights, f32 accumulation.
* :func:`fused_decode_attention` (l.1389): one decode step's QKV
  projection -> rope -> attention over the live cache plus the new token
  -> output projection in one launch.

The kernels live in ``csrc/*.cu`` (CUDA C++ for ``sm_90a``). Each source
is compiled by ``nvcc`` into its own shared library with a plain C
interface under ``build/kernels/`` at first use — all sources in
parallel, keyed by a hash of the source — and loaded with ``ctypes``.

Dispatch: a tensor on the CPU goes to the plain version in this module
(the tests run those); a CUDA tensor launches the kernel or raises —
there is no fallback. Each launch adds one to :func:`launch_counts`
(the analogue of the JAX package's ``dispatch_count``); the plain
versions are not counted.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time

import torch

from ..base import MXNetError

__all__ = ["paged_attention", "default_paged_block_k", "quant_matmul",
           "fused_decode_attention", "paged_attention_plain",
           "quant_matmul_plain", "fused_decode_attention_plain",
           "build", "launch_counts", "reset_launch_counts", "KERNELS"]

KERNELS = ("paged_attention", "quant_matmul", "fused_decode_attention")

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kernels")
_HEADERS = ("common.cuh",)

_LAUNCHES = dict.fromkeys(KERNELS, 0)
_LIBS = {}

# dtype codes of the C interfaces (csrc/common.cuh)
_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def launch_counts():
    """Kernel launches per kernel since :func:`reset_launch_counts`."""
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
        log = open(out[:-3] + ".log", "w")
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
            with open(_lib_path(name)[:-3] + ".log") as f:
                msgs.append("%s:\n%s" % (name, f.read()[-4000:]))
        raise MXNetError("nvcc failed for %s\n%s"
                         % (", ".join(failed), "\n".join(msgs)))
    return secs


def _lib(name):
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(_lib_path(name))
        fn = getattr(lib, "mx_" + name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _LIBS[name] = lib
    return getattr(lib, "mx_" + name)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q, k, v, k_scale, v_scale, pos, out, S, C, H, KV, L, D, scale,
    # q_dtype, kv_dtype, stream
    "paged_attention": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    # x, q, scale, out, part, M, E, F, bits, group, ksplit, x_dtype,
    # out_dtype, stream
    "quant_matmul": [_P] * 5 + [_I] * 8 + [_P],
    # x, pos, k_cache, v_cache, wqkv, sqkv, bqkv, wo, so, bo, cos, sin,
    # out, k_new, v_new, part, count, S, E, H, KV, D, L, bits, group,
    # smem_bytes, scale, x_dtype, cache_dtype, stream
    "fused_decode_attention": [_P] * 17 + [_I] * 9 + [_F, _I, _I, _P],
}


def _launch(name, *args):
    """Call kernel ``name``'s C entry on the current stream and count the
    launch; a launch the runtime refused raises here (it never ran)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = _lib(name)(*args, stream)
    if err != 0:
        raise MXNetError("%s: CUDA launch failed with error %d"
                         % (name, err))
    _LAUNCHES[name] += 1


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
    (``default_paged_block_k``, l.1012). The CUDA kernel does not take
    it: it walks live keys in tiles of 32 rows and stops at each query
    tile's last live key."""
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


def paged_attention(q, k, v, pos, *, k_scale=None, v_scale=None,
                    scale=None):
    """Slot-paged attention reading only the live KV rows.

    q: [S, C, H, D] — each slot's C-token query chunk. k, v:
    [S, L, Hkv, D] cache buffers, float, or int8 with ``k_scale``/
    ``v_scale`` [S, L, Hkv] f32 row scales (dequantized as the rows are
    loaded). pos: [S] int32, the chunk's start per slot; rows
    ``[pos, pos+C)`` must already be written, and chunk row ``c`` attends
    keys ``[0, pos+c]``. Returns [S, C, H, D] in q's dtype, accumulated
    in f32. Rows past a slot's last live key are never read."""
    s_, c, h, d = q.shape
    _check(k.dim() == 4 and k.shape == v.shape and k.shape[0] == s_
           and k.shape[3] == d, "paged_attention: k/v must be [S, L, Hkv, "
           "D] matching q [S, C, H, D]")
    l_, kv = k.shape[1], k.shape[2]
    _check(kv >= 1 and h % kv == 0,
           "paged_attention: %d kv heads must divide %d heads", kv, h)
    _check(pos.shape == (s_,) and pos.dtype == torch.int32,
           "paged_attention: pos must be int32 [S]")
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
    if not _on_cuda(q, k, v, pos, k_scale, v_scale):
        return paged_attention_plain(q, k, v, pos, k_scale, v_scale,
                                     scale)
    _check(d <= 128, "paged_attention: the kernel takes head_dim <= 128, "
           "got %d", d)
    _contig(("q", q), ("k", k), ("v", v), ("pos", pos),
            ("k_scale", k_scale), ("v_scale", v_scale))
    out = torch.empty_like(q)
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


def quant_matmul(x, q, scale, *, bits=8, group=None, out_dtype=None):
    """``x [M, E] @ dequant(q) [F, E]^T -> [M, F]``.

    ``q``: int8 ``[F, E]`` (``bits=8``, ``scale`` f32 ``[F]``, applied to
    the product) or nibble-packed uint8 ``[F, E//2]`` (``bits=4``,
    ``scale`` f32 ``[F, E//group]``, applied to the weight before the
    dot). x in f32 or bf16; the result is accumulated in f32 and returned
    in ``out_dtype`` (default x's)."""
    _check(x.dim() == 2, "quant_matmul: x must be [M, E], got %s",
           tuple(x.shape))
    _check(x.dtype in (torch.float32, torch.bfloat16),
           "quant_matmul: x must be f32 or bf16, got %s", x.dtype)
    m, e = x.shape
    _check_quant("quant_matmul", q, scale, bits, group, e)
    out_dtype = out_dtype or x.dtype
    _check(out_dtype in (torch.float32, torch.bfloat16),
           "quant_matmul: out_dtype must be f32 or bf16")
    if not _on_cuda(x, q, scale):
        return quant_matmul_plain(x, q, scale, bits, group, out_dtype)
    _contig(("x", x), ("q", q), ("scale", scale))
    _aligned(16, ("q", q))
    f = q.shape[0]
    out = torch.empty((m, f), dtype=out_dtype, device=x.device)
    if m:
        ksplit = _quant_matmul_splits(f, e, x.device)
        part = torch.empty((ksplit, m, f), dtype=torch.float32,
                           device=x.device)
        _launch("quant_matmul", _ptr(x), _ptr(q), _ptr(scale), _ptr(out),
                _ptr(part), m, e, f, bits, group or 0, ksplit,
                _CODE[x.dtype], _CODE[out_dtype])
    return out


_QMM_BF, _QMM_BK = 64, 32   # csrc/quant_matmul.cu BF, BK


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _quant_matmul_splits(f, e, device):
    """How many ranges the kernel splits the contraction into: enough for
    two blocks per SM over the weight's 64-channel tiles, whatever M is
    (so a row's sums never depend on its batch), in whole 32-wide
    steps."""
    n_f = -(-f // _QMM_BF)
    n_k = -(-e // _QMM_BK)
    want = min(n_k, max(1, -(-2 * _sm_count(device) // n_f)))
    steps = -(-n_k // want)
    return -(-n_k // steps)


# -- fused_decode_attention -------------------------------------------------

_FD_WARPS = 8            # csrc/fused_decode_attention.cu THREADS / 32
_SMEM_MAX = 232448       # bytes of shared memory a block may use (H100)


def _rope_tables(pos, half, rope, rope_base):
    """Per-slot cos/sin [S, half] f32 at angle ``pos * base**(-i/half)``;
    the identity rotation (cos=1, sin=0) when rope is off."""
    if not rope:
        return _identity_rotation(pos.shape[0], half, pos.device)
    from .attention import rope_freqs
    ang = pos.to(torch.float32)[:, None] \
        * rope_freqs(half, rope_base, pos.device)[None, :]
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=64)
def _identity_rotation(s_, half, device):
    ones = torch.ones((s_, half), dtype=torch.float32, device=device)
    return ones, torch.zeros_like(ones)


def fused_decode_attention_plain(x, pos, k_cache, v_cache, wqkv, sqkv,
                                 bqkv, wo, so, bo, cos, sin, heads, bits,
                                 group, scale):
    """Plain PyTorch version of :func:`fused_decode_attention` (with the
    rope tables already built)."""
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
    return (out.to(x.dtype), kh.to(k_cache.dtype), vh.to(k_cache.dtype))


def fused_decode_attention(x, pos, k_cache, v_cache, wqkv, sqkv, bqkv,
                           wo, so, bo, *, heads, kv_heads, bits=8,
                           group=None, rope=True, rope_base=10000.0,
                           scale=None):
    """One decode step's QKV projection -> rope -> attention -> output
    projection in one launch (``matmul_impl="fused"``, paged, C == 1).

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
    [S, KV, D] in the cache's dtype)``."""
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
    cos, sin = _rope_tables(pos, d // 2, rope, rope_base)
    bq = bqkv.to(torch.float32).contiguous()
    bo_ = bo.to(torch.float32).contiguous()
    if not _on_cuda(x, pos, k_cache, v_cache, wqkv, sqkv, wo, so):
        return fused_decode_attention_plain(
            x, pos, k_cache, v_cache, wqkv, sqkv, bq, wo, so, bo_, cos,
            sin, heads, bits, group, scale)
    g = heads // kv
    smem = 4 * (e + (2 * g + 2 + _FD_WARPS) * d + g * (l_ + 1))
    _check(smem <= _SMEM_MAX,
           "fused_decode_attention: E=%d and L=%d need %d bytes of shared "
           "memory, more than a block has", e, l_, smem)
    _check(d in (8, 16, 32, 64, 128),
           "fused_decode_attention: the kernel reads a cache row in whole "
           "16-byte chunks: head_dim must be a power of two in [8, 128], "
           "got %d", d)
    _contig(("x", x), ("pos", pos), ("k_cache", k_cache),
            ("v_cache", v_cache), ("wqkv", wqkv), ("sqkv", sqkv),
            ("wo", wo), ("so", so))
    _aligned(16, ("k_cache", k_cache), ("v_cache", v_cache),
             ("wqkv", wqkv), ("wo", wo))
    out = torch.empty_like(x)
    kn = torch.empty((s_, kv, d), dtype=k_cache.dtype, device=x.device)
    vn = torch.empty_like(kn)
    # per (slot, kv head) partial output rows, and per slot the count of
    # its blocks that have finished (zeroed by the C entry)
    part = torch.empty((s_, kv, e), dtype=torch.float32, device=x.device)
    count = torch.empty((s_,), dtype=torch.int32, device=x.device)
    _launch("fused_decode_attention", _ptr(x), _ptr(pos), _ptr(k_cache),
            _ptr(v_cache), _ptr(wqkv), _ptr(sqkv), _ptr(bq), _ptr(wo),
            _ptr(so), _ptr(bo_), _ptr(cos), _ptr(sin), _ptr(out),
            _ptr(kn), _ptr(vn), _ptr(part), _ptr(count), s_, e, heads, kv,
            d, l_, bits, group or 0, smem, float(scale), _CODE[x.dtype],
            _CODE[k_cache.dtype])
    return out, kn, vn
