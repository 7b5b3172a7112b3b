"""The port's int8-weight decode step: ``quant_matmul`` on a pipelined
weight stream and ``fused_decode_attention`` as GEMMs over the slots
around a split-KV read.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions. Here, on the CPU, what they compute is
written out in numpy and torch from the sources' own rules and held
against the plain versions and the JAX package:

* the in-register conversions (``csrc/common.cuh`` ``i8x4_bf16``,
  ``csrc/qgemm.cuh`` ``i4x4_bf16``), emulated bit for bit over every byte value, equal the
  plain conversion exactly;
* the split rules (``quant_matmul_splits``, ``fused_decode_splits``) take
  no M, S or pos, cut whole stages and stay within the stage count, and
  the wrappers' launches carry the same splits whatever the batch;
* one stage of ``mma_tile`` emulated lane by lane (the swizzled shared
  tiles, each lane's fragment loads and the m16n8k16 products) equals the
  plain product of the stage;
* the split-K combine in split order gives a row the same bits in every
  subset of rows;
* the fused step in the kernel's phase order (a GEMM over the slots with
  split-K, the split-KV partials with q roped as loaded, the merge in split
  order with the new token last, the output GEMM) equals
  ``fused_decode_attention_plain`` and the JAX kernel (Pallas in interpret
  mode) within f32 tolerance (rtol, atol 1e-5: the sums run in other
  orders).
Inputs come from numpy seeds.
"""
import ctypes
import inspect
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.serving.quant import quantize_tensor

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132
BM, BF, KS = 32, 64, 128          # csrc/qgemm.cuh
LOG2E = 1.0 / math.log(2.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qweights(rng, f, e, bits, group):
    w = torch.from_numpy(rng.uniform(-0.05, 0.05, (f, e)).astype(np.float32))
    qt = quantize_tensor(w, bits=bits, group=group)
    return qt.q, qt.scale


# -- the in-register conversions --------------------------------------------

def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (s >> 4i) & 7 of the eight bytes of (y:x), x the low four."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        byte = (both >> np.uint64(8 * sel)) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def u32(vals):
    return np.asarray(vals, np.float32).view(np.uint32)


def bf16_val(bits):
    return f32(np.asarray(bits, np.uint32) << np.uint32(16)).astype(np.float64)


def bf16_sub(a_bits, b_bits):
    """bf16 a - b (bit patterns) for pairs whose difference is exact in
    bf16 (asserted): the result's bits."""
    d = bf16_val(a_bits) - bf16_val(b_bits)
    r = d.astype(np.float32)
    assert np.all(r.astype(np.float64) == d)
    rb = u32(r)
    assert np.all(rb & np.uint32(0xFFFF) == 0), "not a bf16"
    return rb >> np.uint32(16)


def hsub2(a, b):
    """__hsub2 on bf16 pairs held in uint32 words."""
    lo = bf16_sub(a & np.uint32(0xFFFF), b & np.uint32(0xFFFF))
    hi = bf16_sub(a >> np.uint32(16), b >> np.uint32(16))
    return lo | (hi << np.uint32(16))


def i8x4_bf16(w):
    """csrc/common.cuh i8x4_bf16 on uint32 words: the bf16 pairs (values 0,
    2) and (values 1, 3)."""
    w = np.asarray(w, np.uint32)
    magic = np.uint32(0x43004300)

    def pair(v):
        return hsub2((v & np.uint32(0x007F007F)) | magic,
                     (v & np.uint32(0x00800080)) | magic)
    return pair(w), pair(w >> np.uint32(8))


def i4x4_bf16(h):
    """csrc/qgemm.cuh i4x4_bf16 on 16-bit words: (lo, hi) bf16 pairs."""
    u = np.asarray(h, np.uint32) ^ np.uint32(0x8888)
    a = np.uint32(0x43004300) | (u & 0xF) | ((u & 0xF0) << np.uint32(12))
    b = np.uint32(0x43004300) | ((u >> np.uint32(8)) & 0xF) \
        | ((u & 0xF000) << np.uint32(4))
    k136 = np.uint32(0x43084308)          # bf16 136 twice
    return hsub2(a, k136), hsub2(b, k136)


def _bf16_bits(t):
    return t.to(torch.bfloat16).view(torch.int16).numpy().astype(
        np.uint32) & np.uint32(0xFFFF)


def test_int8_to_bf16_is_exact_for_every_byte():
    vals = np.arange(-128, 128, dtype=np.int32)
    bytes_ = vals.astype(np.int8).view(np.uint8).astype(np.uint32)
    # the four byte positions of a word, each value in each
    words = [bytes_ << np.uint32(8 * i) for i in range(4)]
    want = _bf16_bits(torch.from_numpy(vals.astype(np.float32)))
    for i, w in enumerate(words):
        ev, od = i8x4_bf16(w)
        got = (ev, od, ev >> np.uint32(16), od >> np.uint32(16))[i] \
            & np.uint32(0xFFFF)
        np.testing.assert_array_equal(got, want)
    # a word of four different values: (values 0, 2) and (values 1, 3)
    w = np.uint32(0x80FF017F)        # bytes 0x7f, 0x01, 0xff, 0x80
    ev, od = i8x4_bf16(w)
    four = _bf16_bits(torch.tensor([127.0, 1.0, -1.0, -128.0]))
    assert int(ev) == int(four[0] | four[2] << 16)
    assert int(od) == int(four[1] | four[3] << 16)


def test_int4_to_bf16_is_exact_for_every_byte():
    b = np.arange(256, dtype=np.uint32)
    plain = K.unpack4(torch.from_numpy(b.astype(np.uint8))[:, None])
    want_lo = _bf16_bits(plain[:, 0])     # the low nibble: the even value
    want_hi = _bf16_bits(plain[:, 1])
    for pos in range(2):                  # the byte's place in the word
        lo, hi = i4x4_bf16(b << np.uint32(8 * pos))
        word = (lo, hi)[pos]
        np.testing.assert_array_equal(word & np.uint32(0xFFFF), want_lo)
        np.testing.assert_array_equal(word >> np.uint32(16), want_hi)


# -- the split rules ----------------------------------------------------------

def test_split_rules_take_no_batch_and_no_pos():
    assert list(inspect.signature(K.quant_matmul_splits).parameters) \
        == ["f", "e", "sms"]
    assert list(inspect.signature(K.fused_decode_splits).parameters) \
        == ["l_", "d", "sms"]
    assert [K.fused_decode_splits(1024, d, H100_SMS) for d in (64, 128)] \
        == [2, 4]
    # the 124M LM's products on an H100
    assert [K.quant_matmul_splits(f, e, H100_SMS) for f, e in (
        (2304, 768), (768, 768), (3072, 768), (768, 3072),
        (32000, 768))] == [3, 6, 3, 8, 1]


@pytest.mark.parametrize("e", [32, 96, 128, 768, 1000, 3072, 8192])
@pytest.mark.parametrize("sms", [4, 132])
def test_quant_matmul_splits_cut_whole_stages(e, sms):
    nst = -(-e // KS)
    for f in (1, 37, 64, 768, 2304, 32000):
        n = K.quant_matmul_splits(f, e, sms)
        per = -(-nst // n)               # stages a range (qgemm gemm_items)
        assert 1 <= n <= nst
        assert (n - 1) * per < nst <= n * per    # no range is empty


@pytest.mark.parametrize("d", [8, 16, 64, 128])
def test_fused_decode_splits_bounds(d):
    """Ranges of at least 32768 // d keys (the last may be shorter), at
    most one per 4 SMs and 32, at least one; never more than the decode
    entry's."""
    for sms in (4, 132):
        for l_ in (1, 64, 300, 1000, 1024, 4096, 65536):
            n = K.fused_decode_splits(l_, d, sms)
            assert 1 <= n <= max(1, min(32, sms // 4))
            assert n == 1 or -(-l_ // n) * (n - 1) < l_
            assert n == 1 or -(-l_ // n) >= (32768 // d) * (n - 1) / n
            assert n <= K.paged_decode_splits(l_, d, sms)


def _recorded(monkeypatch, fn, *args, **kw):
    """The arguments of the one launch ``fn`` makes, recorded instead."""
    calls = []
    monkeypatch.setattr(K, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(K, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(K, "_aligned", lambda *a: None)
    monkeypatch.setattr(K, "_launch",
                        lambda entry, *a: calls.append((entry, a)))
    fn(*args, **kw)
    (entry, a), = calls
    return entry, a


@pytest.mark.parametrize("f,e", [(2304, 768), (768, 3072), (32000, 768)])
def test_quant_matmul_launch_splits_take_no_batch(monkeypatch, f, e):
    rng = np.random.RandomState(0)
    q, s = _qweights(rng, f, e, 8, None)
    splits = set()
    for m in (1, 7, 32, 256):
        x = torch.zeros(m, e, dtype=torch.bfloat16)
        entry, a = _recorded(monkeypatch, K.quant_matmul, x, q, s)
        assert entry == "quant_matmul"
        # x, q, s, out, part, count, M, E, F, bits, group, ksplit, ...
        assert a[6:9] == (m, e, f)
        splits.add(a[11])
    assert splits == {K.quant_matmul_splits(f, e, H100_SMS)}


@pytest.mark.parametrize("h,kv", [(12, 12), (12, 4)])
def test_fused_launch_splits_take_no_slots_and_no_pos(monkeypatch, h, kv):
    d, l_, e = 64, 1024, 12 * 64
    rng = np.random.RandomState(1)
    wq, sq = _qweights(rng, e + 2 * kv * d, e, 8, None)
    wo, so = _qweights(rng, e, e, 8, None)
    seen = set()
    for s_, pos in ((1, [0]), (5, [0, 1, 500, 1022, 1023]),
                    (32, list(range(0, 1024, 32)))):
        args = (torch.zeros(s_, e, dtype=torch.bfloat16),
                torch.tensor(pos, dtype=torch.int32),
                torch.zeros(s_, l_, kv, d, dtype=torch.bfloat16),
                torch.zeros(s_, l_, kv, d, dtype=torch.bfloat16), wq, sq,
                torch.zeros(e + 2 * kv * d), wo, so, torch.zeros(e))
        entry, a = _recorded(monkeypatch, K.fused_decode_attention, *args,
                             heads=h, kv_heads=kv)
        assert entry == "fused_decode_attention"
        assert a[20:26] == (s_, e, h, kv, d, l_)
        seen.add(a[28:31])                 # key, QKV and output splits
    assert seen == {(K.fused_decode_splits(l_, d, H100_SMS),
                     K.quant_matmul_splits(e + 2 * kv * d, e, H100_SMS),
                     K.quant_matmul_splits(e, e, H100_SMS))}


# -- one stage of mma_tile, lane by lane ------------------------------------

def xsw(r):
    return ((r & 1) << 2) | (r & 2)


def wsw(n, bits):
    return 2 * (n & 3) if bits == 8 else (n >> 1) & 3


def stage_smem(x_bits, w_bytes, bits):
    """A stage's shared tiles as load_stage stores them: x_bits [32, 128]
    bf16 bit patterns (uint16), w_bytes [64, 128 * bits / 8] uint8; 16-byte
    chunks XOR-swizzled. Returns (A tile bytes, weight tile bytes)."""
    xb = x_bits.astype("<u2").view(np.uint8).reshape(BM, 2 * KS)
    xs = np.zeros((BM, 2 * KS), np.uint8)
    for r in range(BM):
        for c in range(16):
            p = c ^ xsw(r)
            xs[r, 16 * p:16 * p + 16] = xb[r, 16 * c:16 * c + 16]
    rb = KS * bits // 8
    ws = np.zeros((BF, rb), np.uint8)
    for n in range(BF):
        for c in range(rb // 16):
            p = c ^ wsw(n, bits)
            ws[n, 16 * p:16 * p + 16] = w_bytes[n, 16 * c:16 * c + 16]
    return xs, ws


def word(row, off, nbytes):
    return int.from_bytes(bytes(row[off:off + nbytes]), "little")


def bf16_pair(w):
    """A 32-bit register of two bf16 values -> (low value, high value)."""
    return (f32(np.uint32((w & 0xFFFF) << 16)).item(),
            f32(np.uint32(w & 0xFFFF0000)).item())


def mma_stage_emulated(xs, ws, bits, scale=None, group=None, k0=0):
    """mma_stage of csrc/qgemm.cuh, each lane's loads as the kernel makes
    them, each m16n8k16 product formed from the fragments of all 32 lanes
    (A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; B[2t..][g],
    B[2t+8..][g]), its C fragments added as the kernel adds them, then the
    four warps' sums in warp order. Returns [32, 64] float64."""
    warps = []
    for w in range(4):
        acc = np.zeros((BM, BF))
        afr = {}      # (lane, mt, j) -> 4 registers
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for mt in range(2):
                for h in range(2):
                    r = 16 * mt + g + 8 * h
                    if bits == 8:
                        v = [np.uint32(word(xs[r], 16 * ((4 * w + t)
                                                         ^ xsw(r)) + 4 * i,
                                            4)) for i in range(4)]
                        regs = {(0, h): byte_perm(v[0], v[1], 0x5410),
                                (0, 2 + h): byte_perm(v[0], v[1], 0x7632),
                                (1, h): byte_perm(v[2], v[3], 0x5410),
                                (1, 2 + h): byte_perm(v[2], v[3], 0x7632)}
                        regs = {k_: int(v_) for k_, v_ in regs.items()}
                    else:
                        regs = {}
                        for j in range(2):
                            off = 16 * ((4 * w + 2 * j + (t >> 1))
                                        ^ xsw(r)) + 8 * (t & 1)
                            regs[(j, h)] = word(xs[r], off, 4)
                            regs[(j, 2 + h)] = word(xs[r], off + 4, 4)
                    for (j, i), val in regs.items():
                        afr.setdefault((lane, mt, j), [0] * 4)[i] = val
        for nt in range(8):
            for j in range(2):
                bfr = {}
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    n = 8 * nt + g
                    if bits == 8:
                        u = word(ws[n], 16 * ((2 * w + (t >> 1))
                                              ^ wsw(n, 8)) + 8 * (t & 1), 8)
                        lo, hi = i8x4_bf16(np.uint32((u >> (32 * j))
                                                     & 0xFFFFFFFF))
                    else:
                        hw = word(ws[n], 16 * (w ^ wsw(n, 4)) + 8 * j + 2 * t,
                                  2)
                        lo, hi = i4x4_bf16(np.uint32(hw))
                    bfr[lane] = (int(lo), int(hi))
                bmat = np.zeros((16, 8))
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    b0, b1 = bfr[lane]
                    bmat[2 * t:2 * t + 2, g] = bf16_pair(b0)
                    bmat[2 * t + 8:2 * t + 10, g] = bf16_pair(b1)
                for mt in range(2):
                    amat = np.zeros((16, 16))
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        a = afr[(lane, mt, j)]
                        amat[g, 2 * t:2 * t + 2] = bf16_pair(a[0])
                        amat[g + 8, 2 * t:2 * t + 2] = bf16_pair(a[1])
                        amat[g, 2 * t + 8:2 * t + 10] = bf16_pair(a[2])
                        amat[g + 8, 2 * t + 8:2 * t + 10] = bf16_pair(a[3])
                    c = amat @ bmat                        # [16, 8]
                    rows = slice(16 * mt, 16 * mt + 16)
                    cols = slice(8 * nt, 8 * nt + 8)
                    if bits == 8:
                        acc[rows, cols] += c
                    else:
                        gi = (k0 + 32 * w + 16 * j) // group
                        acc[rows, cols] += c * scale[8 * nt:8 * nt + 8, gi]
        warps.append(acc)
    return ((warps[0] + warps[1]) + warps[2]) + warps[3]


@pytest.mark.parametrize("bits,group", [(8, None), (4, 16), (4, 32),
                                        (4, 128)],
                         ids=["int8", "int4-g16", "int4-g32", "int4-g128"])
def test_mma_stage_lanes_form_the_stage_product(bits, group):
    """Every lane's A and weight loads from the swizzled tiles, fed to the
    m16n8k16 fragments, give x @ dequant(w)^T over the stage (the int8
    scale applied later, by the epilogue)."""
    rng = np.random.RandomState(bits + (group or 0))
    x = torch.from_numpy(rng.randn(BM, KS).astype(np.float32)) \
        .to(torch.bfloat16)
    q, s = _qweights(rng, BF, KS, bits, group)
    xs, ws = stage_smem(x.view(torch.int16).numpy().view(np.uint16),
                        q.view(torch.uint8).numpy(), bits)
    got = mma_stage_emulated(xs, ws, bits,
                             s.numpy().astype(np.float64) if bits == 4
                             else None, group)
    w = q.double() if bits == 8 else K.unpack4(q).double() \
        * torch.repeat_interleave(s.double(), group, dim=-1)
    want = x.double().numpy() @ w.numpy().T
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# -- the split-K combine ----------------------------------------------------

def split_k(x, w, sms=H100_SMS):
    """out = x @ w^T with the contraction cut by quant_matmul_splits into
    whole stages, each range's partial summed on its own and the ranges
    added in split order (finish_tile). Each output's sums are elementwise
    over its own row: no other row enters them."""
    f, e = w.shape
    n = K.quant_matmul_splits(f, e, sms)
    nst = -(-e // KS)
    per = -(-nst // n)
    out = None
    for z in range(n):
        lo, hi = z * per * KS, min(e, (z + 1) * per * KS)
        part = (x[:, None, lo:hi] * w[None, :, lo:hi]).sum(dim=-1)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("f,e", [(96, 768), (64, 3072), (200, 256)])
def test_split_k_combine_is_row_subset_invariant(f, e):
    rng = np.random.RandomState(f + e)
    x = torch.from_numpy(rng.randn(40, e).astype(np.float32))
    w = torch.from_numpy(rng.randn(f, e).astype(np.float32))
    full = split_k(x, w)
    for rows in ([0], [3, 17, 39], list(range(7)), list(range(32))):
        assert torch.equal(split_k(x[rows], w), full[rows])
    assert torch.allclose(full, x @ w.t(), rtol=1e-4, atol=1e-3)


# -- the fused step in the kernel's phase order ------------------------------

def fused_phases(x, pos, kc, vc, wq, sq, bq, wo, so, bo, cos, sin, heads,
                 bits, group, scale, sms=H100_SMS):
    """fused_decode_attention as its kernel orders it, in torch f32:
    1. qkv = split_k(x, dequant(wqkv)) (int8: x scale) + bqkv, over all
       slots;
    2. per (slot, kv head, key split) the split's base-2 state (m, l, acc)
       over the cache keys [0, pos) of the split's range, q roped as
       loaded, an empty split (m = -inf, l = 0);
    3. per query row, the splits merged in split order, the new token (its
       score q . k_new from the roped q and k, its v) last; o cast to x's
       dtype;
    4. out = split_k(o, dequant(wo)) (int8: x scale) + bo in x's dtype.
    Returns (out, k_new, v_new)."""
    s_, e = x.shape
    l_, kv, d = kc.shape[1:]
    g, half = heads // kv, d // 2
    ns = K.fused_decode_splits(l_, d, sms)
    fq = wq.shape[0]
    qkv = split_k(x.float(), K._dequant_w(wq, sq, bits, group), sms)
    if bits == 8:
        qkv = qkv * sq
    qkv = qkv + bq

    def rope(hv, si):
        t1, t2 = hv[..., :half], hv[..., half:]
        c, s = cos[si], sin[si]
        return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1)

    c2 = scale * LOG2E
    width = -(-l_ // ns)
    o = torch.zeros(s_, e)
    kn = torch.zeros(s_, kv, d)
    vn = torch.zeros(s_, kv, d)
    inf = float("inf")
    for si in range(s_):
        p = max(int(pos[si]), 0)
        row = qkv[si]
        for kh in range(kv):
            qr = rope(row[kh * g * d:(kh + 1) * g * d].reshape(g, d), si)
            kr = rope(row[e + kh * d:e + (kh + 1) * d], si)
            vr = row[e + (kv + kh) * d:e + (kv + kh + 1) * d]
            kn[si, kh], vn[si, kh] = kr, vr
            parts = []
            for sp in range(ns):
                k0, k1 = sp * width, min(sp * width + width, min(l_, p))
                if k0 >= k1:
                    parts.append((torch.full((g,), -inf), torch.zeros(g),
                                  torch.zeros(g, d)))
                    continue
                sc = (qr * c2) @ kc[si, k0:k1, kh].float().t()
                m = sc.amax(dim=1)
                pr = torch.exp2(sc - m[:, None])
                parts.append((m, pr.sum(dim=1),
                              pr @ vc[si, k0:k1, kh].float()))
            snew = (qr @ kr) * c2
            mx = snew.clone()
            for m, l, _ in parts:
                mx = torch.where(l > 0, torch.maximum(mx, m), mx)
            num, den = torch.zeros(g, d), torch.zeros(g)
            for m, l, acc in parts:
                wt = torch.where(l > 0, torch.exp2(m - mx), torch.zeros(g))
                den = den + wt * l
                num = num + wt[:, None] * torch.where(
                    l[:, None] > 0, acc, torch.zeros_like(acc))
            wn = torch.exp2(snew - mx)
            num = num + wn[:, None] * vr
            den = den + wn
            o[si, kh * g * d:(kh + 1) * g * d] = (num / den[:, None]) \
                .reshape(-1)
    o = o.to(x.dtype).float()
    out = split_k(o, K._dequant_w(wo, so, bits, group), sms)
    if bits == 8:
        out = out * so
    out = out + bo
    return out.to(x.dtype), kn.to(kc.dtype), vn.to(kc.dtype)


def _fused_inputs(seed, s_, h, kv, d, l_, bits, group, pos):
    rng = np.random.RandomState(seed)
    e = h * d
    fq = e + 2 * kv * d
    wq, sq = _qweights(rng, fq, e, bits, group)
    wo, so = _qweights(rng, e, e, bits, group)
    bq = _t(rng.uniform(-0.1, 0.1, (fq,)).astype(np.float32))
    bo = _t(rng.uniform(-0.1, 0.1, (e,)).astype(np.float32))
    x = _t(rng.randn(s_, e).astype(np.float32))
    kc = _t(rng.randn(s_, l_, kv, d).astype(np.float32))
    vc = _t(rng.randn(s_, l_, kv, d).astype(np.float32))
    return (x, torch.tensor(pos, dtype=torch.int32), kc, vc, wq, sq, bq, wo,
            so, bo)


FUSED_CASES = [  # (heads, kv heads, head_dim, L, bits, group, rope, pos)
    (4, 4, 16, 300, 8, None, True, [0, 1, 99, 100, 299]),
    (4, 2, 16, 300, 8, None, False, [0, 150, 299]),
    (4, 4, 32, 64, 4, 16, True, [0, 5, 63]),
    (6, 2, 16, 200, 4, 2, True, [0, 120, 199]),
    (2, 1, 64, 128, 4, 32, False, [127, 0]),
]


@pytest.mark.parametrize("case", range(len(FUSED_CASES)))
def test_phase_order_matches_plain_and_jax(case):
    h, kv, d, l_, bits, group, rope, pos = FUSED_CASES[case]
    args = _fused_inputs(case, len(pos), h, kv, d, l_, bits, group, pos)
    scale = 1.0 / math.sqrt(d)
    cos, sin = K._rope_tables(args[1], d // 2, rope, 10000.0)
    got = fused_phases(*args, cos, sin, h, bits, group, scale)
    plain = K.fused_decode_attention_plain(*args, cos, sin, h, bits, group,
                                           scale)
    kw = dict(heads=h, kv_heads=kv, bits=bits, group=group, rope=rope)
    jx = pk.fused_decode_attention(*(jnp.asarray(a.numpy()) for a in args),
                                   **kw)
    for part, g_, p_, j_ in zip(("out", "k_new", "v_new"), got, plain, jx):
        np.testing.assert_allclose(g_.numpy(), p_.numpy(), err_msg=part,
                                   **TOL)
        np.testing.assert_allclose(g_.numpy(), np.asarray(j_), err_msg=part,
                                   **TOL)


def test_phase_order_is_slot_subset_invariant():
    """A slot's output from the phase order is the same bits alone, among
    5 slots and among all: every sum's order is one of S-independent
    rules."""
    h, kv, d, l_ = 4, 2, 16, 300
    pos = [0, 7, 100, 250, 299, 42, 199]
    args = _fused_inputs(9, len(pos), h, kv, d, l_, 8, None, pos)
    cos, sin = K._rope_tables(args[1], d // 2, True, 10000.0)
    full = fused_phases(*args, cos, sin, h, 8, None, 0.25)
    for rows in ([3], [0, 2, 4, 5, 6]):
        sub = [a[rows] if i < 4 else a for i, a in enumerate(args)]
        got = fused_phases(*sub, cos[rows], sin[rows], h, 8, None, 0.25)
        for g_, f_ in zip(got, full):
            assert torch.equal(g_, f_[rows])


def test_dead_slot_gets_its_own_value_row():
    """A slot at pos 0 reads no cache row: every split is empty and adds
    exact zeros, so its attention output is v_new itself (rows of the
    cache past pos, here NaN, are never read)."""
    h, kv, d, l_ = 2, 2, 16, 64
    args = list(_fused_inputs(4, 2, h, kv, d, l_, 8, None, [0, 0]))
    args[2] = torch.full_like(args[2], float("nan"))
    args[3] = torch.full_like(args[3], float("nan"))
    cos, sin = K._rope_tables(args[1], d // 2, False, 10000.0)
    out, kn, vn = fused_phases(*args, cos, sin, h, 8, None, 0.25)
    assert torch.isfinite(out).all()
    plain = K.fused_decode_attention_plain(
        args[0], args[1], torch.zeros_like(args[2]),
        torch.zeros_like(args[3]), *args[4:], cos, sin, h, 8, None, 0.25)
    np.testing.assert_allclose(out.numpy(), plain[0].numpy(), **TOL)


def test_fused_wrapper_counts_and_workspaces(monkeypatch):
    """The host side of the launch: one count buffer of the phase 1 and
    phase 3 tiles, all 0 (the kernels leave it so)."""
    h, kv, d, l_, s_ = 12, 4, 64, 1024, 3
    e = h * d
    rng = np.random.RandomState(2)
    wq, sq = _qweights(rng, e + 2 * kv * d, e, 8, None)
    wo, so = _qweights(rng, e, e, 8, None)
    args = (torch.zeros(s_, e, dtype=torch.bfloat16),
            torch.tensor([0, 1, 2], dtype=torch.int32),
            torch.zeros(s_, l_, kv, d, dtype=torch.bfloat16),
            torch.zeros(s_, l_, kv, d, dtype=torch.bfloat16), wq, sq,
            torch.zeros(e + 2 * kv * d), wo, so, torch.zeros(e))
    K._COUNTS.clear()
    entry, a = _recorded(monkeypatch, K.fused_decode_attention, *args,
                         heads=h, kv_heads=kv)
    count = K._COUNTS[(torch.device("cpu"), 0)]
    tiles1 = -(-s_ // BM) * -(-(e + 2 * kv * d) // BF)
    tiles3 = -(-s_ // BM) * -(-e // BF)
    assert count.numel() >= tiles1 + tiles3
    assert not count.any()
    assert a[19] == count.data_ptr()
    # the arguments end with the scale and the two dtype codes (the
    # stream is _launch's)
    assert len(a) == len(K._ARGTYPES["fused_decode_attention"]) - 1
    assert a[31] == 0.125


def test_counts_buffer_per_stream(monkeypatch):
    """Two streams may run at once, so each gets its own arrival counts;
    launches on one stream share one buffer, grown when a launch needs
    more."""
    dev = torch.device("cpu")
    stream = [7]
    monkeypatch.setattr(K, "_current_stream", lambda device: stream[0])
    K._COUNTS.clear()
    a = K._zeroed_counts(100, dev)
    assert K._zeroed_counts(50, dev) is a
    stream[0] = 9
    b = K._zeroed_counts(100, dev)
    assert b.data_ptr() != a.data_ptr()
    assert set(K._COUNTS) == {(dev, 7), (dev, 9)}
    big = K._zeroed_counts(a.numel() + 1, dev)
    assert big.numel() > a.numel() and not big.any()
    stream[0] = 7
    assert K._zeroed_counts(100, dev) is a


@pytest.mark.parametrize("entry,source", [
    ("quant_matmul", "quant_matmul.cu"),
    ("fused_decode_attention", "fused_decode_attention.cu")])
def test_entry_argument_types_match_its_signature(entry, source):
    """``_ARGTYPES[entry]`` is ``mx_<entry>``'s C signature."""
    path = os.path.join(os.path.dirname(K.__file__), "csrc", source)
    with open(path) as f:
        src = f.read()
    sig = src[src.index("mx_%s(" % entry):]
    params = [p.split() for p in sig[sig.index("(") + 1:sig.index(")")]
              .replace("const ", "").split(",")]
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if t.endswith("*") else ctype[t]
            for t, _ in params]
    assert K._ARGTYPES[entry] == want
