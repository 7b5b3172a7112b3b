"""The int8-KV prefill chunk on the tensor-core paged forward, and the
port's kernel and engine signatures that follow the JAX package's.

``paged_attention_chunk`` takes a bf16 q over an int8 cache
(``csrc/attention.cuh`` ``fwd_mma_i8<D>``). Its arithmetic is written
out here in PyTorch, tile by tile as the kernel walks it: each int8 tile turned into bf16 integers (exact), the f32
products of q with them, the score columns times the key row scales, the
online softmax in base 2 with the row sum over the unscaled probabilities,
and the probabilities times the value row scales rounded to bf16 for P.V.
That is held against the JAX ``paged_attention`` (the Pallas kernel under
the interpreter, which dequantizes each block and takes f32 products) on
inputs made with numpy from a seed. Tolerance: the one bf16 rounding of
each probability (2^-9 relative) moves an output by at most 2^-9 of the
largest dequantized value it averages, and the two sum in other orders:
``|mirror - jax| <= 2^-8 * max|vs * v|``.

Then the ``Mask::Paged`` tile walk (``visible``, ``key_end``,
``key_range``, ``full_tile``) written out in Python against the mask of
``_paged_attn_kernel`` (``kpos <= p + r % C``); the in-order int8 -> bf16
conversion of a 16-byte chunk over every byte value; the chunk entry's
argument types against its C signature; and the semantics of the JAX
parameters the port now takes: ``cache_dtype``, ``allow_fusion``,
``interpret``, the tile knobs, and the engine parameters a later slice
implements.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.parallel import decode as tdecode
from mxnet_tpu_torch.parallel.graph import make_graph_fn
from mxnet_tpu_torch.serving import engine as tengine
from mxnet_tpu_torch import symbol as sym

TILE = 64                     # attention.cuh BK and the paged QT
LOG2E = 1.4426950408889634


def _t(a):
    return torch.from_numpy(np.array(a))


def _int8_inputs(seed, s_, c, h, kv, d, l_, pos):
    """q rounded to bf16 (as f32 numpy), an int8 cache and its f32 row
    scales."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(s_, c, h, d).astype(np.float32)) \
        .to(torch.bfloat16).float().numpy()
    k = rng.randint(-127, 128, (s_, l_, kv, d)).astype(np.int8)
    v = rng.randint(-127, 128, (s_, l_, kv, d)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (s_, l_, kv)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (s_, l_, kv)).astype(np.float32)
    return q, k, v, ks, vs, np.asarray(pos, np.int32)


# -- the kernel's arithmetic, written out -------------------------------------

def int8_chunk_mirror(q, k, v, ks, vs, pos, scale):
    """``fwd_mma_i8<D>`` (``fwd_tile<D, Mask::Paged, 64, int8_t>``) in
    PyTorch: per (slot, query head, 64-row query tile) the walk over the
    64-key tiles up to the tile's last row's key; returns f32 [S, C, H, D]
    before the final rounding to bf16."""
    qf, kf, vf = (torch.as_tensor(x).float() for x in (q, k, v))
    ksf, vsf = torch.as_tensor(ks), torch.as_tensor(vs)
    s_, c, h, d = qf.shape
    l_, kv = kf.shape[1], kf.shape[2]
    g = h // kv
    cb = scale * LOG2E
    out = torch.zeros((s_, c, h, d))
    for s in range(s_):
        p0 = max(int(pos[s]), 0)
        for hh in range(h):
            hk = hh // g
            for qi in range(-(-c // TILE)):
                rows = torch.arange(qi * TILE, min((qi + 1) * TILE, c))
                kend = min(l_, p0 + int(rows[-1]) + 1)
                m = torch.full((len(rows),), -float("inf"))
                lsum = torch.zeros(len(rows))
                acc = torch.zeros((len(rows), d))
                for j in range(-(-kend // TILE)):
                    keys = torch.arange(j * TILE, (j + 1) * TILE)
                    live = keys < kend
                    kk = keys.clamp(max=l_ - 1)
                    # rows past kend zero-filled, never read
                    kt = torch.where(live[:, None], kf[s, kk, hk], 0.0)
                    vt = torch.where(live[:, None], vf[s, kk, hk], 0.0)
                    ksc = torch.where(live, ksf[s, kk, hk], 0.0)
                    vsc = torch.where(live, vsf[s, kk, hk], 0.0)
                    # the bf16 tiles are the cache's integers, exactly
                    assert torch.equal(kt.to(torch.bfloat16).float(), kt)
                    sv = (qf[s, rows, hh] @ kt.t()) * ksc[None, :]
                    vis = (keys[None, :] <= p0 + rows[:, None]) \
                        & (keys[None, :] < l_)
                    sv = torch.where(vis, sv, -float("inf"))
                    mx = torch.maximum(m, sv.max(dim=1).values)
                    mr = torch.where(mx == -float("inf"), 0.0, mx * cb)
                    corr = torch.where(m == -float("inf"), 0.0,
                                       torch.exp2((m - mx) * cb))
                    m = mx
                    p = torch.exp2(sv * cb - mr[:, None])
                    lsum = lsum * corr + p.sum(dim=1)
                    pv = (p * vsc[None, :]).to(torch.bfloat16).float()
                    acc = acc * corr[:, None] + pv @ vt
                out[s, rows, hh] = acc / lsum.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("c", [16, 64, 100, 256])
def test_int8_chunk_arithmetic_matches_jax(c, d):
    """Three slots at pos 0, the middle and L - C; GQA 12 -> 4."""
    h, kv, l_ = 12, 4, 384
    pos = [0, (l_ - c) // 2, l_ - c]
    q, k, v, ks, vs, pos = _int8_inputs(c + d, 3, c, h, kv, d, l_, pos)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(pk.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), scale=scale,
        interpret=True))
    got = int8_chunk_mirror(q, k, v, ks, vs, pos, scale).numpy()
    atol = 2.0 ** -8 * float(np.abs(vs[..., None] * v).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the port's plain version (f32 throughout) within the same bound
    plain = K.paged_attention_plain(_t(q), _t(k), _t(v), _t(pos), _t(ks),
                                    _t(vs), scale)
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=atol)


def test_int8_chunk_ignores_nan_scales_past_the_live_keys():
    """Scales past each slot's last live key are zero-filled, never read:
    NaN there changes no output of the mirror, as none of the JAX
    kernel's (its mask drops them)."""
    c, h, kv, d, l_ = 100, 12, 4, 64, 384
    q, k, v, ks, vs, pos = _int8_inputs(7, 2, c, h, kv, d, l_, [0, 200])
    clean = int8_chunk_mirror(q, k, v, ks, vs, pos, 0.125)
    for i, p in enumerate(pos):
        ks[i, p + c:] = np.nan
        vs[i, p + c:] = np.nan
    got = int8_chunk_mirror(q, k, v, ks, vs, pos, 0.125)
    assert torch.equal(got, clean)


# -- Mask::Paged, written out --------------------------------------------------

def visible(p0, l_, qp, kp):
    """``visible<Mask::Paged>`` (Tq = C rows, Tk = L keys)."""
    return (kp < l_) & (kp <= p0 + qp)


def key_end(c, l_, p0, qi, bq=TILE):
    clast = min((qi + 1) * bq, c) - 1
    return min(l_, p0 + clast + 1)


def key_range(c, l_, p0, qi, bq=TILE, bk=TILE):
    return 0, -(-key_end(c, l_, p0, qi, bq) // bk)


def full_tile(p0, q0, k0, kend, bk=TILE):
    if k0 + bk > kend:
        return False
    return k0 + bk - 1 <= p0 + q0


def jax_paged_mask(c, l_, p):
    """``_paged_attn_kernel``'s mask over [C, L] for one query head of a
    kv head's group: row r = g*C + c sits at ``p + r % C``."""
    r = np.arange(c)[:, None]
    kpos = np.arange(l_)[None, :]
    return kpos <= p + r % c


@pytest.mark.parametrize("c", [16, 64, 100, 128, 256])
@pytest.mark.parametrize("where", ["start", "middle", "end"])
def test_paged_tile_walk_covers_the_jax_mask(c, where):
    l_ = 1000
    p0 = {"start": 0, "middle": 437, "end": l_ - c}[where]
    mask = jax_paged_mask(c, l_, p0)
    qp = np.arange(c)[:, None]
    kp = np.arange(l_)[None, :]
    assert np.array_equal(visible(p0, l_, qp, kp), mask)
    walked = np.zeros_like(mask)
    for qi in range(-(-c // TILE)):
        rows = slice(qi * TILE, min((qi + 1) * TILE, c))
        lo, hi = key_range(c, l_, p0, qi)
        kend = key_end(c, l_, p0, qi)
        # keys at and past kend are seen by no row of the tile
        assert not mask[rows, kend:].any()
        walked[rows, lo * TILE:min(hi * TILE, l_)] = True
        for j in range(lo, hi):
            if full_tile(p0, qi * TILE, j * TILE, kend):
                assert mask[rows, j * TILE:(j + 1) * TILE].all(), (qi, j)
    # every visible key lies in a walked tile
    assert not (mask & ~walked).any()


# -- the int8 tile's conversion --------------------------------------------------

def _bf16_sub(a, b):
    """__hsub2 on bf16 bit patterns whose difference is exact."""
    fa = torch.from_numpy(a.astype(np.int32) << 16).view(torch.float32)
    fb = torch.from_numpy(b.astype(np.int32) << 16).view(torch.float32)
    out = (fa - fb).to(torch.bfloat16).view(torch.int16).numpy()
    return out.astype(np.uint32) & 0xFFFF


def _i8x4_bf16(w):
    """common.cuh i8x4_bf16: (values 0, 2), (values 1, 3) as bf16 pairs."""
    def pair(x):
        ve = (x & 0x007F007F) | 0x43004300
        se = (x & 0x00800080) | 0x43004300
        lo = _bf16_sub(ve & 0xFFFF, se & 0xFFFF)
        hi = _bf16_sub(ve >> 16, se >> 16)
        return lo | (hi << 16)
    return pair(w), pair(w >> 8)


def _byte_perm(a, b, sel):
    """__byte_perm for selectors whose nibbles are < 8."""
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def test_int8_tile_conversion_is_exact_and_in_order():
    """tile_i8_to_bf16 on one 16-byte chunk: each word's i8x4_bf16 pairs
    put back in order by byte permutes 0x5410 and 0x7632 give the chunk's
    16 values as bf16, for every byte value in every position."""
    vals = np.arange(-128, 128, dtype=np.int8)
    rng = np.random.RandomState(0)
    chunks = np.stack([np.roll(vals, i)[:16] for i in range(0, 256, 4)]
                      + [rng.randint(-128, 128, 16).astype(np.int8)
                         for _ in range(64)])
    words = chunks.view(np.uint32).astype(np.uint32)        # [n, 4]
    ev, od = _i8x4_bf16(words)
    lo, hi = _byte_perm(ev, od, 0x5410), _byte_perm(ev, od, 0x7632)
    got = np.stack([lo, hi], axis=-1).reshape(len(chunks), 8)
    halves = np.stack([got & 0xFFFF, got >> 16], axis=-1).reshape(
        len(chunks), 16).astype(np.int32)
    want = torch.from_numpy(chunks).to(torch.bfloat16).view(torch.int16) \
        .numpy().astype(np.int32) & 0xFFFF
    assert np.array_equal(halves, want)


def test_chunk_entry_argument_types_match_its_signature():
    path = os.path.join(os.path.dirname(K.__file__), "csrc",
                        "paged_attention.cu")
    with open(path) as f:
        src = f.read()
    sig = src[src.index("mx_paged_attention_chunk("):]
    params = [p.split() for p in sig[sig.index("(") + 1:sig.index(")")]
              .replace("const ", "").split(",")]
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if t.endswith("*") else ctype[t]
            for t, _ in params]
    assert K._ARGTYPES["paged_attention_chunk"] == want


def test_int8_chunk_on_the_cpu_runs_plain(monkeypatch):
    """The route sends the int8 chunk to the chunk entry; on the CPU the
    wrapper runs the plain version and never loads the kernels. The
    chunk entry wants the row scales with an int8 cache."""
    def refuse(entry):
        raise AssertionError("a CPU call reached the kernels (%s)" % entry)
    monkeypatch.setattr(K, "_lib", refuse)
    q, k, v, ks, vs, pos = _int8_inputs(3, 2, 16, 4, 2, 16, 48, [0, 32])
    q = _t(q).to(torch.bfloat16)
    assert K.paged_entry(q.dtype, torch.int8, 16, 16) \
        == "paged_attention_chunk"
    K.reset_launch_counts()
    got = K.paged_attention(q, _t(k), _t(v), _t(pos), k_scale=_t(ks),
                            v_scale=_t(vs))
    assert torch.equal(got, K.paged_attention_plain(
        q, _t(k), _t(v), _t(pos), _t(ks), _t(vs)))
    assert not any(K.launch_counts().values())
    with pytest.raises(MXNetError, match="row scales"):
        K._paged_chunk(q, _t(k), _t(v), _t(pos), 0.25)


# -- the JAX parameters the port takes -------------------------------------------

def _fused_args(rng, s_, h, kv, d, l_, cache_dtype):
    from mxnet_tpu.serving.quant import quantize_tensor as jax_quantize
    e = h * d
    fq = e + 2 * kv * d

    def qw(f):
        w = rng.uniform(-0.5, 0.5, (f, e)).astype(np.float32)
        qt = jax_quantize(jnp.asarray(w), bits=8, group=None)
        return np.asarray(qt.q), np.asarray(qt.scale)
    wq, sq = qw(fq)
    wo, so = qw(e)
    bq = rng.uniform(-0.1, 0.1, (fq,)).astype(np.float32)
    bo = rng.uniform(-0.1, 0.1, (e,)).astype(np.float32)
    x = rng.randn(s_, e).astype(np.float32)
    pos = np.array([0, 5, l_ - 1], np.int32)
    kc = rng.randn(s_, l_, kv, d).astype(np.float32)
    vc = rng.randn(s_, l_, kv, d).astype(np.float32)
    if cache_dtype == "bfloat16":
        kc = torch.from_numpy(kc).to(torch.bfloat16).float().numpy()
        vc = torch.from_numpy(vc).to(torch.bfloat16).float().numpy()
    return (x, pos, kc, vc, wq, sq, bq, wo, so, bo)


@pytest.mark.parametrize("cache,new", [("float32", "bfloat16"),
                                       ("bfloat16", "float32"),
                                       ("float32", None)])
def test_fused_decode_cache_dtype_matches_jax(cache, new):
    """k_new and v_new come back in cache_dtype (else the cache's), each
    rounded once from its f32 value, as the JAX kernel casts them."""
    args = _fused_args(np.random.RandomState(1), 3, 4, 2, 8, 16, cache)
    kw = dict(heads=4, kv_heads=2, bits=8, rope=True)
    jargs = list(map(jnp.asarray, args))
    targs = list(map(_t, args))
    jdt = getattr(jnp, cache)
    tdt = getattr(torch, cache)
    jargs[2], jargs[3] = jargs[2].astype(jdt), jargs[3].astype(jdt)
    targs[2], targs[3] = targs[2].to(tdt), targs[3].to(tdt)
    want = pk.fused_decode_attention(
        *jargs, cache_dtype=None if new is None else getattr(jnp, new),
        interpret=True, **kw)
    got = K.fused_decode_attention(*targs, cache_dtype=new, **kw)
    want_dt = getattr(torch, new or cache)
    for part, gt, wt in zip(("out", "k_new", "v_new"), got, want):
        if part != "out":
            assert gt.dtype == want_dt, part
        tol = 1e-5 if gt.dtype == torch.float32 else 2.0 ** -8
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(wt.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=part)
    torch_named = K.fused_decode_attention(
        *targs, cache_dtype=getattr(torch, new or cache), **kw)
    assert all(torch.equal(a, b) for a, b in zip(torch_named, got))
    with pytest.raises(MXNetError, match="cache_dtype"):
        K.fused_decode_attention(*targs, cache_dtype="int8", **kw)


def _fc_relu_symbol():
    data = sym.Variable("data")
    fc = sym.FullyConnected(data=data, num_hidden=6, name="fc")
    return sym.Activation(data=fc, act_type="relu", name="relu")


@pytest.mark.parametrize("allow,env,fused", [(True, None, True),
                                             (False, None, False),
                                             (False, "1", True)])
def test_make_graph_fn_allow_fusion(monkeypatch, allow, env, fused):
    """``allow_fusion=False`` runs no chain fused unless
    ``MXNET_PALLAS_FUSION=1``; the outputs are the same either way."""
    if env is None:
        monkeypatch.delenv("MXNET_PALLAS_FUSION", raising=False)
    else:
        monkeypatch.setenv("MXNET_PALLAS_FUSION", env)
    calls = []
    real = K.fused_linear

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(K, "fused_linear", counting)
    rng = np.random.RandomState(2)
    args = [_t(rng.randn(3, 5).astype(np.float32)),
            _t(rng.randn(6, 5).astype(np.float32)),
            _t(rng.randn(6).astype(np.float32))]
    outs, _ = make_graph_fn(_fc_relu_symbol(), allow)(args, [], False,
                                                      None)
    assert bool(calls) == fused
    want = torch.relu(args[0] @ args[1].t() + args[2])
    torch.testing.assert_close(outs[0], want, rtol=1e-6, atol=1e-6)


def _knob_calls():
    """(name, call with no knob, call with knobs set): each wrapper."""
    rng = np.random.RandomState(3)

    def r(*s):
        return _t(rng.randn(*s).astype(np.float32))
    q, k, v = r(2, 20, 2, 8), r(2, 20, 2, 8), r(2, 20, 2, 8)
    x, w, b = r(9, 12), r(7, 12), r(7)
    cx, cw, cs_, cb = r(2, 3, 6, 6), r(4, 3, 3, 3), r(4), r(4)
    pq, pk_, pv = r(2, 4, 4, 8), r(2, 32, 2, 8), r(2, 32, 2, 8)
    pos = torch.tensor([0, 20], dtype=torch.int32)
    qw = torch.randint(-127, 128, (16, 12), dtype=torch.int8)
    sw = torch.rand(16) * 0.01
    sq, sk, sv = r(4, 10, 8), r(4, 10, 8), r(4, 10, 8)
    return [
        ("flash_attention",
         lambda **kw: K.flash_attention(q, k, v, causal=True, **kw),
         dict(block_q=16, block_k=32)),
        ("striped_pair_attention",
         lambda **kw: K.striped_pair_attention(sq, sk, sv, 1, 0, n_stride=2,
                                               **kw),
         dict(block_q=8, block_k=64)),
        ("fused_linear", lambda **kw: K.fused_linear(x, w, b, "relu", **kw),
         dict(block_m=8, block_n=128, block_k=16)),
        ("fused_conv_bn_act",
         lambda **kw: K.fused_conv_bn_act(cx, cw, cs_, cb, (1, 1), (1, 1),
                                          (1, 1), "relu", **kw),
         dict(block_m=32, block_n=8, block_k=64)),
        ("matmul_stats", lambda **kw: K.matmul_stats(x, w, **kw),
         dict(block_m=8, block_n=8, block_k=8)),
        ("paged_attention",
         lambda **kw: K.paged_attention(pq, pk_, pv, pos, **kw),
         dict(block_k=8)),
        ("quant_matmul", lambda **kw: K.quant_matmul(x, qw, sw, **kw),
         dict(block_f=8)),
    ]


@pytest.mark.parametrize("case", range(7), ids=[
    "flash", "striped", "fused_linear", "conv", "matmul_stats", "paged",
    "quant_matmul"])
def test_tile_knobs_and_interpret_change_no_output(case):
    """A tile knob changes no output; ``interpret=True`` is the plain
    version, the same bits as a CPU call; a knob that is not a positive
    size raises as the JAX wrapper's would."""
    name, call, knobs = _knob_calls()[case]
    base = call()
    for got in (call(**knobs), call(interpret=True),
                call(interpret=False, **knobs)):
        got = got if isinstance(got, tuple) else (got,)
        want = base if isinstance(base, tuple) else (base,)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    bad = dict.fromkeys(knobs, 0)
    with pytest.raises(ValueError):
        call(**bad)


def test_tile_knobs_that_do_not_divide_raise():
    """As in the JAX wrappers: paged_attention's block_k must divide L,
    quant_matmul's min(block_f, F) must divide F."""
    q, kc = torch.randn(1, 2, 2, 8), torch.randn(1, 32, 2, 8)
    pos = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="block_k=12 must divide"):
        K.paged_attention(q, kc, kc, pos, block_k=12)
    x = torch.randn(2, 12)
    qw = torch.randint(-127, 128, (24, 12), dtype=torch.int8)
    sw = torch.rand(24)
    with pytest.raises(ValueError, match="block_f=16 must divide"):
        K.quant_matmul(x, qw, sw, block_f=16)
    # block_f past F is clamped to F, as in JAX
    assert torch.equal(K.quant_matmul(x, qw, sw, block_f=64),
                       K.quant_matmul(x, qw, sw))


def test_interpret_runs_the_plain_version_on_any_device():
    """``interpret=True`` takes the plain version whatever the device (a
    meta tensor here, where no kernel exists); without it the same call
    raises, since only CPU and CUDA tensors have a path."""
    x = torch.empty(9, 12, device="meta")
    w = torch.empty(7, 12, device="meta")
    y = K.fused_linear(x, w, None, "relu", interpret=True)
    assert y.device.type == "meta" and y.shape == (9, 7)
    y, s1, s2 = K.matmul_stats(x, w, interpret=True)
    assert y.shape == (9, 7) and s1.shape == (7,)
    q = torch.empty(1, 20, 2, 8, device="meta")
    assert K.flash_attention(q, q, q, causal=True,
                             interpret=True).shape == q.shape
    with pytest.raises(MXNetError, match="no kernel for device"):
        K.fused_linear(x, w, None, "relu")


VOCAB, T = 23, 16


@pytest.fixture(scope="module")
def decoder():
    symbol = get_transformer_lm(VOCAB, num_layers=1, embed_dim=16,
                                num_heads=2)
    shapes = {"data": (2, T), "softmax_label": (2, T)}
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    params = {n: (0.3 * rng.randn(*s)).astype(np.float32)
              for n, s in zip(symbol.list_arguments(), arg_shapes)
              if n not in shapes}
    return tdecode.Decoder(symbol, params, T, device="cpu")


@pytest.mark.parametrize("param,value", [("_trace", ("t", 1))])
def test_submit_unported_parameters_raise(decoder, param, value):
    """Named when ``_trace`` was still to be ported; it is now: the fleet
    trace context binds as in the JAX package and rides the request."""
    eng = tengine.InferenceEngine(decoder, 2, (8, 16))
    traced = eng.submit([1, 2, 3], 2, **{param: value})
    assert traced.trace == value
    # at their defaults they bind as in the JAX package
    req = eng.submit([1, 2, 3], 2, None, 0.0, None, None, None, None, (),
                     None)
    while not eng.idle:
        eng.step()
    assert req.done and len(req.tokens) == 2


@pytest.mark.parametrize("param,value", [
    ("deadline_ms", 1e6), ("ttft_deadline_ms", 1e6),
    ("_resume_tokens", [3, 4])])
def test_submit_robustness_parameters_are_accepted(decoder, param, value):
    """The request deadlines and a restored request's tokens (they raised
    "later slice" before the robustness layer was ported) bind as in the
    JAX package, and the request is served."""
    eng = tengine.InferenceEngine(decoder, 2, (8, 16))
    req = eng.submit([1, 2, 3], 4, **{param: value})
    eng.serve_forever()
    assert req.done and req.retire_reason == "length"
    assert len(req.tokens) == 4
    # a restored request's tokens are regenerated, not emitted again
    assert eng.stats["tokens"] == 4 - (len(value) if param ==
                                       "_resume_tokens" else 0)


def test_init_cache_kv_sharding_raises(decoder):
    """``kv_sharding`` is ported: what is not a NamedSharding, or one whose
    spec does not name the kv-head dimension, raises; a sharding over the
    model axis gives one tree a rank with half the heads."""
    from mxnet_tpu_torch.parallel import (NamedSharding, P,
                                          model_parallel_mesh)
    with pytest.raises(MXNetError, match="NamedSharding"):
        decoder.init_cache(2, kv_sharding=object())
    mesh = model_parallel_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(MXNetError, match="kv-head dimension"):
        decoder.init_cache(2, kv_sharding=NamedSharding(mesh, P()))
    caches = decoder.init_cache(2, None)
    assert caches[0][0].shape[:2] == (2, T)
    ranks = decoder.init_cache(2, NamedSharding(mesh, P(None, None,
                                                         "model")))
    assert len(ranks) == 2
    assert ranks[1][0][0].shape == caches[0][0].shape[:2] + (
        caches[0][0].shape[2] // 2, caches[0][0].shape[3])


def test_striped_ring_passes_tile_knobs_to_its_hops(monkeypatch):
    """``striped_ring_attention``'s block_q/block_k reach every hop and
    change no output."""
    from mxnet_tpu_torch.parallel.mesh import build_mesh
    from mxnet_tpu_torch.parallel.ring import striped_ring_attention
    seen = []
    real = K.striped_pair_attention

    def hop(*a, **kw):
        seen.append((kw["block_q"], kw["block_k"]))
        return real(*a, **kw)
    monkeypatch.setattr(K, "striped_pair_attention", hop)
    mesh = build_mesh({"sp": 2}, ["cpu"] * 2)
    q, k, v = (torch.randn(1, 16, 2, 8) for _ in range(3))
    a = striped_ring_attention(q, k, v, mesh, block_q=32, block_k=16)
    assert seen and set(seen) == {(32, 16)}
    b = striped_ring_attention(q, k, v, mesh)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        striped_ring_attention(q, k, v, mesh, block_q=-1)
