"""The port's paged read: the three-way entry rule, the decode entry's
split count, and its split-and-merge rule against the JAX package.

``paged_attention_decode`` (every chunk with C < 16) cuts each slot's
cache into key ranges, writes each range's running softmax state
``(m, l, acc)`` and merges the ranges in a second kernel. The CUDA kernel
runs only on the card, where ``chip_smoke.py`` holds it against
``paged_attention_plain``; here a plain-PyTorch mirror of its rule (the
same ranges, empty ranges, base-2 scores and merge) is held against
``paged_attention_plain`` and against the JAX ``paged_attention`` (the
Pallas kernel under the interpreter, as the JAX tests run it on the
CPU). Inputs come from numpy seeds. Tolerance: f32 on every side, rtol
and atol 1e-5 (the three sum in other orders).
"""
import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels as K

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the three-way rule -------------------------------------------------------

@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cache", list(DTYPES))
@pytest.mark.parametrize("c", [1, 5, 15, 16, 256])
def test_paged_entry_three_way_rule(q_dtype, cache, c):
    """C < 16 takes the decode entry whatever the dtypes; a bf16 q over a
    bf16 or an int8 cache with C >= 16 the chunk entry; the rest the
    scalar one."""
    got = K.paged_entry(DTYPES[q_dtype], DTYPES[cache], c, 64)
    if c < 16:
        assert got == "paged_attention_decode"
    elif q_dtype == "bf16" and cache in ("bf16", "int8"):
        assert got == "paged_attention_chunk"
    else:
        assert got == "paged_attention"


@pytest.mark.parametrize("d", [8, 48, 100, 128])
def test_short_chunks_take_the_decode_entry_at_any_head_dim(d):
    for c in (1, 4, 15):
        assert K.paged_entry(torch.bfloat16, torch.bfloat16, c, d) \
            == "paged_attention_decode"


def test_decode_entry_is_registered():
    assert "paged_attention_decode" in K.ENTRIES["paged_attention"]
    assert K.SOURCE["paged_attention_decode"] == "paged_attention"
    assert len(K._ARGTYPES["paged_attention_decode"]) == 19
    assert "paged_attention_decode" in K.launch_counts()


# -- the split count ----------------------------------------------------------

def test_split_count_takes_the_cache_shape_and_the_card_only():
    assert list(inspect.signature(K.paged_decode_splits).parameters) \
        == ["l_", "d", "sms"]
    # the 124M LM's cache (L = 1024, D = 64) on an H100: 8 ranges of 128
    assert K.paged_decode_splits(1024, 64, H100_SMS) == 8
    assert K.paged_decode_splits(1024, 128, H100_SMS) == 16
    assert K.paged_decode_splits(1000, 64, H100_SMS) == 8
    assert K.paged_decode_splits(64, 64, H100_SMS) == 1
    assert K.paged_decode_splits(1, 8, H100_SMS) == 1


@pytest.mark.parametrize("d", [8, 16, 64, 100, 128])
def test_split_count_bounds(d):
    """At least 8192 // d keys a range (the last may be shorter), at most
    one range per 4 SMs and 32, at least one."""
    for sms in (4, 8, 132, 256):
        prev = 0
        for l_ in (1, 7, 64, 100, 300, 1000, 1024, 4096, 65536):
            n = K.paged_decode_splits(l_, d, sms)
            assert 1 <= n <= max(1, min(32, sms // 4))
            assert n == 1 or -(-l_ // n) >= (8192 // d) * (n - 1) / n
            assert n >= prev
            prev = n


def _launch_args(monkeypatch, pos, c, h=4, kv=2, d=16, l_=300, s_=3):
    """The decode wrapper's host side with the launch recorded instead of
    made: (entry, the arguments after the 8 pointers, the workspace)."""
    calls, made = [], []
    monkeypatch.setattr(K, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(K, "_launch",
                        lambda entry, *args: calls.append((entry, args)))
    real_empty = torch.empty

    def empty(*shape, **kw):
        made.append(real_empty(*shape, **kw))
        return made[-1]
    monkeypatch.setattr(torch, "empty", empty)
    q = torch.zeros(s_, c, h, d, dtype=torch.bfloat16)
    k = torch.zeros(s_, l_, kv, d, dtype=torch.bfloat16)
    K._paged_decode(q, k, k, torch.tensor(pos, dtype=torch.int32), None,
                    None, 0.25)
    monkeypatch.setattr(torch, "empty", real_empty)
    (entry, args), = calls
    return entry, args[8:], made[-1]


def test_decode_wrapper_reads_no_device_value(monkeypatch):
    """The launch's sizes, split count and workspace are the same whatever
    pos holds: the host never reads pos."""
    e1, a1, ws1 = _launch_args(monkeypatch, [0, 1, 2], c=5)
    e2, a2, ws2 = _launch_args(monkeypatch, [299, 100, 95], c=5)
    assert e1 == e2 == "paged_attention_decode"
    ns = K.paged_decode_splits(300, 16, H100_SMS)
    # S, C, H, KV, L, D, splits, scale, q dtype, cache dtype
    assert a1 == a2 == (3, 5, 4, 2, 300, 16, ns, 0.25, 1, 1)
    assert ws1.shape == ws2.shape == (3, 2, ns, 2 * 5, 16 + 2)
    assert ws1.dtype == torch.float32


@pytest.mark.parametrize("case", ["c_16", "head_dim_129", "q_view"])
def test_decode_wrapper_rejects(case, monkeypatch):
    monkeypatch.setattr(K, "_sm_count", lambda device: H100_SMS)

    def refuse(entry, *args):
        raise AssertionError("launched %s" % entry)
    monkeypatch.setattr(K, "_launch", refuse)
    c, d = 1, 16
    if case == "c_16":
        c = 16
    elif case == "head_dim_129":
        d = 129
    q = torch.zeros(2, c, 4, d)
    if case == "q_view":
        q = torch.zeros(2, c, 8, d)[:, :, ::2]
    k = torch.zeros(2, 32, 2, d)
    with pytest.raises(MXNetError):
        K._paged_decode(q, k, k, torch.tensor([0, 3], dtype=torch.int32),
                        None, None, 0.25)


def test_cpu_decode_calls_run_plain(monkeypatch):
    """A C < 16 read of CPU tensors runs the plain version, never the
    kernels' library, and is not a launch."""
    def refuse(entry):
        raise AssertionError("a CPU call reached the kernels' library (%s)"
                             % entry)
    monkeypatch.setattr(K, "_lib", refuse)
    K.reset_launch_counts()
    q = torch.randn(2, 4, 4, 16).to(torch.bfloat16)
    kc = torch.randn(2, 48, 2, 16).to(torch.bfloat16)
    pos = torch.tensor([0, 30], dtype=torch.int32)
    out = K.paged_attention(q, kc, kc, pos)
    assert torch.equal(out, K.paged_attention_plain(q, kc, kc, pos))
    assert not any(K.launch_counts().values())


# -- the split-and-merge rule -------------------------------------------------

LOG2E = 1.0 / math.log(2.0)


def split_merge(q, k, v, pos, k_scale, v_scale, scale, ns):
    """Plain-PyTorch mirror of ``paged_attention_decode``: range ``i`` of
    each slot covers keys ``[i * w, (i + 1) * w)``, ``w = ceil(L / ns)``,
    cut at the slot's last live key ``pos + C - 1``; a range that starts
    past it is empty (m = -inf, l = 0). Each range keeps its base-2 running
    state per query row (row r = g * C + c of the kv head, as the decoder
    folds GQA), a row whose max is -inf taking 0 as its reference; the
    merge skips ranges with l = 0. Returns (out, empty ranges)."""
    s_, c, h, d = q.shape
    l_, kv = k.shape[1], k.shape[2]
    g = h // kv
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    w = -(-l_ // ns)
    out = torch.empty(s_, c, h, d)
    empty = 0
    inf = torch.tensor(float("inf"))
    for si in range(s_):
        p = max(int(pos[si]), 0)
        nk = min(l_, p + c)
        for kh in range(kv):
            qs = q[si, :, kh * g:(kh + 1) * g].float().permute(1, 0, 2) \
                .reshape(g * c, d) * (scale * LOG2E)
            qlim = p + torch.arange(g * c) % c
            parts = []
            for sp in range(ns):
                k0, k1 = sp * w, min(sp * w + w, nk)
                if k0 >= k1:
                    empty += 1
                    parts.append((torch.full((g * c,), -inf),
                                  torch.zeros(g * c), torch.zeros(g * c, d)))
                    continue
                sc = qs @ kf[si, k0:k1, kh].t()
                vis = torch.arange(k0, k1)[None, :] <= qlim[:, None]
                sc = torch.where(vis, sc, -inf)
                m = sc.amax(dim=1)
                ref = torch.where(m == -inf, torch.zeros_like(m), m)
                pr = torch.exp2(sc - ref[:, None])
                parts.append((m, pr.sum(dim=1), pr @ vf[si, k0:k1, kh]))
            mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
            ref = torch.where(mx == -inf, torch.zeros_like(mx), mx)
            num = torch.zeros(g * c, d)
            den = torch.zeros(g * c)
            for m, l, acc in parts:
                wt = torch.where(l > 0, torch.exp2(m - ref),
                                 torch.zeros_like(m))
                den = den + wt * l
                num = num + wt[:, None] * torch.where(
                    l[:, None] > 0, acc, torch.zeros_like(acc))
            o = num / torch.clamp(den, min=1e-30)[:, None]
            out[si, :, kh * g:(kh + 1) * g] = o.reshape(g, c, d) \
                .permute(1, 0, 2)
    return out.to(q.dtype), empty


L_, D_ = 300, 64          # three ranges of 100 keys on an H100
NS_ = K.paged_decode_splits(L_, D_, H100_SMS)


def _inputs(seed, c, h, kv, quant, pos, nan=False):
    s_ = len(pos)
    rng = np.random.RandomState(seed)
    q = rng.randn(s_, c, h, D_).astype(np.float32)
    if quant:
        k = rng.randint(-127, 128, (s_, L_, kv, D_)).astype(np.int8)
        v = rng.randint(-127, 128, (s_, L_, kv, D_)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, (s_, L_, kv)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (s_, L_, kv)).astype(np.float32)
    else:
        k = rng.randn(s_, L_, kv, D_).astype(np.float32)
        v = rng.randn(s_, L_, kv, D_).astype(np.float32)
        ks = vs = None
        if nan:
            for i, p in enumerate(pos):
                k[i, p + c:] = np.nan
                v[i, p + c:] = np.nan
    return q, k, v, ks, vs, np.array(pos, np.int32)


def _positions(c):
    """Slots at 0 (every later range empty), live keys ending exactly on
    the first range's edge, and at the end of the cache; then one key
    before, on and after the second range's start."""
    w = -(-L_ // NS_)
    return [[0, w - c, L_ - c], [w - 1, w, w + 1]]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("h,kv", [(12, 4), (12, 12)])
@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("at", [0, 1], ids=["edges", "second-range"])
def test_split_merge_matches_plain_and_jax(quant, h, kv, c, at):
    assert NS_ == 3
    pos = _positions(c)[at]
    q, k, v, ks, vs, pos = _inputs(100 * c + h + kv + at, c, h, kv, quant,
                                   pos)
    scale = 1.0 / math.sqrt(D_)
    kw_t = dict(k_scale=_t(ks), v_scale=_t(vs)) if quant else {}
    got, empty = split_merge(_t(q), _t(k), _t(v), _t(pos),
                             kw_t.get("k_scale"), kw_t.get("v_scale"),
                             scale, NS_)
    if at == 0:
        # slots 0 and 1 (its live keys end on the first range's edge)
        # leave both later ranges empty, slot 2 none
        assert empty == 4 * kv
        assert int(pos[1]) + c == -(-L_ // NS_)
    plain = K.paged_attention(_t(q), _t(k), _t(v), _t(pos), **kw_t)
    kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) \
        if quant else {}
    want = pk.paged_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(pos), **kw_j)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c", [1, 4])
def test_split_merge_never_reads_past_the_live_rows(c):
    """NaN in every cache row past a slot's live keys: the mirror, which
    cuts each range at the slot's last live key, stays finite and equal to
    the plain version of each slot alone."""
    pos = _positions(c)[0]
    q, k, v, _, _, pos = _inputs(7 + c, c, 12, 4, False, pos, nan=True)
    got, _ = split_merge(_t(q), _t(k), _t(v), _t(pos), None, None,
                         1.0 / math.sqrt(D_), NS_)
    assert torch.isfinite(got).all()
    for i in range(len(pos)):
        want = K.paged_attention_plain(_t(q[i:i + 1]), _t(k[i:i + 1]),
                                       _t(v[i:i + 1]), _t(pos[i:i + 1]))
        np.testing.assert_allclose(got[i:i + 1].numpy(), want.numpy(),
                                   **TOL)
