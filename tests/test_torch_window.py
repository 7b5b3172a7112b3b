"""Sliding-window LMs on the port: the ring caches of ``Decoder`` and the
engine that serves them, against the JAX package.

A windowed attention node keeps a RING of ``window`` rows (``[B, W, Hkv,
D]`` and, for an int8 cache, its row scales) and a ``[B, W]`` int32
buffer of each row's absolute position, -1 where never written. Small LMs
(2 layers, E=32, 4 heads, vocab 37, max_len 16, window 4; learned
positions or rope, MHA or MQA) get the same seeded numpy weights in both
packages: a prefill longer than the window and the decode steps after it
agree with the JAX windowed decoder and the JAX full forward within 1e-5
(f32; the int8 cache against the JAX int8 decoder). A padded piece's
ring write is bitwise the exact-length one's. The engine (window 6) serves
with
chunked prefill and slot reuse, its streams equal to the JAX offline
windowed ``generate``, at tp=1 and on two CPU ranks.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.parallel.graph import make_graph_fn

from mxnet_tpu_torch import telemetry as port_tele
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import (Decoder, NamedSharding, P,
                                      model_parallel_mesh)
from mxnet_tpu_torch.serving import InferenceEngine

from check_utils import assert_compile_contract

VOCAB, T, W, EMBED, HEADS = 37, 16, 4, 32, 4
TOL = 1e-5
FLAVOURS = {"learned": {}, "rope": dict(pos_encoding="rope"),
            "mqa": dict(num_kv_heads=1),
            "mqa_rope": dict(pos_encoding="rope", num_kv_heads=1)}


def _build(window, extra, seed):
    cfg = dict(num_layers=2, embed_dim=EMBED, num_heads=HEADS,
               window=window, **extra)
    with JaxNames():
        js = jax_lm(VOCAB, impl="dense", **cfg)
    with TorchNames():
        ts = torch_lm(VOCAB, **cfg)
    shapes, _, _ = js.infer_shape(data=(1, T), softmax_label=(1, T))
    rng = np.random.RandomState(seed)
    params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for n, s in zip(js.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return js, ts, params


@pytest.fixture(scope="module")
def lms():
    return {name: _build(W, extra, 41) for name, extra in FLAVOURS.items()}


def _jax_dec(js, params, **kw):
    return JaxDecoder(js, {k: jnp.asarray(v) for k, v in params.items()},
                      max_len=T, **kw)


def _full_logits(js, params, tokens):
    """The JAX full forward of the logits head on the whole sequence."""
    sym = js.get_internals()["lm_head_output"]
    fn = make_graph_fn(sym)
    args = [jnp.asarray(params[n]) if n != "data"
            else jnp.asarray(tokens, jnp.float32)
            for n in sym.list_arguments()]
    outs, _ = fn(args, [], False, jax.random.PRNGKey(0))
    return np.asarray(outs[0])


def test_ring_cache_layout(lms):
    """The ring's shapes and its -1 positions, plain, int8 and sharded:
    the positions replicate (a whole copy on every rank)."""
    _, ts, params = lms["mqa"]
    d = Decoder(ts, params, max_len=T, device="cpu")
    c = d.init_cache(2)
    assert [b.shape for b in c[0]] == [(2, W, 1, 8), (2, W, 1, 8), (2, W)]
    assert c[0][-1].dtype == torch.int32 and (c[0][-1] == -1).all()
    _, ts, params = lms["learned"]
    d8 = Decoder(ts, params, max_len=T, cache_dtype="int8", device="cpu")
    c8 = d8.init_cache(2)
    assert [b.shape for b in c8[0]] == [(2, W, 4, 8), (2, W, 4), (2, W, 4, 8),
                                        (2, W, 4), (2, W)]
    assert Decoder.cache_specs(c8)[0] == (P(None, None, "model"),) * 4 \
        + (P(),)
    mesh = model_parallel_mesh(2, devices=["cpu"] * 2)
    ranks = d8.init_cache(2, kv_sharding=NamedSharding(
        mesh, P(None, None, "model")))
    for t in ranks:
        assert [b.shape for b in t[0]] == [(2, W, 2, 8), (2, W, 2),
                                           (2, W, 2, 8), (2, W, 2), (2, W)]
        assert (t[0][-1] == -1).all() and (t[0][1] == 1).all()


@pytest.mark.parametrize("flavour,cache",
                         [(f, None) for f in FLAVOURS] + [("learned",
                                                           "int8")],
                         ids=list(FLAVOURS) + ["learned-int8"])
def test_windowed_decoder_matches_jax(lms, flavour, cache):
    """A prefill of 9 tokens (longer than the window: the ring's tail
    write), then a step at every position to the end: the logits equal
    the JAX windowed decoder's and (f32) the JAX full forward's within
    1e-5; greedy ``generate`` is the JAX one's (once: the engine tests
    below hold the rest of the streams)."""
    js, ts, params = lms[flavour]
    jd = _jax_dec(js, params, cache_dtype=cache)
    td = Decoder(ts, params, max_len=T, cache_dtype=cache, device="cpu")
    assert td._attn_impl == "dense"
    toks = np.random.RandomState(7).randint(0, VOCAB, (2, T))
    full = _full_logits(js, params, toks) if cache is None else None
    jl, jc = jd.prefill(jd.init_cache(2), toks[:, :9])
    tl, tc = td.prefill(td.init_cache(2), toks[:, :9])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL)
    if full is not None:
        np.testing.assert_allclose(tl.numpy(), full[:, :9], rtol=0,
                                   atol=TOL)
    for pos in range(9, T):
        jl, jc = jd.step(jc, pos, toks[:, pos])
        tl, tc = td.step(tc, pos, torch.as_tensor(toks[:, pos]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL, err_msg="pos %d" % pos)
        if full is not None:
            np.testing.assert_allclose(tl.numpy(), full[:, pos], rtol=0,
                                       atol=TOL, err_msg="pos %d" % pos)
    if flavour == "learned" and cache is None:
        prompt = toks[:, :3]
        np.testing.assert_array_equal(td.generate(prompt, 10).numpy(),
                                      np.asarray(jd.generate(prompt, 10)))


def _pieces(d, caches, toks, pad, cuts):
    """Prefill ``toks`` [1, n] in the pieces ``cuts`` through ``_run``,
    each right-padded to ``pad`` rows with ``valid_len`` (``pad`` None:
    exact-length pieces). Returns each piece's last real logits."""
    out, start = [], 0
    for n in cuts:
        piece = toks[:, start:start + n]
        if pad is not None:
            piece = torch.cat([piece, torch.zeros((1, pad - n),
                                                  dtype=piece.dtype)], 1)
        logits, caches = d._run(d._params, d._aux, caches, start, piece,
                                valid_len=None if pad is None
                                else start + n)
        out.append(logits[0, n - 1])
        start += n
    return out, caches


@pytest.mark.parametrize("cache", [None, "int8"])
def test_padded_prefill_ring_is_bitwise_the_exact_one(lms, cache):
    """A right-padded piece (``valid_len``) writes the ring as the
    exact-length piece does (the JAX package's
    ``test_window_prefill_pad_rows_do_not_corrupt_ring``): the window
    read and write alone, on the same rows, bit for bit — the real rows'
    outputs, the ring's K/V (and scales) and its positions — for a first
    piece longer than the window and a second one after it; and through
    the whole LM, the positions bit for bit and the ring and the last real
    logits within 1e-6 (the host's BLAS rounds a product by its row count,
    so the layers after the first see other bits)."""
    _, ts, params = lms["rope"]
    d = Decoder(ts, params, max_len=T, cache_dtype=cache, device="cpu")
    gen = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn((1, 16, HEADS, 8), generator=gen)
               for _ in range(3))
    node = d._mha[0]
    exact = d.init_cache(1)[0]
    padded = d.init_cache(1)[0]
    start = 0
    for n in (6, 5):
        o_e, exact = d._window_attn(q[:, start:start + n],
                                    k[:, start:start + n],
                                    v[:, start:start + n], exact,
                                    torch.tensor([start]), W)
        o_p, padded = d._window_attn(q[:, start:start + 8],
                                     k[:, start:start + 8],
                                     v[:, start:start + 8], padded,
                                     torch.tensor([start]), W,
                                     valid_len=torch.tensor([start + n]))
        assert torch.equal(o_p[:, :n], o_e)
        for x, y in zip(padded, exact):
            assert torch.equal(x, y)
        start += n
    assert d._node_window(node) == W
    toks = torch.as_tensor(np.random.RandomState(12).randint(0, VOCAB,
                                                             (1, 11)))
    want_l, want = _pieces(d, d.init_cache(1), toks, None, (6, 5))
    got_l, got = _pieces(d, d.init_cache(1), toks, 8, (6, 5))
    for a, b in zip(got_l, want_l):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for ge, we in zip(got, want):
        assert torch.equal(ge[-1], we[-1])
        for x, y in zip(ge[:-1], we[:-1]):
            torch.testing.assert_close(x.float(), y.float(), rtol=0,
                                       atol=1e-6 if cache is None else 1)


def test_clear_window_positions(lms):
    """Resets every ring's positions to -1, in place; ``only_if`` (a
    device bool) resets only where it holds. Non-windowed entries are
    untouched."""
    _, ts, params = lms["learned"]
    d = Decoder(ts, params, max_len=T, device="cpu")
    c = d.init_cache(2)
    _, c = d.prefill(c, torch.arange(6)[None].repeat(2, 1))
    kept = [e[-1].clone() for e in c]
    assert all((k >= 0).any() for k in kept)
    d.clear_window_positions(c, only_if=torch.tensor(False))
    assert all(torch.equal(e[-1], k) for e, k in zip(c, kept))
    out = d.clear_window_positions(c, only_if=torch.tensor(True))
    assert out is c and all((e[-1] == -1).all() for e in c)
    _, c = d.prefill(c, torch.arange(6)[None].repeat(2, 1))
    d.clear_window_positions(c)
    assert all((e[-1] == -1).all() for e in c)


def test_clone_cache_branching(lms):
    """Prefill once, clone, step two continuations: each equals a decode
    of its own path from scratch (the caches are written in place, so
    without the clone the second branch would read the first's rows)."""
    js, ts, params = lms["rope"]
    d = Decoder(ts, params, max_len=T, device="cpu")
    toks = torch.as_tensor(np.random.RandomState(10).randint(0, VOCAB,
                                                             (2, 7)))
    _, caches = d.prefill(d.init_cache(2), toks[:, :6])
    branch = Decoder.clone_cache(caches)
    assert all(x is not y for e, f in zip(caches, branch)
               for x, y in zip(e, f))
    a, _ = d.step(caches, 6, toks[:, 6])
    alt = (toks[:, 6] + 1) % VOCAB
    b, _ = d.step(branch, 6, alt)
    for got, last in ((a, toks[:, 6]), (b, alt)):
        seq = torch.cat([toks[:, :6], last[:, None]], 1)
        want, _ = d.prefill(d.init_cache(2), seq)
        torch.testing.assert_close(got, want[:, 6], rtol=0, atol=TOL)


def test_windowed_impl_resolution(lms, monkeypatch):
    """A windowed LM reads dense by default, silently; ``"paged"`` asked
    (argument or environment) warns with the JAX text and reads dense."""
    _, ts, params = lms["learned"]
    monkeypatch.delenv("MXNET_SERVING_ATTN_IMPL", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert Decoder(ts, params, max_len=T,
                       device="cpu")._attn_impl == "dense"
    with pytest.warns(UserWarning, match="exact dense ring walk"):
        d = Decoder(ts, params, max_len=T, attn_impl="paged", device="cpu")
    assert d._attn_impl == "dense"
    monkeypatch.setenv("MXNET_SERVING_ATTN_IMPL", "paged")
    with pytest.warns(UserWarning, match="exact dense ring walk"):
        Decoder(ts, params, max_len=T, device="cpu")


# -- the windowed engine -----------------------------------------------

@pytest.fixture(scope="module")
def served():
    """Window 6 over rope (``tests/test_serving_tp.py``'s windowed LM
    shape): the port's decoder and the JAX offline oracle."""
    js, ts, params = _build(6, dict(pos_encoding="rope"), 12)
    return ts, params, _jax_dec(js, params)


def _oracle(jd, cases):
    """The JAX offline windowed ``generate`` of ``cases``, one batch a
    (prompt length, budget) pair."""
    out = {}
    for p, n in sorted({(len(pr), n) for pr, n in cases}):
        idx = [i for i, (pr, m) in enumerate(cases) if (len(pr), m) == (p, n)]
        got = np.asarray(jd.generate(np.stack([cases[i][0] for i in idx]),
                                     n))[:, p:]
        out.update((i, g.tolist()) for i, g in zip(idx, got))
    return [out[i] for i in range(len(cases))]


# (prompt length, budget), two prompts each: pieces of 4 wrap the window-6
# ring within a prompt and during decode; 6 requests reuse 2 slots
CASES = [(3, 9), (9, 5), (11, 5)] * 2


def _serve(eng, seed):
    rng = np.random.RandomState(seed)
    cases = [(rng.randint(0, VOCAB, (p,)), n) for p, n in CASES]
    rs = [eng.submit(p, max_tokens=n) for p, n in cases]
    eng.serve_forever()
    return cases, [r.result().tolist() for r in rs]


def test_windowed_engine_equals_jax_offline(served):
    """Asked for the paged read, the engine warns and serves its dense
    ring read; asked for n-gram speculation, it warns and turns it off;
    it has no prefix pool, refuses a prefill role and a handoff, and over
    2 slots (slot reuse: the ring positions wiped on each new request's
    first piece) with 4-token pieces (rings wrap within a prompt and
    during decode) its streams equal the JAX offline windowed
    ``generate``."""
    ts, params, jd = served
    dec = Decoder(ts, params, max_len=T, device="cpu")
    with pytest.raises(MXNetError, match="serve unified"):
        InferenceEngine(dec, 2, role="prefill")
    with pytest.warns(UserWarning) as got:
        eng = InferenceEngine(dec, 2, prefill_buckets=(4, 8),
                              prefill_chunk=4, attn_impl="paged",
                              draft="ngram", spec_k=3)
    texts = " ".join(str(w.message) for w in got)
    assert "exact dense ring walk" in texts and "draft='off'" in texts
    assert eng.attn_impl == "dense" and eng.spec_draft == "off"
    assert eng._prefix is None
    with pytest.raises(MXNetError, match="windowed"):
        eng.admit_handoff({})          # a handoff carries [0, P) rows
    cases, streams = _serve(eng, 5)
    assert streams == _oracle(jd, cases)
    assert eng.stats["prefill_chunks"] > len(cases)
    assert_compile_contract(eng, verify=0, copy={})
    assert port_tele.snapshot()["serving"]["attn_impl"] == 0
    eng.close()


def test_windowed_engine_tp2_equals_tp1(served):
    """The same wave on two CPU ranks: streams equal tp=1's, the rings'
    positions whole on each rank, and ``kv_bytes_per_shard`` counting
    them in full."""
    ts, params, jd = served
    dec = Decoder(ts, params, max_len=T, device="cpu")
    kw = dict(prefill_buckets=(4, 8), prefill_chunk=4)
    one = InferenceEngine(dec, 2, **kw)
    _, want = _serve(one, 6)
    one.close()
    eng = InferenceEngine(dec, 2, tp=2, **kw)
    cases, got = _serve(eng, 6)
    assert got == want
    assert _oracle(jd, cases) == want
    ranks = eng._caches
    assert len(ranks) == 2
    nbytes = 0
    for e in ranks[0]:
        assert e[0].shape == (2, 6, 2, 8) and e[-1].shape == (2, 6)
        nbytes += sum(b.numel() * b.element_size() for b in e)
    assert port_tele.snapshot()["serving"]["kv_bytes_per_shard"] == nbytes
    assert_compile_contract(eng, verify=0, copy={})
    eng.close()
