"""The port's dense ``Decoder`` reads against the JAX package's.

``attn_impl="dense"``: the dense masked read of all ``max_len`` rows and,
for single tokens with ``cache_block`` set, the blocked online-softmax
read (every block of the cache, the JAX package's live blocks: the extra
ones change nothing). Small LMs (2 layers, E=32, 4 heads, vocab 37,
max_len 16; learned positions, and grouped-query rope) get the same
seeded numpy weights in both packages; in f32 the logits agree within
1e-5 for a prefill and each decode step after it, float and int8 caches.
Then the engine: a dense engine's gauntlet (prefix hits, chunked prefill,
n-gram speculation) against the JAX offline dense decoder, a dense
engine's snapshot restored dense, and a JAX dense capture replayed dense.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import InferenceEngine as JaxEngine
from mxnet_tpu.serving import capture as jax_capture

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.serving import InferenceEngine
from mxnet_tpu_torch.serving import replay as port_replay

from check_utils import assert_compile_contract

VOCAB, T, PROMPT, STEPS = 37, 16, 9, 5
MODELS = {
    "learned": dict(num_layers=2, embed_dim=32, num_heads=4),
    "gqa_rope": dict(num_layers=2, embed_dim=32, num_heads=4,
                     num_kv_heads=2, pos_encoding="rope"),
}
TOL = 1e-5


def _init(rng, name, shape):
    """Fan-in-scaled weights, gains near 1 (varied greedy streams)."""
    if name.endswith("_gamma"):
        v = 1.0 + 0.1 * rng.randn(*shape)
    elif len(shape) == 2 and name != "pos_embed":
        v = 1.5 * rng.randn(*shape) / np.sqrt(shape[1])
    else:
        v = 0.1 * rng.randn(*shape)
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, cfg in MODELS.items():
        with JaxNames():
            js = jax_lm(VOCAB, **cfg)
        with TorchNames():
            ts = torch_lm(VOCAB, **cfg)
        shapes, _, _ = js.infer_shape(data=(1, T), softmax_label=(1, T))
        rng = np.random.RandomState(4)
        params = {n: _init(rng, n, s)
                  for n, s in zip(js.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
        prompt = rng.randint(0, VOCAB, (2, PROMPT)).astype(np.int32)
        out[name] = (js, ts, params, prompt)
    return out


def _pair(models, model, **kw):
    js, ts, params, prompt = models[model]
    jd = JaxDecoder(js, {k: jnp.asarray(v) for k, v in params.items()},
                    max_len=T, attn_impl="dense", **kw)
    td = Decoder(ts, params, max_len=T, attn_impl="dense", device="cpu",
                 **kw)
    return jd, td, prompt


READS = [(m, cache, block) for m in MODELS for cache in (None, "int8")
         for block in (None, 4)]


@pytest.mark.parametrize("model,cache,block", READS,
                         ids=["%s-%s-block%s" % (m, c or "float", b)
                              for m, c, b in READS])
def test_dense_reads_match_jax(models, model, cache, block):
    """A prefill, then decode steps, logits against the JAX dense (and,
    with ``cache_block=4``, blocked) read within 1e-5."""
    jd, td, prompt = _pair(models, model, cache_dtype=cache,
                           cache_block=block)
    assert td._cache_block == jd._cache_block == block
    jl, jc = jd.prefill(jd.init_cache(2), prompt)
    tl, tc = td.prefill(td.init_cache(2), prompt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL)
    tok = np.asarray(jl[:, -1]).argmax(-1)
    for i in range(STEPS):
        jl, jc = jd.step(jc, PROMPT + i, tok)
        tl, tc = td.step(tc, PROMPT + i, torch.as_tensor(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        tok = np.asarray(jl).argmax(-1)


@pytest.mark.parametrize("max_len", [16, 513, 1024, 1025])
def test_cache_block_auto_resolves_as_jax(models, max_len):
    """``"auto"``: None up to 512, 128 beyond where it divides (1025 is
    odd); under the paged read ``"auto"`` is None and an integer raises
    the JAX message in both packages. The rope LM has no position table,
    so any max_len builds."""
    js, ts, params, _ = models["gqa_rope"]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jd = JaxDecoder(js, jp, max_len=max_len, attn_impl="dense")
    td = Decoder(ts, params, max_len=max_len, attn_impl="dense",
                 device="cpu")
    assert td._cache_block == jd._cache_block
    assert td._cache_block == (128 if max_len in (1024,) else None)
    assert Decoder(ts, params, max_len=max_len, attn_impl="paged",
                   device="cpu")._cache_block is None
    for make in (lambda: JaxDecoder(js, jp, max_len=max_len,
                                    attn_impl="paged", cache_block=8),
                 lambda: Decoder(ts, params, max_len=max_len,
                                 attn_impl="paged", cache_block=8,
                                 device="cpu")):
        with pytest.raises(Exception, match="two prefix-bounded"):
            make()
    with pytest.raises(MXNetError, match="positive divisor"):
        Decoder(ts, params, max_len=max_len, attn_impl="dense",
                cache_block=max_len + 1, device="cpu")


def test_default_and_environment_attn_impl(models, monkeypatch):
    """Unset, the port reads paged (its decided default; the JAX package
    reads dense); ``MXNET_SERVING_ATTN_IMPL=dense`` gives the dense read,
    as in the JAX package."""
    _, ts, params, _ = models["learned"]
    monkeypatch.delenv("MXNET_SERVING_ATTN_IMPL", raising=False)
    assert Decoder(ts, params, max_len=T, device="cpu")._attn_impl \
        == "paged"
    monkeypatch.setenv("MXNET_SERVING_ATTN_IMPL", "dense")
    d = Decoder(ts, params, max_len=T, device="cpu")
    assert d._attn_impl == "dense" and d._cache_block is None
    with pytest.raises(MXNetError, match="'dense' or 'paged'"):
        Decoder(ts, params, max_len=T, attn_impl="flash", device="cpu")


RUN_SLOTS = [(m, block) for m in MODELS for block in (None, 4)]


@pytest.mark.parametrize("model,block", RUN_SLOTS,
                         ids=["%s-block%s" % c for c in RUN_SLOTS])
def test_run_slots_dense_mixed_positions_match_jax(models, model, block):
    """``_run_slots(impl="dense")`` at mixed per-slot positions, a decode
    width and a verify width, against the JAX package's vmap of one-row
    dense walks; with ``cache_block=4`` the port's single-token rows take
    the blocked read (the JAX package's vmapped blocked read does not
    trace on this JAX version, so its dense read is the reference)."""
    import jax

    jd, _, _ = _pair(models, model, cache_block=None)
    _, td, _ = _pair(models, model, cache_block=block)
    rng = np.random.RandomState(3)
    S = 3
    toks = rng.randint(0, VOCAB, (S, 8)).astype(np.int32)
    jc = jd.init_cache(S)
    _, jc = jax.jit(lambda c, t: jd._run_slots(
        jd._params, jd._aux, c, jnp.zeros((S,), jnp.int32), t))(
        jc, jnp.asarray(toks))
    tc = td.init_cache(S)
    _, tc = td._run_slots(td._params, td._aux, tc,
                          torch.zeros((S,), dtype=torch.int32),
                          torch.as_tensor(toks, dtype=torch.int64))
    pos = np.array([4, 2, 7], np.int32)
    for width in (1, 3):
        chunk = rng.randint(0, VOCAB, (S, width)).astype(np.int32)
        jl, _ = jax.jit(lambda c, p, t: jd._run_slots(
            jd._params, jd._aux, c, p, t))(
            JaxDecoder.clone_cache(jc), jnp.asarray(pos),
            jnp.asarray(chunk))
        tl, _ = td._run_slots(td._params, td._aux, Decoder.clone_cache(tc),
                              torch.as_tensor(pos),
                              torch.as_tensor(chunk, dtype=torch.int64))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)


def test_dense_and_paged_streams_equal(models):
    """In the port, f32: the dense, blocked and paged reads give the same
    greedy streams (the same attention over each sequence's live rows)."""
    js, ts, params, prompt = models["gqa_rope"]
    runs = [Decoder(ts, params, max_len=T, attn_impl=impl, cache_block=cb,
                    device="cpu").generate(prompt, T - PROMPT)
            for impl, cb in (("paged", None), ("dense", None),
                             ("dense", 4))]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


def test_dense_refusals_follow_jax(models):
    """``impl="dense"`` on a paged decoder raises in ``_run_slots`` and in
    the engine; ``_run``'s ``ep`` reaches MoE nodes only, so on this dense
    LM it changes nothing, as in the JAX package."""
    _, ts, params, _ = models["learned"]
    paged = Decoder(ts, params, max_len=T, attn_impl="paged", device="cpu")
    with pytest.raises(MXNetError, match="build the decoder dense"):
        paged._run_slots(paged._params, paged._aux, paged.init_cache(1),
                         torch.zeros((1,), dtype=torch.int32),
                         torch.zeros((1, 1), dtype=torch.int64),
                         impl="dense")
    with pytest.raises(MXNetError, match="build the decoder dense"):
        InferenceEngine(paged, 2, attn_impl="dense")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    plain, _ = paged._run(paged._params, paged._aux, paged.init_cache(1), 0,
                          tok)
    with_ep, _ = paged._run(paged._params, paged._aux, paged.init_cache(1),
                            0, tok, ep=("expert", 2))
    assert torch.equal(with_ep, plain)


# -- the dense engine ---------------------------------------------------

ENGINE = dict(slots=2, prefill_buckets=(4, 8, 16))
GAUNTLET = dict(prefix_cache_mb=0.01, prefill_chunk=3, draft="ngram",
                spec_k=3)


def _cases(rng):
    """The serving gauntlet's cases (``tests/test_paged_attention.py``):
    prefix hits (full, partial, miss), chunk boundaries, a prompt past
    the second bucket and a stream whose n-gram drafts are accepted."""
    base = rng.randint(0, VOCAB, (7,))
    return [(base, 3), (base[:4].copy(), 6),
            (np.concatenate([base[:4], rng.randint(0, VOCAB, (3,))]), 3),
            (rng.randint(0, VOCAB, (2,)), 5), (base.copy(), 3),
            (rng.randint(0, VOCAB, (10,)), 3), (np.array([0, 3, 3]), 13)]


def _oracle(jd, prompt, n):
    n = min(n, T - len(prompt))
    return np.asarray(jd.generate(np.asarray(prompt)[None], n))[
        0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def dense_pair(models):
    """The JAX dense decoder (``cache_block=None``: the JAX engine serves
    no other), the port's dense one with ``cache_block=4`` (its engine
    serves the blocked read too) and the port's paged one, over the
    learned-position LM."""
    jd, _, _ = _pair(models, "learned", cache_block=None)
    _, td, _ = _pair(models, "learned", cache_block=4)
    _, ts, params, _ = models["learned"]
    return jd, td, Decoder(ts, params, max_len=T, attn_impl="paged",
                           device="cpu")


def test_dense_engine_gauntlet_equals_jax_offline(dense_pair):
    """The dense engine (decode rounds on the blocked read, prefill pieces
    and verify chunks on the dense read) over the gauntlet: every stream
    equals the JAX offline dense decoder's, with the reuse features
    firing and the JAX compile contract."""
    jd, td, _ = dense_pair
    eng = InferenceEngine(td, **ENGINE, **GAUNTLET)
    assert eng.attn_impl == "dense"
    cases = _cases(np.random.RandomState(13))
    rs = [eng.submit(p, max_tokens=n) for p, n in cases]
    eng.serve_forever()
    for (p, n), r in zip(cases, rs):
        assert r.result().tolist() == _oracle(jd, p, n)
    assert_compile_contract(eng)
    st = eng.stats
    assert st["prefix_hits"] >= 1 and st["spec_accepted"] >= 1
    assert st["prefill_chunks"] > len(cases)
    eng.close()


def test_dense_snapshot_restores_dense(dense_pair):
    """A dense engine's snapshot (``attn_impl="dense"`` in its geometry)
    restores onto a dense decoder as a dense engine, and onto a paged one
    as a paged engine; both continue to the JAX offline streams."""
    jd, td, paged = dense_pair
    rng = np.random.RandomState(14)
    cases = [(rng.randint(0, VOCAB, (n,)), b) for n, b in ((3, 9), (6, 7))]
    eng = InferenceEngine(td, **ENGINE, prefix_cache_mb=0)
    rs = [eng.submit(p, max_tokens=b) for p, b in cases]
    for _ in range(3):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    assert snap["engine"]["attn_impl"] == "dense"
    eng.close()
    for dec, want in ((td, "dense"), (paged, "paged")):
        eng2, handles = InferenceEngine.restore(snap, dec)
        assert eng2.attn_impl == want
        eng2.serve_forever()
        for (p, b), r in zip(cases, rs):
            assert handles[r.id].result().tolist() == _oracle(jd, p, b)
        eng2.close()


def test_jax_dense_capture_replays_dense(dense_pair, tmp_path):
    """A JAX dense engine's capture replays on a dense port decoder as a
    dense engine (``build_engine`` honours it), verified clean."""
    jd, td, _ = dense_pair
    jeng = JaxEngine(jd, **ENGINE, prefix_cache_mb=0,
                     capture_dir=str(tmp_path))
    rng = np.random.RandomState(15)
    for n, b in ((3, 6), (5, 4), (9, 5)):
        jeng.submit(rng.randint(0, VOCAB, (n,)), max_tokens=b)
    jeng.serve_forever()
    jeng.close()
    cap = jax_capture.load_capture(jeng.capture.path)
    assert cap["engine"]["attn_impl"] == "dense"
    eng = port_replay.build_engine(cap, td)
    assert eng.attn_impl == "dense"
    rep = port_replay.replay(cap, eng, timing="max", verify=True)
    assert rep["mismatches"] == [] and rep["verified"] == 3
    eng.close()
