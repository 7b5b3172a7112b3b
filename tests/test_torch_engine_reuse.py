"""The port's engine with the prefix cache, chunked prefill and speculation
on, against the JAX package's engine, on the CPU.

The configuration of ``tests/test_serving.py``'s
``test_engine_prefix_cache_chunked_byte_identical``: a 1-layer LM
(vocab 17, max_len 16, seeded numpy weights, f32), 2 slots, buckets 4 and
8, the prefix pool sized to ONE slot (every retention past the first
evicts), ``prefill_chunk=3`` and n-gram speculation with ``spec_k=3``;
its cases — full, partial and nested hits, misses, chunk-boundary
prompts, a prompt past the largest bucket — served in one admission order
and then the reverse on the same engines, then its near-cache-end case (a
prompt whose head sits within ``spec_k + 2`` of ``max_len`` beside an
accepting request). Greedy streams must EQUAL the JAX engine's and the
JAX offline ``generate``; ``compile_counts`` and the scheduling stats
(hits, copies, chunks, verify and fallback rounds, drafted and accepted
tokens) must equal the JAX engine's; the later waves add no program.

Also: ``draft="model"`` with the draft sharing the target's weights (every
draft accepted, the contract extended by ``{draft: 1, draft_prefill:
{b: 1}}``, equal to the JAX engine's), the draft loaded by
``from_checkpoint(draft_prefix=...)``, the int8 KV cache and int8 weights
under all three features, sampled streams equal with the features on and
off, and the fixed addresses of the pool, the staging cache and the
verify and draft operands across rounds.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import InferenceEngine as JaxEngine

from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.serving import InferenceEngine
from mxnet_tpu_torch.serving.quant import QuantizedTensor

from check_utils import assert_compile_contract

VOCAB, T = 17, 16
CFG = dict(num_layers=1, embed_dim=16, num_heads=2)
# one pool slot: a 1-layer f32 slot is 2 KiB
REUSE = dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0.0021,
             prefill_chunk=3, spec_k=3, draft="ngram")
STATS = ("prefills", "steps", "tokens", "prefix_hits", "prefix_hit_tokens",
         "prefill_chunks", "prefix_copies", "spec_rounds",
         "spec_fallback_rounds", "spec_drafted", "spec_accepted")


@pytest.fixture(scope="module")
def lm():
    with JaxNames():
        js = jax_lm(VOCAB, **CFG)
    with TorchNames():
        ts = torch_lm(VOCAB, **CFG)
    shapes, _, _ = js.infer_shape(data=(1, T), softmax_label=(1, T))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for n, s in zip(js.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    jdec = JaxDecoder(js, {k: jnp.asarray(v) for k, v in params.items()},
                      max_len=T, cache_block=None)
    return js, ts, params, jdec, Decoder(ts, params, max_len=T,
                                         device="cpu")


_ORACLE = {}


def _oracle(jdec, prompt, n):
    """The JAX offline greedy continuation, truncated at the cache end."""
    n = min(n, T - len(prompt))
    key = (np.asarray(prompt).tobytes(), n)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(jdec.generate(
            np.asarray(prompt)[None], num_steps=n))[0, len(prompt):].tolist()
    return _ORACLE[key]


def _cases():
    rng = np.random.RandomState(13)
    base = rng.randint(0, VOCAB, (7,))
    return {
        "miss_long": (base, 3),
        "prefix_of": (base[:4].copy(), 6),
        "partial": (np.concatenate([base[:4],
                                    rng.randint(0, VOCAB, (3,))]), 3),
        "unrelated": (rng.randint(0, VOCAB, (2,)), 5),
        "full_dup": (base.copy(), 3),
        "boundary": (rng.randint(0, VOCAB, (6,)), 2),
        "beyond_bucket": (rng.randint(0, VOCAB, (10,)), 3),
        "near_end": (rng.randint(0, VOCAB, (13,)), 2),
    }


def _run_port(eng, work, steps_between=None):
    """Submit ``work`` [(name, prompt, budget)], stepping
    ``steps_between[name]`` rounds after that submission; serve to idle.
    Returns {name: request}."""
    out = {}
    for name, prompt, n in work:
        out[name] = eng.submit(prompt, max_tokens=n)
        for _ in range((steps_between or {}).get(name, 0)):
            eng.step()
    while not eng.idle:
        eng.step()
    return out


def _run_jax(eng, work, steps_between=None):
    out = {}
    for name, prompt, n in work:
        out[name] = eng.submit(prompt, max_tokens=n)
        for _ in range((steps_between or {}).get(name, 0)):
            eng.step()
    eng.serve_forever()
    return out


def _waves():
    cases = _cases()
    order = ["miss_long", "prefix_of", "partial", "unrelated", "full_dup",
             "boundary", "beyond_bucket"]
    first = [(k,) + cases[k] for k in order]
    # near-cache-end guard: an accepting request drafting while a prompt
    # whose head sits within spec_k + 2 of max_len admits beside it
    guard = [("accepting", np.array([0, 3, 3]), 13),
             ("near_end",) + cases["near_end"]]
    return [(first, None), (first[::-1], None),
            (guard, {"accepting": 3})]


@pytest.fixture(scope="module")
def served(lm):
    """Both engines through the three waves: per wave the port's and the
    JAX engine's requests, the compile-log lengths and both stats."""
    js, ts, params, jdec, tdec = lm
    jeng = JaxEngine(JaxDecoder(js, {k: jnp.asarray(v)
                                     for k, v in params.items()},
                                max_len=T, cache_block=None),
                     attn_impl="paged", **REUSE)
    teng = InferenceEngine(tdec, **REUSE)
    assert teng._prefix.capacity == jeng._prefix.capacity == 1
    waves = []
    for work, between in _waves():
        jr = _run_jax(jeng, work, between)
        tr = _run_port(teng, work, between)
        waves.append((work, tr, jr, len(teng._compile_log),
                      dict(teng.stats), dict(jeng.stats)))
    return teng, jeng, waves


@pytest.mark.parametrize("wave", [0, 1, 2], ids=["order", "reversed",
                                                 "near_end"])
def test_reuse_streams_equal_jax_engine_and_generate(lm, served, wave):
    jdec = lm[3]
    work, tr, jr, _, tstats, jstats = served[2][wave]
    for name, prompt, n in work:
        want = _oracle(jdec, prompt, n)
        assert jr[name].result().tolist() == want, name
        assert tr[name].tokens == want, name
        assert tr[name].done and tr[name].retire_reason == "length"
    assert {k: tstats[k] for k in STATS} == {k: jstats[k] for k in STATS}


def test_reuse_compile_counts_equal_jax(served):
    teng, jeng, waves = served
    cc = assert_compile_contract(teng)
    assert cc == jeng.compile_counts
    assert cc["verify"] == 1 and cc["copy"]
    # the later waves built no program
    assert waves[0][3] == waves[1][3] == waves[2][3] \
        == len(teng._compile_log)


def test_reuse_exercised_every_feature(served):
    teng, _, waves = served
    stats = waves[-1][4]
    assert teng._prefix.evictions >= 1          # the one-slot pool churned
    assert stats["prefix_hits"] >= 1 and stats["prefix_copies"] \
        > stats["prefix_hits"]                  # hits and retentions
    assert stats["spec_rounds"] >= 1 and stats["spec_accepted"] >= 1
    assert stats["spec_fallback_rounds"] >= 1
    assert stats["prefill_chunks"] > stats["prefills"]
    reqs = [r for w in waves for r in w[1].values()]
    assert sum(r.prefill_chunks for r in reqs) == stats["prefill_chunks"]
    assert sum(r.prefix_hit_tokens for r in reqs) \
        == stats["prefix_hit_tokens"]
    assert teng._prefix.pinned == 0 and teng.idle


def test_chunking_raises_the_prompt_cap(lm):
    tdec = lm[4]
    off = InferenceEngine(tdec, slots=2, prefill_buckets=(4, 8),
                          prefix_cache_mb=0, prefill_chunk=0)
    with pytest.raises(MXNetError, match="largest"):
        off.submit(np.arange(10) % VOCAB, max_tokens=2)
    on = InferenceEngine(tdec, slots=2, prefill_buckets=(4, 8),
                         prefix_cache_mb=0, prefill_chunk=4)
    r = on.submit(np.arange(T - 1) % VOCAB, max_tokens=4)
    with pytest.raises(MXNetError, match="no room"):
        on.submit(np.arange(T) % VOCAB, max_tokens=1)
    while not on.idle:
        on.step()
    assert r.prefill_chunks == 4 and r.tokens == _oracle(
        lm[3], np.arange(T - 1) % VOCAB, 4)
    with pytest.raises(MXNetError, match="prefill_chunk"):
        InferenceEngine(tdec, prefill_buckets=(4, 8), prefill_chunk=9)


def test_round_budget_holds_admissions(lm):
    """Under chunking a round prefills at most ``prefill_chunk`` tokens:
    a second prompt waits (held, still counted as queued) while the first
    one's pieces run."""
    tdec = lm[4]
    eng = InferenceEngine(tdec, slots=2, prefill_buckets=(4, 8),
                          prefix_cache_mb=0, prefill_chunk=4)
    a = eng.submit(np.arange(9) % VOCAB, max_tokens=2)
    b = eng.submit(np.arange(3, 9) % VOCAB, max_tokens=2)
    eng.step()
    assert eng.queued() == 1 and a.prefill_chunks == 1 \
        and b.prefill_chunks == 0
    while not eng.idle:
        eng.step()
    assert a.tokens == _oracle(lm[3], np.arange(9) % VOCAB, 2)
    assert b.tokens == _oracle(lm[3], np.arange(3, 9) % VOCAB, 2)


def _draft_cases():
    rng = np.random.RandomState(21)
    return [(rng.randint(0, VOCAB, (2,)), 5), (rng.randint(0, VOCAB, (4,)), 6),
            (rng.randint(0, VOCAB, (7,)), 3), (np.array([0, 3, 3]), 13)]


def test_draft_model_equals_jax(lm):
    js, ts, params, jdec, tdec = lm
    kw = dict(slots=2, prefill_buckets=(4, 8), spec_k=3, draft="model",
              prefix_cache_mb=0)
    jeng = JaxEngine(JaxDecoder(js, {k: jnp.asarray(v)
                                     for k, v in params.items()},
                                max_len=T, cache_block=None),
                     attn_impl="paged", draft_decoder=jdec, **kw)
    teng = InferenceEngine(tdec, draft_decoder=Decoder(
        ts, params, max_len=T, device="cpu"), **kw)
    work = [(str(i), p, n) for i, (p, n) in enumerate(_draft_cases())]
    jr, tr = _run_jax(jeng, work), _run_port(teng, work)
    for name, p, n in work:
        assert tr[name].tokens == jr[name].result().tolist() \
            == _oracle(jdec, p, n)
    cc = assert_compile_contract(teng, verify=1, copy={}, draft=1)
    assert cc == jeng.compile_counts
    assert cc["draft_prefill"] == {4: 1, 8: 1}
    # the draft is the target: every proposal is accepted
    assert teng.stats["spec_accepted"] > teng.stats["spec_rounds"] >= 1
    assert {k: teng.stats[k] for k in STATS} \
        == {k: jeng.stats[k] for k in STATS}


def test_draft_model_from_checkpoint(lm, tmp_path):
    """``draft_prefix`` loads the draft (the target's own checkpoint, int8
    as the target) and turns on ``draft="model"``."""
    js, ts, params, jdec, _ = lm
    prefix = str(tmp_path / "lm")
    tmodel.save_checkpoint(prefix, 0, ts, params, {})
    eng = InferenceEngine.from_checkpoint(
        prefix, 0, T, slots=2, prefill_buckets=(4, 8), spec_k=3,
        prefix_cache_mb=0, draft_prefix=prefix, draft_epoch=0,
        weight_dtype="int8", matmul_impl="fused", device="cpu")
    assert eng.spec_draft == "model" and eng._draft_dec is not eng._dec
    assert any(isinstance(v, QuantizedTensor)
               for v in eng._draft_params.values())
    assert eng.weight_bytes == 2 * InferenceEngine(
        eng._dec, slots=2, prefill_buckets=(4, 8)).weight_bytes
    work = [(str(i), p, n) for i, (p, n) in enumerate(_draft_cases())]
    tr = _run_port(eng, work)
    for name, p, n in work:
        ref = eng._dec.generate(p[None], min(n, T - len(p)))[0, len(p):]
        assert tr[name].tokens == ref.tolist()
    assert eng.stats["spec_accepted"] > eng.stats["spec_rounds"] >= 1


def test_int8_engine_quantizes_its_own_draft_copy(lm):
    _, ts, params, _, tdec = lm
    draft = Decoder(ts, params, max_len=T, device="cpu")
    eng = InferenceEngine(tdec, slots=2, prefill_buckets=(4, 8),
                          draft="model", draft_decoder=draft,
                          weight_dtype="int8")
    assert any(isinstance(v, QuantizedTensor)
               for v in eng._draft_params.values())
    assert not any(isinstance(v, QuantizedTensor)
                   for v in draft._params.values())
    q8 = Decoder(ts, params, max_len=T, weight_dtype="int8", device="cpu")
    for bad in (dict(draft_decoder=q8, weight_dtype="float"),
                dict(draft_decoder=Decoder(ts, params, max_len=T - 1,
                                           device="cpu")),
                dict(draft_decoder=None), dict(spec_k=T - 2)):
        with pytest.raises(MXNetError):
            InferenceEngine(tdec, slots=2, prefill_buckets=(4, 8),
                            **dict(dict(draft="model", draft_decoder=draft),
                                   **bad))


@pytest.mark.parametrize("flavor", ["int8_kv", "int8_weights"])
def test_int8_flavors_under_every_feature(lm, flavor):
    """The copy moves every cache buffer (the int8 row scales too) and
    the quantized products run at the verify's M = S (K+1): streams equal
    the same decoder's ``generate``."""
    _, ts, params, _, _ = lm
    kw = dict(cache_dtype="int8") if flavor == "int8_kv" \
        else dict(weight_dtype="int8", matmul_impl="fused")
    dec = Decoder(ts, params, max_len=T, device="cpu", **kw)
    eng = InferenceEngine(dec, **dict(REUSE, prefix_cache_mb=1))
    for work, between in _waves():
        reqs = _run_port(eng, work, between)
        for name, p, n in work:
            ref = dec.generate(p[None], min(n, T - len(p)))[0, len(p):]
            assert reqs[name].tokens == ref.tolist(), (flavor, name)
    assert eng.stats["prefix_hits"] >= 1 and eng.stats["spec_rounds"] >= 1
    assert_compile_contract(eng, verify=1)


def test_sampled_streams_equal_with_features_on_and_off(lm):
    tdec = lm[4]
    prompts = [np.array([0, 3, 3, 0, 3]), np.array([0, 3, 3, 0, 3, 3]),
               np.array([5, 1, 5, 1, 5, 1, 5])]
    temps = [(0.9, 4), (0.0, 0), (1.3, 7)]
    runs = []
    for kw in (dict(REUSE), dict(REUSE, draft="off"),
               dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0,
                    prefill_chunk=0, draft="off")):
        eng = InferenceEngine(tdec, **kw)
        for _ in range(2):              # the second wave hits the pool
            rs = [eng.submit(p, max_tokens=9, temperature=t, seed=sd)
                  for p, (t, sd) in zip(prompts, temps)]
            while not eng.idle:
                eng.step()
            runs.append([r.tokens for r in rs])
        if kw["draft"] == "ngram":
            assert eng.stats["spec_rounds"] >= 1
    assert all(r == runs[0] for r in runs)
    assert runs[0][1] == _oracle(lm[3], prompts[1], 9)


def _buffers(eng):
    bufs = list(eng._state()) + eng._groups + eng._stage_groups \
        + eng._draft_groups + eng._draft_stage_groups
    for entry in eng._cache_bufs + eng._caches + eng._stage \
            + eng._draft_caches + eng._draft_stage:
        bufs.extend(entry)
    for prog in eng._programs.values():
        bufs.extend(prog.operands.values())
    return {id(b): b.data_ptr() for b in bufs}


def test_buffers_keep_their_addresses(lm):
    """The pool, the staging caches, the state and every program's
    operands (verify, draft, copy, prefill) stay where the first rounds
    left them across later rounds and admissions."""
    _, ts, params, _, tdec = lm
    eng = InferenceEngine(tdec, draft_decoder=Decoder(
        ts, params, max_len=T, device="cpu"), **dict(REUSE, draft="model"))
    work = [(str(i), p, n) for i, (p, n) in enumerate(_draft_cases())]
    _run_port(eng, work)
    first = _buffers(eng)
    assert {"verify", "draft"} <= set(eng._programs)
    # the serving cache is a view of the pool's buffers, and every buffer
    # of one dtype and row shape a view of one allocation
    assert eng._caches[0][0].data_ptr() == eng._cache_bufs[0][0].data_ptr()
    for caches, groups in ((eng._cache_bufs, eng._groups),
                           (eng._stage, eng._stage_groups),
                           (eng._draft_caches, eng._draft_groups)):
        bases = {g.untyped_storage().data_ptr() for g in groups}
        assert len(groups) == 1 and {
            b.untyped_storage().data_ptr() for e in caches for b in e} \
            == bases
    _run_port(eng, work[::-1])
    assert _buffers(eng) == first
