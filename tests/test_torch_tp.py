"""Tensor-parallel serving on the port, on the CPU: the KV cache sharded
over a mesh's ``model`` axis on its kv heads (one tp=1 layout tree a rank,
each buffer its own contiguous allocation), every engine program run with
the walk's ``tp``, and the degree carried through snapshot, capture, replay
and the KV handoff.

The oracle is tp=1: the port's own tp=1 engine, the JAX package's tp=1
paged engine and its offline ``Decoder.generate`` (the JAX tp=2 engine is
not run here: its programs fail on this JAX version). Greedy streams must
be equal byte for byte at every degree, and ``compile_counts`` equal to
tp=1's. The LM is ``tests/test_serving_tp.py``'s (1 layer, vocab 17, E=32,
4 heads, max_len 16, seeded numpy weights, f32), so that one symbol serves
tp=2 and tp=4 and tp=3 is the divisibility refusal. Meshes are ``["cpu"] *
2`` and ``["cpu"] * 4``.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import engine as jax_engine

from mxnet_tpu_torch import telemetry as port_tele
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.model import save_checkpoint
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import (Decoder, NamedSharding, P,
                                      build_mesh, model_parallel_mesh)
from mxnet_tpu_torch.serving import capture as port_capture
from mxnet_tpu_torch.serving import engine as port_engine
from mxnet_tpu_torch.serving import replay as port_replay

from check_utils import assert_compile_contract

VOCAB, LAYERS, EMBED, HEADS = 17, 1, 32, 4
T = 16
CFG = dict(num_layers=LAYERS, embed_dim=EMBED, num_heads=HEADS)
GAUNTLET = dict(prefix_cache_mb=0.01, prefill_chunk=3, draft="ngram",
                spec_k=3)

Engine = port_engine.InferenceEngine


def _params(sym, rng):
    shapes, _, _ = sym.infer_shape(data=(2, T), softmax_label=(2, T))
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


@pytest.fixture(scope="module")
def lm():
    with JaxNames():
        js = jax_lm(VOCAB, impl="dense", **CFG)
    with TorchNames():
        ts = torch_lm(VOCAB, **CFG)
    params = _params(js, np.random.RandomState(0))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    return {"jsym": js, "jparams": jparams, "symbol": ts,
            "params": params,
            "oracle": JaxDecoder(js, jparams, max_len=T)}


def _dec(lm, **kw):
    return Decoder(lm["symbol"], lm["params"], max_len=T, device="cpu",
                   **kw)


def _engine(lm, dec_kw=None, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("prefill_buckets", (4, 8))
    kw.setdefault("prefix_cache_mb", 0)
    return Engine(_dec(lm, **(dec_kw or {})), **kw)


_ORACLE = {}


def _oracle(lm, prompt, n):
    """The JAX offline greedy continuation (tp=1), cut at the cache end."""
    prompt = np.asarray(prompt)
    n = min(n, T - len(prompt))
    key = (prompt.tobytes(), n)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(lm["oracle"].generate(
            prompt[None], num_steps=n))[0, len(prompt):].tolist()
    return _ORACLE[key]


def _gauntlet_cases(rng):
    """``tests/test_serving_tp.py``'s cases: prefix hits (full, partial,
    miss), chunk boundaries, a prompt past the largest bucket and a
    stream whose n-gram drafts are accepted."""
    base = rng.randint(0, VOCAB, (7,))
    return [
        (base, 3),
        (base[:4].copy(), 6),
        (np.concatenate([base[:4], rng.randint(0, VOCAB, (3,))]), 3),
        (rng.randint(0, VOCAB, (2,)), 5),
        (base.copy(), 3),
        (rng.randint(0, VOCAB, (10,)), 3),
        (np.array([0, 3, 3]), 13),
    ]


def _serve(eng, cases):
    rs = [eng.submit(p, max_tokens=n) for p, n in cases]
    eng.serve_forever()
    return [r.result().tolist() for r in rs]


def _assert_shards(ranks, tp, rows=T):
    """A sharded tree: one tree a rank, every buffer ``[.., rows, Hkv/tp,
    ..]`` and contiguous, no two ranks sharing an allocation."""
    assert isinstance(ranks, list) and len(ranks) == tp
    for t in ranks:
        for entry in t:
            for b in entry:
                assert b.shape[1] == rows and b.shape[2] == HEADS // tp
                assert b.is_contiguous()
    ptrs = [{b.untyped_storage().data_ptr() for e in t for b in e}
            for t in ranks]
    for a in range(tp):
        for b in range(a + 1, tp):
            assert not ptrs[a] & ptrs[b]


def test_tp2_gauntlet_equals_tp1_and_the_jax_engine(lm):
    """(a) Prefix cache with a churning two-slot pool, chunked prefill
    (3-token pieces), n-gram speculation: the tp=2 engine's streams equal
    the port's tp=1 engine's, the JAX tp=1 paged engine's and the JAX
    offline decoder's, with tp=1's compile counts; a second wave in
    reverse order builds nothing. The degree reaches the gauges and the
    snapshot geometry."""
    cases = _gauntlet_cases(np.random.RandomState(13))
    e1 = _engine(lm, **GAUNTLET)
    e2 = _engine(lm, tp=2, **GAUNTLET)
    assert e2.tp == 2 and e2._mesh is not None and e1._mesh is None
    want = [_oracle(lm, p, n) for p, n in cases]
    assert _serve(e1, cases) == want
    got = _serve(e2, cases)
    assert got == want
    assert e2.stats["prefix_hits"] >= 1
    assert e2.stats["prefill_chunks"] > len(cases)
    assert e2.stats["spec_accepted"] >= 1
    assert e2._prefix.evictions >= 1
    for k in ("prefix_hits", "prefill_chunks", "spec_accepted", "tokens",
              "prefix_copies"):
        assert e2.stats[k] == e1.stats[k], k
    assert e2.compile_counts == e1.compile_counts
    assert_compile_contract(e2)
    je = jax_engine.InferenceEngine(
        JaxDecoder(lm["jsym"], lm["jparams"], max_len=T, cache_block=None),
        slots=2, prefill_buckets=(4, 8), attn_impl="paged", **GAUNTLET)
    jr = [je.submit(p, max_tokens=n) for p, n in cases]
    je.serve_forever()
    assert [r.result().tolist() for r in jr] == want
    assert e2.compile_counts == je.compile_counts
    snap = port_tele.snapshot()["serving"]
    assert snap["tp_degree"] == 2
    assert e2.snapshot()["engine"]["tp"] == 2
    log = len(e2._compile_log)
    assert _serve(e2, cases[::-1]) == want[::-1]
    assert len(e2._compile_log) == log and e2.idle
    for e in (e1, e2):
        e.close()


def test_tp4_snapshot_restores_at_tp4_and_tp1(lm):
    """(b) tp=4 (one kv head a rank) with ``steps_per_round=3``: a
    snapshot taken mid-flight restores at tp=4 (the geometry's degree)
    and at tp=1 (an override), and both continue byte-identically to the
    uninterrupted run."""
    rng = np.random.RandomState(11)
    cases = [(rng.randint(0, VOCAB, (pl,)), n)
             for pl, n in [(2, 5), (6, 4), (4, 6), (3, 5)]]
    eng = _engine(lm, tp=4, steps_per_round=3)
    rs = [eng.submit(p, max_tokens=n) for p, n in cases]
    for _ in range(3):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    assert snap["engine"]["tp"] == 4
    assert any(r["tokens"] for r in snap["requests"])
    e4, h4 = Engine.restore(snap, _dec(lm))
    e1, h1 = Engine.restore(snap, _dec(lm), tp=1)
    assert (e4.tp, e1.tp) == (4, 1) and e1._mesh is None
    eng.serve_forever()
    for e in (e4, e1):
        e.serve_forever()
    for (p, n), r in zip(cases, rs):
        want = _oracle(lm, p, n)
        assert r.result().tolist() == want
        for handles in (h4, h1):
            assert handles.get(r.id, r).result().tolist() == want
    for e in (eng, e4, e1):
        assert_compile_contract(e, copy={})
        e.close()


def test_tp2_int8_kv_equals_tp1(lm):
    """(c) An int8 KV cache at tp=2 (values and row scales sharded alike:
    a row's scale is one head's) serves the streams of int8 KV at tp=1."""
    rng = np.random.RandomState(5)
    cases = [(rng.randint(0, VOCAB, (pl,)), n)
             for pl, n in [(3, 5), (4, 4), (2, 6)]]
    kw = dict(dec_kw=dict(cache_dtype="int8"), prefill_buckets=(4,))
    e1, e2 = _engine(lm, **kw), _engine(lm, tp=2, **kw)
    assert _serve(e2, cases) == _serve(e1, cases)
    for t in e2._caches:
        assert [b.dtype for b in t[0]] == [torch.int8, torch.float32] * 2
    _assert_shards(e2._caches, 2)
    for e in (e1, e2):
        assert_compile_contract(e, verify=0, copy={})
        e.close()


def test_tp2_int8_weights_equal_tp1(lm):
    """(d) int8 weights (replicated: the products run once) with int8 KV
    at tp=2 equal tp=1, the ``quant_matmul`` route included
    (``matmul_impl="pallas"``: the fused step is not eligible under tp)."""
    rng = np.random.RandomState(5)
    cases = [(rng.randint(0, VOCAB, (pl,)), n)
             for pl, n in [(3, 5), (4, 4), (2, 6)]]
    out = []
    for tp in (1, 2):
        e = _engine(lm, dec_kw=dict(cache_dtype="int8",
                                    matmul_impl="pallas"),
                    prefill_buckets=(4,), weight_dtype="int8", tp=tp)
        out.append(_serve(e, cases))
        assert_compile_contract(e, verify=0, copy={})
        e.close()
    assert out[0] == out[1]


DECODER_CASES = {
    "mha": (dict(), dict()),
    "gqa_rope": (dict(num_kv_heads=2, pos_encoding="rope"), dict()),
    "int8_kv": (dict(), dict(cache_dtype="int8")),
}


@pytest.mark.parametrize("case", list(DECODER_CASES))
def test_run_slots_tp2_equals_tp1(case):
    """(e) The decoder alone: ``_run_slots`` over a cache sharded by
    ``init_cache(kv_sharding=NamedSharding(mesh, P(None, None,
    "model")))`` gives tp=1's logits within 1e-6 (f32) and its greedy
    tokens, through a prefill chunk, decode steps, a verify step and a
    draft proposal; the sharded rows of ``slot_prefix_rows`` are the
    unsharded ones cut on the head axis, and ``slot_write_prefix_rows``
    writes them back."""
    lm_kw, dec_kw = DECODER_CASES[case]
    with TorchNames():
        sym = torch_lm(VOCAB, **CFG, **lm_kw)
    params = _params(sym, np.random.RandomState(3))
    dec = Decoder(sym, params, max_len=T, device="cpu", **dec_kw)
    tp = ("model", 2)
    mesh = model_parallel_mesh(2, devices=["cpu"] * 2)
    c1 = dec.init_cache(3)
    c2 = dec.init_cache(3, kv_sharding=NamedSharding(
        mesh, P(None, None, "model")))
    assert Decoder.cache_specs(c1) == [
        (P(None, None, "model"),) * len(c1[0])]
    rng = np.random.RandomState(4)
    pos = torch.tensor([0, 2, 5], dtype=torch.int32)
    toks = torch.from_numpy(rng.randint(0, VOCAB, (3, 4)))
    for step in range(4):
        a, _ = dec._run_slots(dec._params, dec._aux, c1, pos, toks)
        b, _ = dec._run_slots(dec._params, dec._aux, c2, pos, toks, tp=tp)
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
        assert torch.equal(a.argmax(-1), b.argmax(-1))
        pos = pos + toks.shape[1]
        toks = a.argmax(-1)[:, -1:]
    uniform = torch.rand(3, T, generator=torch.Generator().manual_seed(0))
    state = (pos, toks[:, 0], torch.ones(3, dtype=torch.bool),
             torch.zeros(3), uniform, torch.full((3,), -1), torch.full(
                 (3,), T - 1, dtype=torch.int32))
    drafts = torch.from_numpy(rng.randint(0, VOCAB, (3, 2)))
    dlen = torch.tensor([2, 1, 0])
    _, s1, o1 = dec.verify_step_slots(dec._params, dec._aux, c1, state,
                                      drafts, dlen)
    _, s2, o2 = dec.verify_step_slots(dec._params, dec._aux, c2, state,
                                      drafts, dlen, tp=tp)
    assert torch.equal(o1, o2) and torch.equal(s1[0], s2[0])
    catch = torch.from_numpy(rng.randint(0, VOCAB, (3, 3)))
    clen = torch.tensor([3, 1, 2])
    _, d1 = dec.draft_propose_slots(dec._params, dec._aux, c1, s1[0],
                                    catch, clen, 3)
    _, d2 = dec.draft_propose_slots(dec._params, dec._aux, c2, s1[0],
                                    catch, clen, 3, tp=tp)
    assert torch.equal(d1, d2)
    r1 = Decoder.slot_prefix_rows(c1, 1, 8)
    r2 = Decoder.slot_prefix_rows(c2, torch.tensor(1), 8)
    for e1, e2a, e2b in zip(r1, r2[0], r2[1]):
        for x, ya, yb in zip(e1, e2a, e2b):
            assert torch.equal(x, torch.cat([ya, yb], dim=2))
    Decoder.slot_write_prefix_rows(c2, 0, r2)
    for t in c2:
        for entry in t:
            for buf in entry:
                assert torch.equal(buf[0, :8], buf[1, :8])


def test_shards_and_the_per_shard_gauge(lm):
    """(f) The slot cache, the prefix pool, the staging caches and the
    draft model's caches are one allocation set a rank, every buffer
    ``[S, L, Hkv/tp, D]`` and contiguous; the ``kv_bytes_per_shard``
    gauge is the slot cache's bytes over tp, and the byte budgets (the
    pool's slot count) do not depend on the degree."""
    dd = _dec(lm)
    e1 = _engine(lm, prefix_cache_mb=0.02, draft="model", draft_decoder=dd)
    total = port_tele.snapshot()["serving"]["kv_bytes_per_shard"]
    for tp in (2, 4):
        eng = _engine(lm, tp=tp, prefix_cache_mb=0.02, draft="model",
                      draft_decoder=dd)
        for tree in (eng._caches, eng._cache_bufs, eng._draft_caches):
            _assert_shards(tree, tp)
        for tree in (eng._stage, eng._draft_stage):
            _assert_shards(tree, tp, rows=T + 8)
        for t in eng._caches:
            for entry in t:
                for b in entry:
                    assert tuple(b.shape) == (2, T, HEADS // tp,
                                              EMBED // HEADS)
        assert len(eng._groups) == len(e1._groups) * tp
        assert eng._prefix.capacity == e1._prefix.capacity >= 2
        gauge = port_tele.snapshot()["serving"]
        assert gauge["tp_degree"] == tp
        assert gauge["kv_bytes_per_shard"] * tp == total
        eng.close()
    e1.close()


def _mesh_no_model_axis():
    return build_mesh({"dp": 2}, ["cpu"] * 2)


REFUSALS = {
    "tp3_uneven": (dict(tp=3), "divide evenly"),
    "tp0": (dict(tp=0), "tp must be >= 1"),
    "no_model_axis": (dict(mesh="no_model"), "'model' axis"),
    "disagrees": (dict(mesh="cpu2", tp=4), "disagrees"),
    "not_a_mesh": (dict(mesh=object()), "parallel.Mesh"),
    "distinct_cards": (dict(mesh="cuda01"), "later slice"),
    "ep2": (dict(ep=2), "needs a MoE decoder"),
    "draft_uneven": (dict(tp=4, draft="model", draft_decoder="kv2"),
                     "divide evenly"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_tp_refusals_build_nothing(lm, case):
    """(g) Each refusal raises at construction, before any cache or
    program exists."""
    kw, match = REFUSALS[case]
    kw = dict(kw)
    meshes = {"no_model": _mesh_no_model_axis,
              "cpu2": lambda: model_parallel_mesh(2, devices=["cpu"] * 2),
              "cuda01": lambda: model_parallel_mesh(
                  2, devices=["cuda:0", "cuda:1"])}
    if isinstance(kw.get("mesh"), str):
        kw["mesh"] = meshes[kw["mesh"]]()
    if kw.get("draft_decoder") == "kv2":
        with TorchNames():
            sym = torch_lm(VOCAB, num_kv_heads=2, **CFG)
        kw["draft_decoder"] = Decoder(
            sym, _params(sym, np.random.RandomState(1)), max_len=T,
            device="cpu")
    with pytest.raises(MXNetError, match=match):
        _engine(lm, **kw)


def test_tp_is_resolved_as_the_jax_engine_resolves_it(lm, monkeypatch):
    """(g) An explicit mesh wins the degree, ``MXNET_SERVING_TP`` is the
    default without one, a CPU engine's ranks default to the host, and a
    mesh with the ``model`` axis beside others takes that axis's ranks."""
    eng = _engine(lm, mesh=model_parallel_mesh(2, devices=["cpu"] * 2))
    assert eng.tp == 2 and eng._geometry()["tp"] == 2
    eng.close()
    monkeypatch.setenv("MXNET_SERVING_TP", "4")
    eng = _engine(lm)
    assert eng.tp == 4
    assert [str(d) for d in eng._mesh.axis_devices("model")] == ["cpu"] * 4
    eng.close()
    assert _engine(lm, tp=1)._mesh is None
    mesh = build_mesh({"dp": 1, "model": 2}, ["cpu"] * 2)
    eng = _engine(lm, mesh=mesh, tp=2)
    assert eng.tp == 2 and len(eng._caches) == 2
    eng.close()


@pytest.mark.parametrize("degrees", [(2, 1), (1, 2)],
                         ids=["tp2_prefill_tp1_decode",
                              "tp1_prefill_tp2_decode"])
@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_handoff_across_degrees(lm, degrees, dtype):
    """(h) A package does not depend on the degree that made it: a tp=2
    prefill specialist's payload equals a tp=1 one's bit for bit (the
    int8 wire's scale is taken over the full-head rows), and a tp=2 decode
    specialist continues a package as a tp=1 one does: with native rows,
    the streams equal unified tp=1."""
    rng = np.random.RandomState(21)
    cases = [(rng.randint(0, VOCAB, (pl,)), n) for pl, n in [(6, 5), (3, 7)]]
    ref = _engine(lm)
    want = _serve(ref, cases)
    ref.close()
    tpp, tpd = degrees
    payloads = {}
    for tp in {1, tpp}:
        ep = _engine(lm, role="prefill", tp=tp, handoff_dtype=dtype)
        for p, n in cases:
            ep.submit(p, max_tokens=n)
        pkgs = []
        for _ in range(20):
            ep.step()
            pkgs += ep.take_handoffs()
        assert len(pkgs) == len(cases)
        payloads[tp] = [pkg.payload() for pkg in pkgs]
        for pkg in pkgs:
            pkg.resolve()
        ep.close()
    for a, b in zip(payloads[1], payloads[tpp]):
        for ea, eb in zip(a["rows"], b["rows"]):
            for x, y in zip(ea, eb):
                if dtype == "int8" and hasattr(x, "q"):
                    assert torch.equal(x.q, y.q)
                    assert torch.equal(x.scale, y.scale)
                else:
                    assert torch.equal(x, y)
    got = {}
    for tp in {1, tpd}:
        ed = _engine(lm, role="decode", tp=tp)
        reqs = [ed.admit_handoff(pl) for pl in payloads[tpp]]
        ed.serve_forever()
        got[tp] = [r.tokens for r in reqs]
        assert_compile_contract(ed, prefill={}, copy={})
        ed.close()
    assert got[tpd] == got[1]
    if dtype == "native":
        assert got[tpd] == want


def test_replay_across_degrees(lm, tmp_path, capsys):
    """(i) The capture header carries the degree. A tp=1 capture replays
    clean at ``--tp 2 --verify``, a tp=2 capture at ``--tp 1`` and at its
    own degree (the header's), on ``--device cpu``."""
    prefix = str(tmp_path / "lm")
    save_checkpoint(prefix, 0, lm["symbol"], lm["params"], {})
    rng = np.random.RandomState(8)
    cases = [(rng.randint(0, VOCAB, (pl,)), n)
             for pl, n in [(3, 6), (5, 4), (2, 9)]]
    paths = {}
    for tp in (1, 2):
        d = tmp_path / ("cap%d" % tp)
        eng = _engine(lm, tp=tp, capture_dir=str(d))
        _serve(eng, cases)
        paths[tp] = eng.capture.path
        eng.close()
        assert port_capture.load_capture(paths[tp])["engine"]["tp"] == tp
    base = ["--checkpoint", prefix, "--device", "cpu", "--timing", "max",
            "--verify"]
    for path, extra, tp in ((paths[1], ["--tp", "2"], 2),
                            (paths[2], ["--tp", "1"], 1),
                            (paths[2], [], 2)):
        assert port_replay.main([path] + base + extra) == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rep["mismatches"] == [] and rep["verified"] == len(cases)
        assert rep["overrides"].get("tp", tp) == tp


def test_jax_tp2_snapshot_and_capture_serve_on_the_port(lm, tmp_path):
    """A JAX tp=2 engine's snapshot restores on the port at tp=2 (its
    geometry's degree) and at tp=1 (an override), and its capture's header
    builds a tp=2 port engine that replays it; the streams equal the JAX
    offline decoder's. The JAX engine is only built and fed: no program of
    it runs."""
    rng = np.random.RandomState(9)
    cases = [(rng.randint(0, VOCAB, (pl,)), n)
             for pl, n in [(4, 6), (2, 8), (7, 5)]]
    je = jax_engine.InferenceEngine(
        JaxDecoder(lm["jsym"], lm["jparams"], max_len=T, cache_block=None),
        slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0, tp=2,
        capture_dir=str(tmp_path))
    for p, n in cases:
        je.submit(p, max_tokens=n)
    snap = json.loads(json.dumps(je.snapshot()))
    assert snap["engine"]["tp"] == 2
    want = [_oracle(lm, p, n) for p, n in cases]
    for over, tp in (({}, 2), ({"tp": 1}, 1)):
        eng, handles = Engine.restore(snap, _dec(lm), **over)
        assert eng.tp == tp
        eng.serve_forever()
        assert [handles[r["id"]].result().tolist()
                for r in snap["requests"]] == want
        eng.close()
    cap = port_capture.load_capture(je.capture.path)
    eng = port_replay.build_engine(cap, _dec(lm))
    assert eng.tp == 2 and len(eng._caches) == 2
    rep = port_replay.replay(cap, eng, timing="max")
    assert rep["replayed"] == len(cases)
    assert rep["tokens"] == sum(len(w) for w in want)
    eng.close()
