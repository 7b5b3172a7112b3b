"""The port's engine under hostile traffic and partial failures, against the
JAX package's engine, on the CPU: each scenario of
``tests/test_serving_faults.py`` — cancel, deadlines, overload, the
watchdog, ``serve_forever`` ingest errors, submit validation, poison,
crash -> restore under prefix + chunk + n-gram, restore beyond a bucket, a
snapshot in the middle of a verify round, close — run the same way on
both engines.

The two must agree on each request's retire reason and tokens (a
survivor's greedy stream equals both the other engine's and the JAX
offline ``Decoder.generate``; a host-retired request's partial stream is
the same prefix on both), on the ``stats`` deltas and the ``serving.*``
telemetry counter deltas (each package's own registry), and on
``compile_counts``. Free slots and prefix pins return to their starting
values on every path. Also: a JAX ``snapshot()`` restored onto the port's
engine and a port snapshot restored onto the JAX engine both continue
byte-identically.

A restored engine does other work than the JAX one by design: it prefills
each prompt and regenerates the emitted tokens through its rounds, where
the JAX engine prefills prompt + emitted (the port's ``Request`` says why).
So in the restore scenarios the restored engines' own ``stats`` and
``compile_counts`` are not compared (each must keep the compile contract),
and of the counters only those a request's outcome decides (``OUTCOME``).

The LM is ``tests/test_torch_engine_reuse.py``'s (1 layer, vocab 17,
max_len 16, seeded numpy weights, f32), carried across by the existing
conversion; the JAX engines serve ``attn_impl="paged"`` as the port's do,
so that their snapshots carry the same geometry. As in the JAX file, two
module-scoped engine pairs serve almost every scenario — a plain pair
(its ``overload``/``max_queue``/``round_timeout_ms`` knobs flipped and
restored per test; the close test consumes it LAST) and a prefix-cache +
chunked-prefill + n-gram pair.
"""
import collections
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import telemetry as jax_tele
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import engine as jax_engine
from mxnet_tpu.testing import faults as jax_faults

from mxnet_tpu_torch import telemetry as port_tele
from mxnet_tpu_torch.base import MXNetError as PortError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.serving import engine as port_engine
from mxnet_tpu_torch.testing import faults as port_faults

from check_utils import assert_compile_contract

pytestmark = pytest.mark.faults

VOCAB, T = 17, 16
CFG = dict(num_layers=1, embed_dim=16, num_heads=2)
PLAIN = dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0)
# one pool slot: a 1-layer f32 slot is 2 KiB
REUSE = dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0.0021,
             prefill_chunk=3, spec_k=3, draft="ngram")

# one package's side of a scenario: its engine module, error base,
# fault injector module and telemetry registry, and a fresh decoder
Side = collections.namedtuple("Side", "name engine error faults tele mkdec")


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
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def jax_dec():
        return JaxDecoder(js, jparams, max_len=T, cache_block=None)

    def port_dec():
        return Decoder(ts, params, max_len=T, device="cpu")
    return {"jax": Side("jax", jax_engine, JaxError, jax_faults, jax_tele,
                        jax_dec),
            "port": Side("port", port_engine, PortError, port_faults,
                         port_tele, port_dec),
            "oracle": jax_dec()}


def _build(side, **kw):
    extra = dict(attn_impl="paged") if side.name == "jax" else {}
    return side.engine.InferenceEngine(side.mkdec(), **kw, **extra)


@pytest.fixture(scope="module")
def feng(lm):
    """The plain pair (cache off). Tests flip its mutable policy knobs
    and MUST restore them and drain it to idle; the close test (last in
    the file) consumes it."""
    return {k: _build(lm[k], **PLAIN) for k in ("jax", "port")}


@pytest.fixture(scope="module")
def ceng(lm):
    """The prefix-cache + chunked-prefill + n-gram pair (a one-slot
    pool)."""
    out = {k: _build(lm[k], **REUSE) for k in ("jax", "port")}
    assert all(e._prefix.capacity == 1 for e in out.values())
    return out


_ORACLE = {}


def _oracle(lm, prompt, n):
    """The JAX offline greedy continuation, truncated at the cache end."""
    prompt = np.asarray(prompt)
    n = min(n, T - len(prompt))
    key = (prompt.tobytes(), n)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(lm["oracle"].generate(
            prompt[None], num_steps=n))[0, len(prompt):].tolist()
    return _ORACLE[key]


def _counters(side):
    return {n: m.value for n, m in list(side.tele._state.metrics.items())
            if n.startswith("serving.") and m.kind == "counter"}


# the serving.* counters a request's outcome decides; the others count
# scheduling (rounds, prefill pieces, prefix reuse, drafts, builds)
OUTCOME = ("serving." + n for n in (
    "tokens", "completed", "retired_eos", "retired_length", "prefills",
    "shed", "deadline_missed", "cancelled", "request_errors",
    "watchdog_trips", "restores"))
OUTCOME = frozenset(OUTCOME)


def _both(lm, engines, scenario, counters=None):
    """Run ``scenario(side, engine)`` (it returns its requests, a list)
    on the JAX engine, then the port's. Asserts that the two agree on
    each request's retire reason and tokens, on the ``stats`` deltas of
    ``engines`` and on the ``serving.*`` counter deltas (only those in
    ``counters`` when given). Returns {side name: (requests, stats delta,
    counter delta)}."""
    out = {}
    for name in ("jax", "port"):
        side, eng = lm[name], engines[name]
        s0, c0 = dict(eng.stats), _counters(side)
        reqs = scenario(side, eng)
        c1 = _counters(side)
        out[name] = (reqs,
                     {k: eng.stats[k] - s0[k] for k in eng.stats},
                     {k: c1[k] - c0.get(k, 0) for k in c1})
    (jr, js, jc), (pr, ps, pc) = out["jax"], out["port"]
    assert [(r.retire_reason, r.tokens) for r in pr] == \
        [(r.retire_reason, r.tokens) for r in jr]
    assert ps == {k: js[k] for k in ps}
    keep = [k for k in pc if counters is None or k in counters]
    assert {k: pc[k] for k in keep} == {k: jc.get(k) for k in keep}, \
        {k: (pc[k], jc.get(k)) for k in keep if pc[k] != jc.get(k)}
    return out


def _drained(eng):
    assert eng.idle and len(eng._free) == eng.slots
    if eng._prefix is not None:
        assert eng._prefix.pinned == 0


def test_cancel_queued_and_inflight(lm, feng):
    rng = np.random.RandomState(1)
    p1, p2, p3 = (rng.randint(0, VOCAB, (4,)) for _ in range(3))

    def scenario(side, eng):
        r1 = eng.submit(p1, max_tokens=6)
        r2 = eng.submit(p2, max_tokens=6)
        r3 = eng.submit(p3, max_tokens=6)      # 2 slots -> r3 queued
        eng.step()
        eng.step()
        assert eng.cancel(r3.id)               # still queued
        assert eng.cancel(r1.id)               # decoding in a slot
        eng.serve_forever()
        assert r1.retire_reason == "cancelled" and r1.done
        assert r3.retire_reason == "cancelled" and r3.t_admit is None
        got = r1.result()                      # partial, not an error
        assert got.tolist() == _oracle(lm, p1, 6)[:len(got)]
        assert r3.result().size == 0
        assert r2.result().tolist() == _oracle(lm, p2, 6)
        assert not eng.cancel(r1.id) and not eng.cancel("nope")
        _drained(eng)
        return [r1, r2, r3]
    out = _both(lm, feng, scenario)
    assert out["port"][2]["serving.cancelled"] == 2
    assert out["port"][1]["cancelled"] == 2


def test_deadlines_queued_and_inflight(lm, feng):
    rng = np.random.RandomState(2)
    p1, p2 = rng.randint(0, VOCAB, (4,)), rng.randint(0, VOCAB, (4,))

    def scenario(side, eng):
        ra = eng.submit(p1, max_tokens=6)
        rb = eng.submit(p2, max_tokens=6, ttft_deadline_ms=0.0)
        rc = eng.submit(p2, max_tokens=6, deadline_ms=0.0)
        eng.serve_forever()
        assert rb.retire_reason == "deadline" and rb.t_admit is None
        assert rc.retire_reason == "deadline"
        assert ra.result().tolist() == _oracle(lm, p1, 6)
        # in-flight expiry: a few rounds, then the deadline forced past
        rd = eng.submit(p1, max_tokens=6, deadline_ms=1e9)
        eng.step()
        eng.step()
        eng.step()
        rd._deadline = 0.0
        eng.serve_forever()
        assert rd.retire_reason == "deadline"
        got = rd.result()
        assert got.tolist() == _oracle(lm, p1, 6)[:len(got)]
        _drained(eng)
        # the snapshot carries the REMAINING deadline budget
        re_ = eng.submit(p1, max_tokens=6, deadline_ms=0.0)
        assert eng.snapshot()["requests"][0]["deadline_ms"] <= 0
        eng.cancel(re_.id)
        eng.serve_forever()
        return [ra, rb, rc, rd, re_]
    out = _both(lm, feng, scenario)
    assert out["port"][2]["serving.deadline_missed"] == 3


def test_overload_shed_and_shed_oldest(lm, feng):
    rng = np.random.RandomState(3)
    p = rng.randint(0, VOCAB, (4,))

    def scenario(side, eng):
        Overloaded = side.engine.EngineOverloaded
        eng.overload, eng.max_queue = "shed", 0
        try:
            with pytest.raises(Overloaded, match="overloaded"):
                eng.submit(p, max_tokens=6)
            eng.overload, eng.max_queue = "shed_oldest", 1
            g1 = eng.submit(p, max_tokens=6)           # queued
            g2 = eng.submit(p, max_tokens=6)           # evicts g1
            assert g1.done and g1.retire_reason == "shed"
            with pytest.raises(Overloaded, match="shed_oldest"):
                g1.result()
            assert g1.tokens == []
            eng.step()                                 # g2 admitted
            g3 = eng.submit(p, max_tokens=6)           # queued behind g2
            # an INADMISSIBLE submit never sheds valid queued work
            with pytest.raises(side.error, match="integers"):
                eng.submit(np.asarray([1.5, 2.5]), max_tokens=6)
            assert not g3.done
            g4 = eng.submit(p, max_tokens=6)           # evicts g3, not g2
            assert g3.done and g3.retire_reason == "shed"
            assert not g2.done
        finally:
            eng.overload, eng.max_queue = "block", 256
        eng.max_queue = 0
        try:
            with pytest.raises(side.error, match="queue is full"):
                eng.submit(p, max_tokens=6)
        finally:
            eng.max_queue = 256
        eng.serve_forever()
        assert g2.result().tolist() == _oracle(lm, p, 6)
        assert g4.result().tolist() == _oracle(lm, p, 6)
        _drained(eng)
        return [g1, g2, g3, g4]
    out = _both(lm, feng, scenario)
    # one fast-fail shed + two shed_oldest evictions
    assert out["port"][2]["serving.shed"] == 3


def test_watchdog_trip_and_recovery(lm, feng):
    """A wedged round trips the watchdog with EngineStuck; health() says
    stuck until a drain succeeds; the SAME engine then finishes the
    request byte-identically. A stall shorter than the timeout never
    trips."""
    rng = np.random.RandomState(4)
    p = rng.randint(0, VOCAB, (4,))

    def scenario(side, eng):
        eng.round_timeout_ms = 60.0
        fi = side.faults.FaultInjector()
        try:
            w = eng.submit(p, max_tokens=6)
            with fi.serving_round_hang(seconds=60):
                with pytest.raises(side.engine.EngineStuck,
                                   match="round_timeout_ms"):
                    eng.serve_forever()
            assert not w.done and eng.health()["stuck"]
            eng.serve_forever()          # the injector is gone: recovered
            assert not eng.health()["stuck"]
            assert w.result().tolist() == _oracle(lm, p, 6)
            assert fi.log and fi.log[0][0] == "hang"
            w2 = eng.submit(p, max_tokens=6)
            with fi.serving_round_hang(seconds=0.01):
                eng.serve_forever()      # transient: no trip
            assert w2.result().tolist() == _oracle(lm, p, 6)
        finally:
            eng.round_timeout_ms = 0.0
        _drained(eng)
        return [w, w2]
    out = _both(lm, feng, scenario)
    assert out["port"][2]["serving.watchdog_trips"] == 1
    assert out["port"][1]["watchdog_trips"] == 1


def test_serve_forever_ingest_error_drains_or_sheds(lm, feng):
    rng = np.random.RandomState(5)
    ps = [rng.randint(0, VOCAB, (4,)) for _ in range(4)]

    def scenario(side, eng):
        hs = []

        def arrivals():
            hs.append(eng.submit(ps[0], max_tokens=6))
            hs.append(eng.submit(ps[1], max_tokens=6))
            yield None                   # engine steps: both admitted
            hs.append(eng.submit(ps[2], max_tokens=6))   # queued
            hs.append(eng.submit(ps[3], max_tokens=6))
            raise ValueError("ingest boom")

        with pytest.raises(ValueError, match="ingest boom"):
            eng.serve_forever(arrivals())
        for h, p in zip(hs, ps):         # ALL finished first (block)
            assert h.result().tolist() == _oracle(lm, p, 6)
        hs2 = []

        def arrivals2():
            hs2.append(eng.submit(ps[0], max_tokens=6))
            yield None                   # admitted
            for p in ps[1:]:
                hs2.append(eng.submit(p, max_tokens=6))
            raise ValueError("boom2")

        eng.overload = "shed"
        try:
            with pytest.raises(ValueError, match="boom2"):
                eng.serve_forever(arrivals2())
        finally:
            eng.overload = "block"
        assert hs2[0].result().tolist() == _oracle(lm, ps[0], 6)
        shed = [h for h in hs2[1:] if h.retire_reason == "shed"]
        assert shed
        for h in shed:
            with pytest.raises(side.engine.EngineOverloaded,
                               match="stream raised"):
                h.result()
        assert all(h.retire_reason in ("shed", "length") for h in hs2)
        _drained(eng)
        with pytest.raises(side.error, match="max_tokens"):
            eng.serve_forever(iter([dict(prompt=[1, 2], max_tokens=0)]))
        assert eng.idle
        return hs + hs2
    _both(lm, feng, scenario)


BAD_SUBMITS = [
    ("max_tokens", dict(max_tokens=0)), ("max_tokens", dict(max_tokens=-3)),
    ("eos_id", dict(max_tokens=2, eos_id=[3, 4])),
    ("eos_id", dict(max_tokens=2, eos_id=2.5)),
    ("eos_id", dict(max_tokens=2, eos_id=-2)),
    ("temperature", dict(max_tokens=2, temperature=float("nan"))),
    ("temperature", dict(max_tokens=2, temperature=float("inf"))),
    ("temperature", dict(max_tokens=2, temperature=-0.5)),
    ("temperature", dict(max_tokens=2, temperature=[0.5, 0.9]))]


def test_submit_validation_rejects_bad_scalars(lm, feng):
    for name in ("jax", "port"):
        side, eng = lm[name], feng[name]
        for what, kw in BAD_SUBMITS:
            with pytest.raises(side.error, match=what):
                eng.submit([1, 2], **kw)
        with pytest.raises(side.error, match="overload"):
            side.engine.InferenceEngine(eng._dec, overload="drop")
        with pytest.raises(side.error, match="round_timeout_ms"):
            side.engine.InferenceEngine(eng._dec, round_timeout_ms=-1)
        assert eng.idle


def test_poisoned_request_retires_alone(lm, ceng):
    """An injected staging fault retires ONLY its request with a typed
    error; the co-resident request is unaffected, and the pins and slots
    drain back. The failed request's flight timeline has the same events,
    in the same order and with the same fields, on both engines."""
    rng = np.random.RandomState(6)
    pa = rng.randint(0, VOCAB, (7,))
    pb = rng.randint(0, VOCAB, (4,))
    timelines = {}

    def scenario(side, eng):
        r_ok = eng.submit(pa, max_tokens=3)
        eng.step()
        eng.step()
        eng.step()                  # all 3 chunks dispatched; decoding
        assert not eng._chunking
        fi = side.faults.FaultInjector()
        with fi.serving_h2d_failures(1):
            r_bad = eng.submit(pb, max_tokens=6, deadline_ms=60000.0)
            eng.serve_forever()
        assert r_bad.done and r_bad.retire_reason == "error"
        with pytest.raises(side.error, match="poisoned"):
            r_bad.result()
        assert fi.log == [("h2d_fail", r_bad.id)]
        assert r_ok.result().tolist() == _oracle(lm, pa, 3)
        _drained(eng)
        timelines[side.name] = [eng.flight.timeline(r.id)
                                for r in (r_bad, r_ok)]
        return [r_ok, r_bad]
    out = _both(lm, ceng, scenario)
    assert out["port"][2]["serving.request_errors"] == 1
    for jt, pt in zip(timelines["jax"], timelines["port"]):
        assert [(e["event"], sorted(e)) for e in pt["events"]] == \
            [(e["event"], sorted(e)) for e in jt["events"]]
        assert pt["meta"] == jt["meta"] and not pt["live"]
    bad = timelines["port"][0]
    assert bad["meta"]["retire_reason"] == "error"
    assert "poisoned" in bad["events"][-1]["error"]


@pytest.mark.parametrize("how", ["cancel", "deadline"])
def test_retire_mid_chunk_releases_the_prefix_pin(lm, ceng, how):
    """A request cancelled or past its deadline while it is still being
    prefilled in pieces, holding a prefix-cache pin from its hit, gives
    the pin and its slot back at the next round."""
    rng = np.random.RandomState(14)
    base = rng.randint(0, VOCAB, (7,))
    long_ = np.concatenate([base[:6], rng.randint(0, VOCAB, (4,))])

    def scenario(side, eng):
        first = eng.submit(base, max_tokens=2)
        eng.serve_forever()                  # base retained in the pool
        r = eng.submit(long_, max_tokens=3, deadline_ms=1e9)
        eng.step()                           # hit copy + the first piece
        assert r.prefix_hit_tokens == 6 and eng._chunking
        assert eng._prefix.pinned == 1
        if how == "cancel":
            assert eng.cancel(r.id)
        else:
            r._deadline = 0.0
        eng.step()
        assert r.done and eng._prefix.pinned == 0
        assert not eng._chunking
        eng.serve_forever()
        _drained(eng)
        return [first, r]
    out = _both(lm, ceng, scenario)
    want = "cancelled" if how == "cancel" else "deadline_missed"
    assert out["port"][1][want] == 1


def test_cancel_drops_the_slots_draft_context(lm):
    """Cancelling a request under draft-model speculation drops its slot's
    draft backlog (the next occupant's draft cache must not catch up on a
    dead request's tokens) and its n-gram drafter; the co-resident
    request's stream is unaffected."""
    side = lm["port"]
    eng = _build(side, slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0,
                 spec_k=3, draft="model", draft_decoder=side.mkdec())
    rng = np.random.RandomState(15)
    pa, pb = rng.randint(0, VOCAB, (4,)), rng.randint(0, VOCAB, (5,))
    ra = eng.submit(pa, max_tokens=9)
    rb = eng.submit(pb, max_tokens=9)
    while len(rb.tokens) < 2:
        eng.step()
    slot = eng._mirror.index(rb)
    pos = eng._draft_pos[slot]
    assert eng.cancel(rb.id)
    eng.step()        # drains rb's last round, then retires it
    assert rb.retire_reason == "cancelled" and slot in eng._free
    # the draft program caught the freed slot up on nothing
    assert eng._draft_pending[slot] == [] and eng._draft_pos[slot] == pos
    eng.serve_forever()
    assert ra.result().tolist() == _oracle(lm, pa, 9)
    _drained(eng)
    eng.close()


def test_crash_mid_round_restore_byte_identical(lm, ceng):
    """Kill mid-round (tokens dispatched but undrained), snapshot(), then
    restore() onto a fresh engine: every request resumes and its greedy
    stream equals an uninterrupted run's — a plain request, a prefix HIT,
    a chunked prompt and one whose resumed sequence exceeds the largest
    bucket. The snapshots of the two engines are equal JSON."""
    rng = np.random.RandomState(7)
    base = rng.randint(0, VOCAB, (7,))
    cases = [(base, 3), (base[:4].copy(), 6),
             (rng.randint(0, VOCAB, (10,)), 3),
             (rng.randint(0, VOCAB, (2,)), 5)]
    snaps = {}

    def scenario(side, eng):
        rs = [eng.submit(p, max_tokens=n) for p, n in cases]
        fi = side.faults.FaultInjector()
        with fi.serving_crash_mid_round(1):
            with pytest.raises(side.faults.InjectedCrash):
                for _ in range(20):
                    eng.step()
        assert fi.log[-1][0] == "crash"
        snap = json.loads(json.dumps(eng.snapshot()))
        assert snap["requests"], "crash landed after everything finished"
        snaps[side.name] = snap
        eng2, handles = side.engine.InferenceEngine.restore(
            snap, side.mkdec())
        assert (eng2.prefill_chunk, eng2.overload, eng2.spec_draft,
                eng2.spec_k, eng2._auto_seed) == (
                    eng.prefill_chunk, eng.overload, "ngram", eng.spec_k,
                    eng._auto_seed)
        eng2.serve_forever()
        final = [handles.get(r.id, r) for r in rs]
        for (p, n), h in zip(cases, final):
            assert h.result().tolist() == _oracle(lm, p, n)
        assert eng2.stats["restores"] == 1
        _drained(eng2)
        assert_compile_contract(eng2)
        eng2.close()
        eng.serve_forever()         # the crashed engine drains clean too
        _drained(eng)
        assert_compile_contract(eng)
        return final
    out = _both(lm, ceng, scenario, OUTCOME)
    assert out["port"][2]["serving.restores"] == 1
    for s in snaps.values():
        for r in s["requests"]:
            r.pop("deadline_ms"), r.pop("ttft_deadline_ms")
        s.pop("engine_id")
    assert snaps["port"] == snaps["jax"]
    assert ceng["port"].compile_counts == ceng["jax"].compile_counts


def test_restore_beyond_bucket_prefix_hit_chunking_off(lm, ceng):
    """A restored request whose resumed sequence exceeds the largest
    bucket still takes a prefix hit with chunking OFF."""
    rng = np.random.RandomState(9)
    p_long = rng.randint(0, VOCAB, (6,))
    p_short = p_long[:4].copy()

    def scenario(side, eng):
        r_long = eng.submit(p_long, max_tokens=8)
        r_short = eng.submit(p_short, max_tokens=6)
        while len(r_long.tokens) < 5:
            eng.step()
        snap = eng.snapshot()
        sz = {r["id"]: len(r["prompt"]) + len(r["tokens"])
              for r in snap["requests"]}
        assert sz.get(r_long.id, 0) > 8
        assert 0 < sz.get(r_short.id, 9) <= 8
        snap["requests"].sort(key=lambda r: len(r["prompt"]))
        eng2, handles = side.engine.InferenceEngine.restore(
            snap, side.mkdec(), slots=1, prefill_chunk=0)
        eng2.serve_forever()
        hs, hl = handles[r_short.id], handles[r_long.id]
        assert hs.result().tolist() == _oracle(lm, p_short, 6)
        assert hl.result().tolist() == _oracle(lm, p_long, 8)
        assert hl.prefix_hit_tokens >= 4            # a hit, not an error
        _drained(eng2)
        eng2.close()
        eng.serve_forever()
        _drained(eng)
        return [hs, hl, r_long, r_short]
    _both(lm, ceng, scenario, OUTCOME)


def test_snapshot_mid_speculative_verify_round(lm, ceng):
    """A crash DURING a verify round (drafts dispatched, never drained)
    snapshots to the drained prefix only and restores byte-identically;
    the restored engine drafts too."""
    p = np.array([0, 3, 3])

    def scenario(side, eng):
        r = eng.submit(p, max_tokens=13)
        while len(r.tokens) < 5:
            eng.step()
        fi = side.faults.FaultInjector()
        with fi.serving_crash_mid_round(1):
            with pytest.raises(side.faults.InjectedCrash):
                for _ in range(10):
                    eng.step()
        assert eng._drain and eng._drain[-1][0] == "verify"
        snap = eng.snapshot()
        rec = {x["id"]: x for x in snap["requests"]}[r.id]
        assert 5 <= len(rec["tokens"]) < 13
        eng2, handles = side.engine.InferenceEngine.restore(
            snap, side.mkdec())
        eng2.serve_forever()
        h = handles[r.id]
        assert h.result().tolist() == _oracle(lm, p, 13)
        assert eng2.stats["spec_rounds"] > 0
        _drained(eng2)
        assert_compile_contract(eng2)
        eng2.close()
        eng.serve_forever()
        _drained(eng)
        return [h]
    _both(lm, ceng, scenario, OUTCOME)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_restores_across_packages(lm, ceng, direction):
    """A snapshot taken mid-wave on one package's engine, restored onto
    the other package's engine, continues byte-identically (greedy)."""
    src, dst = direction.split("_to_")
    rng = np.random.RandomState(10)
    cases = [(rng.randint(0, VOCAB, (n,)), b)
             for n, b in ((3, 9), (7, 6), (5, 8))]
    eng = ceng[src]
    rs = [eng.submit(p, max_tokens=b) for p, b in cases]
    for _ in range(6):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    assert any(r["tokens"] for r in snap["requests"])
    side = lm[dst]
    eng2, handles = side.engine.InferenceEngine.restore(snap, side.mkdec())
    assert eng2.migrated_from == eng.engine_id
    eng2.serve_forever()
    for (p, b), r in zip(cases, rs):
        h = handles.get(r.id, r)
        assert h.result().tolist() == _oracle(lm, p, b)
    _drained(eng2)
    eng2.close()
    eng.serve_forever()
    _drained(eng)


def test_restore_regenerates_the_emitted_rows_bit_for_bit(lm):
    """The port's restore prefills the prompt and regenerates the emitted
    tokens through its decode rounds: the restored slot's K/V rows equal
    the uninterrupted run's bit for bit (a prefill of prompt + emitted
    rounds them otherwise), the regenerated tokens are not emitted again,
    and only the new ones count."""
    side = lm["port"]
    prompt = np.random.RandomState(12).randint(0, VOCAB, (5,))
    whole = _build(side, slots=1, prefill_buckets=(8,), prefix_cache_mb=0)
    ref = whole.submit(prompt, max_tokens=10)
    while len(ref.tokens) < 4:
        whole.step()
    snap = json.loads(json.dumps(whole.snapshot()))
    whole.serve_forever()
    eng, handles = port_engine.InferenceEngine.restore(snap, side.mkdec())
    h = handles[ref.id]
    resumed = list(h.tokens)
    assert h.resumed == len(resumed) >= 4
    while h._replay:
        eng.step()
        assert h.tokens == resumed            # nothing emitted again
    eng.serve_forever()
    assert h.tokens == ref.tokens == _oracle(lm, prompt, 10)
    assert eng.stats["tokens"] == 10 - len(resumed)
    rows = len(prompt) + 9                    # every row written
    for a, b in zip(whole._caches, eng._caches):
        for x, y in zip(a, b):
            assert torch.equal(x[0, :rows], y[0, :rows])
    eng.close()
    whole.close()


def test_restore_prefills_again_when_a_regenerated_token_differs(lm):
    """A snapshot whose tokens this engine would not generate (another
    package's or configuration's arithmetic, here a doctored token): the
    request is prefilled over prompt + every recorded token, as the JAX
    engine resumes it, and continues from that history."""
    side = lm["port"]
    prompt = np.random.RandomState(13).randint(0, VOCAB, (4,))
    eng0 = _build(side, **PLAIN)
    r = eng0.submit(prompt, max_tokens=8)
    while len(r.tokens) < 3:
        eng0.step()
    snap = json.loads(json.dumps(eng0.snapshot()))
    eng0.close()
    rec = snap["requests"][0]
    rec["tokens"][1] = (rec["tokens"][1] + 1) % VOCAB
    eng, handles = port_engine.InferenceEngine.restore(snap, side.mkdec())
    eng.serve_forever()
    h = handles[r.id]
    seq = np.concatenate([prompt, rec["tokens"]])
    assert h.tokens == rec["tokens"] + _oracle(lm, seq, 8 - len(seq) + 4)
    assert "replay_diverged" in [e["event"] for e in
                                 eng.flight.timeline(r.id)["events"]]
    _drained(eng)
    eng.close()


def test_close_fails_pending_and_is_idempotent(lm, feng):
    """LAST test on the plain pair: close() fails every pending request
    with EngineClosed (drained tokens stay readable), is idempotent and
    gates submit/step/serve_forever; the engine works as a context
    manager. Also the final compile-contract check for everything this
    file ran on the pair."""
    rng = np.random.RandomState(8)
    p = rng.randint(0, VOCAB, (4,))

    def scenario(side, eng):
        Closed = side.engine.EngineClosed
        c1 = eng.submit(p, max_tokens=6)
        eng.step()
        eng.step()
        eng.step()                  # > drain_depth: first token drains
        c2 = eng.submit(p, max_tokens=6)
        assert_compile_contract(eng, verify=0, prefill={4: 1}, copy={})
        eng.close()
        assert c1.retire_reason == c2.retire_reason == "closed"
        assert len(c1.tokens) >= 1
        with pytest.raises(Closed):
            c1.result()
        for call in (lambda: eng.submit(p, max_tokens=2), eng.step,
                     eng.serve_forever):
            with pytest.raises(Closed):
                call()
        eng.close()                 # idempotent
        assert len(eng._free) == eng.slots and eng.health()["closed"]
        with _build(side, slots=1, prefill_buckets=(4,),
                    prefix_cache_mb=0) as e2:
            x = e2.submit(p, max_tokens=2)
            e2.serve_forever()
        assert e2._closed and x.retire_reason == "length"
        assert x.result().tolist() == _oracle(lm, p, 2)
        with pytest.raises(Closed):
            e2.submit(p, max_tokens=2)
        return [c1, c2, x]
    _both(lm, feng, scenario)
    assert feng["port"].compile_counts == feng["jax"].compile_counts


def test_close_drops_the_engines_device_state(lm):
    """The port's close() lets go of every program and device buffer the
    engine owns (on the card: the captures, their memory pools, the
    caches and the engine's weight copy)."""
    eng = _build(lm["port"], **REUSE)
    eng.submit(np.arange(5) % VOCAB, max_tokens=4)
    eng.serve_forever()
    assert eng._programs and eng._groups is not None
    eng.close()
    assert not eng._programs
    assert all(getattr(eng, n, None) is None
               for n in port_engine._DEVICE_STATE)
    assert eng.snapshot()["requests"] == [] and eng.compile_counts["decode"]
