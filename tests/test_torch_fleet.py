"""The fleet router on the port, against the JAX package: every case of
``tests/test_fleet.py`` — placement (rotation, least-loaded, prefix
affinity), ``(client_id, seq)`` dedup, the draining gate, fleet-wide
overload, a slow replica, a dropped submit and its lost reply, a replica
killed mid-round, a live drain and a successor, a heartbeat blackhole, a
migration whose target dies too, the rolling-restart replay and ``close``
— run the same way on both packages' routers over their own engines.

The two must agree on each request's tokens and retire reason (both equal
the JAX offline ``Decoder.generate``), where each request was placed, the
router's ``stats`` and the ``fleet.*`` counter deltas; every engine keeps
the compile contract and drains clean. Where a replica dies or drains, a
migrated request regenerates its emitted tokens on the port where the JAX
engine prefills them (the port's ``Request`` says why), so there the
engines' scheduling stats are not compared, only the outcome.

The LM is the JAX suite's (1 layer, vocab 17, E=16, 2 heads, max_len 16,
seeded numpy weights, f32). One module-scoped 2-replica fleet a package
serves the non-destructive cases (knobs flipped and restored; the close
case consumes it last); the destructive ones build their own.
"""
import collections
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from mxnet_tpu import telemetry as jax_tele
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import capture as jax_capture
from mxnet_tpu.serving import engine as jax_engine
from mxnet_tpu.serving import fleet as jax_fleet
from mxnet_tpu.testing import faults as jax_faults

from mxnet_tpu_torch import telemetry as port_tele
from mxnet_tpu_torch.base import MXNetError as PortError
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames
from mxnet_tpu_torch.parallel import Decoder
from mxnet_tpu_torch.serving import capture as port_capture
from mxnet_tpu_torch.serving import engine as port_engine
from mxnet_tpu_torch.serving import fleet as port_fleet
from mxnet_tpu_torch.serving import replay as port_replay
from mxnet_tpu_torch.testing import faults as port_faults

from check_utils import assert_compile_contract

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools import replay_serving as jax_replay  # noqa: E402

pytestmark = pytest.mark.faults

VOCAB, T = 17, 16
CFG = dict(num_layers=1, embed_dim=16, num_heads=2)

Side = collections.namedtuple(
    "Side", "name engine fleet faults capture replay tele error mkdec")


@pytest.fixture(scope="module")
def lm():
    with JaxNames():
        js = jax_lm(VOCAB, impl="dense", **CFG)
    with TorchNames():
        ts = torch_lm(VOCAB, **CFG)
    shapes, _, _ = js.infer_shape(data=(2, T), softmax_label=(2, T))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for n, s in zip(js.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def jax_dec():
        return JaxDecoder(js, jparams, max_len=T, cache_block=None)

    def port_dec():
        return Decoder(ts, params, max_len=T, device="cpu")
    return {"jax": Side("jax", jax_engine, jax_fleet, jax_faults,
                        jax_capture, jax_replay, jax_tele, JaxError,
                        jax_dec),
            "port": Side("port", port_engine, port_fleet, port_faults,
                         port_capture, port_replay, port_tele, PortError,
                         port_dec),
            "oracle": JaxDecoder(js, jparams, max_len=T)}


def _mkeng(side, **kw):
    cfg = dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0,
               max_queue=8)
    cfg.update(kw)
    return side.engine.InferenceEngine(side.mkdec(), **cfg)


@pytest.fixture(scope="module")
def fleets(lm):
    """The shared 2-replica fleet of each package (capacity-2 prefix
    pools, heartbeats off, a short channel timeout)."""
    out = {}
    for name in ("jax", "port"):
        side = lm[name]
        engines = [_mkeng(side, prefix_cache_mb=0.0042) for _ in range(2)]
        out[name] = side.fleet.FleetRouter(
            engines, timeout_ms=40, max_retries=3, backoff_ms=1,
            heartbeat_ms=1e6)
    yield out
    for f in out.values():
        f.close()


_ORACLE = {}


def _oracle(lm, prompt, n):
    prompt = np.asarray(prompt)
    n = min(n, T - len(prompt))
    key = (prompt.tobytes(), n)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(lm["oracle"].generate(
            prompt[None], num_steps=n))[0, len(prompt):].tolist()
    return _ORACLE[key]


def _reps(fleet):
    return [fleet.replica(r) for r in fleet.replica_ids()]


def _counters(side):
    return {n: m.value for n, m in list(side.tele._state.metrics.items())
            if n.split(".")[0] in ("serving", "fleet")
            and m.kind == "counter"}


# the counters a request's outcome decides (a migrated request's rounds
# differ by design: see the module docstring)
OUTCOME = frozenset(
    ["serving." + n for n in ("tokens", "completed", "retired_eos",
                              "retired_length", "shed", "cancelled",
                              "request_errors")]
    + ["fleet." + n for n in ("failovers", "drains", "migrated_requests",
                              "retries", "dedup_hits", "heartbeat_misses",
                              "affinity_hits")])


def _both(lm, scenario, fleets=None, outcome=False):
    """Run ``scenario(side, fleet)`` (``fleet`` the module fleet of that
    package, or None) on the JAX package, then the port's; it returns
    ``(handles, router)``. Asserts equal tokens and reasons, equal replica
    indices of the handles, equal router stats deltas (its rounds aside
    when ``outcome``) and counter deltas (only ``OUTCOME`` ones when
    ``outcome``), and for the shared fleets
    equal engine stats deltas. Returns {name: (handles, router)}."""
    out = {}
    for name in ("jax", "port"):
        side = lm[name]
        shared = fleets[name] if fleets is not None else None
        s0 = dict(shared.stats) if shared is not None else {}
        e0 = [dict(e.stats) for e in _reps(shared)] if shared else []
        c0 = _counters(side)
        hs, router = scenario(side, shared)
        c1 = _counters(side)
        ids = router.replica_ids()
        out[name] = (
            hs, router,
            [ids.index(getattr(h, "replica_id", None))
             if getattr(h, "replica_id", None) in ids else None
             for h in hs],
            {k: v - s0.get(k, 0) for k, v in router.stats.items()
             if v - s0.get(k, 0)},
            [{k: e.stats[k] - s[k] for k in e.stats}
             for e, s in zip(_reps(shared), e0)] if shared else None,
            {k: v - c0.get(k, 0) for k, v in c1.items()
             if v - c0.get(k, 0) and (not outcome or k in OUTCOME)})
    (jh, _, ji, js, je, jc), (ph, _, pi, ps, pe, pc) = out["jax"], \
        out["port"]
    assert [(h.retire_reason, list(h.tokens)) for h in ph] == \
        [(h.retire_reason, list(h.tokens)) for h in jh]
    assert pi == ji
    if outcome:       # the router's rounds follow the engines' (see above)
        ps.pop("steps", None)
        js.pop("steps", None)
    assert ps == js
    if je is not None and not outcome:
        assert pe == je
    assert pc == jc, {k: (pc.get(k), jc.get(k)) for k in set(pc) | set(jc)
                      if pc.get(k) != jc.get(k)}
    return {k: v[:2] for k, v in out.items()}


def test_routing_least_loaded_and_prefix_affinity(lm, fleets):
    rng = np.random.RandomState(21)
    base = rng.randint(0, VOCAB, (6,))
    p1 = rng.randint(0, VOCAB, (3,))
    pb = rng.randint(0, VOCAB, (5,))
    p_hit = np.concatenate([base, rng.randint(0, VOCAB, (1,))])

    def scenario(side, fleet):
        e0, e1 = _reps(fleet)
        h0 = fleet.submit(base, max_tokens=2)
        assert h0.replica_id == e0.engine_id
        h1 = fleet.submit(p1, max_tokens=2)
        assert h1.replica_id == e1.engine_id
        fleet.serve_forever()
        assert fleet.idle and fleet.queued() == 0
        a0 = fleet.stats["affinity_hits"]
        busy = fleet.submit(pb, max_tokens=4)
        assert busy.replica_id == e0.engine_id
        hit = fleet.submit(p_hit, max_tokens=2)
        assert hit.replica_id == e0.engine_id       # affinity beat load
        assert fleet.stats["affinity_hits"] > a0
        fleet.serve_forever()
        for h, (p, n) in ((h0, (base, 2)), (hit, (p_hit, 2))):
            assert list(h.result()) == _oracle(lm, p, n)
        assert hit.prefix_hit_tokens >= 4
        assert fleet.health()["replicas_live"] == 2
        assert fleet.max_queue == e0.max_queue + e1.max_queue
        for e in (e0, e1):
            assert e._prefix.pinned == 0 and len(e._free) == e.slots
            assert_compile_contract(e)
        return [h0, h1, busy, hit], fleet
    _both(lm, scenario, fleets)


def test_dedup_retried_submit_admits_exactly_once(lm, fleets):
    p = np.random.RandomState(22).randint(0, VOCAB, (4,))

    def scenario(side, fleet):
        s0, d0 = fleet.stats["submitted"], fleet.stats["dedup_hits"]
        h = fleet.submit(p, max_tokens=3, client_id="alice", seq=7)
        h2 = fleet.submit(p, max_tokens=3, client_id="alice", seq=7)
        assert h2 is h
        assert fleet.stats["submitted"] == s0 + 1
        assert fleet.stats["dedup_hits"] == d0 + 1
        with pytest.raises(side.error, match="client_id and seq"):
            fleet.submit(p, max_tokens=3, client_id="alice")
        with pytest.raises(side.error, match="client_id and seq"):
            fleet.submit(p, max_tokens=3, seq=9)
        fleet.serve_forever()
        assert list(h.result()) == _oracle(lm, p, 3)
        h3 = fleet.submit(p, max_tokens=3, client_id="alice", seq=8)
        assert h3 is not h
        fleet.serve_forever()
        assert fleet.idle
        return [h, h3], fleet
    _both(lm, scenario, fleets)


def test_draining_reported_and_guards_new_admission(lm, fleets):
    p = np.random.RandomState(23).randint(0, VOCAB, (4,))

    def scenario(side, fleet):
        e0, e1 = _reps(fleet)
        assert e0.health()["draining"] is False
        e0.draining = True
        try:
            assert e0.health()["draining"] is True
            assert fleet.health()["replicas"][e0.engine_id]["draining"] \
                is True
            with pytest.raises(side.error, match="draining"):
                e0.submit(p, max_tokens=2)
            h = fleet.submit(p, max_tokens=2)
            assert h.replica_id == e1.engine_id
            resumed = e0.submit(p, max_tokens=2,
                                _resume_tokens=(_oracle(lm, p, 2)[0],))
            fleet.serve_forever()
            assert list(h.result()) == _oracle(lm, p, 2)
            assert list(resumed.result()) == _oracle(lm, p, 2)
        finally:
            e0.draining = False
        assert fleet.idle
        return [h], fleet
    # e0's resumed request regenerates on the port (its stats differ)
    _both(lm, scenario, fleets, outcome=True)


def test_fleet_wide_overload_composes_typed_policies(lm, fleets):
    p = np.random.RandomState(24).randint(0, VOCAB, (3,))

    def scenario(side, fleet):
        e0, e1 = _reps(fleet)
        Overloaded = side.engine.EngineOverloaded
        saved = [(e.max_queue, e.overload) for e in (e0, e1)]
        try:
            for e in (e0, e1):
                e.max_queue = 0
                e.overload = "shed"
            with pytest.raises(Overloaded, match="fleet-wide"):
                fleet.submit(p, max_tokens=2)
            e1.overload = "block"
            with pytest.raises(Overloaded, match="fleet-wide"):
                fleet.submit(p, max_tokens=2)
            e0.overload = "block"
            with pytest.raises(side.error, match="queue is full"):
                fleet.submit(p, max_tokens=2)
        finally:
            for e, (mq, ov) in zip((e0, e1), saved):
                e.max_queue, e.overload = mq, ov
        h = fleet.submit(p, max_tokens=2)
        fleet.serve_forever()
        assert list(h.result()) == _oracle(lm, p, 2)
        return [h], fleet
    _both(lm, scenario, fleets)


def test_slow_replica_is_retried_not_failed_over(lm, fleets):
    rng = np.random.RandomState(25)
    p1, p2 = (rng.randint(0, VOCAB, (4,)) for _ in range(2))

    def scenario(side, fleet):
        fi = side.faults.FaultInjector()
        r0, f0 = fleet.stats["retries"], fleet.stats["failovers"]
        with fi.fleet_slow_replica(None, seconds=0.2):
            h1 = fleet.submit(p1, max_tokens=2)
        assert fleet.stats["retries"] == r0 + 1
        assert fleet.stats["failovers"] == f0
        assert fi.log[-1][0] == "slow"
        assert len(fleet.replica_ids(live_only=True)) == 2
        r1 = fleet.stats["retries"]
        with fi.fleet_slow_replica(None, seconds=0.001):
            h2 = fleet.submit(p2, max_tokens=2)
        assert fleet.stats["retries"] == r1
        fleet.serve_forever()
        assert list(h1.result()) == _oracle(lm, p1, 2)
        assert list(h2.result()) == _oracle(lm, p2, 2)
        return [h1, h2], fleet
    _both(lm, scenario, fleets)


def test_submit_drop_retries_and_lost_reply_adopts(lm, fleets):
    p = np.random.RandomState(26).randint(0, VOCAB, (4,))

    def scenario(side, fleet):
        fi = side.faults.FaultInjector()
        r0, f0 = fleet.stats["retries"], fleet.stats["failovers"]
        with fi.fleet_submit_failures(None, n=1):
            h = fleet.submit(p, max_tokens=3)
        assert fleet.stats["retries"] == r0 + 1
        assert fleet.stats["failovers"] == f0
        assert fi.log[-1][0] == "submit_fail"
        rep = fleet._replicas[h.replica_id]
        n_active = len(rep.engine._active)
        sub0 = rep.engine.stats["submitted"]
        with fi.fleet_submit_failures(rep.id, n=1):
            got = fleet._channel_submit(rep, h)
        assert got is h._cur
        assert len(rep.engine._active) == n_active
        assert rep.engine.stats["submitted"] == sub0
        fleet.serve_forever()
        assert list(h.result()) == _oracle(lm, p, 3)
        return [h], fleet
    _both(lm, scenario, fleets)


# -- destructive scenarios (own fleets: they end with closed replicas) ---


def test_kill_replica_mid_round_fails_over_byte_identical(lm):
    rng = np.random.RandomState(27)
    cases = [(rng.randint(0, VOCAB, (4,)), 6) for _ in range(4)]
    p5 = rng.randint(0, VOCAB, (4,))

    def scenario(side, _):
        engines = [_mkeng(side, prefix_cache_mb=0.0021) for _ in range(2)]
        fleet = side.fleet.FleetRouter(engines, heartbeat_ms=1e6,
                                       backoff_ms=1)
        with fleet:
            hs = [fleet.submit(p, max_tokens=n) for p, n in cases]
            for _ in range(3):
                fleet.step()
            victim_id = hs[0].replica_id
            survivor = next(e for e in engines
                            if e.engine_id != victim_id)
            fi = side.faults.FaultInjector()
            with fi.fleet_kill_replica(victim_id):
                fleet.step()
            assert ("kill_replica", victim_id) in fi.log
            assert fi.log[-1] == ("crash", None)
            assert fleet.stats["failovers"] == 1
            assert fleet.replica_ids(live_only=True) == \
                [survivor.engine_id]
            assert fleet.replica(victim_id)._closed
            hd = fleet.submit(p5, max_tokens=3, client_id="c", seq=0)
            hd2 = fleet.submit(p5, max_tokens=3, client_id="c", seq=0)
            assert hd2 is hd and fleet.stats["dedup_hits"] == 1
            fleet.serve_forever()
            for (p, n), h in zip(cases, hs):
                assert list(h.result()) == _oracle(lm, p, n)
            assert list(hd.result()) == _oracle(lm, p5, 3)
            migrated = [h for h in hs if h.migrations]
            assert migrated
            assert fleet.stats["migrated_requests"] >= len(migrated)
            assert all(h.replica_id == survivor.engine_id for h in hs)
            health = fleet.health()
            assert health["replicas"][victim_id] == \
                {"closed": True, "dead": True}
            assert health["replicas_live"] == 1 and health["held"] == 0
            assert survivor._prefix.pinned == 0
            assert len(survivor._free) == survivor.slots
            assert_compile_contract(survivor)
        return hs + [hd], fleet
    _both(lm, scenario, outcome=True)


def test_drain_migrates_live_and_successor_rejoins(lm):
    rng = np.random.RandomState(28)
    cases = [(rng.randint(0, VOCAB, (4,)), 6) for _ in range(4)]
    p_a, p_b = (rng.randint(0, VOCAB, (4,)) for _ in range(2))

    def scenario(side, _):
        engines = [_mkeng(side) for _ in range(2)]
        fleet = side.fleet.FleetRouter(engines, heartbeat_ms=1e6)
        with fleet:
            hs = [fleet.submit(p, max_tokens=n) for p, n in cases]
            for _ in range(2):
                fleet.step()
            victim_id = hs[0].replica_id
            survivor = next(e for e in engines
                            if e.engine_id != victim_id)
            snap = fleet.drain(victim_id)
            assert snap["engine_id"] == victim_id and snap["requests"]
            assert fleet.replica(victim_id)._closed
            assert fleet.stats["drains"] == 1
            assert fleet.stats["migrated_requests"] >= 1
            with pytest.raises(side.error, match="not a live replica"):
                fleet.drain(victim_id)
            with pytest.raises(side.error, match="not a live replica"):
                fleet.drain("never-heard-of-it")
            fleet.serve_forever()
            for (p, n), h in zip(cases, hs):
                assert list(h.result()) == _oracle(lm, p, n)
            assert all(h.resumed == 0 for h in hs)
            succ = _mkeng(side)
            fleet.add_replica(succ)
            assert len(fleet.replica_ids(live_only=True)) == 2
            with pytest.raises(side.error, match="already"):
                fleet.add_replica(succ)
            with pytest.raises(side.error, match="closed"):
                fleet.add_replica(fleet.replica(victim_id))
            ha = fleet.submit(p_a, max_tokens=3)
            hb = fleet.submit(p_b, max_tokens=3)
            assert hb.replica_id == succ.engine_id
            fleet.serve_forever()
            assert list(ha.result()) == _oracle(lm, p_a, 3)
            assert list(hb.result()) == _oracle(lm, p_b, 3)
            for e in (survivor, succ):
                assert len(e._free) == e.slots
                assert_compile_contract(e, copy={})
        return hs + [ha, hb], fleet
    _both(lm, scenario, outcome=True)


def test_fleet_close_fails_pending_and_is_idempotent(lm, fleets):
    """LAST (consumes the module fleets)."""
    p = np.random.RandomState(32).randint(0, VOCAB, (4,))

    def scenario(side, fleet):
        h = fleet.submit(p, max_tokens=6)
        replicas = _reps(fleet)
        fleet.close()
        assert h.done
        with pytest.raises(side.engine.EngineClosed):
            h.result()
        fleet.close()
        with pytest.raises(side.engine.EngineClosed):
            fleet.submit(p, max_tokens=1)
        assert fleet.health()["closed"] is True
        assert all(e._closed for e in replicas)
        assert fleet.replica_ids(live_only=True) == []
        for e in replicas:
            assert_compile_contract(e)
        assert side.tele.snapshot()["fleet"]["replicas_live"] == 0
        return [h], fleet
    _both(lm, scenario, fleets)
