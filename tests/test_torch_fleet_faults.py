"""The fleet router under replica faults on the port, against the JAX
package: the heartbeat, held-migration and rolling-restart cases of
``tests/test_fleet.py`` and ``tests/test_fleet_faults.py``'s randomized
chaos sweep (replica kills, heartbeat partitions, channel drops and
stalls, live drains, a 3-replica fleet under submit pressure), run the
same way on both packages' routers over their own engines.

The two must agree on each request's tokens and retire reason (both equal
the JAX offline ``Decoder.generate``: zero failed requests), where each
request ended, the router's ``stats`` but its rounds, and the outcome
counters (``fleet.*`` and the ``serving.*`` ones a request's outcome
decides). A migrated request regenerates its emitted tokens on the port
where the JAX engine prefills them (the port's ``Request`` says why), so
the engines' scheduling stats and the router's rounds are not compared;
in the chaos sweep that also changes which requests are in flight when a
later fault lands, so there only the requests' outcomes and the
``serving.*`` outcome counters are.
Every engine that served keeps the compile contract and drains clean.

The LM is the JAX suite's (1 layer, vocab 17, E=16, 2 heads, max_len 16,
seeded numpy weights, f32).
"""
import collections
import contextlib
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


def _both(lm, scenario, fleets=None, outcome=False, requests_only=False):
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
    if requests_only:
        # where a request ends and what the router counts follow which
        # requests are still in flight when a fault lands, and a port
        # replica regenerates a migrated request's tokens in more rounds
        pc = {k: v for k, v in pc.items() if k.startswith("serving.")}
        jc = {k: v for k, v in jc.items() if k.startswith("serving.")}
        assert pc == jc, (pc, jc)
        return {k: v[:2] for k, v in out.items()}
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


def test_heartbeat_blackhole_declares_dead_after_misses(lm):
    rng = np.random.RandomState(29)
    p0, p1 = (rng.randint(0, VOCAB, (4,)) for _ in range(2))

    def scenario(side, _):
        engines = [_mkeng(side) for _ in range(2)]
        fleet = side.fleet.FleetRouter(engines, heartbeat_ms=0,
                                       heartbeat_misses=2, backoff_ms=1)
        with fleet:
            h0 = fleet.submit(p0, max_tokens=6)
            h1 = fleet.submit(p1, max_tokens=6)
            victim_id = h0.replica_id
            assert victim_id == engines[0].engine_id
            vrep = fleet._replicas[victim_id]
            fi = side.faults.FaultInjector()
            with fi.fleet_heartbeat_blackhole(victim_id, n=1):
                fleet.step()
            assert vrep.alive and vrep.misses == 1
            fleet.step()
            assert vrep.alive and vrep.misses == 0
            with fi.fleet_heartbeat_blackhole(victim_id, n=2):
                fleet.step()
                assert vrep.alive and vrep.misses == 1
                fleet.step()
            assert not vrep.alive
            assert fleet.stats["failovers"] == 1
            assert fleet.stats["heartbeat_misses"] == 3
            fleet.serve_forever()
            assert list(h0.result()) == _oracle(lm, p0, 6)
            assert list(h1.result()) == _oracle(lm, p1, 6)
            assert h0.migrations == 1
            assert h0.replica_id == engines[1].engine_id
            assert len(engines[1]._free) == engines[1].slots
            assert_compile_contract(engines[1], copy={})
        return [h0, h1], fleet
    _both(lm, scenario, outcome=True)


def test_migration_target_dies_requests_held_then_recover(lm):
    p = np.random.RandomState(30).randint(0, VOCAB, (4,))

    def scenario(side, _):
        engines = [_mkeng(side) for _ in range(2)]
        fleet = side.fleet.FleetRouter(engines, heartbeat_ms=1e6,
                                       max_retries=0, backoff_ms=1)
        with fleet:
            h = fleet.submit(p, max_tokens=6)
            assert h.replica_id == engines[0].engine_id
            for _ in range(2):
                fleet.step()
            fi = side.faults.FaultInjector()
            with fi.fleet_submit_failures(engines[1].engine_id, n=1):
                snap = fleet.drain(engines[0])
            assert fleet.stats["drains"] == 1
            assert fleet.stats["failovers"] == 1
            assert fleet.replica_ids(live_only=True) == []
            assert fleet.health()["held"] == 1
            assert not h.done and h.replica_id is None
            assert h.tokens == list(snap["requests"][0]["tokens"])
            with pytest.raises(side.error, match="awaiting re-placement"):
                h.result()
            with pytest.raises(side.error, match="no healthy replica"):
                fleet.submit(p, max_tokens=2)
            succ = _mkeng(side)
            fleet.add_replica(succ)
            fleet.serve_forever()
            assert h.done and h.migrations == 1
            assert h.replica_id == succ.engine_id
            assert fleet.stats["migrated_requests"] == 1
            assert list(h.result()) == _oracle(lm, p, 6)
            assert len(succ._free) == succ.slots
            assert_compile_contract(succ, copy={})
        return [h], fleet
    _both(lm, scenario, outcome=True)


def test_rolling_restart_replay_zero_failed(lm, tmp_path):
    """A capture recorded on ONE engine replays through a 2-replica fleet
    while ``rolling_restart`` drains and replaces both originals: verify
    clean with zero failed, on both packages' replay libraries."""
    rng = np.random.RandomState(31)
    base = rng.randint(0, VOCAB, (6,))
    cases = [(base, 2), (base[:4].copy(), 4), (rng.randint(0, VOCAB, (3,)),
                                               5),
             (rng.randint(0, VOCAB, (10,)), 3),
             (rng.randint(0, VOCAB, (2,)), 6), (base.copy(), 2)]
    reports = {}

    def scenario(side, _):
        src = _mkeng(side, capture_dir=str(tmp_path / side.name),
                     prefix_cache_mb=0.0021, prefill_chunk=3)
        hs = [src.submit(p, max_tokens=n) for p, n in cases]
        assert len(src.serve_forever()) == len(cases)
        path = src.capture.path
        src.close()
        cap = side.capture.load_capture(path)

        def mkreplica():
            return side.replay.build_engine(cap, side.mkdec())
        fleet = side.fleet.FleetRouter([mkreplica() for _ in range(2)],
                                       heartbeat_ms=1e6)
        with fleet:
            originals = _reps(fleet)
            on_round = side.replay.rolling_restart(fleet, cap, mkreplica)
            rep = side.replay.replay(cap, fleet, timing="max",
                                     verify=True, on_round=on_round)
            reports[side.name] = rep
            assert rep["mismatches"] == []
            assert rep["replayed"] == rep["requests"] == len(cases)
            assert rep["verified"] == len(cases)
            assert fleet.stats["drains"] == 2
            assert fleet.stats["migrated_requests"] > 0
            assert fleet.stats["failovers"] == 0
            assert all(e._closed for e in originals)
            live = [fleet.replica(r)
                    for r in fleet.replica_ids(live_only=True)]
            assert len(live) == 2 and not any(e in originals for e in live)
            for e in originals + live:
                if e.stats["steps"]:
                    assert_compile_contract(e)
                if e._prefix is not None:
                    assert e._prefix.pinned == 0
        return hs, fleet
    _both(lm, scenario, outcome=True)
    keys = ("requests", "replayed", "tokens", "verified", "verify_skipped")
    assert {k: reports["port"][k] for k in keys} == \
        {k: reports["jax"][k] for k in keys}


def test_chaos_sweep_random_faults_zero_failed(lm):
    """A seeded schedule of kills, blackholes, drops, stalls and drains
    against a 3-replica fleet under submit pressure: every admitted
    request finishes byte-identical to offline generate on both packages,
    none is held, live replicas drain clean."""
    def scenario(side, _):
        rng = np.random.RandomState(123)
        fi = side.faults.FaultInjector(seed=5)
        fleet = side.fleet.FleetRouter(
            [_mkeng(side) for _ in range(3)], timeout_ms=40, max_retries=3,
            backoff_ms=1, heartbeat_ms=0, heartbeat_misses=2)
        cases, handles = [], []
        with fleet:
            for _ in range(30):
                live = fleet.replica_ids(live_only=True)
                if len(live) < 2:
                    fleet.add_replica(_mkeng(side))
                    live = fleet.replica_ids(live_only=True)
                act = rng.rand()
                if act < 0.35 and len(handles) < 14:
                    p = rng.randint(0, VOCAB, (int(rng.randint(2, 7)),))
                    n = int(rng.randint(2, 6))
                    f = rng.rand()
                    ctx = contextlib.nullcontext()
                    if f < 0.2:
                        ctx = fi.fleet_submit_failures(None, n=1)
                    elif f < 0.4:
                        ctx = fi.fleet_slow_replica(None, seconds=0.2)
                    try:
                        with ctx:
                            h = fleet.submit(p, max_tokens=n)
                    except side.error:
                        continue
                    cases.append((p, n))
                    handles.append(h)
                elif act < 0.45 and len(live) > 1:
                    victim = live[int(rng.randint(len(live)))]
                    with fi.fleet_kill_replica(victim):
                        fleet.step()
                elif act < 0.55 and len(live) > 1:
                    victim = live[int(rng.randint(len(live)))]
                    with fi.fleet_heartbeat_blackhole(victim, n=2):
                        fleet.step()
                        fleet.step()
                elif act < 0.65 and len(live) > 1:
                    fleet.drain(live[int(rng.randint(len(live)))])
                else:
                    fleet.step()
            fleet.serve_forever()
            assert fleet.stats["failovers"] > 0
            assert fleet.stats["drains"] > 0
            assert fleet.stats["migrated_requests"] > 0
            assert cases
            for (p, n), h in zip(cases, handles):
                assert h.done and h.retire_reason in ("length", "eos")
                assert list(h.result()) == _oracle(lm, p, n)
            assert fleet.health()["held"] == 0
            for rid in fleet.replica_ids(live_only=True):
                e = fleet.replica(rid)
                assert e.idle and len(e._free) == e.slots
                if e.stats["steps"]:
                    assert_compile_contract(e, copy={})
        return handles, fleet
    _both(lm, scenario, outcome=True, requests_only=True)
