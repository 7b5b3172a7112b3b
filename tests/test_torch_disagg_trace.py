"""Disaggregated serving through faults, replays and the fleet tracing
plane on the port, against the JAX package: the remaining cases of
``tests/test_serving_disagg.py`` — a unified capture replayed through a
1P+1D fleet and through a per-role rolling restart, a decode specialist's
capture and its role round trip, one request's stitched journey through a
retried handoff and a decode replica's death (read back over the port's
HTTP server), the unified fallback's journey.

Both packages must agree on each request's tokens and retire reason (both
equal the JAX offline ``Decoder.generate``); where a request migrates, the
port regenerates its emitted tokens where the JAX engine prefills them
(the port's ``Request`` says why), so only outcomes are compared there.
The LM is the JAX suite's (1 layer, vocab 17, E=16, 2 heads, max_len 16,
seeded numpy weights, f32).
"""
import collections
import json
import os
import sys
import urllib.request

import numpy as np
import pytest

import jax.numpy as jnp

from mxnet_tpu import telemetry as jax_tele
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames
from mxnet_tpu.parallel import Decoder as JaxDecoder
from mxnet_tpu.serving import capture as jax_capture
from mxnet_tpu.serving import engine as jax_engine
from mxnet_tpu.serving import fleet as jax_fleet
from mxnet_tpu.testing import faults as jax_faults

from mxnet_tpu_torch import telemetry as port_tele
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
ENG = dict(slots=2, prefill_buckets=(4, 8), prefix_cache_mb=0.0042,
           max_queue=8)
FLEET = dict(timeout_ms=40, max_retries=3, backoff_ms=1, heartbeat_ms=1e6)

Side = collections.namedtuple(
    "Side", "name engine fleet faults capture replay tele mkdec")


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
                        jax_capture, jax_replay, jax_tele, jax_dec),
            "port": Side("port", port_engine, port_fleet, port_faults,
                         port_capture, port_replay, port_tele, port_dec),
            "oracle": JaxDecoder(js, jparams, max_len=T)}


def _mkeng(side, **kw):
    cfg = dict(ENG)
    cfg.update(kw)
    return side.engine.InferenceEngine(side.mkdec(), **cfg)


def _mkfleet(side, roles, eng_kw=None, **kw):
    engines = [_mkeng(side, role=r, **(eng_kw or {})) for r in roles]
    cfg = dict(FLEET)
    cfg.update(kw)
    return side.fleet.FleetRouter(engines, **cfg), engines


_ORACLE = {}


def _oracle(lm, prompt, n):
    prompt = np.asarray(prompt)
    n = min(n, T - len(prompt))
    key = (prompt.tobytes(), n)
    if key not in _ORACLE:
        _ORACLE[key] = np.asarray(lm["oracle"].generate(
            prompt[None], num_steps=n))[0, len(prompt):].tolist()
    return _ORACLE[key]


def _both(lm, scenario):
    """Run ``scenario(side)`` (it returns its handles and router) on both
    packages; assert equal tokens and retire reasons and equal router
    stats but its rounds. Returns {name: (handles, router)}."""
    out = {n: scenario(lm[n]) for n in ("jax", "port")}
    (jh, jr), (ph, pr) = out["jax"], out["port"]
    assert [(h.retire_reason, list(h.tokens)) for h in ph] == \
        [(h.retire_reason, list(h.tokens)) for h in jh]
    if jr is not None:
        js, ps = dict(jr.stats), dict(pr.stats)
        js.pop("steps", None)
        ps.pop("steps", None)
        assert ps == js
    return out


def _assert_clean(*engines):
    for e in engines:
        if e._prefix is not None:
            assert e._prefix.pinned == 0, e.engine_id
        assert len(e._free) == e.slots, e.engine_id


def _assert_role_contracts(prefills, decodes):
    for e in prefills:
        assert_compile_contract(e, decode=0, verify=0)
    for e in decodes:
        assert_compile_contract(e, prefill={}, copy="once")


def test_replay_roles_1p1d_verify_clean(lm, tmp_path):
    """A unified capture replays verify-clean through a 1P+1D fleet, then
    again under a per-role rolling restart (each replacement built with
    its predecessor's role)."""
    rng = np.random.RandomState(29)
    cases = [(rng.randint(0, VOCAB, (n,)), m)
             for n, m in ((4, 3), (6, 4), (3, 2), (7, 2))]

    def scenario(side):
        src = _mkeng(side, capture_dir=str(tmp_path / side.name),
                     role="unified")
        hs = [src.submit(p, max_tokens=m) for p, m in cases]
        src.serve_forever()
        path = src.capture.path
        src.close()
        cap = side.capture.load_capture(path)

        def mkreplica(role="unified"):
            return side.replay.build_engine(cap, side.mkdec(), role=role)
        fleet = side.fleet.FleetRouter([mkreplica(role="prefill"),
                                        mkreplica(role="decode")],
                                       heartbeat_ms=1e6)
        with fleet:
            rep = side.replay.replay(cap, fleet, timing="max", verify=True)
            assert rep["mismatches"] == []
            assert rep["verified"] == len(cases)
            assert fleet.stats["handoffs"] == len(cases)
            engines = [fleet.replica(r) for r in fleet.replica_ids()]
            _assert_clean(*engines)
            _assert_role_contracts([engines[0]], [engines[1]])
        requested = []

        def mkreplica_logged(role="unified"):
            requested.append(role)
            return mkreplica(role=role)
        fleet = side.fleet.FleetRouter([mkreplica(role="prefill"),
                                        mkreplica(role="decode")],
                                       heartbeat_ms=1e6)
        with fleet:
            on_round = side.replay.rolling_restart(
                fleet, cap, mkreplica_logged, per_role=True)
            rep = side.replay.replay(cap, fleet, timing="max", verify=True,
                                     on_round=on_round)
            assert rep["mismatches"] == []
            assert rep["verified"] == len(cases)
            assert fleet.stats["drains"] == 2
            assert requested == ["prefill", "decode"]
            assert fleet.stats["role_promotions"] == 2
            live = [fleet.replica(r)
                    for r in fleet.replica_ids(live_only=True)]
            assert "decode" in [e.role for e in live]
            _assert_clean(*live)
        return hs, fleet
    _both(lm, scenario)


def test_capture_role_round_trip(lm, tmp_path):
    """A 1P+1D fleet with capture armed: the decode specialist's capture
    names its role, every submit is a handoff admission (resume tokens,
    hop 2, the fleet id as trace id); ``role_report`` notes a specialist
    capture replayed without ``--roles``; the capture replays verify-clean
    on one unified engine, the fleet identity preserved. The port's
    specialist capture also replays clean on the JAX engine."""
    p = np.random.RandomState(37).randint(0, VOCAB, (5,))
    paths = {}

    def scenario(side):
        fleet, (ep, ed) = _mkfleet(
            side, ("prefill", "decode"),
            eng_kw={"capture_dir": str(tmp_path / side.name)})
        with fleet:
            h = fleet.submit(p, max_tokens=4)
            fleet.serve_forever()
            assert list(h.result()) == _oracle(lm, p, 4)
            paths[side.name] = ed.capture.path
            _assert_clean(ep, ed)
        cap = side.capture.load_capture(ed.capture.path)
        assert cap["engine"]["role"] == "decode"
        (sub,) = cap["submits"]
        assert sub["trace_id"] == h.id and sub["hop"] == 2
        assert sub["resume_tokens"]
        role, note = side.replay.role_report(cap)
        assert role == "decode" and "--roles" in note
        assert side.replay.role_report(cap, (1, 1)) == ("decode", None)
        uni = side.replay.build_engine(cap, side.mkdec(), role="unified")
        rep = side.replay.replay(cap, uni, timing="max", verify=True)
        assert rep["mismatches"] == [] and rep["verified"] == 1
        assert [r["id"] for r in uni.request_table()] == [h.id]
        _assert_clean(uni)
        uni.close()
        return [h], fleet
    _both(lm, scenario)
    pcap = jax_capture.load_capture(paths["port"])
    jeng = jax_replay.build_engine(pcap, lm["jax"].mkdec(),
                                   role="unified", attn_impl="dense")
    rep = jax_replay.replay(pcap, jeng, timing="max", verify=True)
    assert rep["mismatches"] == [] and rep["verified"] == 1


def _slo_sums(slo):
    comps = ("router_queue", "prefill", "handoff_wait", "decode_admission",
             "decode")
    assert abs(sum(slo[c] for c in comps) - slo["e2e_ms"]) <= 0.01, slo
    assert abs(slo["router_queue"] + slo["prefill"] - slo["ttft_ms"]) \
        <= 0.01, slo
    assert all(slo[c] >= 0.0 for c in comps), slo


def test_fleet_trace_stitched_timeline_under_faults(lm):
    """One request through a 1P+1D fleet with a retried handoff and the
    decode replica killed mid-decode reconstructs as ONE ordered
    timeline — over the port's HTTP server too, ``?chrome=1`` included —
    with the SLO decomposition summing to the measured times."""
    p = np.random.RandomState(31).randint(0, VOCAB, (6,))

    def scenario(side):
        fleet, (ep, ed) = _mkfleet(side, ("prefill", "decode"),
                                   slo_ttft_ms=1e5, slo_cadence_ms=1e5)
        fi = side.faults.FaultInjector()
        with fleet:
            with fi.fleet_handoff_failures(ed.engine_id, n=1):
                # an id no other router of the process has: /fleet/flight
                # answers with the first router that knows the id
                h = fleet.submit(p, max_tokens=6, request_id="t15-trace")
                for _ in range(200):
                    fleet.step()
                    if fleet.stats["handoffs"] == 1:
                        break
            assert fleet.stats["handoffs"] == 1 and not h.done
            with fi.fleet_kill_replica(ed.engine_id):
                fleet.step()
            fleet.serve_forever()
            assert fleet.stats["failovers"] == 1
            assert fleet.stats["role_promotions"] == 1
            assert ep.role == "unified"
            assert list(h.result()) == _oracle(lm, p, 6)
            tl = fleet.flight.timeline(h.id)
            assert tl is not None and not tl["live"]
            assert tl["dropped_events"] == 0
            assert tl["hops"] == [ep.engine_id, ed.engine_id, ep.engine_id]
            ts = [e["t_ms"] for e in tl["events"]]
            assert ts == sorted(ts) and ts[0] == 0.0
            names = [e["event"] for e in tl["events"]]
            assert names[0] == "submit" and names[-1] == "retire"
            for must in ("placed", "first_token", "handoff_export",
                         "in_transit", "retried", "admitted",
                         "handoff_import", "failover", "migrated"):
                assert must in names, (must, names)

            def first(name, scope=None):
                for i, e in enumerate(tl["events"]):
                    if e["event"] == name and \
                            (scope is None or e["scope"] == scope):
                        return i, e
                raise AssertionError((name, scope, names))
            keyed = [("placed", "router"), ("handoff_export", None),
                     ("retried", "router"), ("admitted", "router"),
                     ("failover", "router"), ("migrated", "router")]
            order = [first(n, s)[0] for n, s in keyed]
            assert order == sorted(order)
            by = {n: first(n, s)[1] for n, s in keyed}
            assert by["placed"]["reason"] == "role"
            assert by["placed"]["replica"] == ep.engine_id
            assert by["retried"]["op"] == "handoff"
            assert by["admitted"]["replica"] == ed.engine_id
            assert by["admitted"]["bytes"] > 0
            assert by["admitted"]["pool_hit"] is False
            assert by["failover"]["from"] == ed.engine_id
            assert by["migrated"]["to"] == ep.engine_id
            subs = [e for e in tl["events"]
                    if e["event"] == "submit" and e["scope"] != "router"]
            assert {e["trace"] for e in subs} == {h.id}
            assert {(e["scope"], e["hop"]) for e in subs} >= \
                {(ep.engine_id, 1), (ed.engine_id, 2)}
            slo = tl["meta"]["slo"]
            _slo_sums(slo)
            assert abs(slo["ttft_ms"] - (h.t_first - h.t_submit) * 1e3) \
                <= 0.01
            assert "cadence_ms" in slo
            if side.name == "port":
                srv = side.tele.serve(port=0)
                try:
                    with urllib.request.urlopen(srv.url + "/fleet",
                                                timeout=10) as r:
                        fleets = json.load(r)["fleets"]
                    (ft,) = [f for f in fleets
                             if ep.engine_id in f["replicas"]]
                    assert h.id in ft["flight"]["retired"]
                    assert ft["slo"]["ttft_ms"] == 1e5
                    assert set(ft["slo"]["ttft_burn"]) == {"1m", "5m",
                                                           "1h"}
                    with urllib.request.urlopen(
                            srv.url + "/fleet/flight/%s" % h.id,
                            timeout=10) as r:
                        wire = json.load(r)
                    assert wire["events"] == json.loads(
                        json.dumps(tl["events"]))
                    assert wire["meta"]["slo"] == json.loads(
                        json.dumps(slo))
                    with urllib.request.urlopen(
                            srv.url + "/fleet/flight/%s?chrome=1" % h.id,
                            timeout=10) as r:
                        chrome = json.load(r)
                    assert chrome["otherData"]["trace_id"] == h.id
                    assert [e["name"] for e in chrome["traceEvents"]
                            if e.get("cat") == "fleet.slo"] == [
                        "router_queue", "prefill", "handoff_wait",
                        "decode_admission", "decode"]
                finally:
                    side.tele.stop_server()
            _assert_clean(ep)
            assert_compile_contract(ep)
        ed.close()
        return [h], fleet
    _both(lm, scenario)


def test_fleet_trace_continuity_unified_fallback(lm):
    """No retry budget while the package is in transit: the decode replica
    is declared dead and the package lands rows-less on the promoted
    survivor as the journey's hop 2 — one ascending timeline, the
    decomposition summing."""
    p = np.random.RandomState(37).randint(0, VOCAB, (6,))

    def scenario(side):
        fleet, (ep, ed) = _mkfleet(side, ("prefill", "decode"),
                                   max_retries=0)
        fi = side.faults.FaultInjector()
        with fleet:
            with fi.fleet_handoff_failures(ed.engine_id, n=2):
                h = fleet.submit(p, max_tokens=5)
                fleet.serve_forever()
            assert list(h.result()) == _oracle(lm, p, 5)
            assert fleet.stats["failovers"] == 1
            assert fleet.stats["role_promotions"] == 1
            tl = fleet.flight.timeline(h.id)
            ts = [e["t_ms"] for e in tl["events"]]
            assert ts == sorted(ts)
            names = [e["event"] for e in tl["events"]]
            assert names[0] == "submit" and names[-1] == "retire"
            assert "retried" not in names
            routed = [e for e in tl["events"] if e["scope"] == "router"]
            (fo,) = [e for e in routed if e["event"] == "failover"]
            assert fo["reason"] == "target died in transit"
            assert fo["from"] == ed.engine_id
            (adm,) = [e for e in routed if e["event"] == "admitted"]
            assert adm["replica"] == ep.engine_id
            assert adm["pool_hit"] is True and adm["hop"] == 2
            assert routed.index(fo) < routed.index(adm)
            assert tl["hops"] == [ep.engine_id]
            assert h.migrations == 0
            _slo_sums(tl["meta"]["slo"])
        ed.close()
        return [h], fleet
    _both(lm, scenario)
