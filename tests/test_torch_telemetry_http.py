"""The port's HTTP exposition server (``mxnet_tpu_torch.telemetry.serve``):
the HTTP cases of ``tests/test_observability.py`` against the port's
registry, its engine and router registries and stub engines and routers —
``/metrics`` as Prometheus text (and its ``?prefix=`` filter), ``/snapshot``,
unknown paths and write methods, ``/healthz`` (stuck, closed-stuck,
draining, several engines), restart and stop, the atexit hook,
``/requests``, ``/flight/<id>``, ``/rounds``, scrapes racing writers,
``/fleet`` and ``/fleet/flight/<id>`` (``?chrome=1``), the fleet flight
recorder's stitching — and the JAX package's unchanged
``tools/dump_telemetry.py --url`` reading the port's server. The routes are
the JAX server's; the two servers answer the same requests alike.

Zero-compile: stubs stand in for engines and routers (a real 1P1D fleet's
journey over HTTP is in ``tests/test_torch_disagg_trace.py``).
"""
import atexit
import json
import os
import re
import sys
import threading
import urllib.error
import urllib.request

import pytest

from mxnet_tpu import telemetry_http as jax_http

from mxnet_tpu_torch import telemetry as tele
from mxnet_tpu_torch import telemetry_http
from mxnet_tpu_torch.serving import engine as engine_mod
from mxnet_tpu_torch.serving import fleet as fleet_mod
from mxnet_tpu_torch.serving.fleet import FleetFlightRecorder
from mxnet_tpu_torch.serving.flight import FlightRecorder

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools import dump_telemetry  # noqa: E402


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), \
            resp.read().decode()


@pytest.fixture()
def server():
    srv = tele.serve(port=0)
    try:
        yield srv
    finally:
        tele.stop_server()


_PROM_LINE = re.compile(
    r"^(?:# (?:TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
    r"(?:counter|gauge|histogram)|HELP .*)"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^{}]*\})? [0-9eE+.natif-]+)$")


def _prometheus(text, prefix=None):
    """Every line obeys the exposition grammar and every sample belongs
    to a family declared above it; returns the declared families."""
    declared = set()
    for line in text.rstrip("\n").splitlines():
        assert _PROM_LINE.match(line), "bad exposition line: %r" % line
        if line.startswith("# TYPE "):
            declared.add(line.split()[2])
        elif not line.startswith("#"):
            name = re.split(r"[ {]", line, 1)[0]
            fam = re.sub(r"_(bucket|sum|count)$", "", name)
            assert name in declared or fam in declared, name
            if prefix is not None:
                assert name.startswith(prefix), name
    return declared


def test_http_metrics_is_valid_prometheus_exposition(server):
    tele.counter("t15.http_events").inc(3)
    tele.histogram("t15.http_lat_ms").observe(2.0)
    status, ctype, text = _get(server.url + "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    _prometheus(text)
    assert re.search(r"mxnet_t15_http_events_total \d+", text)
    assert "mxnet_serving_slo_ttft_attained_total" in text
    assert "mxnet_serving_slo_ttft_burn_5m" in text
    assert "mxnet_fleet_replicas_live" in text
    lines = dict(line.rsplit(" ", 1) for line in text.splitlines()
                 if line.startswith("mxnet_t15_http_lat_ms"))
    assert lines['mxnet_t15_http_lat_ms_bucket{le="+Inf"}'] == \
        lines["mxnet_t15_http_lat_ms_count"]


def test_http_prefix_filter_metrics_and_snapshot(server):
    tele.counter("t15p.pref_events").inc(2)
    tele.histogram("t15p.pref_ms").observe(1.0)
    tele.gauge("other15.unrelated").set(5)
    status, _, text = _get(server.url + "/metrics?prefix=t15p.")
    assert status == 200
    declared = _prometheus(text, prefix="mxnet_t15p_")
    assert "mxnet_t15p_pref_events_total" in declared
    assert "mxnet_other15_unrelated" not in text
    _, _, body = _get(server.url + "/snapshot?prefix=t15p.")
    snap = json.loads(body)
    assert set(snap) == {"t15p"} and snap["t15p"]["pref_events"] == 2
    _, _, body = _get(server.url + "/snapshot")
    assert "other15" in json.loads(body)


def test_http_snapshot_round_trips_and_matches_registry(server):
    tele.gauge("t15.http_gauge").set(7.5)
    tele.gauge("t15.http_nan").set(float("nan"))
    status, ctype, body = _get(server.url + "/snapshot")
    assert status == 200 and ctype == "application/json"
    snap = json.loads(body)
    assert snap["t15"]["http_gauge"] == 7.5
    assert snap["t15"]["http_nan"] is None       # strict JSON: no NaN
    assert json.loads(json.dumps(snap)) == snap


def test_http_unknown_paths_and_write_methods_rejected(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server.url + "/not-an-endpoint")
    assert e.value.code == 404
    req = urllib.request.Request(server.url + "/metrics", data=b"x",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 405
    status, _, body = _get(server.url + "/")
    assert status == 200
    # the JAX server's route list, route for route
    assert json.loads(body) == json.loads(jax_http._route("/")[2])


def test_http_healthz_ok_and_server_restart_and_stop(server):
    status, _, body = _get(server.url + "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"
    old_port = server.port
    srv2 = tele.serve(port=0)
    assert telemetry_http._server is srv2
    status, _, _ = _get(srv2.url + "/healthz")
    assert status == 200
    tele.stop_server()
    assert not srv2.running
    tele.stop_server()                           # no-op when none runs
    with pytest.raises(Exception):
        _get("http://127.0.0.1:%d/healthz" % old_port, timeout=2)


def test_http_server_stops_cleanly_atexit_registered():
    atexit.unregister(telemetry_http.stop_server)
    atexit.register(telemetry_http.stop_server)


class _StubEngine:
    def __init__(self):
        self.flight = FlightRecorder(retain=4)
        self.stuck = False

    def request_table(self):
        rows = [{"id": "stub-1", "state": "running", "prompt_len": 3,
                 "tokens": 1, "age_s": 0.5}] + self.flight.rows()
        for row in rows:
            row["engine_id"] = "stub-e0"
            row["role"] = "unified"
        return rows

    def health(self):
        return {"closed": False, "stuck": self.stuck,
                "watchdog_trips": int(self.stuck)}


def test_http_requests_flight_healthz_with_stub_engine():
    stub = _StubEngine()
    stub.flight.start("stub-1", prompt_len=3)
    stub.flight.event("stub-1", "admitted", slot=0)
    stub.flight.retire("stub-1", "deadline", tokens=1)
    engine_mod._ENGINES.add(stub)
    srv = tele.serve(port=0)
    try:
        _, _, body = _get(srv.url + "/requests")
        rows = json.loads(body)["requests"]
        assert {"id": "stub-1", "state": "running", "prompt_len": 3,
                "tokens": 1, "age_s": 0.5, "engine_id": "stub-e0",
                "role": "unified"} in rows
        stub_rows = [r for r in rows if r["id"] == "stub-1"]
        assert len(stub_rows) >= 2
        assert all(r["engine_id"] == "stub-e0" and r["role"] == "unified"
                   for r in stub_rows)
        _, _, body = _get(srv.url + "/flight/stub-1")
        tl = json.loads(body)
        assert [e["event"] for e in tl["events"]] == \
            ["submit", "admitted", "retire"]
        assert tl["meta"]["retire_reason"] == "deadline"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/flight/never-submitted")
        assert e.value.code == 404
        stub.stuck = True
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/healthz")
        assert e.value.code == 503
        assert json.loads(e.value.read())["status"] == "stuck"
    finally:
        engine_mod._ENGINES.discard(stub)
        tele.stop_server()


def test_http_requests_and_healthz_from_a_real_engine(tmp_path):
    """A real port engine registers itself: /requests shows its rows
    with its engine id and role, /flight/<id> finds its request, /healthz
    reports its role and draining state."""
    import numpy as np
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.name import NameManager
    from mxnet_tpu_torch.parallel import Decoder
    with NameManager():
        sym = get_transformer_lm(17, num_layers=1, embed_dim=16,
                                 num_heads=2)
    shapes, _, _ = sym.infer_shape(data=(1, 16), softmax_label=(1, 16))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    eng = engine_mod.InferenceEngine(
        Decoder(sym, params, max_len=16, device="cpu"), slots=2,
        prefill_buckets=(4, 8), role="prefill")
    eng.draining = True
    srv = tele.serve(port=0)
    try:
        # an id no other engine of the process has (the route returns the
        # first engine's record of an id)
        req = eng.submit(np.arange(3), max_tokens=4, _resume_tokens=(1,),
                         request_id="t15-real-engine")
        _, _, body = _get(srv.url + "/requests")
        rows = [r for r in json.loads(body)["requests"]
                if r["engine_id"] == eng.engine_id]
        assert rows and rows[0]["role"] == "prefill"
        _, _, body = _get(srv.url + "/flight/%s" % req.id)
        assert json.loads(body)["meta"]["resumed"] == 1
        _, _, body = _get(srv.url + "/healthz")
        ours = [h for h in json.loads(body)["engines"]
                if h.get("role") == "prefill" and h.get("draining")]
        assert ours and ours[0]["handoffs_waiting"] == 0
    finally:
        tele.stop_server()
        eng.close()


def test_http_scrape_concurrent_with_writers(server):
    stop = threading.Event()
    c = tele.counter("t15.race_count")
    h = tele.histogram("t15.race_hist")

    def writer():
        while not stop.is_set():
            c.inc()
            h.observe(1.0)
    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for _ in range(10):
            assert _get(server.url + "/metrics")[0] == 200
            assert _get(server.url + "/snapshot")[0] == 200
    finally:
        stop.set()
        t.join(timeout=5)


def _add(*stubs):
    for s in stubs:
        engine_mod._ENGINES.add(s)


def _drop(*stubs):
    for s in stubs:
        engine_mod._ENGINES.discard(s)


class _Health:
    flight = FlightRecorder(retain=0)

    def __init__(self, **health):
        self._health = dict(closed=False, stuck=False, watchdog_trips=0)
        self._health.update(health)

    def request_table(self):
        return []

    def health(self):
        return dict(self._health)


def test_healthz_ignores_closed_stuck_and_reports_draining():
    closed = _Health(closed=True, stuck=True, watchdog_trips=1)
    draining = _Health(draining=True)
    _add(closed, draining)
    srv = tele.serve(port=0)
    try:
        status, _, body = _get(srv.url + "/healthz")
        doc = json.loads(body)
        assert status == 200 and doc["status"] == "ok"
        ours = [e for e in doc["engines"] if e.get("draining")]
        assert ours and ours[0]["draining"] is True
    finally:
        _drop(closed, draining)
        tele.stop_server()


def test_http_healthz_multi_engine_itemizes_stuck_and_healthy():
    healthy = _Health(name="healthy", slots=2)
    wedged = _Health(name="wedged", stuck=True, watchdog_trips=1, slots=2)
    _add(healthy, wedged)
    srv = tele.serve(port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/healthz")
        assert e.value.code == 503
        doc = json.loads(e.value.read())
        by_name = {h["name"]: h for h in doc["engines"] if "name" in h}
        assert set(by_name) == {"healthy", "wedged"}
        assert by_name["wedged"]["stuck"] is True
        _drop(wedged)
        status, _, body = _get(srv.url + "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
    finally:
        _drop(healthy, wedged)
        tele.stop_server()


def test_http_rounds_endpoint_reads_ledgers():
    class _LedgerStub:
        flight = FlightRecorder(retain=0)

        def __init__(self):
            self.rows = [{"round": i, "t_s": i * 0.1, "wall_ms": 1.5,
                          "slots_busy": 1, "admitted": 0,
                          "dispatched": "decode",
                          "phases_ms": {"sched": 0.5, "dispatch": 1.0}}
                         for i in range(5)]

        def round_table(self, n=None):
            return self.rows[-n:] if n else list(self.rows)

    class _NoLedger:
        flight = FlightRecorder(retain=0)

    stub, bare = _LedgerStub(), _NoLedger()
    _add(stub, bare)
    srv = tele.serve(port=0)
    try:
        def ours(doc):
            return [b for b in doc["engines"] if b["rounds"]
                    and b["rounds"][-1].get("wall_ms") == 1.5]
        (blk,) = ours(json.loads(_get(srv.url + "/rounds")[2]))
        assert len(blk["rounds"]) == 5
        assert len(ours(json.loads(
            _get(srv.url + "/rounds?n=2")[2]))[0]["rounds"]) == 2
        assert len(ours(json.loads(
            _get(srv.url + "/rounds?n=bogus")[2]))[0]["rounds"]) == 5
    finally:
        _drop(stub, bare)
        tele.stop_server()


def _stub_journey(rid="t15-f9"):
    """A stitched journey built without a fleet: router events plus an
    engine-side FlightRecorder absorbed at hop boundaries."""
    ffr = FleetFlightRecorder(retain=4)
    ffr.start(rid, prompt_len=3, max_tokens=4)
    ffr.hop(rid, "eng-a")
    ffr.hop(rid, "eng-a")
    ffr.event(rid, "placed", replica="eng-a", reason="least_loaded", hop=1)
    efr = FlightRecorder(retain=4)
    efr.start(rid, prompt_len=3, trace=rid, hop=1)
    efr.event(rid, "admitted", slot=0)
    ffr.absorb(rid, "eng-a", efr.records(rid))
    efr.event(rid, "first_token", ttft_ms=1.0)
    efr.retire(rid, "length", tokens=4)
    ffr.absorb(rid, "eng-a", efr.records(rid))
    ffr.absorb(rid, "eng-a", efr.records(rid))
    ffr.retire(rid, "length", tokens=4, migrations=0,
               slo={"router_queue": 0.1, "prefill": 0.9,
                    "handoff_wait": 0.0, "decode_admission": 0.0,
                    "decode": 2.0, "e2e_ms": 3.0, "ttft_ms": 1.0})
    return ffr


def test_fleet_flight_recorder_stitching_and_bounds():
    tl = _stub_journey().timeline("t15-f9")
    assert tl is not None and not tl["live"] and tl["hops"] == ["eng-a"]
    names = [(e["scope"], e["event"]) for e in tl["events"]]
    for ev in ("admitted", "first_token", "retire"):
        assert names.count(("eng-a", ev)) == 1
    assert names[0] == ("router", "submit")
    assert names[-1] == ("router", "retire")
    ts = [e["t_ms"] for e in tl["events"]]
    assert ts == sorted(ts) and ts[0] == 0.0
    ch = _stub_journey().chrome_trace("t15-f9")
    assert {e["args"]["name"] for e in ch["traceEvents"]
            if e.get("ph") == "M"} == {"router", "eng-a"}
    assert [e["name"] for e in ch["traceEvents"] if e.get("ph") == "X"] \
        == ["router_queue", "prefill", "handoff_wait",
            "decode_admission", "decode"]
    capped = FleetFlightRecorder(retain=2, max_events=8)
    capped.start("c", prompt_len=1)
    for i in range(12):
        capped.event("c", "placed", attempt=i)
    capped.retire("c", "done")
    tl = capped.timeline("c")
    assert tl["dropped_events"] == 5
    assert tl["events"][-1]["event"] == "retire"
    for rid in ("r1", "r2"):
        capped.start(rid, prompt_len=1)
        capped.retire(rid, "done")
    assert capped.timeline("c") is None
    assert capped.ids() == ([], ["r1", "r2"])
    off = FleetFlightRecorder(retain=0)
    off.start("x", prompt_len=1)
    off.retire("x", "done")
    assert off.timeline("x") is None and off.rows() == []


class _StubRouter:
    _closed = False

    def __init__(self):
        self.flight = _stub_journey()
        self.ticks = 0

    def _slo_tick(self, now=None):
        self.ticks += 1

    def fleet_table(self):
        live, retired = self.flight.ids()
        return {"replicas": [{"id": "eng-a", "role": "unified",
                              "alive": True}],
                "stats": {"handoffs": 0},
                "flight": {"live": live, "retired": retired},
                "slo": {"ttft_ms": None, "cadence_ms": None}}


def test_http_fleet_endpoints_with_stub_router():
    router = _StubRouter()
    fleet_mod._ROUTERS.add(router)
    srv = tele.serve(port=0)
    try:
        fleets = json.loads(_get(srv.url + "/fleet")[2])["fleets"]
        ours = [f for f in fleets if f["replicas"][0]["id"] == "eng-a"]
        assert len(ours) == 1 and ours[0]["flight"]["retired"] == ["t15-f9"]
        assert router.ticks >= 1
        tl = json.loads(_get(srv.url + "/fleet/flight/t15-f9")[2])
        assert tl["id"] == "t15-f9" and tl["hops"] == ["eng-a"]
        assert tl["meta"]["slo"]["ttft_ms"] == 1.0
        assert {e["scope"] for e in tl["events"]} == {"router", "eng-a"}
        ch = json.loads(_get(srv.url + "/fleet/flight/t15-f9?chrome=1")[2])
        assert ch["otherData"]["trace_id"] == "t15-f9"
        assert any(e.get("cat") == "fleet.slo" for e in ch["traceEvents"])
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/fleet/flight/never-traced")
        assert e.value.code == 404
        assert "stitched" in json.loads(e.value.read())["error"]
        router._closed = True
        assert not [f for f in json.loads(_get(srv.url + "/fleet")[2])[
            "fleets"] if f.get("replicas", [{}])[0].get("id") == "eng-a"]
    finally:
        fleet_mod._ROUTERS.discard(router)
        tele.stop_server()


def test_dump_telemetry_url_reads_the_port_server(capsys):
    """The JAX package's unchanged ``tools/dump_telemetry.py --url`` reads
    the port's server: the snapshot, a copied /metrics URL, ``--watch``,
    and ``--fleet --trace <id>``'s stitched journey."""
    tele.counter("t15.dump_live").inc(4)
    router = _StubRouter()
    fleet_mod._ROUTERS.add(router)
    srv = tele.serve(port=0)
    try:
        dump_telemetry.main(["--url", srv.url])
        out = capsys.readouterr().out
        assert "dump_live" in out and "4" in out
        dump_telemetry.main(["--url", srv.url + "/metrics"])
        assert "dump_live" in capsys.readouterr().out
        dump_telemetry.main(["--url", srv.url, "--watch", "0.01",
                             "--watch-count", "2", "--serving"])
        assert capsys.readouterr().out.count("--- refresh") == 2
        dump_telemetry.main(["--url", srv.url, "--fleet", "--trace", "t15-f9"])
        out = capsys.readouterr().out
        assert "trace t15-f9" in out and "retired(length)" in out
        assert "hops: eng-a" in out and "slo decomposition" in out
        assert "router_queue" in out and "e2e_ms" in out
    finally:
        fleet_mod._ROUTERS.discard(router)
        tele.stop_server()
