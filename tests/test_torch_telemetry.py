"""The port's telemetry (``mxnet_tpu_torch/telemetry.py``) and flight
recorder (``mxnet_tpu_torch/serving/flight.py``) against the JAX
package's, on the CPU.

The same observations go to both registries, and ``snapshot()`` and
``to_prometheus()`` must give the same dict and the same text,
``Histogram.percentile``/``count_le`` the same values, and ``SloWindow``
the same burn gauges under the same ``tick(now=...)`` clock. Two flight
recorders fed the same calls give timelines and rows equal in structure
(event names, order and fields; the times differ). Then the JAX package's
registry, trace and SLO cases (``tests/test_telemetry.py`` and
``tests/test_observability.py``, those that touch no HTTP server and no
trainer) on the port's module. Each registry is process-wide: every name
here starts with ``t14.``, which no other test uses, and the assertions
on shared state are deltas.
"""
import json
import logging
import math
import threading
import time

import pytest

from mxnet_tpu import telemetry as jax_tele
from mxnet_tpu.serving.flight import FlightRecorder as JaxFlight

from mxnet_tpu_torch import telemetry as tele
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving.flight import FlightRecorder

BOTH = (jax_tele, tele)


def _feed(mod, tag):
    """The same observations into ``mod``'s registry, under t14.<tag>.*:
    a counter, a gauge, histograms with default and custom buckets (one
    value past the last bound), a name that extends a histogram's, and
    an empty histogram."""
    p = "t14.%s." % tag
    mod.counter(p + "events").inc(3)
    mod.counter(p + "events").inc(39)
    mod.gauge(p + "depth").set(2.5)
    h = mod.histogram(p + "lat_ms")
    for v in (0.003, 0.07, 0.3, 4.0, 4.0, 123.4, 70000.0):
        h.observe(v)
    c = mod.histogram(p + "custom", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 5000.0):
        c.observe(v)
    mod.counter(p + "custom.sub").inc(5)
    mod.histogram(p + "empty")
    return h, c


def test_snapshot_and_prometheus_equal_jax():
    for mod in BOTH:
        _feed(mod, "s")
    assert tele.snapshot("t14.s.") == jax_tele.snapshot("t14.s.")
    assert tele.to_prometheus("t14.s.") == jax_tele.to_prometheus("t14.s.")
    assert tele.snapshot("t14.s.")["t14.s.custom.sub"] == 5


def test_percentile_and_count_le_equal_jax():
    hs = [_feed(mod, "q") for mod in BOTH]
    (jh, jc), (ph, pc) = hs
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ph.percentile(q) == jh.percentile(q)
        assert pc.percentile(q) == jc.percentile(q)
    for v in (0.001, 0.07, 1.0, 5.0, 10.0, 123.4, 1e9):
        assert ph.count_le(v) == jh.count_le(v)
        assert pc.count_le(v) == jc.count_le(v)


def test_slo_window_burn_gauges_equal_jax():
    gauges = []
    for mod in BOTH:
        h = mod.histogram("t14.slo.hist", buckets=(10.0, 100.0))
        g1 = mod.gauge("t14.slo.burn_short")
        g2 = mod.gauge("t14.slo.burn_long")
        w = mod.SloWindow(h, threshold=10.0, target=0.9,
                          windows=((60.0, g1), (3600.0, g2)),
                          min_interval_s=0.0)
        seen = []
        w.tick(now=1000.0)
        for now, ok, miss in ((1010.0, 8, 2), (1110.0, 10, 0),
                              (1200.0, 0, 0), (1300.0, 3, 7),
                              (5000.0, 1, 1)):
            for _ in range(ok):
                h.observe(1.0)
            for _ in range(miss):
                h.observe(50.0)
            w.tick(now=now)
            seen.append((g1.value, g2.value))
        gauges.append(seen)
    assert gauges[1] == gauges[0]
    assert gauges[1][0] == (pytest.approx(2.0), pytest.approx(2.0))


def _drive(fr):
    """One scripted lifecycle per request, as the engine records them."""
    for rid in range(5):
        fr.start(rid, prompt_len=4, max_tokens=40)
        fr.event(rid, "staged", bucket=4)
        fr.event(rid, "admitted", slot=rid % 2, queue_wait_ms=0.5)
        fr.event(rid, "prefill_chunk", start=0, tokens=4, bucket=4,
                 final=True)
        fr.event(rid, "first_token", ttft_ms=1.0)
        for n in (5, 15, 21, 30, 37):
            fr.token(rid, n)
        fr.retire(rid, "error" if rid == 3 else "length", tokens=37,
                  **({"error": "boom"} if rid == 3 else {}))
    fr.start("live", prompt_len=2)
    for i in range(20):
        fr.event("live", "prefill_chunk", start=i)


def _shape(tl):
    return (tl["id"], tl["live"], tl["meta"], tl["dropped_events"],
            [(e["event"], sorted(e)) for e in tl["events"]])


def test_flight_recorder_equal_jax_in_structure():
    jf, pf = JaxFlight(retain=3, max_events=8), FlightRecorder(
        retain=3, max_events=8)
    _drive(jf)
    _drive(pf)
    assert pf.ids() == jf.ids() == (["live"], [2, 3, 4])
    for rid in (0, 2, 3, 4, "live"):
        jt, pt = jf.timeline(rid), pf.timeline(rid)
        assert (pt is None) == (jt is None)
        if pt is not None:
            assert _shape(pt) == _shape(jt)
    assert [sorted(r.items() - {("age_s", r["age_s"])}) for r in pf.rows()] \
        == [sorted(r.items() - {("age_s", r["age_s"])}) for r in jf.rows()]
    for rid in (3, "live", 0):
        assert [[(e["event"], sorted(e)) for e in evs]
                for _, evs in pf.records(rid)] == \
            [[(e["event"], sorted(e)) for e in evs]
             for _, evs in jf.records(rid)]


# -- the JAX package's registry cases, on the port's module ---------------

def test_counter_gauge_histogram_semantics():
    c = tele.counter("t14.count")
    v0 = c.value
    c.inc()
    c.inc(41)
    assert c.value == v0 + 42
    assert tele.counter("t14.count") is c   # get-or-create returns THE one
    g = tele.gauge("t14.gauge")
    g.set(3)
    g.set(2.5)
    assert g.value == 2.5
    h = tele.histogram("t14.hist", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 5000.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(5055.5)
    snap = h._snap()
    assert snap["min"] == 0.5 and snap["max"] == 5000.0
    assert snap["buckets"] == {"1": 1, "10": 1, "100": 1, "+Inf": 1}
    assert h.percentile(0.5) == 10.0         # the bucket's upper bound
    assert h.percentile(0.99) == 5000.0      # +inf bucket reports max
    assert math.isnan(tele.histogram("t14.empty_hist").percentile(0.5))
    assert h.count_le(1.0) == 1 and h.count_le(5.0) == 2
    assert h.count_le(1e9) == 4


def test_registry_type_conflict_raises():
    tele.counter("t14.conflict")
    with pytest.raises(MXNetError, match="already registered"):
        tele.gauge("t14.conflict")
    with pytest.raises(MXNetError, match="ascending"):
        tele.Histogram("t14.bad", buckets=(2.0, 1.0))


def test_enable_disable_is_a_no_op_switch():
    c = tele.counter("t14.toggle")
    v0 = c.value
    try:
        tele.enable(False)
        assert not tele.enabled()
        c.inc(100)
        tele.gauge("t14.toggle_g").set(7)
        h = tele.histogram("t14.toggle_h")
        h.observe(1.0)
        with tele.span("t14.toggle_span", hist=h):
            pass
        assert c.value == v0 and h.count == 0
        assert tele.gauge("t14.toggle_g").value == 0.0
        assert not FlightRecorder().enabled
    finally:
        tele.enable(True)
    c.inc()
    assert c.value == v0 + 1


def test_thread_safety_counter_and_histogram():
    c = tele.counter("t14.mt_count")
    h = tele.histogram("t14.mt_hist")
    v0, n0 = c.value, h.count
    n, workers = 5000, 8

    def work():
        for i in range(n):
            c.inc()
            h.observe(i % 7)

    threads = [threading.Thread(target=work) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == v0 + n * workers
    assert h.count == n0 + n * workers


def test_snapshot_nested_shape_and_name_collisions():
    tele.counter("t14.snapshot.a").inc(3)
    tele.gauge("t14.snapshot.b").set(1.5)
    tele.histogram("t14.snapshot.c").observe(2.0)
    tele.histogram("t14.coll.y").observe(1.0)
    tele.counter("t14.coll.y.z").inc(5)
    snap = tele.snapshot()
    node = snap["t14"]["snapshot"]
    assert node["a"] >= 3 and node["b"] == 1.5
    assert set(node["c"]) >= {"count", "sum", "mean", "min", "max", "p50",
                              "p99", "buckets"}
    assert "z" not in snap["t14"]["coll"]["y"]   # histogram unpolluted
    assert snap["t14.coll.y.z"] == 5             # flat-key fallback


def test_to_prometheus_exposition():
    tele.counter("t14.prom.events").inc(2)
    tele.gauge("t14.prom.depth").set(4)
    h = tele.histogram("t14.prom.lat_ms")
    h.observe(0.07)
    h.observe(123.4)
    text = tele.to_prometheus()
    assert "# TYPE mxnet_t14_prom_events_total counter" in text
    assert "# TYPE mxnet_t14_prom_depth gauge" in text
    assert "# TYPE mxnet_t14_prom_lat_ms histogram" in text
    lines = dict(ln.rsplit(" ", 1) for ln in text.splitlines()
                 if ln.startswith("mxnet_t14_prom_lat_ms"))
    # the bucket series are CUMULATIVE: +Inf equals _count
    assert lines['mxnet_t14_prom_lat_ms_bucket{le="+Inf"}'] == \
        lines["mxnet_t14_prom_lat_ms_count"] == "2"
    # exact extrema beside the bucket-resolution quantiles
    assert float(lines["mxnet_t14_prom_lat_ms_min"]) == 0.07
    assert float(lines["mxnet_t14_prom_lat_ms_max"]) == 123.4
    tele.histogram("t14.prom.empty")
    assert "mxnet_t14_prom_empty_min" not in tele.to_prometheus()


def test_trace_file_is_valid_chrome_trace_with_nesting(tmp_path):
    path = tele.start_trace(str(tmp_path))
    try:
        with tele.span("t14.outer", cat="test"):
            with tele.span("t14.inner", cat="test", hist=None, tag=1):
                time.sleep(0.001)
        tele.mark("t14.point", cat="test", detail="x")
        with tele.tracing_paused():
            tele.mark("t14.paused")
        fr = FlightRecorder(retain=2)
        fr.start("r", prompt_len=1)
        fr.retire("r", "eos")
    finally:
        out = tele.stop_trace()
    assert out == path
    with open(out) as f:
        evs = json.load(f)["traceEvents"]
    by_name = {e["name"]: e for e in evs}
    assert {"t14.outer", "t14.inner", "t14.point",
            "serving.flight.submit", "serving.flight.retire"} \
        <= set(by_name)
    assert "t14.paused" not in by_name
    for e in evs:
        assert e["ph"] in ("X", "i")
        assert e["ts"] >= 0 and "pid" in e and "tid" in e
    outer, inner = by_name["t14.outer"], by_name["t14.inner"]
    assert inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["args"] == {"tag": 1}
    assert by_name["serving.flight.retire"]["args"]["request"] == "r"
    with tele.span("t14.after"):
        pass
    assert not tele.tracing() and tele.stop_trace() is None


def test_start_trace_rejects_a_file_path(tmp_path):
    f = tmp_path / "taken"
    f.write_text("not a directory")
    with pytest.raises(MXNetError, match="not a directory"):
        tele.start_trace(str(f))
    assert not tele.tracing()


def test_span_feeds_histogram():
    h = tele.histogram("t14.span_ms")
    n0 = h.count
    with tele.span("t14.timed", hist=h):
        time.sleep(0.002)
    assert h.count == n0 + 1 and h.sum >= 1.0     # ~2 ms, in ms


def test_reporter_logs_summaries():
    log = logging.getLogger("t14.reporter")
    records = []

    class _Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    grab = _Grab()
    log.addHandler(grab)
    log.setLevel(logging.INFO)
    tele.counter("t14.reporter_events").inc(5)
    try:
        tele.start_reporter(0.02, logger=log)
        deadline = time.time() + 2.0
        while not records and time.time() < deadline:
            time.sleep(0.01)
    finally:
        tele.stop_reporter()
        log.removeHandler(grab)
    assert records and "t14.reporter_events=5" in records[0]


def test_slo_window_burn_rates_and_rate_limit():
    h = tele.histogram("t14.slo_hist", buckets=(10.0, 100.0))
    g1 = tele.gauge("t14.slo_burn_short")
    g2 = tele.gauge("t14.slo_burn_long")
    w = tele.SloWindow(h, threshold=10.0, target=0.9,
                       windows=((60.0, g1), (3600.0, g2)),
                       min_interval_s=0.0)
    w.tick(now=1000.0)
    for v in [1.0] * 8 + [50.0] * 2:
        h.observe(v)
    w.tick(now=1010.0)
    assert g1.value == pytest.approx(2.0) and g2.value == pytest.approx(2.0)
    for _ in range(10):
        h.observe(1.0)
    w.tick(now=1110.0)
    assert g1.value == pytest.approx(0.0)       # the short window is clean
    assert g2.value == pytest.approx(1.0)       # 2/20 missed / 0.1
    w.tick(now=1200.0)
    assert g1.value == 0.0                      # no traffic: 0, not NaN
    with pytest.raises(MXNetError, match="target"):
        tele.SloWindow(h, 10.0, target=1.0)
    rl = tele.SloWindow(h, threshold=10.0, target=0.99,
                        windows=((60.0, tele.gauge("t14.slo_rl")),),
                        min_interval_s=1.0)
    for i in range(100):
        rl.tick(now=500.0 + i * 0.01)
    assert len(rl._samples) == 1                # all but the first skipped


def test_flight_recorder_ring_cap_and_sampling():
    fr = FlightRecorder(retain=3)
    for rid in range(5):
        fr.start(rid, prompt_len=4)
        fr.event(rid, "admitted", slot=0)
        fr.retire(rid, "eos", tokens=2)
    assert fr.ids() == ([], [2, 3, 4])           # the oldest evicted
    assert fr.timeline(0) is None
    assert [e["event"] for e in fr.timeline(4)["events"]] == \
        ["submit", "admitted", "retire"]
    capped = FlightRecorder(retain=2, max_events=8)
    capped.start("r", prompt_len=1)
    for i in range(20):
        capped.event("r", "prefill_chunk", start=i)
    capped.retire("r", "error", error="boom")
    tl = capped.timeline("r")
    assert tl["dropped_events"] == 20 - 7
    assert tl["events"][-1]["event"] == "retire"  # the terminal lands
    sampled = FlightRecorder(retain=4, token_sample=16)
    sampled.start(2, prompt_len=1)
    for n in (5, 15, 21, 30, 37):                 # skips 16 and 32
        sampled.token(2, n)
    assert [e["tokens"] for e in sampled.timeline(2)["events"]
            if e["event"] == "decode"] == [21, 37]
    off = FlightRecorder(retain=0)
    off.start(1, prompt_len=1)
    off.retire(1, "eos")
    assert off.timeline(1) is None and not off.enabled


def test_http_exposition_belongs_to_a_later_slice():
    for fn in (tele.serve, tele.stop_server):
        with pytest.raises(MXNetError, match="later slice"):
            fn()
