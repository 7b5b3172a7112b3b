"""HTTP exposition of the telemetry plane.

Counterpart of ``mxnet_tpu/telemetry_http.py`` (the port's own copy; the
same routes, so the JAX package's ``tools/dump_telemetry.py --url`` reads
this server unchanged). A stdlib ``http.server`` daemon thread serves
strictly read-only GET endpoints:

``/metrics``
    Prometheus text exposition (``to_prometheus()``), refreshed before
    rendering with the profiler's per-program cost gauges
    (``program.<name>.flops`` and ``.bytes_accessed``, counted when each
    program was built), the device-memory gauges (``device.bytes_in_use``
    and friends, ``profiler.device_memory()``: ``torch.cuda``'s allocator
    on a CUDA process) and the serving and fleet SLO burn rates.
    ``?prefix=serving.`` restricts to one dotted-name subtree.
``/snapshot``
    ``snapshot()`` as JSON (non-finite floats serialized as null); honors
    the same ``?prefix=`` filter.
``/rounds``
    Recent round-phase ledgers across every engine (``?n=<rows>``,
    default 64 per engine).
``/requests``
    Live + recently-retired serving request table across every engine in
    the process.
``/flight/<request_id>``
    One request's flight-recorder timeline.
``/fleet``
    Aggregated fleet plane across every live :class:`FleetRouter`:
    per-replica role/health/occupancy, handoff stats, SLO thresholds +
    burn readings, and the stitched-journey ring occupancy.
``/fleet/flight/<trace_id>``
    One request's STITCHED cross-replica journey; ``?chrome=1`` returns
    the Perfetto/chrome-trace export (one track per replica).
``/healthz``
    Engine liveness fed by the watchdog state: 200 while no engine is
    stuck, 503 when a ``round_timeout_ms`` trip has not yet drained.

Everything is host-side — handlers read host bookkeeping; nothing
launches a kernel or waits on the device (the memory gauges read the
caching allocator's counters). The server is opt-in:
``mxnet_tpu_torch.telemetry.serve(port=0)`` (ephemeral port, the handle
carries ``.url``) or ``MXNET_TELEMETRY_PORT=<port>`` when this module is
imported. It binds ``127.0.0.1`` by default. One server per process;
re-``serve`` stops the previous one, and an armed server stops at
interpreter exit.
"""
from __future__ import annotations

import atexit
import json
import http.server
import logging
import math
import os
import sys
import threading

from . import telemetry

__all__ = ["serve", "stop_server", "TelemetryServer"]

_log = logging.getLogger(__name__)
_server = None
_server_lock = threading.Lock()


def _engines():
    """Live InferenceEngines in this process (empty when serving was
    never imported — the plane works for training-only processes)."""
    eng = sys.modules.get("mxnet_tpu_torch.serving.engine")
    if eng is None:
        return []
    try:
        return list(eng._ENGINES)
    except Exception:
        return []


def _routers():
    """Live FleetRouters in this process (weak registry in
    serving.fleet; empty when the fleet layer was never imported)."""
    fleet = sys.modules.get("mxnet_tpu_torch.serving.fleet")
    if fleet is None:
        return []
    try:
        return [r for r in fleet._ROUTERS if not r._closed]
    except Exception:
        return []


def _refresh():
    """Pre-scrape refresh, all best-effort and host-side: program cost
    gauges (counted at each program's build: nothing runs here), device
    memory gauges, serving + fleet SLO burn rates. A failure in any
    refresher must never fail the scrape."""
    try:
        from . import profiler
        profiler.collect_program_stats()
        profiler.device_memory()
    except Exception:
        pass
    for e in _engines():
        try:
            e._slo_tick()
        except Exception:
            pass
    for r in _routers():
        try:
            r._slo_tick()
        except Exception:
            pass


def _scrub(obj):
    """JSON-safe copy: non-finite floats become null (strict JSON has
    no NaN/Infinity, and /snapshot promises round-trippable output)."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _route(path, query=None):
    """Dispatch one GET: returns (status, content_type, body bytes).
    ``query`` is the parsed query string (first value per key):
    ``/metrics`` and ``/snapshot`` honor ``?prefix=<dotted-prefix>``
    (a fleet scraper pulling only the ``serving.`` subtree),
    ``/rounds`` honors ``?n=<rows>``."""
    query = query or {}
    prefix = query.get("prefix") or None
    if path in ("/metrics", "/metrics/"):
        _refresh()
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                telemetry.to_prometheus(prefix=prefix).encode())
    if path in ("/snapshot", "/snapshot/"):
        _refresh()
        body = json.dumps(_scrub(telemetry.snapshot(prefix=prefix)),
                          sort_keys=True)
        return 200, "application/json", body.encode()
    if path in ("/rounds", "/rounds/"):
        # recent round-phase ledgers (read-only — the engine appends,
        # this copies): one block per engine, newest rounds last
        try:
            n = max(1, int(query.get("n", 64)))
        except (TypeError, ValueError):
            n = 64
        engines = []
        for i, e in enumerate(_engines()):
            try:
                engines.append({"engine": i,
                                "rounds": e.round_table(n)})
            except Exception:
                continue
        return (200, "application/json",
                json.dumps({"engines": _scrub(engines)}).encode())
    if path in ("/requests", "/requests/"):
        rows = []
        for e in _engines():
            try:
                rows.extend(e.request_table())
            except Exception:
                continue
        return (200, "application/json",
                json.dumps({"requests": _scrub(rows)}).encode())
    if path.startswith("/fleet/flight/"):
        rid = path[len("/fleet/flight/"):].rstrip("/")
        chrome = query.get("chrome") in ("1", "true", "yes")
        for r in _routers():
            try:
                tl = r.flight.chrome_trace(rid) if chrome \
                    else r.flight.timeline(rid)
            except Exception:
                tl = None
            if tl is not None:
                return (200, "application/json",
                        json.dumps(_scrub(tl)).encode())
        return (404, "application/json",
                json.dumps({"error": "no stitched journey for trace "
                            "%r (ring keeps the last N retired "
                            "journeys per router)" % rid}).encode())
    if path in ("/fleet", "/fleet/"):
        _refresh()
        fleets = []
        for r in _routers():
            try:
                fleets.append(r.fleet_table())
            except Exception:
                continue
        return (200, "application/json",
                json.dumps({"fleets": _scrub(fleets)}).encode())
    if path.startswith("/flight/"):
        rid = path[len("/flight/"):].rstrip("/")
        keys = [rid]
        if rid.lstrip("-").isdigit():
            keys.insert(0, int(rid))   # auto-assigned integer ids
        for e in _engines():
            for k in keys:
                try:
                    tl = e.flight.timeline(k)
                except Exception:
                    tl = None
                if tl is not None:
                    return (200, "application/json",
                            json.dumps(_scrub(tl)).encode())
        return (404, "application/json",
                json.dumps({"error": "no flight record for request "
                            "%r (ring keeps the last N retired "
                            "requests)" % rid}).encode())
    if path in ("/healthz", "/healthz/"):
        engines = []
        for e in _engines():
            try:
                engines.append(e.health())
            except Exception:
                continue
        # a closed engine can never recover and must not wedge the
        # health signal — only a LIVE engine's tripped watchdog is
        # actionable (stop routing here)
        stuck = any(h.get("stuck") and not h.get("closed")
                    for h in engines)
        doc = {"status": "stuck" if stuck else "ok",
               "engines": engines}
        return (503 if stuck else 200, "application/json",
                json.dumps(_scrub(doc)).encode())
    if path in ("/", ""):
        return (200, "application/json", json.dumps(
            {"endpoints": ["/metrics", "/snapshot", "/requests",
                           "/flight/<request_id>", "/rounds",
                           "/fleet", "/fleet/flight/<trace_id>",
                           "/healthz"]}
        ).encode())
    return (404, "application/json",
            json.dumps({"error": "unknown path %r" % path}).encode())


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "mxnet-telemetry/1"
    protocol_version = "HTTP/1.1"

    def do_GET(self):             # noqa: N802 — http.server contract
        try:
            from urllib.parse import parse_qsl
            path, _, qs = self.path.partition("?")
            query = dict(parse_qsl(qs))
            status, ctype, body = _route(path, query)
        except Exception as e:    # noqa: BLE001 — a scrape never kills
            _log.warning("telemetry http: %s handling %r", e, self.path)
            status, ctype = 500, "application/json"
            body = json.dumps({"error": str(e)}).encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):            # noqa: N802 — strictly read-only
        body = json.dumps({"error": "read-only endpoint"}).encode()
        self.send_response(405)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Allow", "GET")
        self.end_headers()
        self.wfile.write(body)

    do_PUT = do_DELETE = do_PATCH = do_POST

    def log_message(self, fmt, *args):
        _log.debug("telemetry http: " + fmt, *args)


class TelemetryServer:
    """Handle for a running exposition server (``serve()`` returns
    one): ``.host`` / ``.port`` / ``.url`` and ``.stop()``."""

    def __init__(self, port=0, host="127.0.0.1"):
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self.host = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            daemon=True, name="mx-telemetry-http")
        self._thread.start()

    @property
    def url(self):
        host = "127.0.0.1" if self.host in ("0.0.0.0", "::", "") \
            else self.host
        return "http://%s:%d" % (host, self.port)

    @property
    def running(self):
        return self._thread.is_alive()

    def stop(self):
        """Shut the listener down and release the port (idempotent;
        registered atexit for the process-level server)."""
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5)

    def __repr__(self):
        return "TelemetryServer(url=%r, running=%s)" % (self.url,
                                                        self.running)


def serve(port=0, host="127.0.0.1"):
    """Start the process's exposition server (see the module
    docstring). Restarting replaces the previous server. Returns the
    :class:`TelemetryServer` handle."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
        _server = TelemetryServer(port=port, host=host)
        return _server


def stop_server():
    """Stop the process's exposition server (no-op when none runs)."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None


atexit.register(stop_server)

# import-time arm: MXNET_TELEMETRY_PORT=<port> starts the server with
# the module (0 = ephemeral — the chosen port is logged). A bad knob must
# not take down the import.
_port = os.environ.get("MXNET_TELEMETRY_PORT")
if _port:
    try:
        _srv = serve(port=int(_port))
        _log.info("telemetry: exposition server listening on %s",
                  _srv.url)
    except Exception as _e:
        logging.warning("MXNET_TELEMETRY_PORT=%r is unusable (%s) — "
                        "exposition server not started", _port, _e)
