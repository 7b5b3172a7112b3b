"""Process-wide runtime telemetry: counters, gauges, histograms, spans.

Counterpart of ``mxnet_tpu/telemetry.py``, kept as the port's own copy (it
is stdlib only, and the port imports nothing of the JAX package): a single
named-metric registry, cheap enough to stay on by default, plus Chrome
``trace_event`` spans that open in Perfetto / chrome://tracing next to a
``torch.profiler`` trace. The serving engine
(``mxnet_tpu_torch/serving/engine.py``) feeds it.

Design constraints (and why the hot paths can afford this):

* **host-side only** — ``time.perf_counter`` and python ints; nothing
  here is captured into a CUDA graph and nothing forces a device sync.
* **pre-resolved handles** — instrumentation sites call
  ``counter(name)`` once at import and keep the object; the per-event
  cost is one enabled-flag check + one small-lock add.
* **no cross-process state** — only the consumer process feeds the
  registry.

Metric names are dotted (``subsystem.metric``); :func:`snapshot` nests
them into a dict tree and :func:`to_prometheus` renders the standard
text exposition. The two render the same text as the JAX package's
module for the same observations.

Knobs: ``MXNET_TELEMETRY=0`` disables collection entirely;
``MXNET_TRACE_DIR=<dir>`` arms span capture at import (flushed at
process exit, or explicitly via :func:`stop_trace`);
``MXNET_TELEMETRY_LOG_INTERVAL=<seconds>`` starts a background
reporter that logs a compact summary on that cadence. :func:`serve`
puts the plane on HTTP (:mod:`mxnet_tpu_torch.telemetry_http`).
"""
from __future__ import annotations

import atexit
import bisect
import collections
import contextlib
import json
import logging
import os
import re
import threading
import time

from .base import MXNetError

__all__ = ["counter", "gauge", "histogram", "snapshot", "to_prometheus",
           "span", "mark", "trace_complete", "start_trace", "stop_trace",
           "tracing", "tracing_paused", "enable", "enabled", "reset",
           "start_reporter", "stop_reporter", "serve", "stop_server",
           "Counter", "Gauge", "Histogram", "SloWindow"]

# default histogram buckets: wall-time milliseconds, µs-to-minutes —
# wide because the same shape serves sub-ms decode rounds and multi-s
# checkpoint writes; pass buckets= at first creation to specialize
DEFAULT_BUCKETS_MS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                      25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
                      5000.0, 10000.0, 60000.0)

_MAX_TRACE_EVENTS = 200_000  # bound the buffer; overflow is COUNTED


class _State:
    def __init__(self):
        self.enabled = os.environ.get("MXNET_TELEMETRY", "1") != "0"
        self.metrics = {}          # name -> metric object
        self.lock = threading.Lock()   # registry structure only
        # tracing
        self.trace_active = False
        self.trace_events = []
        self.trace_dropped = 0
        self.trace_lock = threading.Lock()
        self.trace_path = None
        self.trace_epoch = 0.0     # perf_counter origin of ts=0
        # reporter
        self.reporter = None
        self.reporter_stop = None


_state = _State()


# ---------------------------------------------------------------------------
# metric types

class Counter:
    """Monotonic event/byte counter. ``inc`` is thread-safe (CPython
    ``+=`` is a read-modify-write and CAN lose increments across
    threads; the per-metric lock is ~100 ns, cheap at host-path
    rates)."""

    __slots__ = ("name", "_v", "_lock")
    kind = "counter"

    def __init__(self, name):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        if not _state.enabled:
            return
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def _reset(self):
        with self._lock:
            self._v = 0

    def _snap(self):
        return self._v


class Gauge:
    """Last-write-wins instantaneous value (queue depth, occupancy,
    samples/sec)."""

    __slots__ = ("name", "_v")
    kind = "gauge"

    def __init__(self, name):
        self.name = name
        self._v = 0.0

    def set(self, v):
        if not _state.enabled:
            return
        self._v = float(v)   # single store: atomic under the GIL

    @property
    def value(self):
        return self._v

    def _reset(self):
        self._v = 0.0

    def _snap(self):
        return self._v


class Histogram:
    """Fixed-bucket histogram (Prometheus-style cumulative ``le``
    buckets) with count/sum/min/max. Percentiles are bucket-resolution
    approximations (the bucket's upper bound), which is what fixed
    buckets can honestly give without storing samples."""

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum",
                 "_min", "_max", "_lock")
    kind = "histogram"

    def __init__(self, name, buckets=None):
        self.name = name
        self.buckets = tuple(float(b) for b in
                             (buckets or DEFAULT_BUCKETS_MS))
        if list(self.buckets) != sorted(set(self.buckets)):
            raise MXNetError("histogram %r: buckets must be strictly "
                             "ascending" % name)
        self._counts = [0] * (len(self.buckets) + 1)  # +1: +inf
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    def observe(self, v):
        if not _state.enabled:
            return
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def percentile(self, q):
        """Upper bound of the bucket containing quantile ``q`` in
        [0, 1] (``nan`` when empty — a percentile of nothing is not a
        number, and a silent None used to poison arithmetic at the
        caller; max for the +inf bucket)."""
        with self._lock:
            total = self._count
            if total == 0:
                return float("nan")
            need = q * total
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= need:
                    if i < len(self.buckets):
                        return self.buckets[i]
                    return self._max
            return self._max

    def count_le(self, v):
        """Observations ``<=`` the smallest bucket bound ``>= v`` —
        the cumulative count a Prometheus ``le`` bucket would report.
        Exact when ``v`` IS a bucket bound; otherwise the threshold is
        quantized UP to the next bound (fixed buckets cannot resolve
        between bounds). ``v`` past the last bound counts everything.
        This is the attainment primitive :class:`SloWindow` reads."""
        i = bisect.bisect_left(self.buckets, float(v))
        with self._lock:
            if i >= len(self.buckets):
                return self._count
            return sum(self._counts[:i + 1])

    def _reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def _snap(self):
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            snap = {
                "count": self._count,
                "sum": round(self._sum, 6),
                "mean": round(self._sum / self._count, 6),
                "min": round(self._min, 6),
                "max": round(self._max, 6),
                "buckets": {("%g" % b): c for b, c in
                            zip(self.buckets, self._counts)
                            if c},
            }
            if self._counts[-1]:
                snap["buckets"]["+Inf"] = self._counts[-1]
        snap["p50"] = self.percentile(0.50)
        snap["p99"] = self.percentile(0.99)
        return snap


# ---------------------------------------------------------------------------
# registry

def _get(name, cls, **kw):
    with _state.lock:
        m = _state.metrics.get(name)
        if m is None:
            m = cls(name, **kw) if kw else cls(name)
            _state.metrics[name] = m
        elif not isinstance(m, cls):
            raise MXNetError("telemetry metric %r already registered as "
                             "%s" % (name, m.kind))
        return m


def counter(name):
    """Get-or-create the named :class:`Counter`."""
    return _get(name, Counter)


def gauge(name):
    """Get-or-create the named :class:`Gauge`."""
    return _get(name, Gauge)


def histogram(name, buckets=None):
    """Get-or-create the named :class:`Histogram` (``buckets`` applies
    only on first creation)."""
    if buckets is None:
        return _get(name, Histogram)
    return _get(name, Histogram, buckets=buckets)


def enable(flag=True):
    """Globally enable/disable collection (``MXNET_TELEMETRY=0`` sets
    the import-time default). Disabled metrics keep their accumulated
    values; spans become no-ops."""
    _state.enabled = bool(flag)


def enabled():
    return _state.enabled


def reset():
    """Zero every registered metric and drop buffered trace events
    (registered objects stay valid — instrumentation sites hold
    references). Test/benchmark hygiene."""
    with _state.lock:
        metrics = list(_state.metrics.values())
    for m in metrics:
        m._reset()
    with _state.trace_lock:
        _state.trace_events = []
        _state.trace_dropped = 0


def snapshot(prefix=None):
    """Nested dict of every metric, keyed by the dotted name's
    segments: ``serving.ttft_ms`` lands at
    ``snap["serving"]["ttft_ms"]``. Counters/gauges are scalars,
    histograms small dicts (count/sum/mean/min/max/p50/p99/buckets).
    ``prefix`` restricts to names starting with it (e.g.
    ``"serving."`` — what ``/snapshot?prefix=serving.`` serves a
    fleet scraper that only wants the serving subtree)."""
    with _state.lock:
        items = sorted(_state.metrics.items())
    if prefix:
        items = [(n, m) for n, m in items if n.startswith(prefix)]
    names = {name for name, _ in items}
    out = {}
    for name, m in items:
        parts = name.split(".")
        d = out
        ok = True
        for i, p in enumerate(parts[:-1]):
            # an intermediate node that IS a registered metric must not
            # be descended into — a histogram's snapshot is a dict, and
            # "x.y.z" would silently merge into histogram "x.y"'s entry
            if ".".join(parts[:i + 1]) in names:
                ok = False
                break
            nxt = d.setdefault(p, {})
            if not isinstance(nxt, dict):
                ok = False
                break
            d = nxt
        if ok and parts[-1] not in d:
            d[parts[-1]] = m._snap()
        else:  # name collides with a subtree: fall back to the flat key
            out[name] = m._snap()
    return out


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def to_prometheus(prefix=None):
    """Prometheus text exposition of the registry (the shape a
    ``/metrics`` endpoint would serve). Dots become underscores;
    counters gain the conventional ``_total`` suffix; histograms emit
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``.
    ``prefix`` filters by DOTTED name prefix (pre-mangling:
    ``prefix="serving."`` keeps every ``mxnet_serving_*`` family) —
    the ``/metrics?prefix=`` subtree scrape."""
    lines = []
    with _state.lock:
        items = sorted(_state.metrics.items())
    if prefix:
        items = [(n, m) for n, m in items if n.startswith(prefix)]
    for name, m in items:
        base = "mxnet_" + _PROM_BAD.sub("_", name)
        if m.kind == "counter":
            lines.append("# TYPE %s_total counter" % base)
            lines.append("%s_total %d" % (base, m.value))
        elif m.kind == "gauge":
            lines.append("# TYPE %s gauge" % base)
            lines.append("%s %.17g" % (base, m.value))
        else:
            lines.append("# TYPE %s histogram" % base)
            acc = 0
            with m._lock:
                counts = list(m._counts)
                total, tsum = m._count, m._sum
                vmin, vmax = m._min, m._max
            for b, c in zip(m.buckets, counts):
                acc += c
                lines.append('%s_bucket{le="%g"} %d' % (base, b, acc))
            lines.append('%s_bucket{le="+Inf"} %d' % (base, total))
            lines.append("%s_sum %.17g" % (base, tsum))
            lines.append("%s_count %d" % (base, total))
            if total:
                # exact streaming extrema next to the bucket-approx
                # quantiles: scrapers can see how far a tail reading
                # may sit from the bucket bound that reported it
                lines.append("# TYPE %s_min gauge" % base)
                lines.append("%s_min %.17g" % (base, vmin))
                lines.append("# TYPE %s_max gauge" % base)
                lines.append("%s_max %.17g" % (base, vmax))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Chrome trace_event spans

def tracing():
    """True while a trace capture is armed."""
    return _state.trace_active


def start_trace(path):
    """Arm span capture. ``path`` may be a directory (a
    ``mx_trace_<pid>.json`` file is created inside) or a ``.json``
    file path. Re-arming while active flushes the previous capture
    first. Automatically armed at import when ``MXNET_TRACE_DIR`` is
    set; flushed at interpreter exit."""
    if _state.trace_active:
        stop_trace()
    if path.endswith(".json"):
        # file form: make sure the flush destination can exist NOW —
        # discovering a missing parent directory at the atexit flush
        # would silently lose the whole capture
        parent = os.path.dirname(path)
        if parent:
            if os.path.exists(parent) and not os.path.isdir(parent):
                raise MXNetError(
                    "telemetry trace path %r: parent %r exists and is "
                    "not a directory" % (path, parent))
            os.makedirs(parent, exist_ok=True)
    else:
        # directory form — refuse loudly if the path is taken by a
        # plain file (os.makedirs would raise a bare FileExistsError)
        if os.path.exists(path) and not os.path.isdir(path):
            raise MXNetError(
                "telemetry trace path %r exists and is not a directory "
                "(pass a directory, or a path ending in .json)" % path)
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "mx_trace_%d.json" % os.getpid())
    with _state.trace_lock:
        _state.trace_events = []
        _state.trace_dropped = 0
        _state.trace_path = path
        _state.trace_epoch = time.perf_counter()
        _state.trace_active = True
    return path


def stop_trace():
    """Disarm and flush the capture to its JSON file
    (``{"traceEvents": [...]}`` — the Chrome ``trace_event`` format
    Perfetto and chrome://tracing open directly). Returns the file
    path, or None when no capture was active."""
    with _state.trace_lock:
        if not _state.trace_active:
            return None
        _state.trace_active = False
        events, _state.trace_events = _state.trace_events, []
        dropped = _state.trace_dropped
        path = _state.trace_path
        _state.trace_path = None
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if dropped:
        doc["mxnetDroppedEvents"] = dropped
    with open(path, "w") as f:
        json.dump(doc, f)
    logging.info("telemetry: wrote %d trace events to %s%s",
                 len(events), path,
                 " (%d dropped at the buffer cap)" % dropped
                 if dropped else "")
    return path


def _emit(ev):
    with _state.trace_lock:
        if not _state.trace_active:
            return
        if len(_state.trace_events) >= _MAX_TRACE_EVENTS:
            _state.trace_dropped += 1
            return
        _state.trace_events.append(ev)


def trace_complete(name, t0, dur_s, cat="mx", args=None):
    """Low-level: record one complete ("X") span from a caller that
    timed itself (``t0`` = perf_counter at entry, ``dur_s`` seconds).
    Nesting in the viewer is positional: events on the same thread
    whose [ts, ts+dur] contain each other render nested — no parent
    bookkeeping needed."""
    if not (_state.enabled and _state.trace_active):
        return
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": (t0 - _state.trace_epoch) * 1e6,
          "dur": dur_s * 1e6,
          "pid": os.getpid(), "tid": threading.get_native_id()}
    if args:
        ev["args"] = args
    _emit(ev)


def mark(name, cat="mx", **args):
    """Record an instant event (compile, reconnect, crash-recovery —
    point-in-time happenings with no duration)."""
    if not (_state.enabled and _state.trace_active):
        return
    ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
          "ts": (time.perf_counter() - _state.trace_epoch) * 1e6,
          "pid": os.getpid(), "tid": threading.get_native_id()}
    if args:
        ev["args"] = args
    _emit(ev)


@contextlib.contextmanager
def tracing_paused():
    """Temporarily suppress span/mark emission without disarming the
    capture — for self-measuring code (bench A/B arms) whose own spans
    would be noise in the user's trace. Emission resumes on exit
    unless the capture was stopped inside the block."""
    with _state.trace_lock:
        was = _state.trace_active
        _state.trace_active = False
    try:
        yield
    finally:
        with _state.trace_lock:
            # stop_trace inside the block wins: resuming onto a
            # flushed capture would buffer events nobody ever writes
            _state.trace_active = was and _state.trace_path is not None


@contextlib.contextmanager
def span(name, cat="mx", hist=None, **args):
    """Time a region: always feeds ``hist`` (a :class:`Histogram`, in
    milliseconds) when given, and records a trace span while a capture
    is armed. Near-free when disabled (one flag check)."""
    if not _state.enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if hist is not None:
            hist.observe(dt * 1e3)
        if _state.trace_active:
            trace_complete(name, t0, dt, cat=cat, args=args or None)


# ---------------------------------------------------------------------------
# SLO accounting: multi-window burn rates over an existing histogram

class SloWindow:
    """Multi-window SLO burn-rate gauges computed from an existing
    cumulative :class:`Histogram` (the JAX package's
    doc/observability.md, "SLO accounting").

    The histogram already holds every observation; what an SLO needs
    on top is *windowed attainment*: of the observations in the last
    W seconds, what fraction beat the target latency, and how fast is
    that burning the error budget? ``tick()`` samples the histogram's
    ``(count, count_le(threshold))`` pair on a bounded cadence and
    differences the samples per window:

        burn = (misses_in_window / observations_in_window)
               / (1 - target)

    so burn 1.0 = missing exactly the budgeted rate (e.g. 1% for
    target 0.99), burn 10 = burning budget 10x too fast — the
    standard multi-window multi-burn-rate alerting shape (SRE
    workbook ch. 5). The threshold is quantized UP to the histogram's
    next bucket bound (:meth:`Histogram.count_le`); windows with no
    observations read 0 (no traffic burns no budget).

    ``windows``: sequence of ``(seconds, Gauge)`` — the gauges are
    created by the caller with literal names so the metric catalog
    lint can see them. Host-side and allocation-bounded: one sample
    per ``min_interval_s`` at most, pruned past the longest window.
    """

    def __init__(self, hist, threshold, target=0.99, windows=(),
                 min_interval_s=1.0):
        if not 0.0 < float(target) < 1.0:
            raise MXNetError("SloWindow: target must be in (0, 1), "
                             "got %r" % (target,))
        self.hist = hist
        self.threshold = float(threshold)
        self.budget = 1.0 - float(target)
        self.windows = tuple(sorted(((float(w), g) for w, g in windows),
                                    key=lambda p: p[0]))
        self.min_interval_s = float(min_interval_s)
        self._samples = collections.deque()
        self._last = None
        # tick() is called from the owning loop AND from exposition-
        # server scrape threads; the deque iteration must not race a
        # concurrent append/popleft (the rate-limit check alone is
        # racy). Uncontended lock: ~100 ns, once per >= min_interval.
        self._lock = threading.Lock()

    def tick(self, now=None):
        """Sample the histogram and refresh every window's burn
        gauge. Rate-limited: calls within ``min_interval_s`` of the
        previous sample are free no-ops, so per-round callers don't
        accumulate unbounded samples. Thread-safe."""
        if not (_state.enabled and self.windows):
            return
        if now is None:
            now = time.perf_counter()
        with self._lock:
            self._tick_locked(now)

    def _tick_locked(self, now):
        if self._last is not None \
                and now - self._last < self.min_interval_s:
            return
        self._last = now
        # ok BEFORE total: the two reads are separate histogram lock
        # acquisitions, and an observe landing between them must err
        # toward counting the racing observation as a miss (bounded by
        # the clamp below) — the other order could read ok > total and
        # export a NEGATIVE burn rate
        ok = self.hist.count_le(self.threshold)
        total = self.hist.count
        self._samples.append((now, total, ok))
        horizon = now - self.windows[-1][0]
        # keep ONE sample at-or-before the horizon: it is the longest
        # window's baseline
        while len(self._samples) >= 2 and self._samples[1][0] <= horizon:
            self._samples.popleft()
        for w, g in self.windows:
            base = self._samples[0]
            for s in self._samples:
                if s[0] <= now - w:
                    base = s
                else:
                    break
            d_total = total - base[1]
            d_ok = ok - base[2]
            if d_total <= 0:
                g.set(0.0)
            else:
                miss_frac = min(1.0, max(
                    0.0, 1.0 - d_ok / float(d_total)))
                g.set(miss_frac / self.budget)


# ---------------------------------------------------------------------------
# HTTP exposition (telemetry_http.py holds the server; these are the
# JAX package's entry points)

def serve(port=0, host="127.0.0.1"):
    """Start (or restart) the read-only HTTP exposition server on a daemon
    thread: ``GET /metrics`` (Prometheus text), ``/snapshot`` (JSON),
    ``/rounds``, ``/requests``, ``/flight/<id>``, ``/fleet``,
    ``/fleet/flight/<id>`` and ``/healthz``. ``port=0`` binds an ephemeral
    port. Returns the server handle (``.url``, ``.port``, ``.stop()``).
    ``MXNET_TELEMETRY_PORT`` starts one when ``telemetry_http`` is
    imported."""
    from . import telemetry_http
    return telemetry_http.serve(port=port, host=host)


def stop_server():
    """Stop the exposition server (no-op when none runs)."""
    from . import telemetry_http
    telemetry_http.stop_server()


# ---------------------------------------------------------------------------
# periodic logging reporter

def _summary_line():
    """One compact human line: every counter/gauge, histograms as
    count/mean/p99."""
    with _state.lock:
        items = sorted(_state.metrics.items())
    bits = []
    for name, m in items:
        if m.kind == "counter":
            if m.value:
                bits.append("%s=%d" % (name, m.value))
        elif m.kind == "gauge":
            if m.value:
                bits.append("%s=%.4g" % (name, m.value))
        elif m.count:
            bits.append("%s[n=%d mean=%.3g p99=%.3g]"
                        % (name, m.count, m.sum / m.count,
                           m.percentile(0.99)))
    return " ".join(bits) if bits else "(no activity)"


def start_reporter(interval_s, logger=None):
    """Log :func:`_summary_line` every ``interval_s`` seconds on a
    daemon thread (``MXNET_TELEMETRY_LOG_INTERVAL`` starts one at
    import). Restarting replaces the previous reporter."""
    stop_reporter()
    log = logger if logger is not None else logging.getLogger(__name__)
    stop = threading.Event()

    def run():
        while not stop.wait(interval_s):
            log.info("telemetry: %s", _summary_line())

    t = threading.Thread(target=run, daemon=True,
                         name="mx-telemetry-reporter")
    _state.reporter, _state.reporter_stop = t, stop
    t.start()
    return t


def stop_reporter():
    if _state.reporter_stop is not None:
        _state.reporter_stop.set()
        _state.reporter = None
        _state.reporter_stop = None


# ---------------------------------------------------------------------------
# import-time arming from the environment

# flush any still-armed capture at interpreter exit — covers both the
# MXNET_TRACE_DIR auto-arm below and a manual start_trace the caller
# forgot to stop (stop_trace is a no-op when nothing is active)
atexit.register(stop_trace)

_trace_dir = os.environ.get("MXNET_TRACE_DIR")
if _trace_dir:
    try:
        start_trace(_trace_dir)
    except Exception as _e:
        # a bad knob value must not take down `import mxnet_tpu_torch`
        logging.warning("MXNET_TRACE_DIR=%r is unusable (%s) — trace "
                        "capture not armed", _trace_dir, _e)

_log_interval = os.environ.get("MXNET_TELEMETRY_LOG_INTERVAL")
if _log_interval:
    try:
        _iv = float(_log_interval)
    except ValueError:
        logging.warning("MXNET_TELEMETRY_LOG_INTERVAL=%r is not a "
                        "number; reporter not started", _log_interval)
    else:
        if _iv > 0:
            start_reporter(_iv)
