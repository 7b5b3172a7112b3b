"""Fleet-level serving: N engines behind an admission router.

Counterpart of ``mxnet_tpu/serving/fleet.py`` (the port's own copy; the
router is host-side bookkeeping over the engines' public seams, so it is
the JAX package's, line for line, over the port's engines).

One :class:`~mxnet_tpu_torch.serving.InferenceEngine` is still a single
point of failure: a dead replica loses every in-flight request, and there
is no way to take one out of rotation for a deploy. :class:`FleetRouter`
fronts N replicas with the serving contract intact:

* **Health-driven routing** — submits are placed by each replica's live
  ``health()`` signals (closed / stuck / draining / queue depth / busy
  slots), with **prefix affinity**: the replica whose prefix trie retains
  the longest prefix of the prompt wins placement (ties broken
  least-loaded), so shared-prefix traffic keeps landing where its K/V rows
  already live.
* **Transport discipline** (the kvstore client's, repurposed for request
  traffic): channel ops carry a per-request timeout, bounded exponential
  backoff with jitter on retry, a ping heartbeat that tells a dead replica
  from a slow one, and ``(client_id, seq)`` dedup so a caller's retried
  submit admits **exactly once** — at the router by the dedup table, at
  the replica by adopting an already-admitted request id instead of
  resubmitting it.
* **Failover** — a replica that dies mid-round (its ``step()`` raises a
  non-engine error), trips its watchdog, or misses ``heartbeat_misses``
  consecutive pings is declared dead: the router takes the ``snapshot()``
  of its host scheduler (valid after a crash — no device state), closes
  it, and resubmits every unfinished request on healthy peers with
  ``_resume_tokens``, so greedy continuations stay **byte-identical** to
  an uninterrupted run (the peer prefills the prompt and regenerates the
  emitted tokens: the port's ``Request`` says why).
* **Drain** (:meth:`FleetRouter.drain`) — the rolling-restart half: mark
  the replica ``draining`` (admission stops, ``health()`` reports the
  state), migrate its in-flight requests to peers the same
  snapshot/resubmit way, close it. ``add_replica`` brings the restarted
  successor back into rotation. A capture replayed through a fleet under a
  rolling restart verifies byte-identical with zero failed requests
  (``python -m mxnet_tpu_torch.serving.replay --replicas 2
  --rolling-restart``).
* **Fleet-wide overload** — the engines' typed policies compose across
  replicas: a submit is tried against every healthy replica in placement
  order and only when ALL of them refuse does the router raise (typed
  :class:`EngineOverloaded` when the fleet is shedding, the generic
  backpressure ``MXNetError`` under ``block`` policies). Requests orphaned
  mid-migration (the restore target died too) wait in a router-side hold
  queue and re-place as replicas return.

The router mirrors the engine's driving surface (``submit``/``step``/
``serve_forever``/``queued``/``max_queue``/``idle``/``health``), so
:func:`~mxnet_tpu_torch.serving.replay.replay` replays a capture through a
fleet unchanged. Replicas run the same programs as alone; the per-replica
compile-count contract is untouched. On one card every replica shares the
device: the router steps them one after the other from one host thread.

Knobs (constructor args override the ``MXNET_FLEET_*`` environment
defaults): ``timeout_ms``, ``max_retries``, ``backoff_ms``,
``heartbeat_ms``, ``heartbeat_misses``.

**Disaggregated prefill/decode**: with role-specialized replicas
(``InferenceEngine(role=...)``) the router places fresh prompts on
prefill/unified replicas only, collects each finished prefill's
:class:`~mxnet_tpu_torch.serving.handoff.KVHandoff` package, and delivers
it to the least-loaded decode-capable replica — consulting decode-side
prefix affinity first, so a pool hit ships NO rows at all. Delivery rides
the same transport discipline as submits (timeout, bounded retries,
exactly-once via the target's import dedup), and losing either specialist
falls back to unified serving on the survivor (the failover path widens
its role).

Observability: ``fleet.failovers``, ``fleet.drains``,
``fleet.migrated_requests``, ``fleet.retries``, ``fleet.dedup_hits``,
``fleet.heartbeat_misses``, ``fleet.affinity_hits``,
``fleet.handoff_count``/``fleet.handoff_bytes`` counters, the
``fleet.handoff_ms`` histogram and the ``fleet.replicas_live`` gauge.

**Fleet tracing**: the router mints a request-scoped trace context at
:meth:`submit` — the fleet request id plus a hop counter — and threads it
through every engine placement, the :class:`KVHandoff` wire format, and
failover resubmits, so each engine's flight record carries the fleet
identity. Its own :class:`FleetFlightRecorder` ring records the
transitions the fleet owns (``placed`` / ``in_transit`` / ``admitted`` /
``retried`` / ``failover`` / ``drained`` / ``migrated``) on the ABSOLUTE
``perf_counter`` clock and absorbs each per-engine flight record as its
hop completes, so ``FleetRouter.flight.timeline(trace_id)`` stitches one
ordered cross-replica journey (``GET /fleet/flight/<id>`` on the
exposition server; ``?chrome=1`` exports a Perfetto track-per-replica
trace). End-to-end SLOs are measured from ROUTER arrival and decomposed
into ``router_queue / prefill / handoff_wait / decode_admission /
decode`` components that sum to the end-to-end wall time by construction:
``fleet.ttft_ms``/``fleet.cadence_ms`` histograms, ``fleet.slo_*``
attained/missed counters and multi-window burn gauges
(``telemetry.SloWindow``), all surfaced by ``GET /fleet``.

Fault injection: ``mxnet_tpu_torch.testing.faults`` installs itself as
:data:`_FLEET_FAULTS` and drives the router's seams deterministically
(kill-replica-mid-round, heartbeat blackhole, slow replica, submit and
handoff failures).
"""
from __future__ import annotations

import collections
import contextlib
import os
import random
import threading
import time
import weakref

import numpy as np

from .. import telemetry as tele
from ..base import MXNetError
from .engine import (EngineClosed, EngineOverloaded, EngineStuck,
                     _TM_HANDOFF_WAIT)

__all__ = ["FleetRouter", "FleetRequest", "FleetFlightRecorder"]

# live routers, for the exposition server's /fleet plane (weak: a
# router the caller dropped must not be kept alive by telemetry)
_ROUTERS = weakref.WeakSet()

# FaultInjector hook point (mxnet_tpu_torch.testing.faults installs itself
# here while a fleet fault plan is active)
_FLEET_FAULTS = None


def _timeout_s():
    """Per-channel-op timeout in seconds (MXNET_FLEET_TIMEOUT_MS): an
    op slower than this counts as a timeout and triggers the
    dead-vs-slow heartbeat probe before any resend."""
    return float(os.environ.get("MXNET_FLEET_TIMEOUT_MS", "1000")) / 1e3


def _max_retries():
    """Resend budget AFTER the first attempt (MXNET_FLEET_MAX_RETRIES)."""
    return int(os.environ.get("MXNET_FLEET_MAX_RETRIES", "3"))


def _backoff_base_s():
    """Base retry backoff in seconds (MXNET_FLEET_BACKOFF_MS)."""
    return float(os.environ.get("MXNET_FLEET_BACKOFF_MS", "5")) / 1e3


def _heartbeat_s():
    """Ping cadence per replica in seconds (MXNET_FLEET_HEARTBEAT_MS)."""
    return float(os.environ.get("MXNET_FLEET_HEARTBEAT_MS", "100")) / 1e3


def _heartbeat_misses():
    """Consecutive missed pings before a replica is declared dead
    (MXNET_FLEET_HEARTBEAT_MISSES)."""
    return int(os.environ.get("MXNET_FLEET_HEARTBEAT_MISSES", "3"))


_TM_FAILOVERS = tele.counter("fleet.failovers")
_TM_DRAINS = tele.counter("fleet.drains")
_TM_MIGRATED = tele.counter("fleet.migrated_requests")
_TM_RETRIES = tele.counter("fleet.retries")
_TM_DEDUP = tele.counter("fleet.dedup_hits")
_TM_HB_MISSES = tele.counter("fleet.heartbeat_misses")
_TM_AFFINITY = tele.counter("fleet.affinity_hits")
_TM_LIVE = tele.gauge("fleet.replicas_live")
# KV handoff (disaggregated prefill/decode): delivered packages, the
# bytes that actually shipped (0 for pool-hit skips), and per-delivery
# channel time; serving.handoff_wait_ms (engine module) gets the
# export-ready -> admitted wait observed here at delivery
_TM_HANDOFF_COUNT = tele.counter("fleet.handoff_count")
_TM_HANDOFF_BYTES = tele.counter("fleet.handoff_bytes")
_TM_HANDOFF_MS = tele.histogram("fleet.handoff_ms")
# End-to-end SLO accounting measured from ROUTER arrival (the engine's
# serving.ttft_ms starts at engine admission and restarts on every
# migration — the fleet figure is what the caller actually saw).
# Attainment counters tick once per request at the same host-side
# points that feed the histograms; the burn gauges are multi-window
# derivatives (tele.SloWindow), refreshed per step and per scrape.
# Declared with literal names so the metric catalog lint sees them.
_TM_FLEET_TTFT = tele.histogram("fleet.ttft_ms")
_TM_FLEET_CADENCE = tele.histogram("fleet.cadence_ms")
_TM_FLEET_SLO_TTFT_OK = tele.counter("fleet.slo_ttft_attained")
_TM_FLEET_SLO_TTFT_MISS = tele.counter("fleet.slo_ttft_missed")
_TM_FLEET_SLO_CAD_OK = tele.counter("fleet.slo_cadence_attained")
_TM_FLEET_SLO_CAD_MISS = tele.counter("fleet.slo_cadence_missed")
_FLEET_SLO_TTFT_WINDOWS = (
    (60.0, tele.gauge("fleet.slo_ttft_burn_1m")),
    (300.0, tele.gauge("fleet.slo_ttft_burn_5m")),
    (3600.0, tele.gauge("fleet.slo_ttft_burn_1h")))
_FLEET_SLO_CADENCE_WINDOWS = (
    (60.0, tele.gauge("fleet.slo_cadence_burn_1m")),
    (300.0, tele.gauge("fleet.slo_cadence_burn_5m")),
    (3600.0, tele.gauge("fleet.slo_cadence_burn_1h")))

# the five SLO decomposition components, in journey order; they sum to
# the end-to-end wall time by construction (``decode`` is the
# remainder: the phases sum to the wall time)
_SLO_COMPONENTS = ("router_queue", "prefill", "handoff_wait",
                   "decode_admission", "decode")


class _FleetFlight:
    """One fleet request's stitched record: router/wire events plus
    the per-engine flight events absorbed as each hop completed.
    Events carry ABSOLUTE ``perf_counter`` stamps (``"t"``) and the
    scope that recorded them (``"router"`` or an engine id); rendering
    re-bases everything onto ``t0`` — the router submit — so one
    monotonic ``t_ms`` axis orders the whole cross-replica journey."""

    __slots__ = ("rid", "t0", "meta", "events", "dropped", "hops",
                 "absorbed")

    def __init__(self, rid, t0, meta):
        self.rid = rid
        self.t0 = t0
        self.meta = meta
        self.events = []
        self.dropped = 0
        self.hops = []          # engine ids, placement order
        self.absorbed = {}      # (engine_id, t0_us) -> events taken


class FleetFlightRecorder:
    """Bounded ring of stitched cross-replica request timelines — the
    fleet-level counterpart of :class:`~.flight.FlightRecorder`, same
    design constraints (host-side only, bounded everywhere, terminal
    event always lands).

    The router records its OWN transitions directly (placement,
    wire movement, retries, failover) and ABSORBS each engine's
    flight record when the request's hop there ends — engine records
    are keyed by request id and a failover resubmit or decode-side
    admission restarts/evicts them, so copying events out at hop
    boundaries is what makes the stitched journey survive the very
    faults it exists to explain. Event budget is per-request
    (``max_events``, terminal ``retire`` always lands); the ring keeps
    the last ``retain`` retired journeys."""

    def __init__(self, retain=256, max_events=512):
        self.retain = max(0, int(retain))
        self.max_events = max(8, int(max_events))
        self._live = {}                            # rid -> _FleetFlight
        self._retired = collections.OrderedDict()  # FIFO ring
        self._lock = threading.Lock()
        self._owner = None      # weakref to the router (set by it)

    @property
    def enabled(self):
        return self.retain > 0 and tele.enabled()

    # -- recording (router thread) --------------------------------------
    def start(self, rid, **meta):
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            self._live[rid] = fl = _FleetFlight(rid, now, dict(meta))
        self._append(fl, now, "router", "submit", meta or None)

    def event(self, rid, name, scope="router", **args):
        if not self.enabled:
            return
        with self._lock:
            fl = self._live.get(rid)
        if fl is not None:
            self._append(fl, time.perf_counter(), scope, name,
                         args or None)

    def hop(self, rid, engine_id):
        """Record a placement hop (consecutive duplicates collapse)."""
        if not self.enabled:
            return
        with self._lock:
            fl = self._live.get(rid)
            if fl is not None and (not fl.hops
                                   or fl.hops[-1] != engine_id):
                fl.hops.append(engine_id)

    def absorb(self, rid, engine_id, records):
        """Fold one engine's flight records for ``rid`` into the
        stitched journey. ``records`` is
        ``FlightRecorder.records(rid)`` — ``(t0, events)`` pairs with
        ABSOLUTE ``t0`` and per-record-relative event times.
        Idempotent per record: a record absorbed mid-life (a live
        ``timeline()`` query) and again at hop end only appends the
        events that arrived in between."""
        if not self.enabled:
            return
        with self._lock:
            fl = self._live.get(rid)
            if fl is None:
                return
            for t0, events in records:
                key = (engine_id, int(round(t0 * 1e6)))
                taken = fl.absorbed.get(key, 0)
                for ev in events[taken:]:
                    if len(fl.events) >= self.max_events:
                        fl.dropped += 1
                        continue
                    out = dict(ev)
                    out["t"] = t0 + out.pop("t_ms", 0.0) / 1e3
                    out["scope"] = engine_id
                    fl.events.append(out)
                fl.absorbed[key] = len(events)

    def retire(self, rid, reason, **args):
        """Terminal event: moves the journey to the retired ring.
        ``slo=`` (the decomposition dict) is folded into the record's
        meta so ``timeline()`` surfaces it without event spelunking."""
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            fl = self._live.pop(rid, None)
            if fl is None:
                return
            fl.meta["retire_reason"] = reason
            if "slo" in args:
                fl.meta["slo"] = args["slo"]
            self._retired[rid] = fl
            self._retired.move_to_end(rid)
            while len(self._retired) > self.retain:
                self._retired.popitem(last=False)
        args = dict(args)
        args["reason"] = reason
        self._append(fl, now, "router", "retire", args, terminal=True)

    def _append(self, fl, now, scope, name, args, terminal=False):
        ev = {"t": now, "scope": scope, "event": name}
        if args:
            for k, v in args.items():
                ev.setdefault(k, v)
        with self._lock:
            if len(fl.events) >= self.max_events and not terminal:
                fl.dropped += 1
            else:
                fl.events.append(ev)
        if tele.tracing():
            tele.mark("fleet.flight." + name, cat="fleet.flight",
                      request=str(fl.rid), scope=scope)

    # -- reconstruction (any thread) ------------------------------------
    def _get(self, rid):
        fl = self._live.get(rid)
        live = fl is not None
        if fl is None:
            fl = self._retired.get(rid)
        return fl, live

    def timeline(self, rid):
        """The stitched journey: ``{"id", "live", "meta", "hops",
        "events", "dropped_events"}``, events sorted on one monotonic
        clock with ``t_ms`` relative to ROUTER submit and ``scope``
        naming who recorded each one — or None if never recorded /
        evicted. Live queries first sweep the current replica's flight
        record so in-progress hops show up too."""
        owner = self._owner() if self._owner is not None else None
        if owner is not None:
            owner._absorb_live(rid)
        with self._lock:
            fl, live = self._get(rid)
            if fl is None:
                return None
            events = sorted(fl.events, key=lambda ev: ev["t"])
            out = []
            for ev in events:
                r = {"t_ms": round((ev["t"] - fl.t0) * 1e3, 3),
                     "scope": ev["scope"], "event": ev["event"]}
                r.update({k: v for k, v in ev.items()
                          if k not in ("t", "scope", "event")})
                out.append(r)
            return {"id": fl.rid, "live": live, "meta": dict(fl.meta),
                    "hops": list(fl.hops), "events": out,
                    "dropped_events": fl.dropped}

    def chrome_trace(self, rid):
        """Perfetto/chrome://tracing export of one stitched journey:
        one track ("thread") per scope — router first, then each
        engine in hop order — instant events for the journey, and the
        SLO decomposition rendered as back-to-back spans on the router
        track (they sum to end-to-end by construction, so the spans
        tile the request's wall time). Times in µs since router
        submit."""
        tl = self.timeline(rid)
        if tl is None:
            return None
        scopes = ["router"]
        for ev in tl["events"]:
            if ev["scope"] not in scopes:
                scopes.append(ev["scope"])
        tid = {s: i for i, s in enumerate(scopes)}
        evs = [{"name": "thread_name", "ph": "M", "pid": 0,
                "tid": tid[s], "args": {"name": s}} for s in scopes]
        for ev in tl["events"]:
            evs.append({
                "name": ev["event"], "ph": "i", "s": "t", "pid": 0,
                "tid": tid[ev["scope"]], "ts": ev["t_ms"] * 1e3,
                "cat": "fleet.flight",
                "args": {k: v for k, v in ev.items()
                         if k not in ("t_ms", "scope", "event")}})
        slo = tl["meta"].get("slo")
        if slo:
            t = 0.0
            for comp in _SLO_COMPONENTS:
                dur = float(slo.get(comp, 0.0))
                evs.append({"name": comp, "ph": "X", "pid": 0,
                            "tid": tid["router"], "ts": t * 1e3,
                            "dur": dur * 1e3, "cat": "fleet.slo",
                            "args": {"ms": dur}})
                t += dur
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"trace_id": str(tl["id"]),
                              "hops": tl["hops"]}}

    def rows(self):
        """Summary rows for the retired ring (oldest first)."""
        now = time.perf_counter()
        with self._lock:
            return [{"id": fl.rid, "state": "retired",
                     "retire_reason": fl.meta.get("retire_reason"),
                     "hops": list(fl.hops),
                     "age_s": round(now - fl.t0, 3),
                     "events": len(fl.events)}
                    for fl in self._retired.values()]

    def ids(self):
        with self._lock:
            return list(self._live), list(self._retired)


class FleetRequest:
    """Router-level request handle: delegates to the CURRENT underlying
    engine :class:`~mxnet_tpu_torch.serving.Request` and is re-pointed when
    the request migrates (failover or drain), so the caller's handle
    survives any replica. While the request sits in the router's hold
    queue (every placement target refused — mid-migration limbo) the
    tokens drained before the migration stay readable.

    The surface mirrors what callers and ``serving.replay``
    read off an engine handle: ``tokens``, ``done``, ``retire_reason``,
    ``result()``, ``resumed``, ``t_submit``/``t_first``/``t_done``,
    plus ``replica_id`` (where it lives now) and ``migrations``."""

    __slots__ = ("id", "client_key", "migrations", "resumed",
                 "_rec", "_cur", "_replica_id", "_t_submit", "_t_first",
                 "_deadline_abs", "_ttft_deadline_abs", "_error",
                 "_cancelled", "_hop", "_detached_from", "_t_place",
                 "_t_ready", "_t_deliver", "_admit_ms", "_ttft_seen",
                 "_finalized")

    def __init__(self, rid, rec, client_key=None):
        self.id = rid
        self.client_key = client_key
        self.migrations = 0
        # trace context: the fleet id IS the trace id; _hop counts
        # engine placements (0 = still router-side). The _t_* stamps
        # are the SLO decomposition breakpoints: first placement,
        # handoff package ready,
        # handoff delivered, and the delivery channel-op cost.
        self._hop = 0
        self._detached_from = None
        self._t_place = None
        self._t_ready = None
        self._t_deliver = None
        self._admit_ms = None
        self._ttft_seen = None    # fleet TTFT observed (once)
        self._finalized = False   # fleet SLO/flight retirement ran
        # what replay() subtracts from the token count: the resume
        # prefix of the ORIGINAL fleet submit, never inflated by
        # migrations (migrated tokens were generated in this run)
        self.resumed = len(rec["tokens"])
        self._rec = rec            # resubmission record (snapshot shape)
        self._cur = None           # underlying Request, None while held
        self._replica_id = None
        now = time.perf_counter()
        self._t_submit = now
        self._t_first = None
        self._deadline_abs = None if rec.get("deadline_ms") is None \
            else now + rec["deadline_ms"] / 1e3
        self._ttft_deadline_abs = None \
            if rec.get("ttft_deadline_ms") is None \
            else now + rec["ttft_deadline_ms"] / 1e3
        self._error = None
        self._cancelled = False

    # -- delegation ---------------------------------------------------
    @property
    def tokens(self):
        if self._cur is not None:
            return self._cur.tokens
        return list(self._rec["tokens"])

    @property
    def done(self):
        if self._error is not None or self._cancelled:
            return True
        # "handoff" is a LOCAL retirement only: the prefill replica is
        # finished with the request, the fleet is not — the package is
        # in transit to a decode replica
        return self._cur is not None and self._cur.done \
            and self._cur.retire_reason != "handoff"

    @property
    def retire_reason(self):
        if self._error is not None:
            return "shed" if isinstance(self._error, EngineOverloaded) \
                else "error"
        if self._cancelled:
            return "cancelled"
        if self._cur is None or self._cur.retire_reason == "handoff":
            return None
        return self._cur.retire_reason

    @property
    def replica_id(self):
        return self._replica_id

    @property
    def t_submit(self):
        return self._t_submit

    @property
    def t_first(self):
        if self._t_first is not None:
            return self._t_first
        return None if self._cur is None else self._cur.t_first

    @property
    def t_done(self):
        return None if self._cur is None else self._cur.t_done

    @property
    def prefix_hit_tokens(self):
        return 0 if self._cur is None \
            else getattr(self._cur, "prefix_hit_tokens", 0)

    def result(self):
        """The emitted tokens (resume prefix included), or the typed
        error this request was retired with — same contract as
        ``Request.result()``, across however many replicas served it."""
        if self._error is not None:
            raise self._error
        if self._cur is None:
            if self._cancelled:
                return np.asarray(self._rec["tokens"], np.int64)
            raise MXNetError(
                "FleetRequest %r is awaiting re-placement (every "
                "replica refused; step() the router)" % (self.id,))
        return self._cur.result()

    # -- router internals ---------------------------------------------
    def _submit_kwargs(self, now):
        """Engine-submit kwargs for (re)placement: deadlines are kept
        ABSOLUTE at the router so time spent held or migrating never
        refreshes a request's budget."""
        kw = dict(
            max_tokens=self._rec["max_tokens"],
            eos_id=self._rec["eos_id"],
            temperature=self._rec["temperature"],
            seed=self._rec["seed"],
            request_id=self.id,
            _resume_tokens=tuple(self._rec["tokens"]),
            _trace=(self.id, self._hop + 1),
        )
        if self._deadline_abs is not None:
            kw["deadline_ms"] = (self._deadline_abs - now) * 1e3
        if self._ttft_deadline_abs is not None and self._t_first is None:
            kw["ttft_deadline_ms"] = \
                (self._ttft_deadline_abs - now) * 1e3
        return kw

    def _point_at(self, req, replica_id):
        self._cur = req
        self._replica_id = replica_id
        trace = getattr(req, "trace", None)
        self._hop = trace[1] if trace is not None else self._hop + 1
        if self._rec["seed"] is None:      # engine drew it: pin for
            self._rec["seed"] = int(req.seed)   # any later migration

    def _unhook(self, snap_rec):
        """Detach from a dying replica: absorb the snapshot record
        (authoritative token prefix + remaining budgets) and remember
        the first-token time — the old underlying handle is about to
        be retired by ``close()`` and must not speak for us."""
        if self._cur is not None and self._cur.t_first is not None \
                and self._t_first is None:
            self._t_first = self._cur.t_first
        self._rec = dict(self._rec, tokens=list(snap_rec["tokens"]))
        self._cur = None
        self._replica_id = None

    def __repr__(self):
        return ("FleetRequest(id=%r, replica=%r, tokens=%d, "
                "migrations=%d, done=%r)"
                % (self.id, self._replica_id, len(self.tokens),
                   self.migrations, self.done))


class _Replica:
    """Router-side bookkeeping for one managed engine."""

    __slots__ = ("engine", "id", "alive", "misses", "last_hb", "order")

    def __init__(self, engine, order):
        self.engine = engine
        self.id = engine.engine_id
        self.alive = True
        self.misses = 0
        self.last_hb = -float("inf")
        self.order = order


class FleetRouter:
    """Admission router over N :class:`InferenceEngine` replicas —
    module docstring has the full contract. Drive it exactly like one
    engine: ``submit()`` + ``step()`` (or ``serve_forever()``);
    ``close()`` shuts the whole fleet down."""

    def __init__(self, engines, timeout_ms=None, max_retries=None,
                 backoff_ms=None, heartbeat_ms=None,
                 heartbeat_misses=None, seed=0,
                 slo_ttft_ms=None, slo_cadence_ms=None, slo_target=0.99,
                 flight_recorder=None):
        engines = list(engines)
        if not engines:
            raise MXNetError("FleetRouter: need at least one replica")
        # end-to-end SLO thresholds, measured from ROUTER arrival
        # (constructor-only: per-engine MXNET_SERVING_SLO_* knobs keep
        # meaning the engine-local figures)
        self.slo_ttft_ms = None if slo_ttft_ms is None \
            else float(slo_ttft_ms)
        self.slo_cadence_ms = None if slo_cadence_ms is None \
            else float(slo_cadence_ms)
        self.slo_target = float(slo_target)
        self._slo_windows = {}
        self.flight = flight_recorder if flight_recorder is not None \
            else FleetFlightRecorder()
        self.flight._owner = weakref.ref(self)
        self.timeout_ms = float(timeout_ms) if timeout_ms is not None \
            else _timeout_s() * 1e3
        self.max_retries = int(max_retries) if max_retries is not None \
            else _max_retries()
        self.backoff_s = (float(backoff_ms) / 1e3) \
            if backoff_ms is not None else _backoff_base_s()
        self.heartbeat_s = (float(heartbeat_ms) / 1e3) \
            if heartbeat_ms is not None else _heartbeat_s()
        self.heartbeat_misses = int(heartbeat_misses) \
            if heartbeat_misses is not None else _heartbeat_misses()
        if self.max_retries < 0 or self.heartbeat_misses < 1:
            raise MXNetError("FleetRouter: max_retries must be >= 0 "
                             "and heartbeat_misses >= 1")
        self._rng = random.Random(seed)    # backoff jitter (seeded:
        self._replicas = {}                # deterministic tests)
        self._order = 0
        self._requests = {}                # id -> FleetRequest (live)
        self._held = collections.deque()   # awaiting re-placement
        self._handoffs = collections.deque()  # (pkg, fr) in transit
        self._dedup = {}                   # (client_id, seq) -> handle
        self._next_id = 0
        self._closed = False
        self.stats = collections.defaultdict(int)
        for e in engines:
            self.add_replica(e)
        _ROUTERS.add(self)

    # -- replica set ----------------------------------------------------
    def add_replica(self, engine):
        """Bring a (fresh or restarted) engine into rotation. Held
        requests re-place onto it on the next :meth:`step`."""
        self._check_open()
        if getattr(engine, "_closed", False):
            raise MXNetError("FleetRouter: replica %r is closed"
                             % (getattr(engine, "engine_id", engine),))
        rid = engine.engine_id
        old = self._replicas.get(rid)
        if old is not None and old.alive:
            raise MXNetError("FleetRouter: replica id %r is already "
                             "in rotation" % (rid,))
        self._replicas[rid] = _Replica(engine, self._order)
        self._order += 1
        _TM_LIVE.set(len(self._live()))
        return rid

    def replica(self, rid):
        rep = self._replicas.get(rid)
        return None if rep is None else rep.engine

    def replica_ids(self, live_only=False):
        if live_only:
            return [r.id for r in self._live()]
        return list(self._replicas)

    def _live(self):
        return [r for r in self._replicas.values()
                if r.alive and not r.engine._closed]

    def _candidates(self):
        """Replicas admission may target: alive, not draining, not
        stuck, not closed — the health() signals a real fleet would
        scrape off each replica's /healthz."""
        out = []
        for r in self._live():
            h = r.engine.health()
            if h.get("draining") or h.get("stuck"):
                continue
            out.append(r)
        return out

    # -- engine-mirroring surface ---------------------------------------
    @property
    def max_queue(self):
        """Aggregate admission capacity (live replicas' max_queue sum;
        at least 1 so a replica-less interregnum doesn't zero the
        backpressure check into a busy loop)."""
        return max(1, sum(r.engine.max_queue for r in self._live()))

    def queued(self):
        return sum(r.engine.queued() for r in self._live()) \
            + len(self._held)

    @property
    def weight_dtype(self):
        """The fleet's weight-storage dtype (replicas are uniform;
        replay's auto verify-mode keys off it)."""
        live = self._live()
        return live[0].engine.weight_dtype if live else "float"

    @property
    def idle(self):
        # a package awaiting delivery (router-side or still inside a
        # prefill replica's outbox) is outstanding work: the fleet
        # must keep stepping until it lands or falls back
        if self._held or self._handoffs:
            return False
        for r in self._live():
            if not r.engine.idle or r.engine._handoff_out:
                return False
        return True

    def health(self):
        """Fleet liveness: per-replica ``health()`` dicts (dead ones
        abbreviated) plus router-level queue state."""
        reps = {}
        for r in self._replicas.values():
            if r.alive and not r.engine._closed:
                reps[r.id] = r.engine.health()
            else:
                reps[r.id] = {"closed": True, "dead": True}
        return {
            "closed": self._closed,
            "replicas": reps,
            "replicas_live": len(self._live()),
            "held": len(self._held),
            "handoffs_in_transit": len(self._handoffs),
        }

    def _check_open(self):
        if self._closed:
            raise EngineClosed("FleetRouter is closed")

    # -- admission ------------------------------------------------------
    def submit(self, prompt, max_tokens, eos_id=None, temperature=0.0,
               seed=None, request_id=None, deadline_ms=None,
               ttft_deadline_ms=None, client_id=None, seq=None,
               _resume_tokens=()):
        """Route one request to a healthy replica; returns its
        :class:`FleetRequest` handle.

        ``(client_id, seq)`` is the exactly-once identity for callers
        that RETRY a submit after an ambiguous failure (their channel
        to the router timed out): a resubmission with the same pair
        returns the original handle instead of admitting twice — the
        kvstore client's dedup discipline applied to request traffic.
        Both-or-neither; ids are per-client monotonic sequence
        numbers.

        Placement prefers the replica whose prefix cache retains the
        longest prefix of ``prompt`` (affinity), then the least
        loaded. A replica that refuses (typed shed or block
        backpressure) is skipped; only when EVERY healthy replica
        refuses does the router raise — typed
        :class:`EngineOverloaded` if the fleet is shedding, else the
        generic backpressure error."""
        self._check_open()
        if (client_id is None) != (seq is None):
            raise MXNetError("FleetRouter: client_id and seq must be "
                             "passed together")
        key = None
        if client_id is not None:
            key = (client_id, int(seq))
            prev = self._dedup.get(key)
            if prev is not None:
                self.stats["dedup_hits"] += 1
                _TM_DEDUP.inc()
                return prev
        rid = request_id
        if rid is None:
            rid = "f%d" % self._next_id
            self._next_id += 1
        rec = {
            "prompt": np.asarray(prompt),
            "tokens": list(_resume_tokens),
            "max_tokens": max_tokens,
            "eos_id": eos_id,
            "temperature": temperature,
            "seed": seed,
            "deadline_ms": deadline_ms,
            "ttft_deadline_ms": ttft_deadline_ms,
        }
        fr = FleetRequest(rid, rec, client_key=key)
        if self.flight.enabled:
            meta = {"prompt_len": int(rec["prompt"].size),
                    "max_tokens": int(max_tokens)}
            if rec["tokens"]:
                meta["resumed"] = len(rec["tokens"])
            if deadline_ms is not None:
                meta["deadline_ms"] = deadline_ms
            if ttft_deadline_ms is not None:
                meta["ttft_deadline_ms"] = ttft_deadline_ms
            self.flight.start(rid, **meta)
        try:
            self._place_new(fr)
        except Exception:
            # fleet-wide refusal: the journey ends at the router
            self.flight.retire(rid, "refused")
            raise
        self._requests[rid] = fr
        if key is not None:
            self._dedup[key] = fr
        self.stats["submitted"] += 1
        return fr

    def _place_new(self, fr):
        """First placement of a fresh submit: raise on fleet-wide
        refusal (migrations use :meth:`_try_place` and hold instead)."""
        shed_err, block_err = None, None
        for rep in self._ranked(fr):
            try:
                req = self._channel_submit(rep, fr)
            except EngineOverloaded as e:
                shed_err = e
                continue
            except EngineClosed:
                self._fail_over(rep, "closed underneath the router")
                continue
            except ConnectionError:
                self._fail_over(rep, "channel dead")
                continue
            except MXNetError as e:
                if "queue is full" in str(e):
                    block_err = e          # block-policy backpressure
                    continue
                raise                      # validation error: caller bug
            fr._point_at(req, rep.id)
            fr._t_place = time.perf_counter()
            self.flight.hop(fr.id, rep.id)
            self.flight.event(fr.id, "placed", replica=rep.id,
                              reason=self._place_reason(rep, fr),
                              hop=fr._hop)
            return
        if shed_err is not None:
            raise EngineOverloaded(
                "FleetRouter: fleet-wide overload — every healthy "
                "replica shed (last: %s)" % (shed_err,))
        if block_err is not None:
            raise MXNetError(
                "FleetRouter: every healthy replica's queue is full "
                "(block policy) — step() the router to drain")
        raise MXNetError("FleetRouter: no healthy replica to admit "
                         "request %r (live=%d)"
                         % (fr.id, len(self._live())))

    def _ranked(self, fr):
        """Placement order: deepest prefix-affinity first, then least
        loaded, then rotation order. Counts an affinity hit when a
        retained prefix actually decided placement. Decode specialists
        never take fresh prompts — their whole point is to never trace
        a prefill program."""
        cands = [r for r in self._candidates()
                 if getattr(r.engine, "role", "unified") != "decode"]
        if not cands:
            return []
        prompt = fr._rec["prompt"]
        scored = []
        for rep in cands:
            h = rep.engine.health()
            load = h.get("queued", 0) + h.get("slots_busy", 0)
            scored.append((-self._affinity(rep.engine, prompt),
                           load, rep.order, rep))
        scored.sort(key=lambda t: t[:3])
        if scored and scored[0][0] < 0:
            self.stats["affinity_hits"] += 1
            _TM_AFFINITY.inc()
        return [t[3] for t in scored]

    def _place_reason(self, rep, fr):
        """Why placement chose this replica, for the ``placed`` flight
        event: a retained prompt prefix → ``affinity``, a prefill
        specialist → ``role``, otherwise plain ``least_loaded``."""
        if self._affinity(rep.engine, fr._rec["prompt"]) > 0:
            return "affinity"
        if getattr(rep.engine, "role", "unified") == "prefill":
            return "role"
        return "least_loaded"

    @staticmethod
    def _affinity(engine, prompt):
        """Longest retained prefix of ``prompt`` in the replica's
        trie — a PLACEMENT HINT only: no LRU touch, no pin (the
        engine re-walks at admission and takes the hit itself)."""
        pc = getattr(engine, "_prefix", None)
        if pc is None or not len(prompt):
            return 0
        node, depth = pc._root, 0
        for t in prompt:
            child = node.children.get(int(t))
            if child is None:
                break
            node, depth = child, depth + 1
        return depth

    def _channel_submit(self, rep, fr, migration=False):
        """One admission over the replica channel, with the kvstore
        client's transport discipline: per-op timeout, bounded exponential
        backoff + jitter on retry, ping-probe after a timeout to tell
        dead from slow, and exactly-once adoption — a retried submit
        whose first attempt DID land (the reply was what got lost)
        finds the admitted request by id instead of double-admitting.
        Raises ``ConnectionError`` when the budget is exhausted;
        ``migration=True`` lifts ``max_queue`` for the one submit
        (migrated work was already admitted fleet-wide and must never
        shed — the ``restore()`` discipline)."""
        eng = rep.engine
        backoff = self.backoff_s
        last_err = None
        for attempt in range(self.max_retries + 1):
            flt = _FLEET_FAULTS
            try:
                if flt is not None:
                    delay = flt.fleet_submit(rep.id)
                    if delay and delay * 1e3 > self.timeout_ms:
                        raise TimeoutError(
                            "fleet channel: submit to %r exceeded "
                            "timeout_ms=%g" % (rep.id, self.timeout_ms))
                kw = fr._submit_kwargs(time.perf_counter())
                if migration:
                    real_mq = eng.max_queue
                    eng.max_queue = max(real_mq, eng.queued() + 1)
                    try:
                        return eng.submit(fr._rec["prompt"], **kw)
                    finally:
                        eng.max_queue = real_mq
                return eng.submit(fr._rec["prompt"], **kw)
            except (ConnectionError, TimeoutError) as e:
                last_err = e
                # the first attempt may have landed before the fault
                # (lost-reply case): adopt it — exactly-once admission
                existing = eng._active.get(fr.id)
                if existing is not None:
                    return existing
                alive = isinstance(e, TimeoutError) \
                    and self._ping(rep)
                if attempt >= self.max_retries:
                    raise ConnectionError(
                        "fleet channel: replica %r %s after %d "
                        "attempt(s) (%s)"
                        % (rep.id,
                           "is alive but slow" if alive
                           else "is unreachable or died",
                           attempt + 1, e))
                self.stats["retries"] += 1
                _TM_RETRIES.inc()
                self.flight.event(fr.id, "retried", replica=rep.id,
                                  op="submit", attempt=attempt + 1)
                if not alive:
                    delay = backoff * (2 ** attempt)
                    time.sleep(min(
                        delay * (0.5 + self._rng.random()), 0.5))
        raise ConnectionError("fleet channel: replica %r failed (%s)"
                              % (rep.id, last_err))  # pragma: no cover

    # -- KV handoff (disaggregated prefill/decode) ----------------------
    @staticmethod
    def _pool_covers(engine, pkg):
        """Does this replica's prefix pool retain the package's FULL
        prefill? Then delivery ships identity only — the target copies
        the rows out of its own pool (peek: no LRU touch, no pin; the
        engine re-walks and pins at admission)."""
        pc = getattr(engine, "_prefix", None)
        if pc is None:
            return False
        return pc.peek(pkg.prefill_seq) >= pkg.prefill_len

    def _ranked_decode(self, pkg):
        """Delivery order for one package: decode-capable replicas
        (never prefill specialists), full-pool-affinity first — a hit
        skips the row transfer entirely — then least loaded, then
        rotation order."""
        scored = []
        for rep in self._candidates():
            if getattr(rep.engine, "role", "unified") == "prefill":
                continue
            h = rep.engine.health()
            load = h.get("queued", 0) + h.get("slots_busy", 0)
            scored.append((0 if self._pool_covers(rep.engine, pkg)
                           else 1, load, rep.order, rep))
        scored.sort(key=lambda t: t[:3])
        if scored and scored[0][0] == 0:
            self.stats["affinity_hits"] += 1
            _TM_AFFINITY.inc()
        return [t[3] for t in scored]

    def _collect_handoffs(self):
        """Sweep every live replica's handoff outbox into the router's
        in-transit queue. Packages whose fleet handle already retired
        (cancelled / errored while the prefill ran) resolve on the
        spot — the source slot frees, nothing ships."""
        for rep in list(self._replicas.values()):
            if not rep.alive or rep.engine._closed \
                    or not rep.engine._handoff_out:
                continue
            for pkg in rep.engine.take_handoffs():
                fr = self._requests.get(pkg.id)
                if fr is None or fr.done:
                    with contextlib.suppress(Exception):
                        pkg.resolve()
                    continue
                # the prefill hop is over: pin the first-token stamp
                # before _point_at re-points the handle at a decode
                # request whose t_first is its own admission time, and
                # absorb the prefill engine's flight record while its
                # retired ring still holds it
                if fr._t_first is None and fr._cur is not None \
                        and fr._cur.t_first is not None:
                    fr._t_first = fr._cur.t_first
                fr._t_ready = pkg.t_ready
                self._absorb_hop(fr, rep)
                self.flight.event(
                    fr.id, "in_transit",
                    **{"from": rep.id, "prefill_len": pkg.prefill_len})
                self._handoffs.append((pkg, fr))

    def _channel_handoff(self, rep, pkg, fr):
        """Deliver one package over the replica channel with the same
        transport discipline as ``_channel_submit``: per-op timeout
        (the ``fleet_handoff`` fault hook is the injected network),
        bounded backoff + jitter, ping-probe after a timeout, and
        exactly-once — a retried delivery whose first attempt landed
        finds the admitted request by id on the target (the target's
        own import dedup backs this up). Returns ``(request,
        shipped_bytes, pool_hit)``; raises ``ConnectionError`` when
        the budget is exhausted."""
        eng = rep.engine
        skip = self._pool_covers(eng, pkg)
        kw = {}
        if fr._deadline_abs is not None:
            kw["deadline_ms"] = \
                (fr._deadline_abs - time.perf_counter()) * 1e3
        backoff = self.backoff_s
        last_err = None
        for attempt in range(self.max_retries + 1):
            flt = _FLEET_FAULTS
            try:
                if flt is not None:
                    delay = flt.fleet_handoff(rep.id)
                    if delay and delay * 1e3 > self.timeout_ms:
                        raise TimeoutError(
                            "fleet channel: KV handoff to %r exceeded "
                            "timeout_ms=%g" % (rep.id, self.timeout_ms))
                t0 = time.perf_counter()
                req = eng.admit_handoff(pkg.payload(with_rows=not skip),
                                        **kw)
                fr._admit_ms = (time.perf_counter() - t0) * 1e3
                _TM_HANDOFF_MS.observe(fr._admit_ms)
                return req, (0 if skip else pkg.nbytes), skip
            except (ConnectionError, TimeoutError) as e:
                last_err = e
                existing = eng._active.get(pkg.id)
                if existing is not None:
                    return existing, (0 if skip else pkg.nbytes), skip
                alive = isinstance(e, TimeoutError) \
                    and self._ping(rep)
                if attempt >= self.max_retries:
                    raise ConnectionError(
                        "fleet channel: replica %r %s after %d handoff "
                        "attempt(s) (%s)"
                        % (rep.id,
                           "is alive but slow" if alive
                           else "is unreachable or died",
                           attempt + 1, e))
                self.stats["retries"] += 1
                _TM_RETRIES.inc()
                self.flight.event(fr.id, "retried", replica=rep.id,
                                  op="handoff", attempt=attempt + 1)
                if not alive:
                    delay = backoff * (2 ** attempt)
                    time.sleep(min(
                        delay * (0.5 + self._rng.random()), 0.5))
        raise ConnectionError(
            "fleet channel: replica %r failed handoff (%s)"
            % (rep.id, last_err))  # pragma: no cover

    def _deliver_handoffs(self):
        """One delivery pass over the in-transit queue. Each package
        tries every decode-capable replica in affinity/load order; all
        slots busy → it keeps waiting (serving.handoff_wait_ms is
        exactly this wait); NO decode-capable replica left → unified
        fallback: the package is abandoned and the request re-prefills
        on whatever survives via the hold queue, byte-identically."""
        fell_back = False
        for _ in range(len(self._handoffs)):
            pkg, fr = self._handoffs.popleft()
            if pkg.resolved:
                continue
            if fr.done or fr._cur is None \
                    or fr._cur.retire_reason != "handoff":
                # cancelled, errored, or already re-placed (the
                # source failed over and the fallback path took it):
                # this package has nothing left to deliver
                with contextlib.suppress(Exception):
                    pkg.resolve()
                continue
            placed = False
            for rep in self._ranked_decode(pkg):
                try:
                    req, nbytes, pool_hit = \
                        self._channel_handoff(rep, pkg, fr)
                except EngineOverloaded:
                    continue               # no free slot: next replica
                except EngineClosed:
                    self._fail_over(rep, "closed underneath the router")
                    continue
                except ConnectionError:
                    # the journey's delivery target died under it —
                    # record that on the stitched timeline (the request
                    # itself was never resident there, so _fail_over's
                    # per-request _detach sweep won't see it)
                    self.flight.event(
                        fr.id, "failover",
                        reason="target died in transit",
                        **{"from": rep.id,
                           "resume_len": len(pkg.tokens)})
                    self._fail_over(rep, "channel dead during KV "
                                         "handoff")
                    continue
                except MXNetError:
                    continue               # refused (geometry/stale)
                _TM_HANDOFF_WAIT.observe(
                    (time.perf_counter() - pkg.t_ready) * 1e3)
                fr._t_deliver = time.perf_counter()
                fr._point_at(req, rep.id)
                self.flight.hop(fr.id, rep.id)
                self.flight.event(
                    fr.id, "admitted", replica=rep.id,
                    bytes=int(nbytes), pool_hit=bool(pool_hit),
                    dtype=getattr(pkg.source, "handoff_dtype",
                                  "native"),
                    hop=fr._hop)
                pkg.resolve()
                self.stats["handoffs"] += 1
                _TM_HANDOFF_COUNT.inc()
                if pool_hit:
                    self.stats["handoff_pool_hits"] += 1
                else:
                    self.stats["handoff_bytes"] += nbytes
                    _TM_HANDOFF_BYTES.inc(nbytes)
                placed = True
                break
            if placed:
                continue
            if any(getattr(r.engine, "role", "unified") != "prefill"
                   for r in self._candidates()):
                # decode capacity exists but is full right now: keep
                # waiting (the wait histogram is measuring this)
                self._handoffs.append((pkg, fr))
            else:
                with contextlib.suppress(Exception):
                    pkg.resolve()
                fr._unhook({"tokens": pkg.tokens})
                fr._detached_from = pkg.source.engine_id
                self._held.append(fr)
                self.stats["handoff_fallbacks"] += 1
                self.flight.event(
                    fr.id, "failover", reason="no decode capacity",
                    **{"from": pkg.source.engine_id,
                       "resume_len": len(pkg.tokens)})
                fell_back = True
        if fell_back:
            self._ensure_roles()
            self._drain_held()

    def _abandon_handoffs(self, rep):
        """A replica is dying: packages IT exported cannot deliver
        (their rows live in its cache) — unhook their requests onto
        the hold queue for a unified re-prefill on the survivors."""
        for _ in range(len(self._handoffs)):
            pkg, fr = self._handoffs.popleft()
            if pkg.source is not rep.engine:
                self._handoffs.append((pkg, fr))
                continue
            with contextlib.suppress(Exception):
                pkg.resolve()
            if not fr.done:
                fr._unhook({"tokens": pkg.tokens})
                fr._detached_from = rep.id
                self._held.append(fr)
                self.stats["handoff_fallbacks"] += 1
                self.flight.event(
                    fr.id, "failover", reason="source died in transit",
                    **{"from": rep.id,
                       "resume_len": len(pkg.tokens)})

    def _ensure_roles(self):
        """Failover role repair: when the fleet has lost every replica
        of one phase (all survivors are the same specialist), widen
        the least-loaded survivor to unified so both phases keep
        serving — the missing program family compiles lazily on first
        use. No-op while a unified replica or both specialists are
        live."""
        live = self._live()
        roles = {getattr(r.engine, "role", "unified") for r in live}
        if not live or "unified" in roles \
                or ("prefill" in roles and "decode" in roles):
            return

        def load(r):
            h = r.engine.health()
            return (h.get("queued", 0) + h.get("slots_busy", 0),
                    r.order)

        target = min(live, key=load)
        with contextlib.suppress(Exception):
            target.engine.set_role("unified")
            self.stats["role_promotions"] += 1

    # -- heartbeats / liveness ------------------------------------------
    def _ping(self, rep):
        """One heartbeat probe: False = no answer (a blackholed or
        dead peer), True = alive (possibly slow/stuck — health() says
        which). In-process the 'network' is the fault injector."""
        flt = _FLEET_FAULTS
        if flt is not None and flt.fleet_ping_blackholed(rep.id):
            return False
        return rep.alive and not rep.engine._closed

    def _heartbeat(self, rep):
        if self._ping(rep):
            rep.misses = 0
            return
        rep.misses += 1
        self.stats["heartbeat_misses"] += 1
        _TM_HB_MISSES.inc()
        if rep.misses >= self.heartbeat_misses:
            self._fail_over(rep, "%d consecutive heartbeat misses"
                            % rep.misses)

    # -- failover / drain -----------------------------------------------
    def _fail_over(self, rep, reason):
        """Declare ``rep`` dead and migrate its unfinished requests to
        peers: snapshot the host scheduler (valid after a crash or
        watchdog trip), close the corpse, resubmit every
        request with its token prefix so continuations stay
        byte-identical. Requests no peer can take right now wait in
        the hold queue."""
        if not rep.alive:
            return
        rep.alive = False
        _TM_LIVE.set(len(self._live()))
        self.stats["failovers"] += 1
        _TM_FAILOVERS.inc()
        try:
            snap = rep.engine.snapshot()
        except Exception:
            snap = {"requests": []}
        # in-transit packages this replica exported die with it (their
        # rows live in its cache); packages still in its outbox ride
        # the snapshot into _detach — disjoint sets, no double-hold
        self._abandon_handoffs(rep)
        self._detach(snap, rep, event="failover")
        with contextlib.suppress(Exception):
            rep.engine.close()
        self._ensure_roles()
        self._drain_held()

    def drain(self, replica):
        """Take one replica out of rotation for a deploy, migrating
        its in-flight work live: admission stops first (the
        engine reports ``draining`` on ``/healthz``), then the
        snapshot/resubmit migration runs and the replica is closed.
        Pass the engine or its ``engine_id``; returns the snapshot
        that was migrated (what an operator would archive). Restart
        with :meth:`add_replica`."""
        self._check_open()
        rid = getattr(replica, "engine_id", replica)
        rep = self._replicas.get(rid)
        if rep is None or not rep.alive or rep.engine._closed:
            raise MXNetError("FleetRouter.drain: %r is not a live "
                             "replica" % (rid,))
        rep.engine.draining = True       # stop admission; /healthz
        snap = rep.engine.snapshot()     # reports "draining"
        rep.alive = False
        _TM_LIVE.set(len(self._live()))
        self.stats["drains"] += 1
        _TM_DRAINS.inc()
        self._abandon_handoffs(rep)
        self._detach(snap, rep, event="drained")
        with contextlib.suppress(Exception):
            rep.engine.close()
        self._ensure_roles()
        self._drain_held()
        return snap

    def _detach(self, snap, rep=None, event="failover"):
        """Re-point every fleet handle off a dying replica onto the
        hold queue, snapshot record absorbed (token prefix + remaining
        deadline budgets). The dying engine's flight records are
        absorbed FIRST — ``close()`` is about to retire them with
        reasons that belong to the corpse, and the resubmit on a peer
        will reuse the request id."""
        for r in snap.get("requests", ()):
            fr = self._requests.get(r["id"])
            if fr is None or fr.done:
                continue
            if rep is not None:
                self._absorb_hop(fr, rep)
                fr._detached_from = rep.id
            fr._unhook(r)
            self._held.append(fr)
            self.flight.event(
                fr.id, event,
                **{"from": None if rep is None else rep.id,
                   "resume_len": len(r.get("tokens", ()))})

    def _drain_held(self):
        """One re-placement pass over the hold queue (each held
        request tried once; failures keep waiting — a later step or
        add_replica retries)."""
        for _ in range(len(self._held)):
            if not self._held:
                break
            fr = self._held.popleft()
            if fr.done:
                continue
            if self._try_place(fr):
                fr.migrations += 1
                self.stats["migrated_requests"] += 1
                _TM_MIGRATED.inc()
            else:
                self._held.append(fr)

    def _try_place(self, fr):
        """Best-effort migration placement: refusals hold instead of
        raising (the work was already admitted fleet-wide)."""
        for rep in self._ranked(fr):
            try:
                req = self._channel_submit(rep, fr, migration=True)
            except (EngineOverloaded, EngineClosed):
                continue
            except ConnectionError:
                self._fail_over(rep, "channel dead mid-migration")
                continue
            except MXNetError:
                continue
            fr._point_at(req, rep.id)
            self.flight.hop(fr.id, rep.id)
            self.flight.event(
                fr.id, "migrated", hop=fr._hop,
                reason=self._place_reason(rep, fr),
                **{"from": fr._detached_from, "to": rep.id,
                   "resume_len": len(fr._rec["tokens"])})
            return True
        return False

    # -- fleet tracing / SLO decomposition ------------------------------
    def _absorb_hop(self, fr, rep):
        """Copy one engine's flight records for this request into the
        stitched journey (idempotent — see
        :meth:`FleetFlightRecorder.absorb`)."""
        if not self.flight.enabled:
            return
        try:
            recs = rep.engine.flight.records(fr.id)
        except Exception:   # noqa: BLE001 — tracing never breaks serving
            return
        if recs:
            self.flight.absorb(fr.id, rep.id, recs)

    def _absorb_live(self, rid):
        """Lazy sweep backing a live ``timeline()`` query: fold in
        whatever the request's CURRENT replica has recorded so far."""
        fr = self._requests.get(rid)
        if fr is None or fr._replica_id is None:
            return
        rep = self._replicas.get(fr._replica_id)
        if rep is not None:
            self._absorb_hop(fr, rep)

    def _breakdown(self, fr, t_end):
        """The end-to-end SLO decomposition, phases-sum-to-wall style:
        ``router_queue`` and ``prefill`` are exact
        sub-intervals of the TTFT window (they sum to fleet TTFT by
        construction), ``handoff_wait``/``decode_admission`` split the
        wire crossing, and ``decode`` is the remainder — so the five
        components sum to the measured end-to-end wall time exactly,
        failover gaps and all."""
        e2e = (t_end - fr._t_submit) * 1e3
        comp = dict.fromkeys(_SLO_COMPONENTS, 0.0)
        t_first = fr.t_first
        if fr._t_place is not None:
            comp["router_queue"] = (fr._t_place - fr._t_submit) * 1e3
            if t_first is not None:
                comp["prefill"] = (t_first - fr._t_place) * 1e3
        if fr._t_ready is not None and fr._t_deliver is not None:
            admit = fr._admit_ms or 0.0
            wait = (fr._t_deliver - fr._t_ready) * 1e3
            comp["decode_admission"] = min(admit, wait)
            comp["handoff_wait"] = max(0.0, wait - admit)
        comp["decode"] = max(0.0, e2e - sum(comp.values()))
        return e2e, comp

    def _observe(self, fr):
        """Once-per-request fleet SLO accounting, run every step and
        at close: observe fleet TTFT the first time a first token is
        visible, and on completion observe cadence, absorb the final
        hop's flight record, and retire the stitched journey with the
        decomposition in its meta."""
        t_first = fr.t_first
        if fr._ttft_seen is None and t_first is not None:
            ttft = (t_first - fr._t_submit) * 1e3
            fr._ttft_seen = ttft
            _TM_FLEET_TTFT.observe(ttft)
            if self.slo_ttft_ms is not None:
                (_TM_FLEET_SLO_TTFT_OK if ttft <= self.slo_ttft_ms
                 else _TM_FLEET_SLO_TTFT_MISS).inc()
        if not fr.done or fr._finalized:
            return
        fr._finalized = True
        t_done = fr.t_done
        gen = len(fr.tokens) - fr.resumed
        cadence = None
        if t_first is not None and t_done is not None and gen > 1:
            cadence = (t_done - t_first) / (gen - 1) * 1e3
            _TM_FLEET_CADENCE.observe(cadence)
            if self.slo_cadence_ms is not None:
                (_TM_FLEET_SLO_CAD_OK
                 if cadence <= self.slo_cadence_ms
                 else _TM_FLEET_SLO_CAD_MISS).inc()
        if not self.flight.enabled:
            return
        rep = self._replicas.get(fr._replica_id) \
            if fr._replica_id is not None else None
        if rep is not None:
            self._absorb_hop(fr, rep)
        e2e, comp = self._breakdown(
            fr, t_done if t_done is not None else time.perf_counter())
        slo = {k: round(v, 3) for k, v in comp.items()}
        slo["e2e_ms"] = round(e2e, 3)
        if fr._ttft_seen is not None:
            slo["ttft_ms"] = round(fr._ttft_seen, 3)
        if cadence is not None:
            slo["cadence_ms"] = round(cadence, 3)
        self.flight.retire(fr.id, fr.retire_reason or "done",
                           tokens=len(fr.tokens),
                           migrations=fr.migrations, slo=slo)

    def _slo_tick(self, now=None):
        """Refresh the fleet multi-window burn gauges (rate-limited
        inside ``tele.SloWindow``) — the engine-side ``_slo_tick``
        mirrored at fleet scope. Called at the end of every
        :meth:`step` and by the exposition server per ``/fleet``
        scrape."""
        for kind, thr, hist, windows in (
                ("ttft", self.slo_ttft_ms, _TM_FLEET_TTFT,
                 _FLEET_SLO_TTFT_WINDOWS),
                ("cadence", self.slo_cadence_ms, _TM_FLEET_CADENCE,
                 _FLEET_SLO_CADENCE_WINDOWS)):
            if thr is None:
                continue
            w = self._slo_windows.get(kind)
            if w is None or w.threshold != float(thr):
                w = tele.SloWindow(
                    hist, thr, target=self.slo_target,
                    windows=[(s, g) for s, g in windows])
                self._slo_windows[kind] = w
            w.tick(now)

    def fleet_table(self):
        """The ``GET /fleet`` rollup: per-replica health (role,
        occupancy, queue — dead replicas abbreviated), router queue
        state, lifetime stats, handoff figures, the SLO thresholds
        with their current burn-gauge readings, and the flight ring
        occupancy."""
        tbl = self.health()
        tbl["stats"] = {k: int(v) for k, v in self.stats.items()}
        live, retired = self.flight.ids()
        tbl["flight"] = {"live": live, "retired": retired}
        slo = {"ttft_ms": self.slo_ttft_ms,
               "cadence_ms": self.slo_cadence_ms,
               "target": self.slo_target}
        for kind, windows in (("ttft", _FLEET_SLO_TTFT_WINDOWS),
                              ("cadence", _FLEET_SLO_CADENCE_WINDOWS)):
            slo[kind + "_burn"] = {
                g.name.rsplit("_", 1)[-1]: g.value
                for _, g in windows}
        tbl["slo"] = slo
        return tbl

    # -- the drive loop -------------------------------------------------
    def step(self):
        """One fleet scheduling round: heartbeat sweep, hold-queue
        re-placement, then one ``step()`` on every non-idle live
        replica. A replica whose step raises a non-engine error
        (process death — ``InjectedCrash`` in tests, deliberately not
        an ``MXNetError``) or a typed ``EngineStuck`` fails over; its
        requests continue on peers."""
        self._check_open()
        now = time.perf_counter()
        for rep in list(self._replicas.values()):
            if not rep.alive or rep.engine._closed:
                continue
            if now - rep.last_hb >= self.heartbeat_s:
                rep.last_hb = now
                self._heartbeat(rep)
        self._drain_held()
        for rep in list(self._replicas.values()):
            if not rep.alive or rep.engine._closed \
                    or rep.engine.idle:
                continue
            flt = _FLEET_FAULTS
            ctx = flt.fleet_step_context(rep.id) \
                if flt is not None else None
            try:
                with (ctx if ctx is not None
                      else contextlib.nullcontext()):
                    rep.engine.step()
            except EngineClosed:
                self._fail_over(rep, "closed underneath the router")
            except EngineStuck:
                self._fail_over(rep, "watchdog trip")
            except MXNetError:
                raise                      # a bug, not a death
            except Exception:              # InjectedCrash / SIGKILL
                self._fail_over(rep, "died mid-round")
        self._collect_handoffs()
        self._deliver_handoffs()
        # fleet SLO + journey finalization BEFORE the prune drops done
        # handles (attribute guards make the sweep a no-op per settled
        # request)
        for fr in list(self._requests.values()):
            if not fr._finalized:
                self._observe(fr)
        self._slo_tick(now)
        if self._requests and not self.stats["steps"] % 16:
            self._requests = {k: v for k, v in self._requests.items()
                              if not v.done}
        self.stats["steps"] += 1

    def serve_forever(self, requests=None):
        """Drive the fleet until idle, optionally ingesting submits
        from ``requests`` (same item protocol as the engine's
        ``serve_forever``: dict kwargs, ``(prompt, kwargs)``, a bare
        prompt, or ``None`` = nothing arrived yet). Returns every
        request retired during this call, submission order."""
        self._check_open()
        before = {rid for rid, fr in self._requests.items() if fr.done}
        it = iter(requests) if requests is not None else None
        while True:
            if it is not None:
                try:
                    item = next(it)
                except StopIteration:
                    it = None
                else:
                    if item is not None:
                        if isinstance(item, dict):
                            self.submit(**item)
                        elif isinstance(item, tuple) and len(item) == 2\
                                and isinstance(item[1], dict):
                            self.submit(item[0], **item[1])
                        else:
                            self.submit(item, max_tokens=16)
            if it is None and self.idle:
                break
            self.step()
        return [fr for rid, fr in self._requests.items()
                if fr.done and rid not in before]

    def cancel(self, request_id):
        """Retire one request wherever it lives (queued, in-flight on
        any replica, or held mid-migration); tokens so far stay
        readable. True if it was live."""
        fr = self._requests.get(request_id)
        if fr is None or fr.done:
            return False
        if fr._cur is not None \
                and fr._cur.retire_reason == "handoff":
            # in transit between replicas: mark cancelled here; the
            # next delivery pass sees ``done`` and resolves the
            # package (source slot freed, nothing admitted)
            fr._cancelled = True
            return True
        if fr._cur is not None:
            rep = self._replicas.get(fr._replica_id)
            if rep is not None and rep.alive \
                    and not rep.engine._closed:
                return rep.engine.cancel(request_id)
        try:
            self._held.remove(fr)
        except ValueError:
            pass
        fr._cancelled = True
        return True

    def close(self):
        """Shut the whole fleet down: every replica closes (its
        pending requests retire with ``EngineClosed``) and held
        requests fail the same way. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for rep in self._replicas.values():
            with contextlib.suppress(Exception):
                rep.engine.close()
            rep.alive = False
        err = EngineClosed("FleetRouter was closed before this "
                           "request was re-placed")
        while self._held:
            fr = self._held.popleft()
            if not fr.done:
                fr._error = err
        while self._handoffs:
            pkg, fr = self._handoffs.popleft()
            with contextlib.suppress(Exception):
                pkg.resolve()
            if not fr.done:
                fr._error = err
        # settle the books: every journey retires (post-close replica
        # flight records are still readable — host-side rings)
        for fr in list(self._requests.values()):
            if not fr._finalized:
                self._observe(fr)
        _TM_LIVE.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
