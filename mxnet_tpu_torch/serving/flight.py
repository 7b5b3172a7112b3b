"""Per-request flight recorder for the serving engine.

Counterpart of ``mxnet_tpu/serving/flight.py`` (the port's own copy).

The telemetry histograms answer "how is the fleet doing"; they cannot
answer "what happened to request 1173" once it retired — a deadline
miss or a ``retire_reason="error"`` used to leave nothing but a
counter increment behind. The :class:`FlightRecorder` keeps a bounded
ring of structured lifecycle timelines: every event the scheduler
already knows about (submit → staged → prefix hit/miss → admitted →
each prefill chunk → first token → sampled decode progress → retire
with the reason) is appended to the request's record, and the last
``retain`` RETIRED records are kept for post-hoc reconstruction through
:meth:`FlightRecorder.timeline` (the JAX package also serves them over
HTTP, which belongs to a later slice of the port).

Design constraints, matching the rest of the telemetry plane:

* **host-side only** — events carry values the scheduler already has
  (``time.perf_counter`` stamps, slot ids, token counts); recording is
  an append under one lock, no device op anywhere.
* **bounded everywhere** — ``retain`` retired requests (FIFO ring,
  ``MXNET_SERVING_FLIGHT_RECORDER``, default 256; 0 disables), at most
  ``max_events`` events per request (overflow is counted, and the
  terminal ``retire`` event always lands), decode progress sampled
  every ``token_sample`` tokens rather than per token.
* **Chrome-trace export** — while a ``telemetry.start_trace``
  capture is armed, every recorded event also emits an instant event
  (cat ``serving.flight``, the request id in ``args``), so flight
  timelines line up with the engine's prefill/decode spans in
  Perfetto.
"""
from __future__ import annotations

import collections
import threading
import time

from .. import telemetry as tele

__all__ = ["FlightRecorder"]


class _Flight:
    """One request's record: static metadata + the event list."""

    __slots__ = ("rid", "t0", "meta", "events", "dropped", "tokens")

    def __init__(self, rid, t0, meta):
        self.rid = rid
        self.t0 = t0
        self.meta = meta
        self.events = []
        self.dropped = 0
        self.tokens = 0


class FlightRecorder:
    """Bounded ring of per-request lifecycle timelines (one instance
    per :class:`~mxnet_tpu_torch.serving.InferenceEngine`).

    ``retain``
        Retired requests kept for reconstruction (0 disables recording
        entirely — every method becomes a cheap no-op).
    ``max_events``
        Per-request event cap; past it events are dropped and counted
        (``dropped_events`` in the timeline), except the terminal
        ``retire`` event, which always lands.
    ``token_sample``
        Decode progress is recorded every this-many tokens (plus the
        first token, which gets its own ``first_token`` event from the
        engine) — a 2048-token generation leaves ~128 progress events,
        not 2048.
    """

    def __init__(self, retain=256, max_events=256, token_sample=16):
        self.retain = max(0, int(retain))
        self.max_events = max(8, int(max_events))
        self.token_sample = max(1, int(token_sample))
        self._live = {}                        # rid -> _Flight
        self._retired = collections.OrderedDict()   # FIFO ring
        self._lock = threading.Lock()

    @property
    def enabled(self):
        return self.retain > 0 and tele.enabled()

    # -- recording (engine thread) --------------------------------------
    def start(self, rid, **meta):
        """Open a record at submit time (``meta``: prompt_len,
        max_tokens, deadlines, resumed ...). Re-submitting an id that
        is still live restarts its record."""
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            self._live[rid] = fl = _Flight(rid, now, dict(meta))
        self._append(fl, now, "submit", meta or None)

    def event(self, rid, name, **args):
        """Record one lifecycle event for a live request (unknown ids
        are ignored — the recorder may have been disabled when the
        request was submitted)."""
        if not self.enabled:
            return
        with self._lock:
            fl = self._live.get(rid)
        if fl is not None:
            self._append(fl, time.perf_counter(), name, args or None)

    def token(self, rid, n):
        """Sampled decode progress: called once per drained token with
        the running count; records when the count CROSSES a
        ``token_sample`` boundary. Crossing, not ``n %% sample == 0``:
        a speculative verify round drains several accepted tokens at
        once, so the running count may skip over an exact multiple —
        the recorded event carries the true ``tokens=`` count either
        way."""
        if not self.enabled:
            return
        with self._lock:
            fl = self._live.get(rid)
        if fl is None:
            return
        prev = fl.tokens
        fl.tokens = n
        if n // self.token_sample > prev // self.token_sample:
            self._append(fl, time.perf_counter(), "decode",
                         {"tokens": n})

    def retire(self, rid, reason, **args):
        """Terminal event: moves the record to the retired ring
        (evicting the oldest past ``retain``). Always recorded, even
        at the event cap."""
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            fl = self._live.pop(rid, None)
            if fl is None:
                return
            fl.meta["retire_reason"] = reason
            self._retired[rid] = fl
            self._retired.move_to_end(rid)
            while len(self._retired) > self.retain:
                self._retired.popitem(last=False)
        args = dict(args)
        args["reason"] = reason
        self._append(fl, now, "retire", args, terminal=True)

    def _append(self, fl, now, name, args, terminal=False):
        ev = {"t_ms": round((now - fl.t0) * 1e3, 3), "event": name}
        if args:
            ev.update(args)
        with self._lock:
            if len(fl.events) >= self.max_events and not terminal:
                fl.dropped += 1
            else:
                fl.events.append(ev)
        if tele.tracing():
            tele.mark("serving.flight." + name, cat="serving.flight",
                      request=str(fl.rid), **(args or {}))

    # -- reconstruction (any thread) ------------------------------------
    def timeline(self, rid):
        """Full timeline of a live or recently-retired request:
        ``{"id", "live", "meta", "events", "dropped_events"}`` with
        event times in ms since submit — or None if the id was never
        recorded / already evicted from the ring."""
        with self._lock:
            fl = self._live.get(rid)
            live = fl is not None
            if fl is None:
                fl = self._retired.get(rid)
            if fl is None:
                return None
            return {"id": fl.rid, "live": live, "meta": dict(fl.meta),
                    "events": list(fl.events),
                    "dropped_events": fl.dropped}

    def records(self, rid):
        """Raw records for a request id, retired-then-live, each as
        ``(t0, events)`` with ``t0`` the ABSOLUTE ``perf_counter``
        stamp of the record's submit: a caller can stitch them onto
        its own clock (the JAX package's fleet router does). A resubmit
        of a live id restarts its live record, so callers copy events
        out rather than reference them in place."""
        with self._lock:
            out = []
            fl = self._retired.get(rid)
            if fl is not None:
                out.append((fl.t0, list(fl.events)))
            fl = self._live.get(rid)
            if fl is not None:
                out.append((fl.t0, list(fl.events)))
            return out

    def rows(self):
        """Summary rows for the retired ring (oldest first) — the
        "recently retired" half of the engine's ``request_table()``."""
        now = time.perf_counter()
        with self._lock:
            return [{"id": fl.rid, "state": "retired",
                     "retire_reason": fl.meta.get("retire_reason"),
                     "prompt_len": fl.meta.get("prompt_len"),
                     "tokens": fl.tokens,
                     "age_s": round(now - fl.t0, 3),
                     "events": len(fl.events)}
                    for fl in self._retired.values()]

    def ids(self):
        """(live ids, retired ids oldest-first) currently recorded."""
        with self._lock:
            return list(self._live), list(self._retired)
