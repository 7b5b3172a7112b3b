"""Deterministic fault injection for the ``dist_async`` transport, the
serving engine and the fleet.

Counterpart of ``mxnet_tpu/testing/faults.py``. The transport plans
(:meth:`FaultInjector.random_faults`, ``drop_sends``, ``delay_sends``,
``sever_connections``, ``close_mid_message``, ``drop_replies``) install
the injector as ``mxnet_tpu_torch.kvstore_dist._CLIENT_FAULTS`` and
consume one directive per request attempt of
``kvstore_dist.PSBackend._request``; :func:`kill_server`,
:func:`restart_server` and :func:`server_down` stop a live parameter
server and bring up a successor with its state on the same port.

A :class:`FaultInjector` installs itself
as ``mxnet_tpu_torch.serving.engine._SERVING_FAULTS`` while one of its
serving plans is active, and drives the engine's host-side failure seams
deterministically:

* :meth:`FaultInjector.serving_h2d_failures` poisons individual requests
  (a bad host-to-device staging raises inside admission — the engine must
  retire ONLY that request);
* :meth:`FaultInjector.serving_round_hang` makes a dispatched round look
  not-ready, so that the ``round_timeout_ms`` watchdog trips;
* :meth:`FaultInjector.serving_crash_mid_round` raises
  :class:`InjectedCrash` after a decode or verify dispatch — process death
  mid-round, the setup for ``engine.snapshot()`` ->
  ``InferenceEngine.restore()``.

The plans are a FIFO of directives, consumed one per seam visit, so a
test reads like a fault schedule:

    inj = FaultInjector()
    with inj.serving_h2d_failures(1):
        engine.submit(...)      # this request's staging fails

The fleet plans install it as
``mxnet_tpu_torch.serving.fleet._FLEET_FAULTS`` and drive the
:class:`~mxnet_tpu_torch.serving.FleetRouter`'s seams:
:meth:`FaultInjector.fleet_kill_replica` (the named replica's next stepped
round dies with :class:`InjectedCrash` through the engine's own crash
seam — dispatched but undrained), :meth:`FaultInjector.
fleet_heartbeat_blackhole` (the replica's next pings go unanswered),
:meth:`FaultInjector.fleet_slow_replica` (the channel to the replica
stalls; the router's per-op timeout and ping probe decide slow-not-dead),
:meth:`FaultInjector.fleet_submit_failures` (the channel drops a submit)
and :meth:`FaultInjector.fleet_handoff_failures` (the channel drops a KV
handoff delivery). A directive naming replica ``None`` matches whichever
replica reaches that seam first.

Every injected fault is appended to ``FaultInjector.log`` as ``(kind,
op)``.
"""
from __future__ import annotations

import collections
import contextlib
import random
import threading
import time

from .. import kvstore_dist as _kd

__all__ = ["FaultInjector", "InjectedCrash", "kill_server",
           "restart_server", "server_down"]


class InjectedCrash(RuntimeError):
    """Simulated process death mid-round (serving_crash_mid_round):
    deliberately NOT an MXNetError — the engine's per-request error
    isolation must not swallow it, exactly as it could not swallow a
    real SIGKILL."""


class FaultInjector:
    """A seeded, FIFO fault plan over the serving engine's host seams.

    ``seed`` seeds the injector's own RNG (the randomized transport
    schedules draw from it; no serving plan does). The transport
    directives, consumed one per ``_request`` send/recv attempt:
    ``("drop",)`` swallows the outgoing frame (the client times out and
    retries), ``("delay", s)`` sleeps ``s`` seconds before sending,
    ``("sever",)`` closes the connection instead of sending,
    ``("truncate",)`` sends half a length header then closes,
    ``("drop_reply",)`` lets the request through then loses its reply
    (the apply-then-lose-the-ack case the server's dedup exists for) and
    ``("pass",)`` is no fault."""

    def __init__(self, seed=0):
        self.rng = random.Random(seed)
        self.plan = collections.deque()
        self.serving_plan = collections.deque()
        self.fleet_plan = collections.deque()
        self.log = []          # (kind, op) per injected fault
        self._depth = 0
        self._prev = None
        self._serving_depth = 0
        self._fleet_depth = 0
        self._fleet_prev = None
        self._serving_prev = None
        self._hang_until = None
        self._lock = threading.Lock()

    # -- plan construction --------------------------------------------
    def random_faults(self, n, p_drop=0.0, p_sever=0.2, p_delay=0.0,
                      delay_s=0.05):
        """A deterministic (seeded) schedule of ``n`` directives, each
        independently a drop/sever/delay with the given probabilities
        (else a no-op). Returns the active context manager."""
        plan = []
        for _ in range(n):
            r = self.rng.random()
            if r < p_drop:
                plan.append(("drop",))
            elif r < p_drop + p_sever:
                plan.append(("sever",))
            elif r < p_drop + p_sever + p_delay:
                plan.append(("delay", delay_s))
            else:
                plan.append(("pass",))
        return self._scheduled(plan)

    def drop_sends(self, n=1):
        """Swallow the next ``n`` outgoing frames (timeout path)."""
        return self._scheduled([("drop",)] * n)

    def delay_sends(self, n=1, seconds=0.05):
        """Stall the next ``n`` sends by ``seconds`` each."""
        return self._scheduled([("delay", seconds)] * n)

    def sever_connections(self, n=1):
        """Close the connection instead of the next ``n`` sends."""
        return self._scheduled([("sever",)] * n)

    def close_mid_message(self, n=1):
        """Send a truncated frame then close, ``n`` times."""
        return self._scheduled([("truncate",)] * n)

    def drop_replies(self, n=1):
        """Lose the reply (after the server applied the request) for
        the next ``n`` round trips."""
        return self._scheduled([("drop_reply",)] * n)

    # -- serving-engine plans -----------------------------------------
    def serving_h2d_failures(self, n=1):
        """Fail the next ``n`` per-request host->device stagings inside
        engine admission (the poisoned-request case: each failure must
        retire ONLY its own request, with an error result)."""
        return self._serving_scheduled([("h2d_fail",)] * n)

    def serving_round_hang(self, seconds=0.5):
        """Make the next drained round look not-ready for ``seconds``
        (a wedged device dispatch): with ``round_timeout_ms`` set the
        engine's watchdog trips with ``EngineStuck`` — and once the
        hang passes, the round drains normally (recovery path)."""
        return self._serving_scheduled([("hang", seconds)])

    def serving_crash_mid_round(self, n=1):
        """Raise :class:`InjectedCrash` right after the next ``n``
        decode dispatches — the process dies mid-round with tokens
        dispatched but undrained, the snapshot()/restore() scenario."""
        return self._serving_scheduled([("crash",)] * n)

    @contextlib.contextmanager
    def _serving_scheduled(self, directives):
        from ..serving import engine as _se

        with self._lock:
            self.serving_plan.extend(directives)
            if self._serving_depth == 0:
                self._serving_prev = _se._SERVING_FAULTS
                _se._SERVING_FAULTS = self
            self._serving_depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._serving_depth -= 1
                if self._serving_depth == 0:
                    _se._SERVING_FAULTS = self._serving_prev
                    self.serving_plan.clear()
                    self._hang_until = None

    # -- hooks called by serving.engine (host-side seams only) --------
    def serving_h2d(self, req):
        """May raise: a per-request staging failure at admission."""
        with self._lock:
            head = self.serving_plan[0] if self.serving_plan else None
            if head is None or head[0] != "h2d_fail":
                return
            self.serving_plan.popleft()
        self.log.append(("h2d_fail", req.id))
        raise RuntimeError("fault injection: h2d failed for request "
                           "%r" % (req.id,))

    def serving_round_stuck(self):
        """True while a scheduled round-hang is active (the watchdog's
        readiness poll consults this; a real wedge would keep the
        round's CUDA event unfinished the same way)."""
        with self._lock:
            if self._hang_until is None:
                head = (self.serving_plan[0] if self.serving_plan
                        else None)
                if head is None or head[0] != "hang":
                    return False
                self.serving_plan.popleft()
                self._hang_until = time.perf_counter() + head[1]
                self.log.append(("hang", head[1]))
            if time.perf_counter() < self._hang_until:
                return True
            self._hang_until = None
            return False

    def serving_crash(self):
        """May raise InjectedCrash: process death after dispatch."""
        with self._lock:
            head = self.serving_plan[0] if self.serving_plan else None
            if head is None or head[0] != "crash":
                return
            self.serving_plan.popleft()
        self.log.append(("crash", None))
        raise InjectedCrash("fault injection: process died mid-round "
                            "(dispatched, undrained)")

    # -- fleet plans ---------------------------------------------------
    def fleet_kill_replica(self, replica_id=None, n=1):
        """Kill the named replica (or whichever steps first when
        ``None``) mid-round, ``n`` times: its next stepped round dies
        with :class:`InjectedCrash` AFTER dispatch via the engine's
        own crash seam — tokens dispatched but undrained, exactly the
        snapshot-after-crash state the router must fail over from."""
        return self._fleet_scheduled([("kill_replica", replica_id)] * n)

    def fleet_heartbeat_blackhole(self, replica_id=None, n=1):
        """The replica's next ``n`` heartbeat pings go unanswered (a
        partitioned or hung peer): ``heartbeat_misses`` consecutive
        misses and the router declares it dead and fails over."""
        return self._fleet_scheduled([("blackhole", replica_id)] * n)

    def fleet_slow_replica(self, replica_id=None, seconds=1.0, n=1):
        """The channel to the replica stalls ``seconds`` on the next
        ``n`` submits. Past the router's ``timeout_ms`` the op times
        out and the ping probe decides slow-not-dead (retry, no
        failover) — under it, the submit just lands."""
        return self._fleet_scheduled(
            [("slow", replica_id, seconds)] * n)

    def fleet_submit_failures(self, replica_id=None, n=1):
        """Drop the next ``n`` submits to the replica on the floor
        (``ConnectionError`` from the channel): the router's bounded
        retry/backoff — and, when the submit actually LANDED before
        the fault, the exactly-once adoption path — must absorb it."""
        return self._fleet_scheduled([("submit_fail", replica_id)] * n)

    def fleet_handoff_failures(self, replica_id=None, n=1):
        """Drop the next ``n`` KV-handoff deliveries to the decode
        replica (``ConnectionError`` from the channel): the router's
        retry must re-deliver the SAME package, and when the admit
        landed before the fault died on the wire, the decode engine's
        dedup table must admit exactly once (adoption, not double
        admission)."""
        return self._fleet_scheduled([("handoff_fail", replica_id)] * n)

    @contextlib.contextmanager
    def _fleet_scheduled(self, directives):
        from ..serving import fleet as _sf

        with self._lock:
            self.fleet_plan.extend(directives)
            if self._fleet_depth == 0:
                self._fleet_prev = _sf._FLEET_FAULTS
                _sf._FLEET_FAULTS = self
            self._fleet_depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._fleet_depth -= 1
                if self._fleet_depth == 0:
                    _sf._FLEET_FAULTS = self._fleet_prev
                    self.fleet_plan.clear()

    # -- hooks called by serving.fleet.FleetRouter --------------------
    def _fleet_head(self, kind, replica_id):
        """Pop-and-return the head directive iff it is ``kind`` aimed
        at ``replica_id`` (or at anyone). FIFO: a head aimed at a
        DIFFERENT replica blocks this one from matching, so a test's
        schedule fires in the order it was written."""
        head = self.fleet_plan[0] if self.fleet_plan else None
        if head is None or head[0] != kind:
            return None
        if head[1] is not None and head[1] != replica_id:
            return None
        return self.fleet_plan.popleft()

    def fleet_step_context(self, replica_id):
        """Context manager for one replica round, or None. A matched
        kill directive arms the ENGINE crash seam for the round's
        scope, so death lands after dispatch exactly like
        :meth:`serving_crash_mid_round`."""
        with self._lock:
            head = self._fleet_head("kill_replica", replica_id)
        if head is None:
            return None
        self.log.append(("kill_replica", replica_id))
        return self._serving_scheduled([("crash",)])

    def fleet_ping_blackholed(self, replica_id):
        """True when the replica's ping should go unanswered."""
        with self._lock:
            head = self._fleet_head("blackhole", replica_id)
        if head is None:
            return False
        self.log.append(("blackhole", replica_id))
        return True

    def fleet_submit(self, replica_id):
        """Channel fault for one submit attempt: raises
        ``ConnectionError`` (dropped), or returns a stall in seconds
        (the router judges it against its timeout), or 0 (clean)."""
        with self._lock:
            head = self._fleet_head("submit_fail", replica_id)
            if head is None:
                slow = self._fleet_head("slow", replica_id)
            else:
                slow = None
        if head is not None:
            self.log.append(("submit_fail", replica_id))
            raise ConnectionError(
                "fault injection: submit to replica %r lost"
                % (replica_id,))
        if slow is not None:
            self.log.append(("slow", replica_id))
            return slow[2]
        return 0

    def fleet_handoff(self, replica_id):
        """Channel fault for one KV-handoff delivery attempt: raises
        ``ConnectionError`` (package lost on the wire), or returns a
        stall in seconds, or 0 (clean) — same contract as
        :meth:`fleet_submit`, separate directive kind so a schedule
        can fault handoffs without touching ordinary submits."""
        with self._lock:
            head = self._fleet_head("handoff_fail", replica_id)
            if head is None:
                slow = self._fleet_head("slow", replica_id)
            else:
                slow = None
        if head is not None:
            self.log.append(("handoff_fail", replica_id))
            raise ConnectionError(
                "fault injection: handoff to replica %r lost"
                % (replica_id,))
        if slow is not None:
            self.log.append(("slow", replica_id))
            return slow[2]
        return 0

    @contextlib.contextmanager
    def _scheduled(self, directives):
        with self._lock:
            self.plan.extend(directives)
            if self._depth == 0:
                self._prev = _kd._CLIENT_FAULTS
                _kd._CLIENT_FAULTS = self
            self._depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    _kd._CLIENT_FAULTS = self._prev
                    self.plan.clear()  # unconsumed faults die with scope

    # -- hooks called by kvstore_dist._request ------------------------
    def before_send(self, server, envelope, conn):
        """Return False to suppress the real send (frame dropped)."""
        with self._lock:
            head = self.plan[0] if self.plan else None
            if head is None or head[0] == "drop_reply":
                return True  # drop_reply waits for after_recv
            self.plan.popleft()
        op = envelope[3][0]
        kind = head[0]
        if kind == "pass":
            return True
        self.log.append((kind, op))
        if kind == "drop":
            return False
        if kind == "delay":
            time.sleep(head[1])
            return True
        if kind == "sever":
            conn.close()
            raise ConnectionError("fault injection: connection severed "
                                  "before send")
        if kind == "truncate":
            try:
                conn.sendall(b"\x00\x00\x00\x00")  # half a length prefix
            finally:
                conn.close()
            raise ConnectionError("fault injection: connection closed "
                                  "mid-message")
        raise AssertionError("unknown fault directive %r" % (head,))

    def after_recv(self, server, envelope, reply, conn):
        with self._lock:
            head = self.plan[0] if self.plan else None
            if head is None or head[0] != "drop_reply":
                return
            self.plan.popleft()
        self.log.append(("drop_reply", envelope[3][0]))
        conn.close()
        raise ConnectionError("fault injection: reply lost")


# -- server crash / recovery ------------------------------------------

def kill_server(owner):
    """Stop a live ``_Server`` (listener + every accepted connection),
    as a crash would. ``owner`` is a ``PSBackend`` or a ``_Server``;
    returns the dead server (its in-memory state survives for
    :func:`restart_server`)."""
    server = getattr(owner, "server", owner)
    server.close()
    return server


def restart_server(owner, dead=None):
    """Bring up a successor ``_Server`` on the dead one's port with its
    whole state (store, updater, retry-dedup table, and the shared
    lock/condition, so a predecessor handler still mid-apply publishes
    where successor waiters can see it) — a parameter server recovering
    from its replica. Rebinds ``owner.server`` when ``owner`` is a
    ``PSBackend``. Returns the new server."""
    old = dead if dead is not None else getattr(owner, "server", owner)
    new = _kd._Server(old.rank, old.port, predecessor=old)
    new.start()
    if hasattr(owner, "server"):
        owner.server = new
    return new


@contextlib.contextmanager
def server_down(backend, restart_after=None):
    """The backend's colocated server is DEAD inside the block.

    With ``restart_after`` set, a timer restarts it that many seconds
    in — so a client request issued inside the block retries against a
    refused port and then succeeds against the successor, the
    kill-and-recover scenario. Without it, the server stays down until
    the block exits (then it is restarted)."""
    dead = kill_server(backend)
    restarted = threading.Event()

    def _revive():
        restart_server(backend, dead)
        restarted.set()

    timer = None
    if restart_after is not None:
        timer = threading.Timer(restart_after, _revive)
        timer.daemon = True
        timer.start()
    try:
        yield dead
    finally:
        if timer is not None:
            timer.join()
        if not restarted.is_set():
            _revive()
