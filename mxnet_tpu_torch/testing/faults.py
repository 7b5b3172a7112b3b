"""Deterministic fault injection for the serving engine.

Counterpart of the serving half of ``mxnet_tpu/testing/faults.py``. A
:class:`FaultInjector` installs itself as
``mxnet_tpu_torch.serving.engine._SERVING_FAULTS`` while one of its
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

Every injected fault is appended to ``FaultInjector.log`` as ``(kind,
op)``. The JAX package's transport plans (the ``dist_async`` kvstore)
and fleet plans raise: they belong to later slices of the port.
"""
from __future__ import annotations

import collections
import contextlib
import random
import threading
import time

from ..base import later_slice

__all__ = ["FaultInjector", "InjectedCrash"]


class InjectedCrash(RuntimeError):
    """Simulated process death mid-round (serving_crash_mid_round):
    deliberately NOT an MXNetError — the engine's per-request error
    isolation must not swallow it, exactly as it could not swallow a
    real SIGKILL."""


class FaultInjector:
    """A seeded, FIFO fault plan over the serving engine's host seams.

    ``seed`` seeds the injector's own RNG (the JAX package's randomized
    transport schedules draw from it; no serving plan does)."""

    def __init__(self, seed=0):
        self.rng = random.Random(seed)
        self.serving_plan = collections.deque()
        self.log = []          # (kind, op) per injected fault
        self._serving_depth = 0
        self._serving_prev = None
        self._hang_until = None
        self._lock = threading.Lock()

    # -- the transport and fleet plans: later slices ------------------
    def random_faults(self, n, p_drop=0.0, p_sever=0.2, p_delay=0.0,
                      delay_s=0.05):
        raise later_slice("FaultInjector", "the kvstore transport plans")

    def drop_sends(self, n=1):
        raise later_slice("FaultInjector", "the kvstore transport plans")

    def delay_sends(self, n=1, seconds=0.05):
        raise later_slice("FaultInjector", "the kvstore transport plans")

    def sever_connections(self, n=1):
        raise later_slice("FaultInjector", "the kvstore transport plans")

    def close_mid_message(self, n=1):
        raise later_slice("FaultInjector", "the kvstore transport plans")

    def drop_replies(self, n=1):
        raise later_slice("FaultInjector", "the kvstore transport plans")

    def fleet_kill_replica(self, replica_id=None, n=1):
        raise later_slice("FaultInjector", "the fleet plans")

    def fleet_heartbeat_blackhole(self, replica_id=None, n=1):
        raise later_slice("FaultInjector", "the fleet plans")

    def fleet_slow_replica(self, replica_id=None, seconds=1.0, n=1):
        raise later_slice("FaultInjector", "the fleet plans")

    def fleet_submit_failures(self, replica_id=None, n=1):
        raise later_slice("FaultInjector", "the fleet plans")

    def fleet_handoff_failures(self, replica_id=None, n=1):
        raise later_slice("FaultInjector", "the fleet plans")

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
