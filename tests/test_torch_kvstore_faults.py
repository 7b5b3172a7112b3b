"""The ``dist_async`` transport of the port under deterministic faults:
the twelve transport tests of ``tests/test_faults.py`` (dropped frames,
severed connections, lost replies, slow applies, a server killed and
restarted mid-run, a dead server, a seeded fault storm) run against the
port's ``kvstore_dist.PSBackend`` and ``testing.faults`` — the same
scenarios, timeouts and assertions, in one process on localhost.
"""
import socket
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.testing import faults


def _free_port_block(span=64):
    """A port base whose next ``span`` ports were free a moment ago (the
    backend binds base + generation * servers + rank)."""
    for _ in range(50):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        if base + span >= 65535:
            continue
        ok = True
        for p in range(base, base + span):
            t = socket.socket()
            try:
                t.bind(("0.0.0.0", p))
            except OSError:
                ok = False
            finally:
                t.close()
            if not ok:
                break
        if ok:
            return base
    raise RuntimeError("no free port block")


def _accumulate(key, recv, stored):
    """Picklable server-side updater: stored += recv (so double-applied
    pushes are visible as a doubled value)."""
    stored += recv


@pytest.fixture
def backend(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_PORT_BASE", str(_free_port_block()))
    monkeypatch.setenv("MXNET_KVSTORE_TIMEOUT", "1.5")
    monkeypatch.setenv("MXNET_KVSTORE_MAX_RETRIES", "8")
    monkeypatch.setenv("MXNET_KVSTORE_BACKOFF_MS", "40")
    from mxnet_tpu_torch import distributed
    distributed.initialize()
    from mxnet_tpu_torch.kvstore_dist import PSBackend
    ps = PSBackend()
    yield ps
    ps.close()


def test_ping_heartbeat(backend):
    """The ping op answers while the server lives and stops answering
    the instant it is killed — the dead-vs-slow discriminator."""
    rtt0 = mx.telemetry.histogram("kvstore.ping_rtt_ms").count
    assert backend._ping(0)
    with faults.server_down(backend):
        assert not backend._ping(0)
    assert backend._ping(0)  # successor answers again
    # only the SUCCESSFUL probes record a heartbeat RTT sample
    assert mx.telemetry.histogram("kvstore.ping_rtt_ms").count \
        == rtt0 + 2


def test_sever_reconnect_retry(backend):
    """A connection severed mid-request is transparently reconnected
    and the request retried — exactly once applied. The retry storm is
    visible in telemetry: a fault-injection run produces a non-trivial
    kvstore snapshot."""
    import pickle
    retries0 = mx.telemetry.counter("kvstore.retries").value
    reconn0 = mx.telemetry.counter("kvstore.reconnects").value
    backend.init(1, np.zeros(4))
    backend.set_optimizer(pickle.dumps(_accumulate))
    inj = faults.FaultInjector(seed=1)
    with inj.sever_connections(1):
        backend.push(1, np.ones(4))
    assert [k for k, _ in inj.log] == ["sever"]
    np.testing.assert_allclose(backend.pull(1), 1.0)
    snap = mx.telemetry.snapshot()["kvstore"]
    assert snap["retries"] > retries0
    assert snap["reconnects"] > reconn0
    assert snap["pushes"] >= 1 and snap["push_bytes"] >= 4 * 8
    assert snap["pulls"] >= 1 and snap["pull_bytes"] > 0


def test_dropped_frame_times_out_then_retries(backend):
    """A swallowed frame surfaces as a dead request; the retry path
    resends and the value lands once."""
    backend.init(2, np.zeros(3))
    inj = faults.FaultInjector(seed=2)
    timeouts0 = mx.telemetry.counter("kvstore.timeouts").value
    retries0 = mx.telemetry.counter("kvstore.retries").value
    t0 = time.time()
    with inj.drop_sends(1):
        backend.push(2, np.full(3, 7.0))
    # the lost frame cost at least the request timeout before the retry
    assert time.time() - t0 >= 1.0
    assert ("drop", "push") in inj.log
    np.testing.assert_allclose(backend.pull(2), 7.0)
    # the client's recv timeout and the server's idle-connection drop
    # are both armed at MXNET_KVSTORE_TIMEOUT: on a loaded box the
    # server can win, turning the stall into a ConnectionError instead
    # of socket.timeout — either way the retry counter must move
    assert mx.telemetry.counter("kvstore.retries").value > retries0 or \
        mx.telemetry.counter("kvstore.timeouts").value > timeouts0


def test_lost_reply_not_double_applied(backend):
    """The server applied the push but the reply was lost: the retried
    request must be answered from the dedup cache, NOT re-applied —
    with an accumulate updater a double apply would read 2.0."""
    import pickle
    backend.init(3, np.zeros(5))
    backend.set_optimizer(pickle.dumps(_accumulate))
    inj = faults.FaultInjector(seed=3)
    dedup0 = mx.telemetry.counter("kvstore.dedup_hits").value
    with inj.drop_replies(1):
        backend.push(3, np.ones(5))
    assert ("drop_reply", "push") in inj.log
    np.testing.assert_allclose(backend.pull(3), 1.0)
    # the retried request was answered from the dedup cache — counted
    assert mx.telemetry.counter("kvstore.dedup_hits").value > dedup0


_SLOW_CALLS = []


def _slow_accumulate(key, recv, stored):
    """Picklable updater whose FIRST apply outlives the client timeout,
    forcing a retry while the original request is still executing."""
    if not _SLOW_CALLS:
        _SLOW_CALLS.append(1)
        time.sleep(2.2)  # > the fixture's 1.5s MXNET_KVSTORE_TIMEOUT
    stored += recv


def test_slow_apply_retry_not_double_applied(backend):
    """A push whose server-side APPLY outlives the client timeout is
    resent (ping says the server is alive) while the original is still
    inside the updater. The duplicate must block on the in-flight dedup
    claim and answer from the original's cached reply — never re-apply.
    A double apply would read 2.0."""
    import pickle
    _SLOW_CALLS.clear()
    backend.init(8, np.zeros(3))
    backend.set_optimizer(pickle.dumps(_slow_accumulate))
    backend.push(8, np.ones(3))
    assert _SLOW_CALLS  # the slow path actually ran
    np.testing.assert_allclose(backend.pull(8), 1.0)


def test_ping_answers_during_long_apply(backend):
    """The heartbeat must answer PROMPTLY while a long updater apply
    holds the server's store lock — ping rides its own handler thread
    and never touches the store. If accepting connections serialized on
    the store lock, a merely-slow server would be unreachable for
    probes and misclassified as dead."""
    import pickle
    _SLOW_CALLS.clear()
    backend.init(9, np.zeros(3))
    backend.set_optimizer(pickle.dumps(_slow_accumulate))
    t = threading.Thread(
        target=lambda: backend.push(9, np.ones(3)), daemon=True)
    t.start()
    time.sleep(0.4)  # let the 2.2s apply get under way
    t0 = time.time()
    alive = backend._ping(0)
    dt = time.time() - t0
    t.join()
    assert alive
    assert dt < 1.0, "ping starved behind the in-flight apply (%.2fs)" % dt
    np.testing.assert_allclose(backend.pull(9), 1.0)


def test_stale_older_seq_duplicate_acked_not_reapplied(backend):
    """A mutating frame from an ABANDONED connection, read after the
    client has already moved on to a newer seq, is acknowledged from the
    dedup layer without re-executing (the client only advances past a
    mutating seq once it was applied)."""
    srv = backend.server
    assert srv._claim("c", 1) is None      # claimed for execution
    with srv.lock:
        srv._dedup["c"] = (1, ("ok",))     # applied + published
        srv._applied.notify_all()
    assert srv._claim("c", 1) == ("ok",)   # plain retry: cached reply
    assert srv._claim("c", 2) is None      # next request claims
    with srv.lock:
        srv._dedup["c"] = (2, ("ok",))
        srv._applied.notify_all()
    # late retransmit of seq 1: acked, never claimed for execution
    assert srv._claim("c", 1) == ("ok",)
    with srv.lock:
        assert srv._dedup["c"][0] == 2     # newer entry undisturbed


def _exploding(key, recv, stored):
    """Picklable updater with a deterministic server-side apply error."""
    raise ValueError("boom")


def test_failed_apply_fails_fast(backend):
    """A deterministic server-side apply error must surface to the
    client as a prompt MXNetError — not minutes of retries each
    stalling a full request timeout on the dead handler's unpublished
    dedup claim."""
    import pickle
    backend.init(11, np.zeros(2))
    backend.set_optimizer(pickle.dumps(_exploding))
    t0 = time.time()
    with pytest.raises(MXNetError, match="apply failed"):
        backend.push(11, np.ones(2))
    assert time.time() - t0 < 6.0  # well under one 1.5s-timeout stall


def test_mid_message_close_keeps_server_sane(backend):
    """A connection dying mid-frame (half a length header) must neither
    wedge a server handler nor corrupt state; the client retries on a
    fresh connection."""
    backend.init(4, np.zeros(2))
    inj = faults.FaultInjector(seed=4)
    with inj.close_mid_message(1):
        backend.push(4, np.full(2, 3.0))
    np.testing.assert_allclose(backend.pull(4), 3.0)
    # server still serves further traffic on new connections
    backend.push(4, np.full(2, 5.0))
    np.testing.assert_allclose(backend.pull(4), 5.0)


def test_server_killed_and_restarted_mid_run(backend):
    """THE acceptance scenario: the server dies mid-run and a successor
    with its state comes up on the same port; in-flight push/pull
    retries reconnect and succeed with no double-applied update."""
    import pickle
    backend.init(5, np.zeros(4))
    backend.set_optimizer(pickle.dumps(_accumulate))
    backend.push(5, np.ones(4))  # healthy baseline push
    with faults.server_down(backend, restart_after=0.4):
        # issued while the port refuses connections; retries with
        # backoff until the successor binds, then must apply ONCE
        backend.push(5, np.ones(4))
        np.testing.assert_allclose(backend.pull(5), 2.0)
    # successor keeps serving after the block too
    backend.push(5, np.ones(4))
    np.testing.assert_allclose(backend.pull(5), 3.0)


def test_dead_server_fails_fast_with_clear_error(backend, monkeypatch):
    """A server that never comes back exhausts the bounded retry budget
    and surfaces as a loud MXNetError naming the peer — not a hang."""
    monkeypatch.setenv("MXNET_KVSTORE_MAX_RETRIES", "2")
    monkeypatch.setenv("MXNET_KVSTORE_BACKOFF_MS", "20")
    backend.init(6, np.zeros(2))
    faults.kill_server(backend)
    t0 = time.time()
    with pytest.raises(MXNetError, match="unreachable or died"):
        backend.push(6, np.ones(2))
    assert time.time() - t0 < 5.0
    # revive so the fixture's close() doesn't log noise
    faults.restart_server(backend)


def test_random_fault_storm_is_deterministic_and_survivable(backend):
    """A seeded storm of severed connections across many pushes: the
    store ends exactly where a fault-free run would (each push applied
    once), and the same seed injects the same schedule."""
    import pickle
    backend.init(7, np.zeros(3))
    backend.set_optimizer(pickle.dumps(_accumulate))
    inj = faults.FaultInjector(seed=1234)
    with inj.random_faults(20, p_sever=0.4):
        for _ in range(10):
            backend.push(7, np.ones(3))
    np.testing.assert_allclose(backend.pull(7), 10.0)
    assert inj.log == [("sever", "push")] * len(inj.log)
    # determinism: a fresh injector with the same seed plans the same
    # schedule (compare against a replayed plan, not wall-clock)
    inj2 = faults.FaultInjector(seed=1234)
    with inj2.random_faults(20, p_sever=0.4):
        plan2 = list(inj2.plan)
    inj3 = faults.FaultInjector(seed=1234)
    with inj3.random_faults(20, p_sever=0.4):
        plan3 = list(inj3.plan)
    assert plan2 == plan3
