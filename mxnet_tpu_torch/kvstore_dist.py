"""``dist_async``: a real update-per-push parameter server.

Counterpart of ``mxnet_tpu/kvstore_dist.py`` (the port's own copy of its
transport, which is plain Python): the process rank and count come from
``distributed.rank``/``num_workers`` (torch.distributed over gloo), the
start-up and close barriers are ``distributed.barrier``, and a server
thread applies the pickled updater to CPU tensors.

The reference's async mode lives in ps-lite server processes: every
worker push is applied to the weights immediately, with NO worker
lockstep (the reference's ``src/kvstore/kvstore_dist_server.h:194-202``);
workers pull whatever the current weights are. Collectives cannot
express that (they are synchronous by construction), so this backend is
deliberately HOST-driven, like the reference's: each process runs one
server thread (the reference colocates via ps-lite roles; here every
worker hosts a server, so ``-n N`` gives N servers like ``num_servers =
num_workers`` launches), and requests ride length-prefixed pickle over
TCP where ps-lite rode ZMQ.

Key placement mirrors ``EncodeKey`` (``kvstore_dist.h:230-268``):

* small keys hash to one server: ``(key * 9973) % num_servers``;
* arrays >= ``MXNET_KVSTORE_BIGARRAY_BOUND`` are RANGE-PARTITIONED along
  their first axis across all servers, so no single host stores or
  updates a whole embedding-sized array.

Updates run in the owning server's thread, serialized per server by the
request loop (the reference serializes through the ps handler thread) —
``updater(key, recv, stored)`` with the optimizer the workers sent via
``set_optimizer`` (pickled, command 0 in the reference protocol).

Server addresses: ``MXNET_KVSTORE_SERVER_HOSTS`` (comma list, one per
process) or 127.0.0.1 for single-machine multi-process runs;
``MXNET_KVSTORE_PORT_BASE`` (default 24500) + rank.
"""
from __future__ import annotations

import errno
import logging
import os
import pickle
import random
import socket
import struct
import threading
import time

import numpy as np

from .base import MXNetError
from . import telemetry as tele
from .kvstore import _bigarray_bound  # single source for the threshold

__all__ = ["PSBackend"]

# transport health metrics (doc/observability.md "kvstore_dist"): a
# retry storm, a flapping server or a half-open peer shows up here
# long before the bounded-retry MXNetError does
_TM_PUSHES = tele.counter("kvstore.pushes")
_TM_PULLS = tele.counter("kvstore.pulls")
_TM_PUSH_BYTES = tele.counter("kvstore.push_bytes")
_TM_PULL_BYTES = tele.counter("kvstore.pull_bytes")
_TM_RETRIES = tele.counter("kvstore.retries")
_TM_RECONNECTS = tele.counter("kvstore.reconnects")
_TM_TIMEOUTS = tele.counter("kvstore.timeouts")
_TM_DEDUP_HITS = tele.counter("kvstore.dedup_hits")
_TM_PING_MS = tele.histogram("kvstore.ping_rtt_ms")
_TM_REQUEST_MS = tele.histogram("kvstore.request_ms")

_LEN = struct.Struct("!Q")

# Test seam: ``mxnet_tpu_torch.testing.faults`` installs an injector here to
# deterministically drop/delay/sever CLIENT-side frames (the server side
# is faulted by killing/restarting the _Server itself). None in
# production — the hot path pays one attribute read per request.
_CLIENT_FAULTS = None


def _request_timeout():
    """Per-request socket timeout in seconds (MXNET_KVSTORE_TIMEOUT).

    Generous by default: on oversubscribed test hosts a peer can
    legitimately stall for minutes (a kernel build, a long step); a DEAD
    peer is detected by TCP reset or the ping probe, not by idleness
    (ps-lite likewise waits on its van)."""
    return float(os.environ.get("MXNET_KVSTORE_TIMEOUT", "600"))


def _max_retries():
    """Resend budget AFTER the first attempt (MXNET_KVSTORE_MAX_RETRIES)."""
    return int(os.environ.get("MXNET_KVSTORE_MAX_RETRIES", "4"))


def _backoff_base_s():
    """Base reconnect backoff in seconds (MXNET_KVSTORE_BACKOFF_MS)."""
    return float(os.environ.get("MXNET_KVSTORE_BACKOFF_MS", "100")) / 1000.0

# SECURITY: the wire format is pickle, and ``pickle.loads`` on attacker
# bytes is remote code execution. Like ps-lite's ZMQ, this transport
# assumes a TRUSTED private cluster network. Set
# ``MXNET_KVSTORE_SECRET`` (any shared string, exported to every
# process — tools/launch.py forwards env) to require an HMAC-SHA256 tag
# on every message, rejecting frames from anything that doesn't hold
# the secret. Do NOT expose the server port beyond the cluster.


def _secret():
    return os.environ.get("MXNET_KVSTORE_SECRET", "").encode()


def _send_msg(sock, obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sec = _secret()
    if sec:
        import hmac
        payload += hmac.new(sec, payload, "sha256").digest()
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    payload = _recv_exact(sock, n)
    sec = _secret()
    if sec:
        import hmac
        if len(payload) < 32:
            raise MXNetError("kvstore dist_async: short frame under "
                             "MXNET_KVSTORE_SECRET")
        payload, tag = payload[:-32], payload[-32:]
        want = hmac.new(sec, payload, "sha256").digest()
        if not hmac.compare_digest(tag, want):
            raise MXNetError(
                "kvstore dist_async: HMAC verification failed — peer "
                "does not hold MXNET_KVSTORE_SECRET (refusing to "
                "unpickle untrusted bytes)")
    return pickle.loads(payload)


def _port_base():
    if "MXNET_KVSTORE_PORT_BASE" in os.environ:
        return int(os.environ["MXNET_KVSTORE_PORT_BASE"])
    # derive from the coordinator port so concurrent launches on one
    # machine (each with its own free coordinator port) don't collide
    coord = os.environ.get("MXNET_TPU_COORDINATOR")
    if coord and ":" in coord:
        return int(coord.rsplit(":", 1)[1]) + 1000
    return 24500


class _Server(threading.Thread):
    """One server thread: owns a slice of the key space; applies pushes
    immediately (async semantics). Daemon — dies with the process.

    ``predecessor`` hands a dead server's whole state — store, updater,
    retry-dedup table, AND its lock/condition (a predecessor handler
    thread can still be mid-apply when the successor starts; sharing the
    synchronization keeps that late publish visible to successor
    waiters) — to a restart-after-crash successor (or the fault
    harness's kill/restart injector): the analogue of a ps-lite server
    recovering from its replica."""

    def __init__(self, rank, port, predecessor=None):
        super().__init__(daemon=True, name="mxnet-ps-server-%d" % rank)
        self.rank = rank
        self.port = port
        if predecessor is not None:
            self.store = predecessor.store       # (key, part) -> np
            # the updater lives in a SHARED one-slot box, not a
            # per-instance attribute: a predecessor handler finishing a
            # set_optimizer mid-restart must install into the successor
            # too (the shared _dedup acks that request as applied)
            self._updater_box = predecessor._updater_box
            self._dedup = predecessor._dedup
            self._claim_holders = predecessor._claim_holders
            self.lock = predecessor.lock
            self._applied = predecessor._applied
        else:
            self.store = {}
            self._updater_box = {"u": None}
            # client_id -> (seq, reply) of the last MUTATING request
            # for that client: a retried push/init/set_optimizer (reply
            # lost to a connection drop AFTER the server applied it) is
            # answered from here instead of being applied twice —
            # exactly-once updates under at-least-once delivery. One
            # entry per client; reply None marks an in-flight claim
            # whose executing thread is in _claim_holders (see _claim).
            self._dedup = {}
            self._claim_holders = {}
            self.lock = threading.Lock()
            self._applied = threading.Condition(self.lock)
        self.conns = []        # accepted sockets — see close()
        # conns gets its own lock: run() must keep accepting (and
        # spawning handler threads — the ping heartbeat rides one) while
        # a long updater apply holds self.lock, or a merely-slow server
        # would be unreachable for probes and misclassified as dead
        self._conns_lock = threading.Lock()
        self._closed = False   # set by close(), checked under _conns_lock
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.sock.bind(("0.0.0.0", port))
        except OSError as e:
            raise MXNetError(
                "dist_async: cannot bind parameter-server port %d (%s). "
                "Another job on this host owns it — set "
                "MXNET_KVSTORE_PORT_BASE to a free range." % (port, e))
        self.sock.listen(64)

    @property
    def updater(self):
        return self._updater_box["u"]

    @updater.setter
    def updater(self, fn):
        self._updater_box["u"] = fn

    def run(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return  # socket closed at shutdown
            with self._conns_lock:
                if self._closed:
                    # close() already drained conns: a connection that
                    # slipped through accept() in that window must not
                    # be served — a "killed" server would keep this
                    # socket ESTABLISHED and the port bound, failing
                    # the successor's bind
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self.conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name="mxnet-ps-handler-%d" % self.rank,
                             daemon=True).start()

    def close(self):
        """Close the listener AND every accepted connection: on Linux an
        ESTABLISHED accepted socket still counts as bound to the port,
        so a successor server could not re-bind until they are gone
        (SO_REUSEADDR only covers TIME_WAIT). shutdown() first: close()
        alone does NOT unblock a thread sitting in accept() — the kernel
        keeps the listening socket (and the port!) alive until that
        syscall returns, so a "killed" server would silently keep
        accepting."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        with self._conns_lock:
            self._closed = True
            conns, self.conns = self.conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    # ops whose effect on server state is NOT idempotent — only their
    # replies are cached for retry dedup (pull/ping re-execute freely)
    _MUTATING_OPS = ("init", "push", "set_optimizer")

    def _claim(self, client, seq):
        """Atomically claim a mutating request for execution; return the
        cached reply instead when ``(client, seq)`` was already applied.

        The dedup entry is written BEFORE execution as ``(seq, None)`` —
        a claim — so a timeout-resent duplicate arriving while the
        original is still inside the updater blocks here until the first
        handler publishes its reply, instead of racing past a
        not-yet-written cache entry and double-applying the push. A
        waiter takes an unpublished claim over ONLY when its holder
        thread is dead (handler error mid-apply) — re-execution then,
        but only in that pathological case; a merely-slow holder (alive
        inside the updater) is waited on indefinitely."""
        deadline = time.monotonic() + _request_timeout()
        with self.lock:
            while True:
                hit = self._dedup.get(client)
                if hit is not None and hit[0] > seq:
                    # a frame from BEFORE the client's current request
                    # (buffered on a conn the client abandoned, read
                    # late): the client only advances seq after its
                    # previous mutating request was applied, so this is
                    # an already-applied duplicate — ack, never re-run
                    _TM_DEDUP_HITS.inc()
                    return ("ok",)
                if hit is None or hit[0] != seq:
                    self._dedup[client] = (seq, None)  # ours to execute
                    self._claim_holders[client] = \
                        threading.current_thread()
                    return None
                if hit[1] is not None:
                    _TM_DEDUP_HITS.inc()
                    return hit[1]  # duplicate of an applied request
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    holder = self._claim_holders.get(client)
                    if holder is not None and holder.is_alive():
                        # alive but slow (long updater apply): keep
                        # waiting — taking over would double-apply
                        deadline = (time.monotonic()
                                    + _request_timeout())
                        continue
                    self._dedup[client] = (seq, None)  # holder died
                    self._claim_holders[client] = \
                        threading.current_thread()
                    return None
                self._applied.wait(remaining)

    def _serve(self, conn):
        # a half-open worker (crashed without FIN, NAT dropped the flow)
        # must not wedge this handler in _recv_exact forever: after the
        # request timeout of idleness treat the peer as gone and close
        conn.settimeout(_request_timeout())
        try:
            while True:
                msg = _recv_msg(conn)
                client = seq = None
                claimed = False
                if msg[0] == "req":
                    # retry-safe envelope: (op, ...) wrapped with the
                    # sender's identity and a per-client sequence number
                    _, client, seq, msg = msg
                    if msg[0] in self._MUTATING_OPS:
                        cached = self._claim(client, seq)
                        if cached is not None:
                            _send_msg(conn, cached)  # already applied
                            continue
                        claimed = True
                try:
                    reply = self._handle(msg)
                except BaseException:
                    if claimed:
                        # publish an err reply so the client's retry
                        # fails FAST: an unpublished claim would stall
                        # every resend a full request timeout inside
                        # _claim before dead-holder takeover, then
                        # re-execute and fail again — with defaults
                        # that is minutes of hang for a deterministic
                        # server-side apply error
                        err = ("err", "server-side apply failed "
                               "(see server %d log)" % self.rank)
                        with self.lock:
                            hit = self._dedup.get(client)
                            if hit is not None and hit[0] == seq:
                                # only publish onto OUR claim: a newer
                                # request may have claimed after our
                                # client gave up on this one
                                self._dedup[client] = (seq, err)
                                self._claim_holders.pop(client, None)
                            self._applied.notify_all()
                        try:
                            # best effort on the live conn too, so the
                            # FIRST attempt sees the error without
                            # paying a reconnect + backoff round
                            _send_msg(conn, err)
                        except OSError:
                            pass
                    raise
                if claimed:
                    with self.lock:
                        hit = self._dedup.get(client)
                        if hit is not None and hit[0] == seq:
                            # only publish onto OUR claim: if the
                            # client gave up on this seq (retry budget
                            # spent while we were inside a long apply)
                            # and moved on, a newer request owns the
                            # slot — rolling it back would reopen the
                            # double-apply window
                            self._dedup[client] = (seq, reply)
                            self._claim_holders.pop(client, None)
                        self._applied.notify_all()
                _send_msg(conn, reply)
                if msg[0] == "stop":
                    return
        except socket.timeout:
            logging.warning(
                "parameter server %d: peer idle beyond "
                "MXNET_KVSTORE_TIMEOUT=%ss — assuming half-open "
                "connection and dropping it", self.rank,
                _request_timeout())
        except (ConnectionError, EOFError):
            pass
        except OSError as e:
            # EBADF only: close() pulled this connection out from under
            # a blocked recv (server shutdown) — expected, not a crash.
            # Any other OSError (e.g. an updater hitting a full disk
            # mid-apply) is a real handler failure and must be loud.
            if e.errno != errno.EBADF:
                import traceback
                logging.error("parameter server %d: handler crashed:\n%s",
                              self.rank, traceback.format_exc())
        except BaseException:
            # a dying server thread must not be silent: the peer only
            # sees a connection reset with no cause
            import traceback
            logging.error("parameter server %d: handler crashed:\n%s",
                          self.rank, traceback.format_exc())
        finally:
            conn.close()
            with self._conns_lock:
                # drop the dead socket from the close() bookkeeping or
                # conns grows by one entry per ping probe / reconnect
                # for the life of the server
                try:
                    self.conns.remove(conn)
                except ValueError:
                    pass  # close() already drained the list

    def _handle(self, msg):
        """Apply one request; return the reply tuple."""
        op = msg[0]
        if op == "init":
            _, key, part, val = msg
            with self.lock:
                # first init wins (every worker inits every key)
                self.store.setdefault((key, part), val.copy())
            return ("ok",)
        elif op == "push":
            _, key, part, val = msg
            with self.lock:
                if (key, part) not in self.store:
                    return ("err", "key %s not init" % key)
                stored = self.store[(key, part)]
                if self.updater is not None:
                    # update-per-push, reference
                    # kvstore_dist_server.h:194-202
                    from . import ndarray as nd
                    from .context import cpu
                    recv = nd.array(val, ctx=cpu())
                    dst = nd.array(stored, ctx=cpu())
                    self.updater(key, recv, dst)
                    self.store[(key, part)] = dst.asnumpy()
                else:
                    # no updater: plain overwrite-with-merged,
                    # like the reference server without optimizer
                    self.store[(key, part)] = val.copy()
            return ("ok",)
        elif op == "pull":
            _, key, part = msg
            with self.lock:
                val = self.store.get((key, part))
            if val is None:
                return ("err", "key %s not init" % key)
            return ("ok", val)
        elif op == "set_optimizer":
            from . import optimizer as opt_mod
            optimizer = pickle.loads(msg[1])
            with self.lock:
                if isinstance(optimizer, opt_mod.Optimizer):
                    self.updater = opt_mod.get_updater(optimizer)
                else:
                    self.updater = optimizer  # pre-built updater
            return ("ok",)
        elif op == "ping":
            # heartbeat: lets a worker distinguish a dead server
            # (connect refused / reset) from a slow one (ping answers
            # while a long request is still being chewed on)
            return ("ok", "pong")
        elif op == "stop":
            return ("ok",)
        return ("err", "bad op %r" % (op,))


class PSBackend:
    """Worker-side client + this process's colocated server.

    One live backend per process (like one ps-lite van per process):
    creating a new dist_async store closes the previous backend's
    sockets first — GC cannot be relied on to run ``close()`` before
    the new server binds the same port, because the server THREAD
    object stays registered in ``threading`` while its accept loop
    runs. Sequential store lifetimes only; two concurrently-used
    dist_async stores in one process are not supported (they weren't
    in the reference either — one ps-lite customer id per role).
    """

    _live = None
    _generation = 0

    def __init__(self):
        from . import distributed
        if PSBackend._live is not None:
            PSBackend._live.close()
            PSBackend._live = None
        # each store generation gets a fresh port block: even after
        # close(), peer-held FIN_WAIT sockets keep the OLD ports bound
        # on Linux, so re-binding them is not reliable. Store creation
        # is collective (every process creates stores in the same
        # order), so the generation — and thus the port map — agrees
        # across processes without communication.
        PSBackend._generation += 1
        self.generation = PSBackend._generation
        self.rank = distributed.rank()
        self.nserv = distributed.num_workers()
        hosts = os.environ.get("MXNET_KVSTORE_SERVER_HOSTS")
        if hosts:
            self.hosts = [h.strip() for h in hosts.split(",")]
            if len(self.hosts) != self.nserv:
                raise MXNetError(
                    "MXNET_KVSTORE_SERVER_HOSTS lists %d hosts for %d "
                    "processes" % (len(self.hosts), self.nserv))
        else:
            self.hosts = ["127.0.0.1"] * self.nserv
        self.server = _Server(self.rank, self._port(self.rank))
        self.server.start()
        self._conns = {}
        self._lock = threading.Lock()
        self._layout = {}  # key -> [(server, slice)] fixed at init
        # retry-safe identity: servers dedup mutating requests by
        # (client_id, seq), so a retried push is applied exactly once
        self._client_id = "w%d.g%d.%08x" % (
            self.rank, self.generation,
            int.from_bytes(os.urandom(4), "little"))
        self._seq = 0
        # make sure every server is listening before anyone pushes
        distributed.barrier("ps_backend_up")
        PSBackend._live = self
        logging.info("dist_async parameter server up: rank %d/%d",
                     self.rank, self.nserv)

    def _port(self, server):
        return _port_base() + (self.generation - 1) * self.nserv + server

    # -- transport ----------------------------------------------------
    def _conn_locked(self, server):
        c = self._conns.get(server)
        if c is None:
            c = socket.create_connection(
                (self.hosts[server], self._port(server)),
                timeout=_request_timeout())
            self._conns[server] = c
        return c

    def _drop_conn_locked(self, server):
        stale = self._conns.pop(server, None)
        if stale is not None:
            _TM_RECONNECTS.inc()  # next _conn_locked dials fresh
            try:
                stale.close()
            except OSError:
                pass

    def _ping(self, server, timeout=None):
        """Heartbeat probe on a FRESH short-timeout connection: True iff
        the server's accept loop answers. Distinguishes a dead server
        (connect refused/reset -> False) from one that is alive but slow
        on a long request (the probe rides its own handler thread)."""
        if timeout is None:
            timeout = min(5.0, _request_timeout())
        try:
            tic = time.perf_counter()
            with socket.create_connection(
                    (self.hosts[server], self._port(server)),
                    timeout=timeout) as c:
                _send_msg(c, ("ping",))
                ok = _recv_msg(c)[0] == "ok"
            if ok:
                _TM_PING_MS.observe((time.perf_counter() - tic) * 1e3)
            return ok
        except (OSError, EOFError, MXNetError):
            return False

    def _request(self, server, msg):
        """One request/reply round trip, with bounded retries.

        Failure policy (reference ps-lite resent its van messages after
        ZMQ reconnected; this is the same contract over raw TCP):

        * connection drop/refusal -> reconnect and resend with
          exponential backoff + jitter, up to MXNET_KVSTORE_MAX_RETRIES
          times (a server restarting behind the same port is picked
          back up transparently);
        * request timeout -> ping-probe the server on a side
          connection: alive means slow (resend, the dedup layer makes
          that safe), dead means the backoff path;
        * budget exhausted -> a loud MXNetError naming the peer and
          whether it looked dead or merely slow, so the operator can
          act (restart from the last checkpoint vs raise the timeout).

        Mutating requests carry (client_id, seq) so a server that
        already applied a retried push answers from its dedup cache
        instead of double-applying (see _Server._serve).
        """
        retries = _max_retries()
        backoff = _backoff_base_s()
        req_t0 = time.perf_counter()
        with self._lock:  # one in-flight request per worker (like the
            self._seq += 1  # engine var serializing pushes)
            envelope = ("req", self._client_id, self._seq, msg)
            last_err, server_alive = None, False
            for attempt in range(retries + 1):
                try:
                    c = self._conn_locked(server)
                    do_send = True
                    if _CLIENT_FAULTS is not None:
                        do_send = _CLIENT_FAULTS.before_send(
                            server, envelope, c)
                    if do_send:
                        _send_msg(c, envelope)
                    reply = _recv_msg(c)
                    if _CLIENT_FAULTS is not None:
                        _CLIENT_FAULTS.after_recv(
                            server, envelope, reply, c)
                    break
                except (ConnectionError, socket.timeout, OSError) as e:
                    last_err = e
                    if isinstance(e, socket.timeout):
                        _TM_TIMEOUTS.inc()
                    if attempt < retries:
                        _TM_RETRIES.inc()  # about to resend
                    self._drop_conn_locked(server)
                    # a timeout on an ESTABLISHED connection may just be
                    # a slow server: the heartbeat tells us which
                    server_alive = (isinstance(e, socket.timeout)
                                    and self._ping(server))
                    if attempt >= retries:
                        self._raise_dead(server, attempt + 1,
                                         server_alive, e)
                    if not server_alive:
                        # cap AFTER the jitter multiply: the documented
                        # bound is 10s per sleep, jitter included
                        delay = backoff * (2 ** attempt)
                        time.sleep(min(delay * (0.5 + random.random()),
                                       10.0))
            else:  # pragma: no cover - loop always breaks or raises
                self._raise_dead(server, retries + 1, False, last_err)
        _TM_REQUEST_MS.observe((time.perf_counter() - req_t0) * 1e3)
        if reply[0] != "ok":
            raise MXNetError("parameter server: %s" % (reply[1],))
        return reply[1] if len(reply) > 1 else None

    def _raise_dead(self, server, attempts, alive, err):
        # a dead/unreachable server is a cluster failure, not a bug in
        # the caller: name the peer so the operator can act (the
        # reference's ps-lite likewise aborts the run when a server van
        # connection drops)
        if alive:
            state = ("is alive (heartbeat answers) but did not reply "
                     "within MXNET_KVSTORE_TIMEOUT=%ss" %
                     _request_timeout())
        else:
            state = "is unreachable or died mid-request"
        raise MXNetError(
            "dist_async: parameter server %d (%s:%d) %s after %d "
            "attempt(s) (%s: %s). The key range it owned is lost; "
            "restart the job from the last checkpoint."
            % (server, self.hosts[server], self._port(server), state,
               attempts, type(err).__name__, err))

    # -- key placement (reference EncodeKey, kvstore_dist.h:230-268) --
    def _owner(self, key):
        return (key * 9973) % self.nserv

    def _partition(self, key, shape):
        """[(server, slice)] — whole-array for small keys, first-axis
        ranges across every server for big ones."""
        size = int(np.prod(shape)) if shape else 1
        if size < _bigarray_bound() or not shape or shape[0] < self.nserv:
            return [(self._owner(key), slice(None))]
        rows = shape[0]
        per = -(-rows // self.nserv)
        parts = []
        for s in range(self.nserv):
            lo = min(s * per, rows)
            hi = min(lo + per, rows)
            if lo < hi:
                parts.append((s, slice(lo, hi)))
        return parts

    # -- API ----------------------------------------------------------
    def init(self, key, value):
        value = np.asarray(value)
        self._layout[key] = self._partition(key, value.shape)
        for part, (server, sl) in enumerate(self._layout[key]):
            self._request(server, ("init", key, part, value[sl]))

    def push(self, key, value):
        value = np.asarray(value)
        for part, (server, sl) in enumerate(self._layout[key]):
            self._request(server, ("push", key, part, value[sl]))
        # counted after the part loop, like pull: both op/byte counters
        # mean COMPLETED operations (a push that exhausts its retries
        # raises without being counted)
        _TM_PUSHES.inc()
        _TM_PUSH_BYTES.inc(value.nbytes)

    def pull(self, key):
        parts = [self._request(server, ("pull", key, part))
                 for part, (server, _) in enumerate(self._layout[key])]
        _TM_PULLS.inc()
        _TM_PULL_BYTES.inc(sum(p.nbytes for p in parts))
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts, axis=0)

    def set_optimizer(self, pickled):
        for s in range(self.nserv):
            self._request(s, ("set_optimizer", pickled))

    def close(self):
        """Finalize the parameter-server backend (reference ps-lite
        Postoffice::Finalize semantics): BARRIER FIRST, then close
        sockets. The barrier must come before ANY server shard goes
        away — a worker that finishes early and tears down its server
        while a slow peer is still pulling kills that peer with a
        connection reset (observed as the 1-core 4-worker flake: ranks
        1-3 GC'd their kvstore while rank 0 was mid-pull on the key
        range rank 2's server owned). Idempotent: only the first close
        barriers and closes, so a second close can never deadlock
        waiting for peers that already left."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        try:
            from . import distributed
            # If a peer DIED before reaching this barrier, gloo's
            # timeout (MXNET_TPU_INIT_TIMEOUT) aborts the collective (it
            # does not hang forever) — the same unhappy-path contract as
            # ps-lite's Finalize barrier.
            distributed.barrier("kvstore_ps_close")
        except Exception:
            pass  # interpreter teardown / single process: best effort
        with self._lock:
            for c in self._conns.values():
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()
        self.server.close()
        if PSBackend._live is self:
            PSBackend._live = None
