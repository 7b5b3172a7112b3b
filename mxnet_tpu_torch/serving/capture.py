"""Traffic capture for the serving engine: the record half of the
serving time machine.

Counterpart of ``mxnet_tpu/serving/capture.py`` (the port's own copy, the
same JSONL format, version 1: a capture written by either package loads
in the other's :func:`load_capture`).

The flight recorder reconstructs what happened to one request; nothing
so far could reconstruct the TRAFFIC — once a request retires, the
stream of arrivals that produced a p99 blowup or a watchdog trip is
gone, and the incident cannot be rerun. The engine's defining property
makes that a waste: greedy outputs are byte-identical across admission
orders, speculation, chunking, prefix hits and snapshot/restore, so a
captured request stream can be replayed EXACTLY —
``python -m mxnet_tpu_torch.serving.replay`` turns any capture into an
offline test case (``--verify`` asserts the replayed tokens byte-match
the captured ones) and an A/B bench for any engine-config change.

:class:`CaptureStream` is a crash-safe, size-bounded JSONL appender:

* **one line per event**, flushed per record — a killed process leaves
  a readable log ending at the last completed line (the loader
  tolerates a torn final line from a crash mid-write);
* a **header** record first (capture format version + the engine
  geometry ``snapshot()`` reports), so replay can rebuild the same
  engine — or the same engine with overrides — without guessing;
* a **submit** record per accepted request: monotonic arrival time
  (seconds since capture start), request id, prompt token ids, the
  sampling identity (temperature, seed — draws are a function of the
  seed and the position, so they replay exactly within one package),
  token budget, eos id, deadlines, and any resume prefix (a restored
  engine's resubmits capture as what they are);
* a **retire** record per captured request: the emitted tokens, the
  retire reason, and the TTFT / steady-cadence timings the replay
  reports its latency diff against.

Bounded: ``MXNET_SERVING_CAPTURE_MB`` (default 64) caps the file —
past the budget NEW submits stop being captured (counted in
``serving.capture_skipped``), but the retire record of an
already-captured submit always lands (a capture whose submits have no
retires cannot be ``--verify``-replayed, and retires are bounded — at
most one per captured submit). Host-side only: recording is JSON
serialization of values the scheduler already has, under one lock, on
the submit/retire paths — never per token, never a device op.

Knobs: ``InferenceEngine(capture_dir=...)`` /
``MXNET_SERVING_CAPTURE_DIR`` (default unset = off) name the
directory; each engine opens its own ``mx_capture_<pid>_<n>.jsonl``
inside it. ``snapshot()`` carries ``capture_dir``, so a
``restore()``-ed engine keeps capturing into a fresh file in the same
directory — the crash cycle itself stays on tape.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import threading

from .. import telemetry as tele
from ..base import MXNetError

_log = logging.getLogger(__name__)

__all__ = ["CaptureStream", "load_capture"]

CAPTURE_VERSION = 1

_TM_RECORDS = tele.counter("serving.capture_records")
_TM_SKIPPED = tele.counter("serving.capture_skipped")
_TM_BYTES = tele.gauge("serving.capture_bytes")

# per-process file counter: a restore() cycle (or several engines
# sharing one capture_dir) must never overwrite an earlier capture
_FILE_SEQ = itertools.count()


class CaptureStream:
    """Crash-safe JSONL traffic capture (one instance per
    :class:`~mxnet_tpu_torch.serving.InferenceEngine`; build via
    :meth:`open`, which returns a disabled no-op stream when the knob
    is unset)."""

    def __init__(self, path, max_bytes, header):
        self.path = path
        self.max_bytes = int(max_bytes)
        self.skipped = 0
        self._captured = set()       # ids whose submit landed
        self._lock = threading.Lock()
        self._t0 = None              # set by the engine (perf_counter)
        self._f = None
        self.bytes_written = 0
        if path is None:
            return
        self._f = open(path, "w")
        self._write({"kind": "header", "version": CAPTURE_VERSION,
                     "engine": header}, always=True)

    @classmethod
    def open(cls, capture_dir, capture_mb, header, t0):
        """Open a capture in ``capture_dir`` (None/empty = the
        ``MXNET_SERVING_CAPTURE_DIR`` env default; still empty =
        capture off — a disabled stream whose methods are no-ops).
        ``capture_mb`` None = the ``MXNET_SERVING_CAPTURE_MB`` env
        default, else 64. ``t0`` is the engine's perf_counter origin
        for arrival timestamps."""
        if capture_dir is None:
            capture_dir = os.environ.get("MXNET_SERVING_CAPTURE_DIR") \
                or None
        if not capture_dir:
            st = cls(None, 0, None)     # capture off: all no-ops
            st._t0 = t0
            return st
        if capture_mb is None:
            capture_mb = float(os.environ.get(
                "MXNET_SERVING_CAPTURE_MB") or "64")
        if float(capture_mb) <= 0:
            raise MXNetError(
                "serving capture: MXNET_SERVING_CAPTURE_MB must be "
                "> 0, got %r (unset MXNET_SERVING_CAPTURE_DIR to "
                "disable capture)" % (capture_mb,))
        if os.path.exists(capture_dir) \
                and not os.path.isdir(capture_dir):
            raise MXNetError(
                "serving capture: capture_dir %r exists and is not a "
                "directory" % (capture_dir,))
        os.makedirs(capture_dir, exist_ok=True)
        path = os.path.join(capture_dir, "mx_capture_%d_%d.jsonl"
                            % (os.getpid(), next(_FILE_SEQ)))
        st = cls(path, int(float(capture_mb) * 2**20), header)
        st._t0 = t0
        return st

    @property
    def enabled(self):
        return self._f is not None

    def _write(self, rec, always=False):
        """Serialize + append one record. ``always`` exempts the
        header and retires of captured submits from the byte budget
        (see the module docstring). Returns False when the record was
        dropped at the budget.

        Capture failures never unwind the engine (flight-recorder /
        scrape-path precedent: observability must not kill serving):
        an unserializable record — e.g. a caller's ``np.int64``
        request id — is skipped and counted; an I/O error (disk full,
        file yanked) additionally DISABLES the stream, since every
        later write would fail the same way mid-submit/mid-drain."""
        try:
            line = json.dumps(rec, separators=(",", ":")) + "\n"
        except Exception as e:       # noqa: BLE001 — isolated
            with self._lock:
                self.skipped += 1
            _TM_SKIPPED.inc()
            _log.warning("serving capture: unserializable record "
                         "skipped (%s)", e)
            return False
        try:
            with self._lock:
                if self._f is None:
                    return False
                if not always and self.bytes_written + len(line) \
                        > self.max_bytes:
                    self.skipped += 1
                    _TM_SKIPPED.inc()
                    return False
                self._f.write(line)
                # flush per record: a SIGKILL'd process leaves every
                # completed line readable (the OS has the bytes; fsync
                # durability against machine crashes is not the
                # contract)
                self._f.flush()
                self.bytes_written += len(line)
        except OSError as e:
            _log.warning("serving capture: write failed (%s) — "
                         "capture disabled, %s is truncated at the "
                         "last whole record", e, self.path)
            self.close()
            return False
        _TM_RECORDS.inc()
        _TM_BYTES.set(self.bytes_written)
        return True

    def submit(self, req):
        """Record one accepted submit (called by the engine right
        after the request enters the queue)."""
        if self._f is None:
            return
        rec = {"kind": "submit",
               "t": round(req.t_submit - self._t0, 6),
               "id": req.id,
               "prompt": [int(x) for x in req.prompt],
               "max_tokens": int(req.max_tokens),
               "temperature": float(req.temperature),
               "seed": int(req.seed)}
        if req.eos_id is not None:
            rec["eos_id"] = int(req.eos_id)
        if req.deadline_ms is not None:
            rec["deadline_ms"] = float(req.deadline_ms)
        if req.ttft_deadline_ms is not None:
            rec["ttft_deadline_ms"] = float(req.ttft_deadline_ms)
        if req.resumed:
            rec["resume_tokens"] = list(req.tokens[:req.resumed])
        trace = getattr(req, "trace", None)
        if trace is not None:
            # fleet identity rides the capture so replay preserves it
            rec["trace_id"], rec["hop"] = trace
        if self._write(rec):
            with self._lock:
                self._captured.add(req.id)

    def retire(self, req):
        """Record one retirement — only for requests whose submit was
        captured (a retire without its submit is unreplayable noise).
        Carries the emitted tokens and the timings
        ``replay --verify`` byte-checks and latency-diffs against."""
        if self._f is None:
            return
        with self._lock:
            if req.id not in self._captured:
                return
            self._captured.discard(req.id)
        rec = {"kind": "retire",
               "t": round((req.t_done or req.t_submit) - self._t0, 6),
               "id": req.id,
               "reason": req.retire_reason,
               "tokens": [int(x) for x in req.tokens]}
        if req.t_first is not None:
            rec["ttft_ms"] = round(
                (req.t_first - req.t_submit) * 1e3, 3)
            if req.t_done is not None \
                    and len(req.tokens) - req.resumed > 1:
                rec["cadence_ms"] = round(
                    (req.t_done - req.t_first)
                    / (len(req.tokens) - req.resumed - 1) * 1e3, 3)
        self._write(rec, always=True)

    def close(self):
        """Flush and close the file (idempotent; a never-closed
        capture is still readable — every record was flushed)."""
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                finally:
                    self._f = None


def load_capture(path):
    """Parse a capture file into
    ``{"engine": geometry, "version": n, "submits": [...],
    "retires": {id: record}}``. Tolerates a torn final line (a crash
    mid-write leaves at most one partial record; every earlier line
    was flushed whole). Raises :class:`MXNetError` when the file has
    no header (not a capture)."""
    header = None
    submits = []
    retires = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            # only the FINAL line may be torn (a crash mid-write);
            # garbage earlier means the file is not a capture
            if i == len(lines) - 1:
                break
            raise MXNetError(
                "capture %s: unparseable record at line %d "
                "(not a capture file?)" % (path, i + 1))
        kind = rec.get("kind")
        if header is None:
            if kind != "header" \
                    or rec.get("version") != CAPTURE_VERSION:
                raise MXNetError(
                    "capture %s: missing/unknown header (want a "
                    "version-%d mx_capture JSONL)"
                    % (path, CAPTURE_VERSION))
            header = rec
        elif kind == "submit":
            submits.append(rec)
        elif kind == "retire":
            retires[rec["id"]] = rec
    if header is None:
        raise MXNetError("capture %s: empty file" % path)
    return {"engine": header["engine"], "version": header["version"],
            "submits": submits, "retires": retires}
